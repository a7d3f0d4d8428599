"""NSVF (Synthetic-NSVF) dataparser.

Port of ``gsl_tpu/data/dataparsers/nsvf.py``: ``intrinsics.txt`` (fx cx
cy), ``pose/*.txt`` camera-to-world matrices (OpenGL, flipped to OpenCV)
and ``rgb/*`` images, split by file-name prefix (``0_`` train, ``1_`` val,
``2_`` test; a missing val split falls back to train, a missing test split
to val). The point cloud is `random_point_count` uniform points in the
scene box (``bbox.txt`` when present, else ±1.5) from
``RandomState(42)``, gray (0.5).
"""
from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np

from .dataparser import (DataParser, DataParserOutputs, ImageSet, PointCloud,
                         camera_centers, cameras_from_numpy,
                         compute_camera_extent)


@dataclasses.dataclass
class NSVFDataParserConfig:
    path: str = ""
    random_point_count: int = 100_000

    def instantiate(self) -> "NSVFDataParser":
        return NSVFDataParser(self)


class NSVFDataParser(DataParser):
    def __init__(self, config: NSVFDataParserConfig):
        self.config = config

    def _load(self, prefix: str):
        root = self.config.path
        poses = sorted(glob.glob(os.path.join(root, "pose",
                                              f"{prefix}_*.txt")))
        rgbs = sorted(glob.glob(os.path.join(root, "rgb", f"{prefix}_*")))
        if not poses:
            return None
        with open(os.path.join(root, "intrinsics.txt")) as f:
            vals = f.read().split()
        fx = float(vals[0])
        cx, cy = float(vals[1]), float(vals[2])

        from PIL import Image
        with Image.open(rgbs[0]) as im:
            w, h = im.size

        names, paths, Rs, Ts = [], [], [], []
        for pose_path, rgb_path in zip(poses, rgbs):
            c2w = np.loadtxt(pose_path).reshape(4, 4)
            c2w[:3, 1:3] *= -1  # OpenGL -> OpenCV
            w2c = np.linalg.inv(c2w)
            Rs.append(w2c[:3, :3])
            Ts.append(w2c[:3, 3])
            names.append(os.path.basename(rgb_path))
            paths.append(rgb_path)
        n = len(names)
        cams = cameras_from_numpy(
            np.stack(Rs), np.stack(Ts), np.full(n, fx), np.full(n, fx),
            np.full(n, cx), np.full(n, cy), np.full(n, w), np.full(n, h))
        return ImageSet(image_names=names, image_paths=paths, cameras=cams)

    def get_outputs(self) -> DataParserOutputs:
        train = self._load("0")
        val = self._load("1") or train
        test = self._load("2") or val

        bbox_path = os.path.join(self.config.path, "bbox.txt")
        if os.path.exists(bbox_path):
            bb = np.loadtxt(bbox_path).ravel()
            lo, hi = bb[:3], bb[3:6]
        else:
            lo, hi = np.full(3, -1.5), np.full(3, 1.5)
        rng = np.random.RandomState(42)
        xyz = rng.uniform(lo, hi,
                          size=(self.config.random_point_count, 3))
        rgb = np.full((self.config.random_point_count, 3), 0.5, np.float32)
        return DataParserOutputs(
            train_set=train, val_set=val, test_set=test,
            point_cloud=PointCloud(xyz=xyz.astype(np.float32), rgb=rgb),
            camera_extent=compute_camera_extent(camera_centers(train.cameras)),
        )
