"""Blender (nerf_synthetic) dataparser.

Port of ``gsl_tpu/data/dataparsers/blender.py``:
transforms_{train,val,test}.json with OpenGL c2w matrices (flipped to
OpenCV), fx from camera_angle_x; point cloud = `random_point_count` uniform
points in [-random_point_max_coordinate, +...]^3 drawn from
``RandomState(random_point_seed)``, gray (127). A missing val split falls
back to train, a missing test split to val.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

from .dataparser import (DataParser, DataParserOutputs, ImageSet, PointCloud,
                         camera_centers, cameras_from_numpy,
                         compute_camera_extent)


@dataclasses.dataclass
class BlenderDataParserConfig:
    path: str = ""
    white_background: bool = True
    random_point_count: int = 100_000
    random_point_max_coordinate: float = 1.3
    random_point_seed: int = 42

    def instantiate(self) -> "BlenderDataParser":
        return BlenderDataParser(self)


class BlenderDataParser(DataParser):
    def __init__(self, config: BlenderDataParserConfig):
        self.config = config

    def _load_split(self, split: str) -> Optional[ImageSet]:
        path = os.path.join(self.config.path, f"transforms_{split}.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            meta = json.load(f)
        names, paths = [], []
        Rs, Ts = [], []
        for frame in meta["frames"]:
            fp = frame["file_path"]
            if not fp.endswith(".png"):
                fp = fp + ".png"
            img_path = os.path.join(self.config.path, fp)
            names.append(os.path.basename(fp))
            paths.append(img_path)
            c2w = np.array(frame["transform_matrix"], np.float64)
            c2w[:3, 1:3] *= -1  # OpenGL -> OpenCV camera convention
            w2c = np.linalg.inv(c2w)
            Rs.append(w2c[:3, :3])
            Ts.append(w2c[:3, 3])
        # the image size from the first image
        from PIL import Image
        with Image.open(paths[0]) as im:
            w, h = im.size
        n = len(names)
        fx = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
        cams = cameras_from_numpy(
            np.stack(Rs), np.stack(Ts), np.full(n, fx), np.full(n, fx),
            np.full(n, w / 2.0), np.full(n, h / 2.0), np.full(n, w),
            np.full(n, h))
        return ImageSet(image_names=names, image_paths=paths, cameras=cams)

    def get_outputs(self) -> DataParserOutputs:
        train = self._load_split("train")
        val = self._load_split("val") or train
        test = self._load_split("test") or val

        rng = np.random.RandomState(self.config.random_point_seed)
        m = self.config.random_point_max_coordinate
        xyz = rng.uniform(-m, m, size=(self.config.random_point_count, 3))
        rgb = np.full((self.config.random_point_count, 3), 127.0 / 255.0,
                      np.float32)
        return DataParserOutputs(
            train_set=train, val_set=val, test_set=test,
            point_cloud=PointCloud(xyz=xyz.astype(np.float32), rgb=rgb),
            camera_extent=compute_camera_extent(camera_centers(train.cameras)),
        )
