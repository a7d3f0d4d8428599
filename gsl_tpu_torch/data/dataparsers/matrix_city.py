"""MatrixCity dataparser.

Port of ``gsl_tpu/data/dataparsers/matrix_city.py``: the MatrixCity
``transforms.json`` lists (train, test) with per-frame
``transform_matrix`` (OpenGL, flipped to OpenCV) and shared or per-frame
intrinsics, one appearance id per frame. The initial point cloud
unprojects every `depth_read_step`-th pixel of each train view's depth map
(``.../depth/<stem>.exr`` beside ``.../rgb/``, scaled by `depth_scale`),
coloured by the image, at most `max_points` of them (a
``RandomState(0)`` choice). With no depth map at all it is 100,000
uniform points in ±50 from ``RandomState(0)``, gray (0.5), as in the JAX
package.

A depth file that exists but cannot be read raises, naming the file:
OpenCV reads ``.exr`` only when ``OPENCV_IO_ENABLE_OPENEXR=1`` is set
before it is imported, and the JAX package skips such a file silently.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List

import numpy as np

from .dataparser import (DataParser, DataParserOutputs, ImageSet, PointCloud,
                         camera_centers, cameras_from_numpy,
                         compute_camera_extent)


@dataclasses.dataclass
class MatrixCityDataParserConfig:
    path: str = ""
    train: List[str] = dataclasses.field(
        default_factory=lambda: ["transforms_train.json"])
    test: List[str] = dataclasses.field(
        default_factory=lambda: ["transforms_test.json"])
    depth_read_step: int = 4         # depth-pixel subsampling for points
    max_points: int = 3_000_000
    depth_scale: float = 0.01        # MatrixCity depth unit -> meters/100

    def instantiate(self) -> "MatrixCityDataParser":
        return MatrixCityDataParser(self)


def read_depth(path: str) -> np.ndarray:
    """A depth map [H, W] as OpenCV reads it; raises where it cannot."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"reading the MatrixCity depth map {path} needs OpenCV "
            "(cv2), which is not installed") from e
    depth = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR)
    if depth is None:
        raise RuntimeError(
            f"OpenCV could not read the MatrixCity depth map {path}; an "
            ".exr file is read only with OPENCV_IO_ENABLE_OPENEXR=1 set in "
            "the environment before cv2 is imported")
    return depth[..., 0] if depth.ndim == 3 else depth


class MatrixCityDataParser(DataParser):
    def __init__(self, config: MatrixCityDataParserConfig):
        self.config = config
        self._depth_paths = []

    def _load_set(self, json_names) -> ImageSet:
        names, paths, Rs, Ts = [], [], [], []
        fxs, fys, cxs, cys, ws, hs = [], [], [], [], [], []
        depth_paths = []
        for jn in json_names:
            jp = os.path.join(self.config.path, jn)
            with open(jp) as f:
                meta = json.load(f)
            base = os.path.dirname(jp)
            fl_x = meta.get("fl_x")
            fl_y = meta.get("fl_y", fl_x)
            for frame in meta["frames"]:
                fp = frame["file_path"]
                img_path = os.path.normpath(os.path.join(base, fp))
                c2w = np.array(frame["transform_matrix"], np.float64)
                c2w[:3, 1:3] *= -1
                w2c = np.linalg.inv(c2w)
                Rs.append(w2c[:3, :3])
                Ts.append(w2c[:3, 3])
                names.append(os.path.relpath(img_path, self.config.path))
                paths.append(img_path)
                fxs.append(frame.get("fl_x", fl_x))
                fys.append(frame.get("fl_y", fl_y))
                ws.append(int(frame.get("w", meta.get("w", 1000))))
                hs.append(int(frame.get("h", meta.get("h", 1000))))
                cxs.append(frame.get("cx", meta.get("cx", ws[-1] / 2)))
                cys.append(frame.get("cy", meta.get("cy", hs[-1] / 2)))
                depth_paths.append(img_path.replace(
                    "rgb", "depth").rsplit(".", 1)[0] + ".exr")
        n = len(names)
        cams = cameras_from_numpy(
            np.stack(Rs), np.stack(Ts), np.asarray(fxs, np.float32),
            np.asarray(fys, np.float32), np.asarray(cxs, np.float32),
            np.asarray(cys, np.float32), ws, hs,
            appearance_id=np.arange(n))
        self._depth_paths = depth_paths
        return ImageSet(image_names=names, image_paths=paths, cameras=cams)

    def _points_from_depths(self, image_set: ImageSet) -> PointCloud:
        """Unproject the depth maps into a world point cloud."""
        cfg = self.config
        xyz_all, rgb_all = [], []
        step = cfg.depth_read_step
        from PIL import Image
        for i, dpath in enumerate(self._depth_paths):
            if not os.path.exists(dpath):
                continue
            depth = read_depth(dpath)
            depth = depth[::step, ::step].astype(np.float64) \
                * cfg.depth_scale
            cam = image_set.cameras[i]
            H, W = depth.shape
            ys, xs = np.mgrid[0:H, 0:W]
            xs = xs * step + 0.5
            ys = ys * step + 0.5
            valid = (depth > 0) & np.isfinite(depth)
            z = depth[valid]
            x = (xs[valid] - float(cam.cx)) / float(cam.fx) * z
            y = (ys[valid] - float(cam.cy)) / float(cam.fy) * z
            p_cam = np.stack([x, y, z], axis=-1)
            R = cam.R.numpy().astype(np.float64)
            t = cam.T.numpy().astype(np.float64)
            xyz_all.append((p_cam - t) @ R)
            with Image.open(image_set.image_paths[i]) as im:
                rgb = np.asarray(im)[::step, ::step, :3]
            rgb_all.append(rgb[valid].astype(np.float32) / 255.0)
        if not xyz_all:
            rng = np.random.RandomState(0)
            return PointCloud(
                xyz=rng.uniform(-50, 50, (100_000, 3)).astype(np.float32),
                rgb=np.full((100_000, 3), 0.5, np.float32))
        xyz = np.concatenate(xyz_all).astype(np.float32)
        rgb = np.concatenate(rgb_all)
        if xyz.shape[0] > cfg.max_points:
            sel = np.random.RandomState(0).choice(
                xyz.shape[0], cfg.max_points, replace=False)
            xyz, rgb = xyz[sel], rgb[sel]
        return PointCloud(xyz=xyz, rgb=rgb)

    def get_outputs(self) -> DataParserOutputs:
        train = self._load_set(self.config.train)
        pc = self._points_from_depths(train)
        test = (self._load_set(self.config.test)
                if self.config.test else train)
        return DataParserOutputs(
            train_set=train, val_set=test, test_set=test, point_cloud=pc,
            camera_extent=compute_camera_extent(camera_centers(train.cameras)))
