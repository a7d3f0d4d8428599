"""SiLVR dataparser (LiDAR-visual radiance-field exports).

Port of ``gsl_tpu/data/dataparsers/silvr.py``: one nerfstudio-style
``transforms.json`` holds every frame, with intrinsics per frame or shared
(``fl_x`` / ``fl_y``, ``cx`` / ``cy``, ``w`` / ``h``; ``camera_angle_x``
where no focal length is given). Every frame trains and the first doubles
as val and test. The point cloud is `n_random_points` uniform points in a
cube of side `random_point_range` centred on the mean camera centre, from
``RandomState(random_point_seed)``; gray (127), or random colours drawn
after the points with `random_point_color`.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from .blender import BlenderDataParser, BlenderDataParserConfig
from .dataparser import (DataParserOutputs, ImageSet, PointCloud,
                         camera_centers, cameras_from_numpy,
                         compute_camera_extent)


@dataclasses.dataclass
class SILVRDataParserConfig(BlenderDataParserConfig):
    n_random_points: int = 100_000
    random_point_color: bool = False
    random_point_range: float = 10.0

    def instantiate(self) -> "SILVRDataParser":
        return SILVRDataParser(self)


class SILVRDataParser(BlenderDataParser):
    def _load_transforms(self) -> ImageSet:
        path = os.path.join(self.config.path, "transforms.json")
        with open(path) as f:
            meta = json.load(f)
        names, paths, Rs, Ts = [], [], [], []
        fxs, fys, cxs, cys, ws, hs = [], [], [], [], [], []
        for frame in meta["frames"]:
            fp = frame["file_path"]
            img_path = os.path.join(self.config.path, fp)
            names.append(os.path.basename(fp))
            paths.append(img_path)
            c2w = np.array(frame["transform_matrix"], np.float64)
            c2w[:3, 1:3] *= -1
            w2c = np.linalg.inv(c2w)
            Rs.append(w2c[:3, :3])
            Ts.append(w2c[:3, 3])
            w = int(frame.get("w", meta.get("w", 0)))
            h = int(frame.get("h", meta.get("h", 0)))
            fx = float(frame.get("fl_x", meta.get("fl_x", 0.0)))
            fy = float(frame.get("fl_y", meta.get("fl_y", fx)))
            cx = float(frame.get("cx", meta.get("cx", w / 2.0)))
            cy = float(frame.get("cy", meta.get("cy", h / 2.0)))
            if fx == 0.0 and "camera_angle_x" in meta:
                if w == 0:
                    from PIL import Image
                    with Image.open(img_path) as im:
                        w, h = im.size
                fx = 0.5 * w / np.tan(
                    0.5 * float(meta["camera_angle_x"]))
                fy = fx
            fxs.append(fx)
            fys.append(fy)
            cxs.append(cx)
            cys.append(cy)
            ws.append(w)
            hs.append(h)
        cams = cameras_from_numpy(np.stack(Rs), np.stack(Ts), fxs, fys, cxs,
                                  cys, ws, hs)
        return ImageSet(image_names=names, image_paths=paths, cameras=cams)

    def get_outputs(self) -> DataParserOutputs:
        train = self._load_transforms()
        val = ImageSet(image_names=train.image_names[:1],
                       image_paths=train.image_paths[:1],
                       cameras=train.cameras[np.asarray([0])])

        centers = camera_centers(train.cameras)
        rng = np.random.RandomState(self.config.random_point_seed)
        r = self.config.random_point_range
        xyz = (rng.random((self.config.n_random_points, 3)) * r - r / 2.0
               + centers.mean(0))
        if self.config.random_point_color:
            rgb = rng.random((self.config.n_random_points, 3)
                             ).astype(np.float32)
        else:
            rgb = np.full((self.config.n_random_points, 3), 127 / 255.0,
                          np.float32)
        return DataParserOutputs(
            train_set=train, val_set=val, test_set=val,
            point_cloud=PointCloud(xyz=xyz.astype(np.float32), rgb=rgb),
            camera_extent=compute_camera_extent(centers))
