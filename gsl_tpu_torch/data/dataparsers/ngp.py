"""instant-ngp dataparser.

Port of ``gsl_tpu/data/dataparsers/ngp.py``: one ``transforms.json`` with
shared or per-frame intrinsics (``fl_x`` / ``fl_y`` or
``camera_angle_x``, ``cx`` / ``cy``, ``w`` / ``h``, the image's own size
where none is given), OpenGL camera-to-world matrices flipped to OpenCV,
one appearance id per frame. Every frame trains; every `eval_step`-th
(from the first) is also val and test. The point cloud is
`random_point_count` uniform points in ±`scene_box` from
``RandomState(42)``, gray (0.5).
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from .dataparser import (DataParser, DataParserOutputs, ImageSet, PointCloud,
                         camera_centers, cameras_from_numpy,
                         compute_camera_extent)


@dataclasses.dataclass
class NGPDataParserConfig:
    path: str = ""
    transforms: str = "transforms.json"
    eval_step: int = 8
    random_point_count: int = 100_000
    scene_box: float = 1.5

    def instantiate(self) -> "NGPDataParser":
        return NGPDataParser(self)


class NGPDataParser(DataParser):
    def __init__(self, config: NGPDataParserConfig):
        self.config = config

    def get_outputs(self) -> DataParserOutputs:
        cfg = self.config
        with open(os.path.join(cfg.path, cfg.transforms)) as f:
            meta = json.load(f)

        names, paths, Rs, Ts = [], [], [], []
        fxs, fys, cxs, cys, ws, hs = [], [], [], [], [], []
        from PIL import Image
        for frame in meta["frames"]:
            fp = frame["file_path"]
            img_path = os.path.join(cfg.path, fp)
            if not os.path.exists(img_path) \
                    and os.path.exists(img_path + ".png"):
                img_path += ".png"
            c2w = np.array(frame["transform_matrix"], np.float64)
            c2w[:3, 1:3] *= -1
            w2c = np.linalg.inv(c2w)
            Rs.append(w2c[:3, :3])
            Ts.append(w2c[:3, 3])
            names.append(os.path.basename(img_path))
            paths.append(img_path)

            w = int(frame.get("w", meta.get("w", 0)))
            h = int(frame.get("h", meta.get("h", 0)))
            if w == 0 or h == 0:
                with Image.open(img_path) as im:
                    w, h = im.size
            fl_x = frame.get("fl_x", meta.get("fl_x"))
            if fl_x is None:
                fl_x = 0.5 * w / np.tan(
                    0.5 * float(meta["camera_angle_x"]))
            fl_y = frame.get("fl_y", meta.get("fl_y", fl_x))
            fxs.append(fl_x)
            fys.append(fl_y)
            cxs.append(frame.get("cx", meta.get("cx", w / 2)))
            cys.append(frame.get("cy", meta.get("cy", h / 2)))
            ws.append(w)
            hs.append(h)

        n = len(names)
        cams = cameras_from_numpy(
            np.stack(Rs), np.stack(Ts), fxs, fys, cxs, cys, ws, hs,
            appearance_id=np.arange(n))

        idx = np.arange(n)
        val_mask = (idx % cfg.eval_step) == 0

        def subset(sel) -> ImageSet:
            sel = np.nonzero(sel)[0]
            return ImageSet(
                image_names=[names[i] for i in sel],
                image_paths=[paths[i] for i in sel],
                cameras=cams[sel])

        train = subset(np.ones(n, bool))
        val = subset(val_mask)

        rng = np.random.RandomState(42)
        xyz = rng.uniform(-cfg.scene_box, cfg.scene_box,
                          (cfg.random_point_count, 3)).astype(np.float32)
        rgb = np.full((cfg.random_point_count, 3), 0.5, np.float32)
        return DataParserOutputs(
            train_set=train, val_set=val, test_set=val,
            point_cloud=PointCloud(xyz=xyz, rgb=rgb),
            camera_extent=compute_camera_extent(camera_centers(train.cameras)))
