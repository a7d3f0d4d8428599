"""Nerfies / HyperNeRF dataparser.

Port of ``gsl_tpu/data/dataparsers/nerfies.py``:
- ``dataset.json``: the ids, and the train and val ids (no val ids: the
  first train id);
- ``scene.json``: the scale and centre that positions and points are
  normalised by;
- ``camera/<id>.json``: orientation, position, focal length, pixel aspect
  ratio, principal point and image size;
- ``rgb/{d}x/<id>.png``: the images, at downsample d;
- ``metadata.json`` (where present): each image's ``time_id``, divided by
  the largest of them, as the camera's time; an image without one is at
  time 0;
- ``points.npy`` (where present): the initial points, grey; otherwise
  `random_point_count` points uniform in [-1.5, 1.5]^3 from
  ``RandomState(42)``.

As gsl_tpu's: the ``orientation`` is used as the world-to-camera rotation
(rows), the radial and tangential distortion are not read, and every
image is its own appearance group. The test split is the val split.
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
class NerfiesDataParserConfig:
    path: str = ""
    downsample: int = 1
    random_point_count: int = 100_000

    def instantiate(self) -> "NerfiesDataParser":
        return NerfiesDataParser(self)


class NerfiesDataParser(DataParser):
    def __init__(self, config: NerfiesDataParserConfig):
        self.config = config

    def _image_set(self, ids, scene_scale, scene_center, times) -> ImageSet:
        cfg = self.config
        sub = f"{cfg.downsample}x" if cfg.downsample > 1 else "1x"
        f_scale = 1.0 / cfg.downsample
        names, paths, Rs, Ts = [], [], [], []
        fxs, fys, cxs, cys, ws, hs, tms = [], [], [], [], [], [], []
        from PIL import Image
        for iid in ids:
            with open(os.path.join(cfg.path, "camera", f"{iid}.json")) as f:
                c = json.load(f)
            R = np.array(c["orientation"], np.float64)
            pos = (np.array(c["position"], np.float64)
                   - np.asarray(scene_center)) * scene_scale
            img_path = os.path.join(cfg.path, "rgb", sub, f"{iid}.png")
            names.append(f"{iid}.png")
            paths.append(img_path)
            Rs.append(R)
            Ts.append(-R @ pos)
            fxs.append(c["focal_length"] * f_scale)
            fys.append(c["focal_length"]
                       * c.get("pixel_aspect_ratio", 1.0) * f_scale)
            pp = c.get("principal_point", [0, 0])
            cxs.append(pp[0] * f_scale)
            cys.append(pp[1] * f_scale)
            if os.path.exists(img_path):
                with Image.open(img_path) as im:
                    w, h = im.size
            else:
                size = c.get("image_size", [1000, 1000])
                w, h = int(size[0] * f_scale), int(size[1] * f_scale)
            ws.append(w)
            hs.append(h)
            tms.append(times.get(iid, 0.0))
        n = len(names)
        cams = cameras_from_numpy(
            np.stack(Rs), np.stack(Ts), np.asarray(fxs), np.asarray(fys),
            np.asarray(cxs), np.asarray(cys), np.asarray(ws),
            np.asarray(hs), appearance_id=np.arange(n),
            time=np.asarray(tms))
        return ImageSet(image_names=names, image_paths=paths, cameras=cams)

    def get_outputs(self) -> DataParserOutputs:
        cfg = self.config
        with open(os.path.join(cfg.path, "dataset.json")) as f:
            ds = json.load(f)
        with open(os.path.join(cfg.path, "scene.json")) as f:
            scene = json.load(f)
        scale = scene.get("scale", 1.0)
        center = scene.get("center", [0.0, 0.0, 0.0])

        times = {}
        meta_path = os.path.join(cfg.path, "metadata.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            tids = [meta[i].get("time_id", 0) for i in ds["ids"]
                    if i in meta]
            t_max = max(tids) if tids else 1
            for iid in ds["ids"]:
                if iid in meta:
                    times[iid] = meta[iid].get("time_id", 0) / max(t_max, 1)

        train_ids = ds.get("train_ids", ds["ids"])
        val_ids = ds.get("val_ids", []) or train_ids[:1]
        train = self._image_set(train_ids, scale, center, times)
        val = self._image_set(val_ids, scale, center, times)

        pts_path = os.path.join(cfg.path, "points.npy")
        if os.path.exists(pts_path):
            xyz = (np.load(pts_path) - np.asarray(center)) * scale
        else:
            xyz = np.random.RandomState(42).uniform(
                -1.5, 1.5, (cfg.random_point_count, 3))
        rgb = np.full((xyz.shape[0], 3), 0.5, np.float32)
        return DataParserOutputs(
            train_set=train, val_set=val, test_set=val,
            point_cloud=PointCloud(xyz=xyz.astype(np.float32), rgb=rgb),
            camera_extent=compute_camera_extent(camera_centers(
                train.cameras)))
