"""COLMAP dataparser.

Port of ``gsl_tpu/data/dataparsers/colmap.py``:
- reads a COLMAP sparse model (bin or txt) from `<path>/<sparse_dir>`
  (falling back to ``sparse/0``, then ``sparse``),
- image dir selection honors `images_{down_sample_factor}` pre-downsampled
  dirs, with intrinsic rescaling otherwise,
- eval split modes: step (every Nth image), ratio, or an explicit list file;
  split modes: reconstruction (train on every image) or experiment (train
  on the rest),
- point cloud from the SfM points (optionally filtered by reprojection
  error) or uniform random points (``RandomState(42)``), scene extent from
  camera centers,
- one appearance group per image; per-image distortion in ``extra_data``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Literal, Optional

import numpy as np

from ..colmap_io import qvec_to_rotmat, read_model
from .dataparser import (DataParser, DataParserOutputs, ImageSet, PointCloud,
                         camera_centers, cameras_from_numpy,
                         compute_camera_extent)


@dataclasses.dataclass
class ColmapDataParserConfig:
    path: str = ""
    sparse_dir: str = "sparse/0"
    images_dir: str = "images"
    down_sample_factor: int = 1
    split_mode: Literal["reconstruction", "experiment"] = "reconstruction"
    eval_image_select_mode: Literal["step", "ratio", "list"] = "step"
    eval_step: int = 8
    eval_ratio: float = 0.1
    eval_list: Optional[str] = None
    scene_scale: float = 1.0
    appearance_groups: Optional[str] = None
    image_list: Optional[str] = None
    """restrict to the image names in this file (partition training)"""
    max_point_error: float = -1.0
    points_from: Literal["sfm", "random"] = "sfm"
    random_point_count: int = 100_000

    def instantiate(self) -> "ColmapDataParser":
        return ColmapDataParser(self)


class ColmapDataParser(DataParser):
    def __init__(self, config: ColmapDataParserConfig):
        self.config = config

    def _sparse_path(self) -> str:
        for cand in (self.config.sparse_dir, "sparse/0", "sparse"):
            p = os.path.join(self.config.path, cand)
            if os.path.isdir(p):
                return p
        raise FileNotFoundError(
            f"no COLMAP sparse model under {self.config.path}")

    def _images_dir(self) -> str:
        f = self.config.down_sample_factor
        if f > 1:
            cand = os.path.join(self.config.path,
                                f"{self.config.images_dir}_{f}")
            if os.path.isdir(cand):
                return cand
        return os.path.join(self.config.path, self.config.images_dir)

    def get_outputs(self) -> DataParserOutputs:
        cfg = self.config
        model = read_model(self._sparse_path())
        images_dir = self._images_dir()
        image_dir_is_downsampled = images_dir.endswith(
            f"_{cfg.down_sample_factor}")

        items = sorted(model.images.values(), key=lambda im: im.name)
        if cfg.image_list:
            with open(cfg.image_list) as f:
                allowed = {ln.strip() for ln in f if ln.strip()}
            items = [im for im in items if im.name in allowed]
        names, paths, Rs, Ts = [], [], [], []
        fx, fy, cx, cy, ws, hs = [], [], [], [], [], []
        for im in items:
            cam = model.cameras[im.camera_id]
            names.append(im.name)
            paths.append(os.path.join(images_dir, im.name))
            Rs.append(qvec_to_rotmat(im.qvec))
            Ts.append(im.tvec)
            scale = 1.0
            if cfg.down_sample_factor > 1 and not image_dir_is_downsampled:
                scale = 1.0 / cfg.down_sample_factor
            fx.append(cam.fx * scale)
            fy.append(cam.fy * scale)
            cx.append(cam.cx * scale)
            cy.append(cam.cy * scale)
            ws.append(int(round(cam.width * scale)))
            hs.append(int(round(cam.height * scale)))
        distortions = [model.cameras[im.camera_id].distortion
                       for im in items]
        n = len(names)
        cams = cameras_from_numpy(np.stack(Rs), np.stack(Ts), fx, fy, cx, cy,
                                  ws, hs, appearance_id=np.arange(n))

        # eval split
        idx = np.arange(n)
        if cfg.eval_image_select_mode == "step":
            val_mask = (idx % cfg.eval_step) == 0
        elif cfg.eval_image_select_mode == "ratio":
            n_val = max(1, int(round(n * cfg.eval_ratio)))
            stride = max(1, n // n_val)
            val_mask = (idx % stride) == 0
        else:
            with open(os.path.join(cfg.path, cfg.eval_list)) as f:
                val_names = {ln.strip() for ln in f if ln.strip()}
            val_mask = np.array([nm in val_names for nm in names])
        if cfg.split_mode == "reconstruction":
            train_mask = np.ones(n, bool)   # train on all images
        else:
            train_mask = ~val_mask

        def subset(mask) -> ImageSet:
            sel = np.nonzero(mask)[0]
            return ImageSet(
                image_names=[names[i] for i in sel],
                image_paths=[paths[i] for i in sel],
                cameras=cams[sel],
                extra_data={"distortion": [distortions[i] for i in sel]},
            )

        train_set = subset(train_mask)
        val_set = subset(val_mask)

        centers = camera_centers(cams)
        if cfg.points_from == "random":
            rng = np.random.RandomState(42)
            lo, hi = centers.min(0) - 1.0, centers.max(0) + 1.0
            xyz = rng.uniform(lo, hi, size=(cfg.random_point_count, 3))
            rgb = rng.uniform(0, 1, size=xyz.shape).astype(np.float32)
        else:
            xyz = model.points_xyz
            rgb = model.points_rgb.astype(np.float32) / 255.0
            if cfg.max_point_error > 0:
                keep = model.points_err <= cfg.max_point_error
                xyz, rgb = xyz[keep], rgb[keep]

        extent = compute_camera_extent(centers) * cfg.scene_scale

        appearance_group_ids = {nm: i for i, nm in enumerate(names)}
        return DataParserOutputs(
            train_set=train_set, val_set=val_set, test_set=val_set,
            point_cloud=PointCloud(xyz=xyz.astype(np.float32),
                                   rgb=rgb.astype(np.float32)),
            camera_extent=extent,
            appearance_group_ids=appearance_group_ids,
        )
