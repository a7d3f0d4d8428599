"""Dataparser base contracts.

Port of ``gsl_tpu/data/dataparsers/dataparser.py``: ImageSet
(names/paths/cameras/masks/extra), PointCloud(xyz, rgb), DataParserOutputs
with the default camera extent = 1.1 * max distance to the mean camera
center.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..cameras import Cameras


@dataclasses.dataclass
class ImageSet:
    image_names: List[str]
    image_paths: List[str]
    cameras: Cameras                      # batched on the CPU, len == n
    mask_paths: Optional[List[Optional[str]]] = None
    extra_data: Optional[Dict[str, Any]] = None

    def __len__(self):
        return len(self.image_names)


@dataclasses.dataclass
class PointCloud:
    xyz: np.ndarray  # [N, 3] float
    rgb: np.ndarray  # [N, 3] float in [0, 1]


@dataclasses.dataclass
class DataParserOutputs:
    train_set: ImageSet
    val_set: ImageSet
    test_set: ImageSet
    point_cloud: PointCloud
    camera_extent: float
    appearance_group_ids: Optional[Dict[str, int]] = None

    @property
    def prune_extent(self) -> float:
        return self.camera_extent


def compute_camera_extent(camera_centers: np.ndarray,
                          factor: float = 1.1) -> float:
    """camera_centers [M, 3] -> 1.1 * max dist to mean center."""
    mean = camera_centers.mean(axis=0, keepdims=True)
    dists = np.linalg.norm(camera_centers - mean, axis=-1)
    return float(dists.max() * factor)


def camera_centers(cameras: Cameras) -> np.ndarray:
    """[N, 3] float32 centers of a batch, one camera at a time as the JAX
    package computes them."""
    return np.stack([cameras[i].camera_center.numpy()
                     for i in range(len(cameras))])


def cameras_from_numpy(R, T, fx, fy, cx, cy, width, height,
                       appearance_id=None, time=None) -> Cameras:
    """A CPU batch from numpy arrays: float32 geometry and times, int32
    sizes."""
    def f32(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32))

    def i32(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32))

    return Cameras(R=f32(R), T=f32(T), fx=f32(fx), fy=f32(fy), cx=f32(cx),
                   cy=f32(cy), width=i32(width), height=i32(height),
                   appearance_id=(None if appearance_id is None
                                  else i32(appearance_id)),
                   time=None if time is None else f32(time))


class DataParser:
    def get_outputs(self) -> DataParserOutputs:
        raise NotImplementedError
