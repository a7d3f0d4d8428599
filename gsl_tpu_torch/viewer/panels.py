"""The viewer's edit panels: model transforms, deletion in a box, camera
paths.

Port of ``gsl_tpu/viewer/panels.py``. The deletion marks the rows dead on
the state's device (the JAX package tests the means on the host).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..models.gaussian import GaussianState
from ..utils.gaussian_model_editor import inside_box, without
from ..utils.gaussian_transforms import (rotate_state, scale_state,
                                         translate_state)
from .camera_path import CameraPath

__all__ = ["CameraPath", "delete_in_box", "euler_to_rotmat",
           "transform_state"]


def euler_to_rotmat(rx: float, ry: float, rz: float) -> np.ndarray:
    """Degrees, applied z*y*x (the viewer's slider convention)."""
    a, b, c = np.deg2rad([rx, ry, rz])
    Rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                   [0, np.sin(a), np.cos(a)]])
    Ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                   [-np.sin(b), 0, np.cos(b)]])
    Rz = np.array([[np.cos(c), -np.sin(c), 0],
                   [np.sin(c), np.cos(c), 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def transform_state(state: GaussianState, translate=(0, 0, 0),
                    rotate_deg=(0, 0, 0), scale: float = 1.0
                    ) -> GaussianState:
    """Rotation (SH rotated with it), then uniform scale, then
    translation."""
    out = state
    R = euler_to_rotmat(*rotate_deg)
    if not np.allclose(R, np.eye(3)):
        out = rotate_state(out, R)
    if scale != 1.0:
        out = scale_state(out, float(scale))
    if any(t != 0 for t in translate):
        out = translate_state(out, np.asarray(translate, np.float32))
    return out


def delete_in_box(state: GaussianState, bbox_min, bbox_max
                  ) -> Tuple[GaussianState, int]:
    """Mark dead the alive rows whose centres lie inside the axis-aligned
    box; -> (state, how many)."""
    inside = inside_box(state, bbox_min, bbox_max)
    return without(state, inside), int(inside.sum())
