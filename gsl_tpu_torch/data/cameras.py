"""Camera container, port of ``gsl_tpu/data/cameras.py``.

``p_cam = R @ p_world + T`` (column-vector convention) everywhere.
Intrinsics are float32 tensors, as in JAX, so projection arithmetic rounds
the same way in both packages; width and height are Python ints.
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils.device import resolve_device


@dataclasses.dataclass
class Cameras:
    """One camera.

    R: [3, 3] world-to-camera rotation; T: [3] world-to-camera translation;
    fx, fy, cx, cy: 0-d float32 tensors (pixels); width, height: int.
    """

    R: torch.Tensor
    T: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int

    @property
    def world_to_camera(self) -> torch.Tensor:
        """[4, 4] such that p_cam = (w2c @ [p, 1])[:3]."""
        w2c = torch.eye(4, dtype=self.R.dtype, device=self.R.device)
        w2c[:3, :3] = self.R
        w2c[:3, 3] = self.T
        return w2c

    @property
    def camera_center(self) -> torch.Tensor:
        """[3] camera position in world space: -R^T T."""
        return -(self.R.T @ self.T)


def make_camera(R, T, fx, fy, cx, cy, width, height,
                device=None) -> Cameras:
    """Build a camera from scalars/arrays on `device` (default cuda)."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32).to(dev)

    return Cameras(R=f32(R), T=f32(T), fx=f32(fx), fy=f32(fy), cx=f32(cx),
                   cy=f32(cy), width=int(width), height=int(height))
