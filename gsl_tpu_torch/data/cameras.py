"""Camera container, port of ``gsl_tpu/data/cameras.py``.

``p_cam = R @ p_world + T`` (column-vector convention) everywhere.
Intrinsics are float32 tensors, as in JAX, so projection arithmetic rounds
the same way in both packages. One camera holds 0-d tensors and Python-int
width and height; a batch (what the dataparsers build) holds [N, ...]
tensors, int32 widths and heights included, and indexing it gives one
camera or a smaller batch.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

from ..utils.device import resolve_device

_TENSOR_FIELDS = ("R", "T", "fx", "fy", "cx", "cy", "appearance_id", "time")


@dataclasses.dataclass
class Cameras:
    """One camera or a batch of them.

    R: [..., 3, 3] world-to-camera rotation; T: [..., 3] world-to-camera
    translation; fx, fy, cx, cy: [...] float32 (pixels); width, height: int
    for one camera, [N] int32 for a batch; appearance_id: [...] int32
    (per-image appearance group); time: [...] float32 (0 for static
    scenes).
    """

    R: torch.Tensor
    T: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: Union[int, torch.Tensor]
    height: Union[int, torch.Tensor]
    appearance_id: torch.Tensor = None
    time: torch.Tensor = None

    def __post_init__(self):
        shape, dev = self.fx.shape, self.fx.device
        if self.appearance_id is None:
            self.appearance_id = torch.zeros(shape, dtype=torch.int32,
                                             device=dev)
        if self.time is None:
            self.time = torch.zeros(shape, dtype=torch.float32, device=dev)

    def __len__(self) -> int:
        return int(self.fx.shape[0])

    def __getitem__(self, idx) -> "Cameras":
        """An int gives one camera (int width and height); an index array
        or slice gives a batch."""
        if not isinstance(idx, (int, slice)):
            idx = torch.as_tensor(idx, dtype=torch.int64)
        fields = {k: getattr(self, k)[idx] for k in _TENSOR_FIELDS}
        w, h = self.width[idx], self.height[idx]
        if w.ndim == 0:
            w, h = int(w), int(h)
        return Cameras(width=w, height=h, **fields)

    def to(self, device) -> "Cameras":
        moved = {k: getattr(self, k).to(device) for k in _TENSOR_FIELDS}
        if not isinstance(self.width, int):
            moved.update(width=self.width.to(device),
                         height=self.height.to(device))
        return dataclasses.replace(self, **moved)

    @property
    def device(self) -> torch.device:
        return self.R.device

    @property
    def world_to_camera(self) -> torch.Tensor:
        """[..., 4, 4] such that p_cam = (w2c @ [p, 1])[:3]."""
        w2c = torch.eye(4, dtype=self.R.dtype, device=self.R.device).expand(
            self.R.shape[:-2] + (4, 4)).clone()
        w2c[..., :3, :3] = self.R
        w2c[..., :3, 3] = self.T
        return w2c

    @property
    def camera_center(self) -> torch.Tensor:
        """[..., 3] camera position in world space: -R^T T."""
        if self.R.ndim == 2:
            return -(self.R.T @ self.T)
        return -torch.einsum("...ji,...j->...i", self.R, self.T)

    def _size(self, v):
        return (torch.as_tensor(v, dtype=self.fx.dtype, device=self.device)
                if isinstance(v, int) else v.to(self.fx.dtype))

    @property
    def fov_x(self) -> torch.Tensor:
        return 2.0 * torch.atan2(self._size(self.width) / 2.0, self.fx)

    @property
    def fov_y(self) -> torch.Tensor:
        return 2.0 * torch.atan2(self._size(self.height) / 2.0, self.fy)

    def get_K(self) -> torch.Tensor:
        """[..., 3, 3] intrinsics matrix."""
        z, o = torch.zeros_like(self.fx), torch.ones_like(self.fx)
        return torch.stack([
            torch.stack([self.fx, z, self.cx], dim=-1),
            torch.stack([z, self.fy, self.cy], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ], dim=-2)

    def rescale(self, factor: float) -> "Cameras":
        """Image size and intrinsics divided by `factor`; sizes truncate
        toward zero, as the JAX package's int32 cast does."""
        def size(v):
            if isinstance(v, int):
                return int(v / factor)
            return (v / factor).to(torch.int32)

        return dataclasses.replace(
            self, fx=self.fx / factor, fy=self.fy / factor,
            cx=self.cx / factor, cy=self.cy / factor,
            width=size(self.width), height=size(self.height))


def make_camera(R, T, fx, fy, cx, cy, width, height, appearance_id=0,
                time=0.0, device=None) -> Cameras:
    """Build one camera from scalars/arrays on `device` (default cuda)."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32).to(dev)

    return Cameras(R=f32(R), T=f32(T), fx=f32(fx), fy=f32(fy), cx=f32(cx),
                   cy=f32(cy), width=int(width), height=int(height),
                   appearance_id=torch.as_tensor(
                       appearance_id, dtype=torch.int32).to(dev),
                   time=f32(time))


def stack_cameras(cams) -> Cameras:
    """A batch from a list of single cameras."""
    def stack(k):
        return torch.stack([getattr(c, k) for c in cams])

    return Cameras(
        **{k: stack(k) for k in _TENSOR_FIELDS},
        width=torch.tensor([c.width for c in cams], dtype=torch.int32,
                           device=cams[0].device),
        height=torch.tensor([c.height for c in cams], dtype=torch.int32,
                            device=cams[0].device))
