"""Glossy Gaussians with a learnable environment light.

Port of ``gsl_tpu/models/glossy.py``: a per-Gaussian metalness, a
per-Gaussian normal (the rotation column of the smallest scale axis,
turned toward the camera) and a learnable latlong environment map; the
colour is clamp(SH albedo + metalness * env(reflect(view, normal)), 0, 1),
the map sampled bilinearly. Gradients reach the means and rotations
through the reflection (not the scales: the choice of axis has none), the
metalness and the map.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..ops.transforms import normalize_quat, quat_to_rotmat


@dataclasses.dataclass
class EnvLightConfig:
    height: int = 64
    width: int = 128
    init_value: float = 0.5

    def instantiate(self):
        return self


def init_envmap(cfg: EnvLightConfig, device=None) -> torch.Tensor:
    return torch.full((cfg.height, cfg.width, 3), cfg.init_value,
                      dtype=torch.float32, device=device)


def sample_envmap(envmap: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Bilinear latlong lookup: dirs [N, 3] (unit) -> rgb [N, 3]. The
    polar angle runs from +y, the azimuth from +x toward +z; the azimuth
    wraps, the poles clamp. A direction whose y rounds to +-1 takes no
    gradient through the polar angle, where arccos has no finite one
    (gsl_tpu's is infinite there, and Adam turns it into NaN)."""
    H, W, _ = envmap.shape
    y = dirs[:, 1]
    y = torch.where(y.abs() < 1.0, y, y.detach())
    theta = torch.arccos(torch.clamp(y, -1.0, 1.0))              # [0, pi]
    phi = torch.atan2(dirs[:, 2], dirs[:, 0])                    # [-pi, pi]
    v = theta / math.pi * (H - 1)
    u = (phi / (2.0 * math.pi) + 0.5) * (W - 1)
    u0f, v0f = torch.floor(u), torch.floor(v)
    u0, v0 = u0f.to(torch.int64), v0f.to(torch.int64)
    u1 = (u0 + 1) % W
    v1 = torch.clamp(v0 + 1, max=H - 1)
    fu = (u - u0f)[:, None]
    fv = (v - v0f)[:, None]
    return (envmap[v0, u0] * (1 - fu) * (1 - fv)
            + envmap[v0, u1] * fu * (1 - fv)
            + envmap[v1, u0] * (1 - fu) * fv
            + envmap[v1, u1] * fu * fv)


def gaussian_normals(scales_raw: torch.Tensor, rotations: torch.Tensor
                     ) -> torch.Tensor:
    """[N, 3] the rotation column of each Gaussian's smallest scale axis
    (the first one on a tie)."""
    rot = quat_to_rotmat(normalize_quat(rotations))        # [N, 3, 3]
    idx = torch.argmin(scales_raw, dim=-1)
    return torch.gather(rot, 2, idx[:, None, None].expand(-1, 3, 1))[:, :, 0]


def specular(envmap: torch.Tensor, means: torch.Tensor,
             scales_raw: torch.Tensor, rotations: torch.Tensor,
             camera_center: torch.Tensor) -> torch.Tensor:
    """[N, 3] env(reflect(view, normal)): the map at each Gaussian's
    reflection of the view direction about its normal."""
    view = means - camera_center
    # a safe normalise: no NaN in the gradient of a mean on the camera
    v2 = torch.sum(view * view, dim=-1, keepdim=True)
    view = view * torch.rsqrt(torch.clamp(v2, min=1e-16))
    n = gaussian_normals(scales_raw, rotations)
    # normals turned toward the camera
    n = n * torch.sign(-torch.sum(view * n, dim=-1, keepdim=True) + 1e-12)
    refl = view - 2.0 * torch.sum(view * n, dim=-1, keepdim=True) * n
    return sample_envmap(envmap, refl)


def glossy_rgbs(base_rgbs: torch.Tensor, metalness: torch.Tensor,
                envmap: torch.Tensor, means: torch.Tensor,
                scales_raw: torch.Tensor, rotations: torch.Tensor,
                camera_center: torch.Tensor,
                rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """rgb = clamp(albedo + m * env(reflect(view, normal)), 0, 1). With
    `rows` (indices), the specular term is looked up in those rows only
    and is 0 in the others, whose metalness must be 0 (dead rows): they
    would all sit on one texel, and the lookup's backward, which sums the
    rows of each texel by index, would add them one after another."""
    if rows is None:
        spec = specular(envmap, means, scales_raw, rotations, camera_center)
    else:
        spec = torch.zeros_like(base_rgbs).index_put(
            (rows,), specular(envmap, means[rows], scales_raw[rows],
                              rotations[rows], camera_center))
    return torch.clamp(base_rgbs + metalness[:, None] * spec, 0.0, 1.0)
