"""Mip-Splatting: a per-Gaussian 3D smoothing filter and a 2D mip filter.

Port of ``gsl_tpu/models/mip_splatting.py``:

- filter_3d = (the smallest depth over the train cameras that see the
  Gaussian) / (the largest fx) * sqrt(0.2), recomputed every
  `filter_3d_update_interval` (100) steps; a Gaussian no camera sees takes
  the largest such depth among the alive Gaussians that are seen;
- a camera sees a Gaussian when its depth exceeds 0.01 and its projection,
  taken about (width / 2, height / 2), lies within 15% of the image beyond
  each edge;
- effective scales = sqrt(s^2 + f^2); opacity *= sqrt(prod s^2 / prod
  (s^2 + f^2)) (3D opacity compensation);
- the renderer's 2D low-pass kernel shrinks from 0.3 to 0.1
  (``renderers/mip_splatting_renderer.py``).

filter_3d lives in ``GaussianState.extra["filter_3d"]``, [CAP, 1].
"""
from __future__ import annotations

import dataclasses

import torch

from ..data.cameras import Cameras
from .gaussian import VanillaGaussianConfig

_BIG = 1e5          # the distance of a Gaussian no camera has seen yet


@dataclasses.dataclass
class MipSplattingConfig(VanillaGaussianConfig):
    filter_3d_update_interval: int = 100
    opacity_compensation: bool = True


@torch.no_grad()
def compute_3d_filter(means: torch.Tensor, alive: torch.Tensor,
                      cameras: Cameras) -> torch.Tensor:
    """means [CAP, 3], alive [CAP], `cameras` a batch of M. Returns
    filter_3d [CAP, 1] on the means' device; one pass over the Gaussians
    per camera."""
    cams = cameras.to(means.device)
    n = means.shape[0]
    min_dist = torch.full((n,), _BIG, dtype=torch.float32,
                          device=means.device)
    any_valid = torch.zeros(n, dtype=torch.bool, device=means.device)
    for i in range(len(cams)):
        R, T = cams.R[i], cams.T[i]
        # p_cam = means @ R^T + T, summed elementwise (no TF32 on the card)
        p_cam = (means[:, None, :] * R[None, :, :]).sum(-1) + T
        z = torch.clamp(p_cam[:, 2], min=1e-3)
        w = cams.width[i].to(torch.float32)
        h = cams.height[i].to(torch.float32)
        x = p_cam[:, 0] / z * cams.fx[i] + w / 2.0
        y = p_cam[:, 1] / z * cams.fy[i] + h / 2.0
        in_screen = ((x >= -0.15 * w) & (x <= 1.15 * w)
                     & (y >= -0.15 * h) & (y <= 1.15 * h))
        valid = (p_cam[:, 2] > 0.01) & in_screen
        min_dist = torch.where(valid, torch.minimum(min_dist, z), min_dist)
        any_valid = any_valid | valid
    max_focal = cams.fx.max()

    # a Gaussian no camera sees takes the largest distance among the seen
    max_visible = torch.where(any_valid & alive, min_dist,
                              torch.zeros_like(min_dist)).max()
    min_dist = torch.where(any_valid, min_dist, max_visible)
    filter_3d = min_dist / torch.clamp(max_focal, min=1e-6) * (0.2 ** 0.5)
    return filter_3d[:, None]


def apply_3d_filter(scales: torch.Tensor, opacities: torch.Tensor,
                    filter_3d: torch.Tensor,
                    opacity_compensation: bool = True):
    """scales [CAP, 3] and opacities [CAP] ACTIVATED; returns
    (new_opacities, new_scales). Differentiable in both, so a scale's
    gradient flows through the covariance and through the opacity."""
    s2 = scales * scales
    s2f = s2 + filter_3d * filter_3d
    new_scales = torch.sqrt(s2f)
    if opacity_compensation:
        coef = torch.sqrt(torch.prod(s2, dim=-1) / torch.prod(s2f, dim=-1))
        opacities = opacities * coef
    return opacities, new_scales
