"""2DGS surfel projection.

Port of ``gsl_tpu/ops/surfel.py``: each primitive is a 2D disk in 3D. The
projection hands the rasterizer (``ops/surfel_rasterize.py``) the three
homogeneous pixel-space rows Tu, Tv, Tw of the disk's local frame, from
which it solves the perspective-correct ray-splat intersection per pixel,
and composites

- rgb plus any constant per-splat channels (view-space normals),
- alpha, expected depth (sum w * depth at the intersection),
- median depth (the depth where transmittance first drops to 0.5),
- depth distortion (sum_i w_i sum_{j<i} w_j (m_i - m_j)^2 with the
  NDC-mapped depth m, near 0.2 / far 100).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .projection import _f32
from .transforms import normalize_quat, quat_to_rotmat

MAX_ALPHA_2D = 0.99          # the surfel rasterizer clamps at 0.99, not 0.999
FILTER_INV_SQUARE = 2.0      # 2D screen-space low-pass: rho2d = 2 * d^2
NEAR_2D = 0.2
FAR_2D = 100.0
CUTOFF_SQ = 9.0              # 3 sigma


class SurfelProjections(NamedTuple):
    Tu: torch.Tensor        # [N, 3] homogeneous pixel-space u-axis
    Tv: torch.Tensor        # [N, 3]
    Tw: torch.Tensor        # [N, 3] (center)
    zcoef: torch.Tensor     # [N, 3] camera z = z0 + u*zu + v*zv -> (zu, zv, z0)
    normals: torch.Tensor   # [N, 3] view-space, facing the camera
    means2d: torch.Tensor   # [N, 2] projected center (pixels)
    depths: torch.Tensor    # [N] center camera z (sort key)
    radii: torch.Tensor     # [N] int32
    mask: torch.Tensor      # [N] bool


def project_surfels(means3d, scales2d, quats, viewmat, fx, fy, cx, cy,
                    img_width: int, img_height: int,
                    scale_modifier: float = 1.0) -> SurfelProjections:
    """scales2d [N, 2] activated; quats wxyz."""
    fx, fy, cx, cy = (_f32(v, means3d) for v in (fx, fy, cx, cy))
    R_wc = viewmat[:3, :3]
    t_wc = viewmat[:3, 3]
    p_cam = means3d @ R_wc.T + t_wc

    Rg = quat_to_rotmat(normalize_quat(quats))            # [N, 3, 3]
    R_cam = torch.einsum("ij,njk->nik", R_wc, Rg)         # into the camera
    au = R_cam[:, :, 0] * (scales2d[:, 0:1] * scale_modifier)   # [N, 3]
    av = R_cam[:, :, 1] * (scales2d[:, 1:2] * scale_modifier)
    n_view = R_cam[:, :, 2]
    flip = -torch.sign(torch.sum(p_cam * n_view, dim=-1, keepdim=True))
    normals = n_view * torch.where(flip == 0.0, torch.ones_like(flip), flip)

    # homogeneous pixel projection: (X, Y, W) = A @ q, pix = (X/W, Y/W)
    def proj(q):
        return torch.stack([fx * q[:, 0] + cx * q[:, 2],
                            fy * q[:, 1] + cy * q[:, 2],
                            q[:, 2]], dim=-1)

    Tu, Tv, Tw = proj(au), proj(av), proj(p_cam)
    zcoef = torch.stack([au[:, 2], av[:, 2], p_cam[:, 2]], dim=-1)

    wz = torch.where(Tw[:, 2] == 0, torch.ones_like(Tw[:, 2]), Tw[:, 2])
    center = torch.stack([Tw[:, 0] / wz, Tw[:, 1] / wz], dim=-1)

    # conic-bound AABB with t = (9, 9, -1) (2DGS compute_aabb). It only
    # feeds the integer radius and the mask, so it is taken off the graph:
    # ceil hands sqrt a zero cotangent, and 0 / sqrt(0) would be NaN
    t = torch.tensor([CUTOFF_SQ, CUTOFF_SQ, -1.0], dtype=torch.float32,
                     device=means3d.device)
    M = torch.stack([Tu, Tv, Tw], dim=1).detach()  # [N, 3 (row uvw), 3 (xyw)]
    d = (t * (M[:, :, 2] * M[:, :, 2])).sum(-1)
    d_safe = torch.where(d.abs() < 1e-12, torch.ones_like(d), d)
    f = t[None, :] / d_safe[:, None]               # [N, 3]
    cx_b = (f * (M[:, :, 0] * M[:, :, 2])).sum(-1)
    cy_b = (f * (M[:, :, 1] * M[:, :, 2])).sum(-1)
    hx = torch.sqrt(torch.clamp(
        cx_b * cx_b - (f * (M[:, :, 0] * M[:, :, 0])).sum(-1), min=0.0))
    hy = torch.sqrt(torch.clamp(
        cy_b * cy_b - (f * (M[:, :, 1] * M[:, :, 1])).sum(-1), min=0.0))
    # low-pass filter footprint: 3 sigma of sigma^2 = 1 / FILTER_INV_SQUARE
    filter_r = 3.0 * math.sqrt(1.0 / FILTER_INV_SQUARE)
    radius = torch.ceil(torch.clamp(torch.maximum(hx, hy), min=filter_r))

    depth_ok = p_cam[:, 2] > NEAR_2D
    c = center.detach()
    inside = ((c[:, 0] + radius > 0) & (c[:, 0] - radius < img_width)
              & (c[:, 1] + radius > 0) & (c[:, 1] - radius < img_height))
    mask = depth_ok & (d.abs() >= 1e-12) & inside
    zero = torch.zeros((), dtype=torch.float32, device=means3d.device)
    m = mask[:, None]

    return SurfelProjections(
        Tu=torch.where(m, Tu, zero),
        Tv=torch.where(m, Tv, zero),
        Tw=torch.where(m, Tw, zero),
        zcoef=torch.where(m, zcoef, zero),
        normals=torch.where(m, normals, zero),
        means2d=torch.where(m, center, zero),
        depths=torch.where(mask, p_cam[:, 2], zero),
        radii=torch.where(mask, radius, zero).to(torch.int32),
        mask=mask,
    )


def _map_depth(d):
    """NDC-ish depth mapping of the distortion loss."""
    return (FAR_2D * (d - NEAR_2D)) / ((FAR_2D - NEAR_2D)
                                       * torch.clamp(d, min=1e-6))


class SurfelRenderResult(NamedTuple):
    channels: torch.Tensor      # [H, W, C] rgb + constant channels, without
                                # background
    alpha: torch.Tensor         # [H, W]
    exp_depth: torch.Tensor     # [H, W] sum w * depth (unnormalized)
    median_depth: torch.Tensor  # [H, W] (carries no gradient)
    distortion: torch.Tensor    # [H, W]
