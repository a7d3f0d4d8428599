"""EWA splat projection: 3D Gaussians -> 2D screen-space splats.

Port of ``gsl_tpu/ops/projection.py``, elementwise over N like the JAX
version, with the same numeric conventions:
- low-pass filter: cov2d diag += filter_2d (0.3 default), opacity
  compensation = sqrt(det_orig / det_blurred)
- radius = ceil(3 * sqrt(max eigenvalue)), eigen clamp mid^2-det >= 0.1
- Jacobian input point clamped to 1.3 * tan(fov)
- min depth 0.01; culled gaussians get radius 0 / zeroed outputs
- means2d in pixel coordinates; the +0.5 pixel-center offset is applied at
  rasterization time.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .transforms import normalize_quat


class Projections(NamedTuple):
    """Per-Gaussian screen-space projection results (all [N, ...])."""

    means2d: torch.Tensor        # [N, 2] pixel coords
    depths: torch.Tensor         # [N] camera-space z
    radii: torch.Tensor          # [N] int32 pixel radius (0 = culled)
    conics: torch.Tensor         # [N, 3] inverse cov2d (a, b, c) packed
    compensations: torch.Tensor  # [N] AA opacity compensation
    mask: torch.Tensor           # [N] bool visibility
    depth_grads: Optional[torch.Tensor] = None
    """[N, 2] d(depth)/d(pixel): the E[z | xy] plane slope (StopThePop
    depth keys)"""


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    # intrinsics become float32 scalars, as make_camera makes them in JAX,
    # so every product below rounds in float32 on both sides
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def project_gaussians(
    means3d: torch.Tensor,       # [N, 3]
    scales: torch.Tensor,        # [N, 3] activated (positive)
    quats: torch.Tensor,         # [N, 4] wxyz (need not be normalized)
    viewmat: torch.Tensor,       # [4, 4] world-to-camera (column vectors)
    fx, fy, cx, cy,              # scalars
    img_width: int,
    img_height: int,
    scale_modifier: float = 1.0,
    filter_2d: float = 0.3,
    min_depth: float = 0.01,
) -> Projections:
    fx, fy, cx, cy = (_f32(v, means3d) for v in (fx, fy, cx, cy))
    R_wc = viewmat[:3, :3]
    t_wc = viewmat[:3, 3]

    p_cam = means3d @ R_wc.T + t_wc  # [N, 3]
    depths = p_cam[..., 2]
    depth_ok = depths >= min_depth
    z_safe = torch.where(depth_ok, depths, torch.ones_like(depths))

    q = normalize_quat(quats)
    w, x, y, zq = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + zq * zq)
    r01 = 2.0 * (x * y - w * zq)
    r02 = 2.0 * (x * zq + w * y)
    r10 = 2.0 * (x * y + w * zq)
    r11 = 1.0 - 2.0 * (x * x + zq * zq)
    r12 = 2.0 * (y * zq - w * x)
    r20 = 2.0 * (x * zq - w * y)
    r21 = 2.0 * (y * zq + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    s0 = scales[..., 0] * scale_modifier
    s1 = scales[..., 1] * scale_modifier
    s2 = scales[..., 2] * scale_modifier
    # M = R diag(s); Sigma = M M^T, 6 unique entries
    m00, m01, m02 = r00 * s0, r01 * s1, r02 * s2
    m10, m11, m12 = r10 * s0, r11 * s1, r12 * s2
    m20, m21, m22 = r20 * s0, r21 * s1, r22 * s2
    sig00 = m00 * m00 + m01 * m01 + m02 * m02
    sig01 = m00 * m10 + m01 * m11 + m02 * m12
    sig02 = m00 * m20 + m01 * m21 + m02 * m22
    sig11 = m10 * m10 + m11 * m11 + m12 * m12
    sig12 = m10 * m20 + m11 * m21 + m12 * m22
    sig22 = m20 * m20 + m21 * m21 + m22 * m22

    # EWA Jacobian with fov clamping
    tan_fovx = (0.5 * img_width) / fx
    tan_fovy = (0.5 * img_height) / fy
    z = z_safe
    inv_z = 1.0 / z_safe
    tx = torch.clamp(p_cam[..., 0] * inv_z, -1.3 * tan_fovx,
                     1.3 * tan_fovx) * z
    ty = torch.clamp(p_cam[..., 1] * inv_z, -1.3 * tan_fovy,
                     1.3 * tan_fovy) * z

    # T = J @ R_wc, J = [[fx/z, 0, -fx tx/z^2], [0, fy/z, -fy ty/z^2]]
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z * inv_z
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z * inv_z
    t00 = j00 * R_wc[0, 0] + j02 * R_wc[2, 0]
    t01 = j00 * R_wc[0, 1] + j02 * R_wc[2, 1]
    t02 = j00 * R_wc[0, 2] + j02 * R_wc[2, 2]
    t10 = j11 * R_wc[1, 0] + j12 * R_wc[2, 0]
    t11 = j11 * R_wc[1, 1] + j12 * R_wc[2, 1]
    t12 = j11 * R_wc[1, 2] + j12 * R_wc[2, 2]

    # cov2d = T Sigma T^T (2x2 symmetric -> 3 numbers)
    st00 = sig00 * t00 + sig01 * t01 + sig02 * t02
    st01 = sig01 * t00 + sig11 * t01 + sig12 * t02
    st02 = sig02 * t00 + sig12 * t01 + sig22 * t02
    su00 = sig00 * t10 + sig01 * t11 + sig02 * t12
    su01 = sig01 * t10 + sig11 * t11 + sig12 * t12
    su02 = sig02 * t10 + sig12 * t11 + sig22 * t12
    c00 = t00 * st00 + t01 * st01 + t02 * st02
    c01 = t10 * st00 + t11 * st01 + t12 * st02
    c11 = t10 * su00 + t11 * su01 + t12 * su02

    # depth-plane slope: E[z_cam | xy] is linear with slope
    # Sigma_{z,xy} Sigma_xy^{-1}
    cov_zx = (R_wc[2, 0] * st00 + R_wc[2, 1] * st01 + R_wc[2, 2] * st02)
    cov_zy = (R_wc[2, 0] * su00 + R_wc[2, 1] * su01 + R_wc[2, 2] * su02)

    det_orig = c00 * c11 - c01 * c01
    c00 = c00 + filter_2d
    c11 = c11 + filter_2d
    det = c00 * c11 - c01 * c01
    det_ok = det > 0.0
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    compensations = torch.sqrt(torch.clamp(det_orig / det_safe, min=1e-12))
    inv_det = torch.where(det_ok, 1.0 / det_safe, torch.zeros_like(det))
    conics = torch.stack([c11 * inv_det, -c01 * inv_det, c00 * inv_det],
                         dim=-1)

    means2d = torch.stack([
        fx * p_cam[..., 0] * inv_z + cx,
        fy * p_cam[..., 1] * inv_z + cy,
    ], dim=-1)

    # screen-space extent: 3 sigma of the max eigenvalue
    mid = 0.5 * (c00 + c11)
    sqrt_disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lam_max = mid + sqrt_disc
    radius = torch.ceil(3.0 * torch.sqrt(lam_max))

    inside = (
        (means2d[..., 0] + radius > 0.0)
        & (means2d[..., 0] - radius < img_width)
        & (means2d[..., 1] + radius > 0.0)
        & (means2d[..., 1] - radius < img_height)
    )
    mask = depth_ok & det_ok & inside

    zero = torch.zeros((), dtype=means3d.dtype, device=means3d.device)
    radii = torch.where(mask, radius, zero).to(torch.int32)
    kz_x = conics[..., 0] * cov_zx + conics[..., 1] * cov_zy
    kz_y = conics[..., 1] * cov_zx + conics[..., 2] * cov_zy
    depth_grads = torch.stack([kz_x, kz_y], dim=-1)
    m = mask[..., None]
    return Projections(
        means2d=torch.where(m, means2d, zero),
        depths=torch.where(mask, depths, zero),
        radii=radii,
        conics=torch.where(m, conics, zero),
        compensations=torch.where(mask, compensations, zero),
        mask=mask,
        depth_grads=torch.where(m, depth_grads, zero),
    )


def tile_rect(projections: Projections, tile_size: int,
              tiles_x: int, tiles_y: int):
    """Inclusive-min / exclusive-max touched-tile rectangle per Gaussian
    (radii == 0 -> empty rect), from the 3-sigma ellipse's per-axis AABB:
    max |dx| on {v^T Sigma^-1 v = 9} is 3 sqrt(Sigma_xx), and Sigma's
    diagonal is adj(conic) / det(conic). Coordinates truncate toward zero
    before clipping, as the JAX version's int32 cast does."""
    r = projections.radii.to(torch.float32)
    xy = projections.means2d
    ca = projections.conics[..., 0]
    cb = projections.conics[..., 1]
    cc = projections.conics[..., 2]
    det = torch.clamp(ca * cc - cb * cb, min=1e-12)
    rx = torch.minimum(
        torch.ceil(3.0 * torch.sqrt(torch.clamp(cc / det, min=0.0))), r)
    ry = torch.minimum(
        torch.ceil(3.0 * torch.sqrt(torch.clamp(ca / det, min=0.0))), r)

    rect_min_x = torch.clamp(
        ((xy[..., 0] - rx) / tile_size).to(torch.int32), 0, tiles_x)
    rect_min_y = torch.clamp(
        ((xy[..., 1] - ry) / tile_size).to(torch.int32), 0, tiles_y)
    rect_max_x = torch.clamp(
        ((xy[..., 0] + rx) / tile_size).to(torch.int32) + 1, 0, tiles_x)
    rect_max_y = torch.clamp(
        ((xy[..., 1] + ry) / tile_size).to(torch.int32) + 1, 0, tiles_y)
    empty = projections.radii <= 0
    rect_max_x = torch.where(empty, rect_min_x, rect_max_x)
    rect_max_y = torch.where(empty, rect_min_y, rect_max_y)
    return (torch.stack([rect_min_x, rect_min_y], dim=-1),
            torch.stack([rect_max_x, rect_max_y], dim=-1))
