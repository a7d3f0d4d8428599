"""Quaternion math for 3D Gaussians (wxyz quaternions).

Port of ``gsl_tpu/ops/transforms.py``: Sigma = R S S^T R^T with
S = diag(scales) (`build_cov3d`, which MCMC's position noise takes), and
world normals from an expected-depth map (`depth_to_normal`, which the
normal regulariser takes).
"""
from __future__ import annotations

import torch


def normalize_quat(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternions [..., 4] (wxyz)."""
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion [..., 4] -> rotation matrix [..., 3, 3].

    Assumes input is already normalized (call normalize_quat first).
    """
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack([
        torch.stack([r00, r01, r02], dim=-1),
        torch.stack([r10, r11, r12], dim=-1),
        torch.stack([r20, r21, r22], dim=-1),
    ], dim=-2)


def build_cov3d(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """3D covariance Sigma = (R S)(R S)^T.

    scales: activated (positive) scales [..., 3]; quats: normalized wxyz
    [..., 4]. Returns [..., 3, 3].
    """
    M = quat_to_rotmat(quats) * scales[..., None, :]  # R @ diag(s)
    # summed elementwise: a batched matmul could take TF32 on the card
    return (M[..., :, None, :] * M[..., None, :, :]).sum(-1)


def depth_to_normal(depth: torch.Tensor, world_to_camera: torch.Tensor,
                    fx, fy, cx, cy) -> torch.Tensor:
    """World-space normals from an expected-depth map [H, W]: each pixel
    unprojected to a camera-space point, rotated to world, and the
    normalised cross product of central differences. The one-pixel
    border is zero. `world_to_camera` [4, 4] maps p_world to
    p_cam = R p_world + t. Returns [H, W, 3]."""
    H, W = depth.shape
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=depth.dtype, device=depth.device),
        torch.arange(W, dtype=depth.dtype, device=depth.device),
        indexing="ij")
    x = (xs + 0.5 - cx) / fx * depth
    y = (ys + 0.5 - cy) / fy * depth
    pts_cam = torch.stack([x, y, depth], dim=-1)
    # rotate to world: R^T p_cam, as rows p_cam R; summed elementwise, as a
    # matmul could take TF32 on the card
    R = world_to_camera[:3, :3]
    pts = (pts_cam[..., :, None] * R).sum(-2)
    dx = pts[2:, 1:-1] - pts[:-2, 1:-1]
    dy = pts[1:-1, 2:] - pts[1:-1, :-2]
    n = torch.linalg.cross(dx, dy, dim=-1)
    # rsqrt(max(n.n, eps)) has a finite gradient where dx = dy = 0
    n2 = torch.sum(n * n, dim=-1, keepdim=True)
    n = n * torch.rsqrt(torch.clamp(n2, min=1e-18))
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))
