"""Quaternion math for 3D Gaussians (wxyz quaternions).

Port of ``gsl_tpu/ops/transforms.py``: Sigma = R S S^T R^T with
S = diag(scales) (`build_cov3d`, which MCMC's position noise takes).
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
