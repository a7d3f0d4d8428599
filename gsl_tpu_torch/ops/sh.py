"""Spherical-harmonics color evaluation, real SH bands 0..3.

Port of ``gsl_tpu/ops/sh.py``: RGB = sum_k basis_k(dir) * sh_k and the
DC <-> RGB conversion RGB2SH(rgb) = (rgb - 0.5) / C0.
"""
from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2


def rgb_to_sh0(rgb: torch.Tensor) -> torch.Tensor:
    """RGB in [0,1] -> SH DC coefficient."""
    return (rgb - 0.5) / C0


def sh0_to_rgb(sh0: torch.Tensor) -> torch.Tensor:
    return sh0 * C0 + 0.5


def sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH basis values [..., (degree+1)^2] for unit directions
    [..., 3], in the order of the coefficients, in the dtype of `dirs`."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, C0)]
    if degree >= 1:
        out += [-C1 * y, C1 * z, -C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
                C2[3] * xz, C2[4] * (xx - yy)]
    if degree >= 3:
        out += [
            C3[0] * y * (3.0 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4.0 * zz - xx - yy),
            C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            C3[4] * x * (4.0 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(out, dim=-1)


def sh_to_rgb(shs: torch.Tensor, dirs: torch.Tensor, degree: int,
              normalize_dirs: bool = True) -> torch.Tensor:
    """Evaluate SH color. shs [..., K, 3] with K >= (degree+1)^2,
    dirs [..., 3] (view dirs, gaussian_center - camera_center).

    Returns raw SH color [..., 3]; callers add 0.5 and clamp. The terms are
    summed in the same order as the JAX version so both round alike.
    """
    if normalize_dirs:
        dirs = dirs / torch.clamp(
            torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)
    x = dirs[..., 0:1]
    y = dirs[..., 1:2]
    z = dirs[..., 2:3]

    def sh(k):
        return shs[..., k, :]

    acc = C0 * sh(0)
    if degree >= 1:
        acc = acc + (C1 * z) * sh(2) - (C1 * y) * sh(1) - (C1 * x) * sh(3)
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        acc = (acc
               + (C2[0] * (x * y)) * sh(4)
               + (C2[1] * (y * z)) * sh(5)
               + (C2[2] * (2.0 * zz - xx - yy)) * sh(6)
               + (C2[3] * (x * z)) * sh(7)
               + (C2[4] * (xx - yy)) * sh(8))
    if degree >= 3:
        acc = (acc
               + (C3[0] * y * (3.0 * xx - yy)) * sh(9)
               + (C3[1] * (x * y) * z) * sh(10)
               + (C3[2] * y * (4.0 * zz - xx - yy)) * sh(11)
               + (C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy)) * sh(12)
               + (C3[4] * x * (4.0 * zz - xx - yy)) * sh(13)
               + (C3[5] * z * (xx - yy)) * sh(14)
               + (C3[6] * x * (xx - 3.0 * yy)) * sh(15))
    return acc
