"""Spherical-harmonics color evaluation, real SH bands 0..3.

Port of ``gsl_tpu/ops/sh.py``: RGB = sum_k basis_k(dir) * sh_k and the
DC <-> RGB conversion RGB2SH(rgb) = (rgb - 0.5) / C0.

``sh_colors`` is the renderer's colour pass, clamp(SH(dir) + 0.5, min=0),
as a pair of CUDA kernels (``csrc/sh_fwd.cu``, ``csrc/sh_bwd.cu``) behind
one autograd function. Each wrapper launches its kernel for CUDA tensors,
or raises, and runs its plain PyTorch version (``sh_colors_fwd_plain``,
``sh_colors_bwd_plain``) for CPU tensors; ``<wrapper>.launches`` counts
the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.tracing import span
from . import cuda_build
from .cuda_build import check_cuda, kernel_attributes, ptr, stream

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


def _sh_terms(dirs: torch.Tensor, degree: int):
    """[(k, f_k)] in the order `sh_to_rgb` adds the terms f_k * sh_k, for
    unit directions [..., 3]: f_0 is the Python float C0, the others
    [..., 1]. The sum subtracts the terms of coefficients 1 and 3, so their
    sign is folded into f (-(a) * s is -(a * s) exactly)."""
    x = dirs[..., 0:1]
    y = dirs[..., 1:2]
    z = dirs[..., 2:3]
    terms = [(0, C0)]
    if degree >= 1:
        terms += [(2, C1 * z), (1, -(C1 * y)), (3, -(C1 * x))]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        terms += [(4, C2[0] * (x * y)),
                  (5, C2[1] * (y * z)),
                  (6, C2[2] * (2.0 * zz - xx - yy)),
                  (7, C2[3] * (x * z)),
                  (8, C2[4] * (xx - yy))]
    if degree >= 3:
        terms += [(9, C3[0] * y * (3.0 * xx - yy)),
                  (10, C3[1] * (x * y) * z),
                  (11, C3[2] * y * (4.0 * zz - xx - yy)),
                  (12, C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy)),
                  (13, C3[4] * x * (4.0 * zz - xx - yy)),
                  (14, C3[5] * z * (xx - yy)),
                  (15, C3[6] * x * (xx - 3.0 * yy))]
    return terms


def _unit(dirs: torch.Tensor) -> torch.Tensor:
    return dirs / torch.clamp(
        torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)


def sh_to_rgb(shs: torch.Tensor, dirs: torch.Tensor,
              degree: int) -> torch.Tensor:
    """Evaluate SH color. shs [..., K, 3] with K >= (degree+1)^2,
    dirs [..., 3] (view dirs, gaussian_center - camera_center).

    Returns raw SH color [..., 3]; callers add 0.5 and clamp. The terms are
    summed in the same order as the JAX version so both round alike.
    """
    terms = _sh_terms(_unit(dirs), degree)
    acc = terms[0][1] * shs[..., terms[0][0], :]
    for k, f in terms[1:]:
        acc = acc + f * shs[..., k, :]
    return acc


_CHANNEL_BITS = (1, 2, 4)  # the clamp mask's bit of channel 0, 1, 2


def _check_degree(what, degree: int, n_rest: int):
    if not 0 <= degree <= 3 or num_sh_bases(degree) > 1 + n_rest:
        raise ValueError(f"{what}: degree {degree} needs 0..3 and "
                         f"{num_sh_bases(degree)} coefficients; there are "
                         f"{1 + n_rest}")


def _check_float32(what, *tensors):
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{what}: tensors must be float32")


def _fwd_lib():
    lib = cuda_build.load("sh_fwd")
    lib.gsl_sh_fwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                               + [ctypes.c_int64] + [ctypes.c_void_p] * 3)
    lib.gsl_sh_fwd.restype = ctypes.c_int
    lib.gsl_sh_fwd_attributes.argtypes = [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p]
    lib.gsl_sh_fwd_attributes.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = cuda_build.load("sh_bwd")
    lib.gsl_sh_bwd.argtypes = (
        [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 2 + [ctypes.c_int64] + [ctypes.c_void_p] * 3)
    lib.gsl_sh_bwd.restype = ctypes.c_int
    lib.gsl_sh_bwd_attributes.argtypes = [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p]
    lib.gsl_sh_bwd_attributes.restype = ctypes.c_int
    return lib


def sh_colors_fwd_attributes(degree: int = 3, n_rest: int = 15):
    """`kernel_attributes` of the SH forward kernel."""
    return kernel_attributes(_fwd_lib(), "gsl_sh_fwd_attributes", degree,
                             n_rest)


def sh_colors_bwd_attributes(degree: int = 3, n_rest: int = 15):
    """`kernel_attributes` of the SH backward kernel."""
    return kernel_attributes(_bwd_lib(), "gsl_sh_bwd_attributes", degree,
                             n_rest)


def sh_colors_fwd_plain(means, camera_center, shs_dc, shs_rest, degree: int):
    """`sh_colors_fwd` in plain PyTorch: `sh_to_rgb` over the concatenated
    coefficients, plus 0.5, clamped at 0."""
    raw = sh_to_rgb(torch.cat([shs_dc, shs_rest], dim=1),
                    means - camera_center, degree) + 0.5
    passed = (raw >= 0.0).to(torch.uint8)
    mask = passed[:, 0] | (passed[:, 1] << 1) | (passed[:, 2] << 2)
    return torch.clamp(raw, min=0.0), mask


def sh_colors_fwd(means, camera_center, shs_dc, shs_rest, degree: int):
    """Colours [N, 3] = clamp(SH(dir) + 0.5, min=0) of the coefficients
    shs_dc [N, 1, 3] and shs_rest [N, K - 1, 3] up to band `degree`, dir
    the unit vector from camera_center [3] to means [N, 3]; and the
    clamp's mask [N] uint8 (bit c: channel c's gradient passes, SH + 0.5
    >= 0). The kernel on CUDA tensors (all float32 and contiguous),
    `sh_colors_fwd_plain` on CPU tensors."""
    n = means.shape[0]
    if (means.shape != (n, 3) or shs_dc.shape != (n, 1, 3)
            or shs_rest.dim() != 3 or shs_rest.shape[0] != n
            or shs_rest.shape[2] != 3 or camera_center.numel() != 3):
        raise ValueError("sh_colors_fwd: means must be [N, 3], shs_dc "
                         "[N, 1, 3], shs_rest [N, K - 1, 3] and "
                         "camera_center [3]")
    _check_degree("sh_colors_fwd", degree, shs_rest.shape[1])
    if not means.is_cuda:
        return sh_colors_fwd_plain(means, camera_center, shs_dc, shs_rest,
                                   degree)
    _check_float32("sh_colors_fwd", means, camera_center, shs_dc, shs_rest)
    dev = check_cuda("sh_colors_fwd", means, camera_center, shs_dc,
                      shs_rest)
    rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)
    mask = torch.empty(n, dtype=torch.uint8, device=dev)
    lib = _fwd_lib()
    code = lib.gsl_sh_fwd(
        ptr(means), ptr(camera_center), ptr(shs_dc), ptr(shs_rest),
        shs_rest.shape[1], degree, n, ptr(rgb), ptr(mask), stream(dev))
    cuda_build.check(lib, code, "sh_fwd")
    if n:
        sh_colors_fwd.launches += 1
    return rgb, mask


sh_colors_fwd.launches = 0


def sh_colors_bwd_plain(grad_rgb, means, camera_center, mask, degree: int,
                        n_rest: int):
    """`sh_colors_bwd` in plain PyTorch: the clamp's gradient where its
    mask bit is set, times each coefficient's factor in `sh_to_rgb`'s sum
    (the same products autograd forms through it); zeros above the
    degree."""
    n = means.shape[0]
    bits = torch.tensor(_CHANNEL_BITS, dtype=torch.uint8, device=mask.device)
    passed = (mask[:, None] & bits) != 0
    g = torch.where(passed, grad_rgb, torch.zeros((), dtype=grad_rgb.dtype,
                                                   device=grad_rgb.device))
    terms = _sh_terms(_unit(means - camera_center), degree)
    g_rest = g.new_zeros((n, n_rest, 3))
    for k, f in terms[1:]:
        g_rest[:, k - 1] = g * f
    return (g * terms[0][1])[:, None, :], g_rest


def sh_colors_bwd(grad_rgb, means, camera_center, mask, degree: int,
                  n_rest: int):
    """(grad shs_dc [N, 1, 3], grad shs_rest [N, n_rest, 3]) of
    `sh_colors_fwd` from grad_rgb [N, 3] and its mask. The kernel on CUDA
    tensors, `sh_colors_bwd_plain` on CPU tensors. On the card grad_rgb's
    rows may lie any stride >= 3 apart (the channel columns of a wider
    gradient), each row's three values adjacent; the other tensors are
    contiguous."""
    n = means.shape[0]
    if (means.shape != (n, 3) or grad_rgb.shape != (n, 3)
            or mask.shape != (n,) or camera_center.numel() != 3):
        raise ValueError("sh_colors_bwd: grad_rgb and means must be [N, 3], "
                         "the mask [N] and camera_center [3]")
    _check_degree("sh_colors_bwd", degree, n_rest)
    if not means.is_cuda:
        return sh_colors_bwd_plain(grad_rgb, means, camera_center, mask,
                                   degree, n_rest)
    _check_float32("sh_colors_bwd", grad_rgb, means, camera_center)
    if mask.dtype != torch.uint8:
        raise TypeError("sh_colors_bwd: the mask must be uint8")
    dev = check_cuda("sh_colors_bwd", means, camera_center, mask)
    if (grad_rgb.device != dev or grad_rgb.stride(1) != 1
            or grad_rgb.stride(0) < 3):
        raise ValueError(f"sh_colors_bwd: grad_rgb must be on {dev}, each "
                         "row's 3 values adjacent")
    g_dc = torch.empty((n, 1, 3), dtype=torch.float32, device=dev)
    g_rest = torch.empty((n, n_rest, 3), dtype=torch.float32, device=dev)
    lib = _bwd_lib()
    code = lib.gsl_sh_bwd(
        ptr(grad_rgb), grad_rgb.stride(0), ptr(means), ptr(camera_center),
        ptr(mask), n_rest, degree, n, ptr(g_dc), ptr(g_rest),
        stream(dev))
    cuda_build.check(lib, code, "sh_bwd")
    if n:
        sh_colors_bwd.launches += 1
    return g_dc, g_rest


sh_colors_bwd.launches = 0


class _SHColors(torch.autograd.Function):
    """`sh_colors_fwd`'s colours; the backward is `sh_colors_bwd`, on
    autograd's own thread where the tensors are on the card. Saved: the
    means, the centre and the one-byte mask a row."""

    @staticmethod
    def forward(ctx, means, camera_center, shs_dc, shs_rest, degree):
        rgb, mask = sh_colors_fwd(means, camera_center, shs_dc, shs_rest,
                                  degree)
        ctx.save_for_backward(means, camera_center, mask)
        ctx.degree = degree
        ctx.n_rest = shs_rest.shape[1]
        return rgb

    @staticmethod
    def backward(ctx, grad_rgb):
        means, camera_center, mask = ctx.saved_tensors
        if grad_rgb.stride(1) != 1 or grad_rgb.stride(0) < 3:
            grad_rgb = grad_rgb.contiguous()  # e.g. an expanded gradient
        with span("sh.backward"):
            g_dc, g_rest = sh_colors_bwd(grad_rgb, means, camera_center,
                                         mask, ctx.degree, ctx.n_rest)
        return None, None, g_dc, g_rest, None


def sh_colors(means, camera_center, shs_dc, shs_rest,
              degree: int) -> torch.Tensor:
    """Colours [N, 3] = clamp(SH(dir) + 0.5, min=0) up to band `degree`,
    dir the unit vector from camera_center [3] to means [N, 3] (both
    detached: no gradient reaches them), differentiable in shs_dc
    [N, 1, 3] and shs_rest [N, K - 1, 3]. The SH kernels on the card, their
    plain versions on the CPU."""
    return _SHColors.apply(means.detach(), camera_center.detach(), shs_dc,
                           shs_rest, degree)
