"""Plain PyTorch 3DGS: render, loss, gradient and Adam, in float32.

The benchmark's own reference for what `correct` compares. It follows
3D Gaussian Splatting (Kerbl et al. 2023) as the port states it: EWA
projection with a 0.3-pixel low-pass filter and anti-aliasing
compensation, real SH bands 0-3, tile compositing (``raster.py``, or
StopThePop's per-pixel window resort, ``stp.py``), a background blend,
L1 + 0.2 (1 - SSIM) with an 11x11 Gaussian window, and per-property Adam
(b1 0.9, b2 0.999, eps 1e-15) with the means' rate decayed from 1.6e-4 to
1.6e-6 times the camera extent over 30,000 steps. It imports nothing of
the program and takes nothing the program made: the benchmark hands it
the same generated scene, cameras and targets.

`precision="tf32"` computes the matrix products and convolutions on
operands rounded to TF32 (10 mantissa bits, to nearest even), as a card's
tensor cores take them: the control that `correct` has to reject.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import raster, stp

FIELDS = ("means", "scales", "rotations", "opacities", "shs_dc", "shs_rest")
B1, B2 = 0.9, 0.999
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    """a @ b on TF32 operands, its gradient's products too."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = tf32(a), tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        return g @ b.T, a.T @ g


class _Tf32Conv(torch.autograd.Function):
    """A depthwise convolution on TF32 operands, its input gradient too
    (the window takes no gradient)."""

    @staticmethod
    def forward(ctx, x, w, padding, groups):
        x, w = tf32(x), tf32(w)
        ctx.save_for_backward(w)
        ctx.shape, ctx.padding, ctx.groups = x.shape, padding, groups
        return F.conv2d(x, w, padding=padding, groups=groups)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        gx = torch.nn.grad.conv2d_input(ctx.shape, w, tf32(g),
                                        padding=ctx.padding,
                                        groups=ctx.groups)
        return gx, None, None, None


class Precision:
    def __init__(self, name: str = "float32"):
        if name not in ("float32", "tf32"):
            raise ValueError(f"precision {name!r}")
        self.low = name == "tf32"

    def matmul(self, a, b):
        return _Tf32Matmul.apply(a, b) if self.low else a @ b

    def conv2d(self, x, w, padding, groups):
        if self.low:
            return _Tf32Conv.apply(x, w, padding, groups)
        return F.conv2d(x, w, padding=padding, groups=groups)


def camera(R, T, fx, fy, cx, cy, width, height, device):
    """One camera as a dict of float32 tensors; p_cam = R p + T."""
    R = torch.as_tensor(np.asarray(R, np.float32), device=device)
    T = torch.as_tensor(np.asarray(T, np.float32), device=device)
    f32 = [torch.tensor(float(v), dtype=torch.float32, device=device)
           for v in (fx, fy, cx, cy)]
    return dict(R=R, T=T, fx=f32[0], fy=f32[1], cx=f32[2], cy=f32[3],
                width=int(width), height=int(height))


def camera_centre(cam, prec: Precision):
    return -prec.matmul(cam["R"].T, cam["T"])


def normalize_quat(q, eps=1e-12):
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=eps)


def project(means3d, scales, quats, cam, prec: Precision, filter_2d=0.3,
            min_depth=0.01):
    """EWA projection -> dict of means2d, depths, radii, conics,
    compensations, depth_grads (zero where culled)."""
    W, H = cam["width"], cam["height"]
    fx, fy, cx, cy = cam["fx"], cam["fy"], cam["cx"], cam["cy"]
    R_wc, t_wc = cam["R"], cam["T"]
    p_cam = prec.matmul(means3d, R_wc.T) + t_wc
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
    s0, s1, s2 = scales[..., 0], scales[..., 1], scales[..., 2]
    m00, m01, m02 = r00 * s0, r01 * s1, r02 * s2
    m10, m11, m12 = r10 * s0, r11 * s1, r12 * s2
    m20, m21, m22 = r20 * s0, r21 * s1, r22 * s2
    sig00 = m00 * m00 + m01 * m01 + m02 * m02
    sig01 = m00 * m10 + m01 * m11 + m02 * m12
    sig02 = m00 * m20 + m01 * m21 + m02 * m22
    sig11 = m10 * m10 + m11 * m11 + m12 * m12
    sig12 = m10 * m20 + m11 * m21 + m12 * m22
    sig22 = m20 * m20 + m21 * m21 + m22 * m22
    tan_fovx = (0.5 * W) / fx
    tan_fovy = (0.5 * H) / fy
    z = z_safe
    inv_z = 1.0 / z_safe
    tx = torch.clamp(p_cam[..., 0] * inv_z, -1.3 * tan_fovx,
                     1.3 * tan_fovx) * z
    ty = torch.clamp(p_cam[..., 1] * inv_z, -1.3 * tan_fovy,
                     1.3 * tan_fovy) * z
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
    st00 = sig00 * t00 + sig01 * t01 + sig02 * t02
    st01 = sig01 * t00 + sig11 * t01 + sig12 * t02
    st02 = sig02 * t00 + sig12 * t01 + sig22 * t02
    su00 = sig00 * t10 + sig01 * t11 + sig02 * t12
    su01 = sig01 * t10 + sig11 * t11 + sig12 * t12
    su02 = sig02 * t10 + sig12 * t11 + sig22 * t12
    c00 = t00 * st00 + t01 * st01 + t02 * st02
    c01 = t10 * st00 + t11 * st01 + t12 * st02
    c11 = t10 * su00 + t11 * su01 + t12 * su02
    cov_zx = R_wc[2, 0] * st00 + R_wc[2, 1] * st01 + R_wc[2, 2] * st02
    cov_zy = R_wc[2, 0] * su00 + R_wc[2, 1] * su01 + R_wc[2, 2] * su02
    det_orig = c00 * c11 - c01 * c01
    c00 = c00 + filter_2d
    c11 = c11 + filter_2d
    det = c00 * c11 - c01 * c01
    det_ok = det > 0.0
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    comp = torch.sqrt(torch.clamp(det_orig / det_safe, min=1e-12))
    inv_det = torch.where(det_ok, 1.0 / det_safe, torch.zeros_like(det))
    conics = torch.stack([c11 * inv_det, -c01 * inv_det, c00 * inv_det], -1)
    means2d = torch.stack([fx * p_cam[..., 0] * inv_z + cx,
                           fy * p_cam[..., 1] * inv_z + cy], -1)
    mid = 0.5 * (c00 + c11)
    sqrt_disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(mid + sqrt_disc))
    inside = ((means2d[..., 0] + radius > 0.0)
              & (means2d[..., 0] - radius < W)
              & (means2d[..., 1] + radius > 0.0)
              & (means2d[..., 1] - radius < H))
    mask = depth_ok & det_ok & inside
    zero = torch.zeros((), dtype=means3d.dtype, device=means3d.device)
    kz_x = conics[..., 0] * cov_zx + conics[..., 1] * cov_zy
    kz_y = conics[..., 1] * cov_zx + conics[..., 2] * cov_zy
    m = mask[..., None]
    return dict(
        means2d=torch.where(m, means2d, zero),
        depths=torch.where(mask, depths, zero),
        radii=torch.where(mask, radius, zero).to(torch.int32),
        conics=torch.where(m, conics, zero),
        compensations=torch.where(mask, comp, zero),
        depth_grads=torch.where(m, torch.stack([kz_x, kz_y], -1), zero))


def sh_colour(shs, dirs, degree: int = 3):
    """Raw SH colour [N, 3], terms summed in the port's order."""
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                              min=1e-12)
    x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]

    def sh(k):
        return shs[..., k, :]

    acc = SH_C0 * sh(0)
    if degree >= 1:
        acc = (acc + (SH_C1 * z) * sh(2) - (SH_C1 * y) * sh(1)
               - (SH_C1 * x) * sh(3))
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        acc = (acc + (SH_C2[0] * (x * y)) * sh(4)
               + (SH_C2[1] * (y * z)) * sh(5)
               + (SH_C2[2] * (2.0 * zz - xx - yy)) * sh(6)
               + (SH_C2[3] * (x * z)) * sh(7)
               + (SH_C2[4] * (xx - yy)) * sh(8))
    if degree >= 3:
        acc = (acc + (SH_C3[0] * y * (3.0 * xx - yy)) * sh(9)
               + (SH_C3[1] * (x * y) * z) * sh(10)
               + (SH_C3[2] * y * (4.0 * zz - xx - yy)) * sh(11)
               + (SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy)) * sh(12)
               + (SH_C3[4] * x * (4.0 * zz - xx - yy)) * sh(13)
               + (SH_C3[5] * z * (xx - yy)) * sh(14)
               + (SH_C3[6] * x * (xx - 3.0 * yy)) * sh(15))
    return acc


class _Raster(torch.autograd.Function):
    """Plain compositing with its written-out gradient; differentiable in
    means2d, conics, opacities and colours."""

    @staticmethod
    def forward(ctx, means2d, conics, opacities, colours, depths,
                depth_grads, radii, H, W, tile, stp_resort):
        tiles_x, tiles_y = raster.tiles_of(H, W, tile)
        offsets, rect, total, _ = raster.isect_encode(means2d, conics,
                                                      radii, H, W, tile)
        keys, gids = raster.expand(offsets, rect, total, means2d, conics,
                                   opacities, depths, tiles_x, tiles_y,
                                   tile, stp_resort, depth_grads)
        gids_s, bounds = raster.sort_and_bound(keys, gids, tiles_x * tiles_y)
        wants = any(ctx.needs_input_grad[:4])
        if stp_resort:
            out, t_fin, ckpt = stp.forward(
                means2d, conics, opacities, colours, depths, depth_grads,
                gids_s, bounds, H, W, tile, checkpoints=wants)
            i_stop = None
        else:
            out, t_fin, i_stop = raster.forward(
                means2d, conics, opacities, colours, gids_s, bounds, H, W,
                tile)
            ckpt = None
        ctx.save_for_backward(means2d, conics, opacities, colours, depths,
                              depth_grads, gids_s, bounds, t_fin, i_stop,
                              ckpt)
        ctx.tile, ctx.stp_resort = tile, stp_resort
        return out, 1.0 - t_fin

    @staticmethod
    def backward(ctx, g_out, g_alpha):
        (means2d, conics, opacities, colours, depths, depth_grads, gids_s,
         bounds, t_fin, i_stop, ckpt) = ctx.saved_tensors
        if ctx.stp_resort:
            rows = stp.backward(means2d, conics, opacities, colours, depths,
                                depth_grads, gids_s, bounds,
                                g_out.contiguous(), g_alpha.contiguous(),
                                t_fin, ckpt, ctx.tile)
        else:
            rows = raster.backward(means2d, conics, opacities, colours,
                                   gids_s, bounds, g_out.contiguous(),
                                   g_alpha.contiguous(), t_fin, i_stop,
                                   ctx.tile)
        s = raster.reduce_rows(rows, gids_s, means2d.shape[0])
        return (s[:, 0:2], s[:, 2:5], s[:, 5], s[:, 6:]) + (None,) * 7


def render(params, cam, background, prec: Precision, stp_resort: bool,
           tile: int = 16, sh_degree: int = 3):
    """Raw parameters (scales log, opacities logit, rotations unnormalised)
    -> image [H, W, 3] with the background blended."""
    H, W = cam["height"], cam["width"]
    proj = project(params["means"], torch.exp(params["scales"]),
                   normalize_quat(params["rotations"]), cam, prec)
    opac = torch.sigmoid(params["opacities"][:, 0]) * proj["compensations"]
    shs = torch.cat([params["shs_dc"], params["shs_rest"]], 1)
    dirs = params["means"].detach() - camera_centre(cam, prec)
    colours = torch.clamp(sh_colour(shs, dirs, sh_degree) + 0.5, min=0.0)
    out, alpha = _Raster.apply(
        proj["means2d"].contiguous(), proj["conics"].contiguous(),
        opac.contiguous(), colours.contiguous(),
        proj["depths"].detach().contiguous(),
        proj["depth_grads"].detach().contiguous(), proj["radii"], H, W, tile,
        stp_resort)
    return out + (1.0 - alpha)[..., None] * background


def quantise(img):
    """The viewer's uint8 frame."""
    return (torch.clamp(img, 0.0, 1.0) * 255).to(torch.uint8)


def _window(size=11, sigma=1.5, device=None):
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _blur(img, win, prec: Precision):
    c, size = img.shape[0], win.shape[0]
    pad = size // 2
    x = prec.conv2d(img[None], win.reshape(1, 1, size, 1).expand(
        c, 1, size, 1), (pad, 0), c)
    x = prec.conv2d(x, win.reshape(1, 1, 1, size).expand(c, 1, 1, size),
                    (0, pad), c)
    return x[0]


def ssim(img1, img2, prec: Precision):
    """Mean SSIM of [C, H, W] images; C1 = 0.01^2, C2 = 0.03^2, zero
    same-padding."""
    win = _window(device=img1.device)
    mu1, mu2 = _blur(img1, win, prec), _blur(img2, win, prec)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _blur(img1 * img1, win, prec) - mu1_sq
    s2 = _blur(img2 * img2, win, prec) - mu2_sq
    s12 = _blur(img1 * img2, win, prec) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2.0 * mu12 + c1) * (2.0 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return m.mean()


def loss_of(img, gt, prec: Precision, rows=None):
    """0.8 L1 + 0.2 (1 - SSIM). `rows` keeps only those image rows: the
    fault of a loss that leaves part of the batch out."""
    if rows is not None:
        img, gt = img[rows], gt[rows]
    l1 = torch.mean(torch.abs(img - gt))
    s = ssim(img.permute(2, 0, 1), gt.permute(2, 0, 1), prec)
    return 0.8 * l1 + 0.2 * (1.0 - s)


def means_lr(count: int, extent: float, init=1.6e-4, final_factor=0.01,
             max_steps=30_000):
    """The means' rate at Adam count `count`: log-linear from init to
    init * final_factor, times the camera extent, in float32."""
    step = torch.tensor(count, dtype=torch.float32)
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    lr0 = init * extent
    lr1 = init * final_factor * extent
    return float(torch.exp((1.0 - t) * math.log(lr0)
                           + t * math.log(lr1)))


def learning_rates(count: int, extent: float):
    return {"means": means_lr(count, extent), "scales": 5e-3,
            "rotations": 1e-3, "opacities": 5e-2, "shs_dc": 2.5e-3,
            "shs_rest": 2.5e-3 / 20.0}


def adam(params, grads, mu, nu, count: int, extent: float, eps=1e-15):
    """One Adam step of every property at count `count` (updates taken
    before this one) -> (params, mu, nu). Bias corrections in float32."""
    t = count + 1
    c1 = float(1.0 - torch.tensor(B1, dtype=torch.float32) ** t)
    c2 = float(1.0 - torch.tensor(B2, dtype=torch.float32) ** t)
    lrs = learning_rates(count, extent)
    new_p, new_mu, new_nu = {}, {}, {}
    for k in FIELDS:
        g = grads[k]
        m = B1 * mu[k] + (1.0 - B1) * g
        v = B2 * nu[k] + (1.0 - B2) * (g * g)
        new_p[k] = params[k] + (m / c1) / (torch.sqrt(v / c2) + eps) * -lrs[k]
        new_mu[k], new_nu[k] = m, v
    return new_p, new_mu, new_nu


def train_step(params, mu, nu, count, cam, gt, background, extent,
               prec: Precision, stp_resort: bool, rows=None):
    """-> (loss, gradients, params, mu, nu) of one step on one view."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    img = render(leaves, cam, background, prec, stp_resort)
    loss = loss_of(img, gt, prec, rows)
    grads = dict(zip(FIELDS, torch.autograd.grad(
        loss, [leaves[k] for k in FIELDS], allow_unused=True)))
    grads = {k: torch.zeros_like(params[k]) if g is None else g
             for k, g in grads.items()}
    new_p, mu, nu = adam(params, grads, mu, nu, count, extent)
    return float(loss.detach()), grads, new_p, mu, nu
