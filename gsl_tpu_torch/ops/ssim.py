"""SSIM with an 11x11 Gaussian window.

Port of ``ssim`` in ``gsl_tpu/ops/ssim.py``: window sigma 1.5,
C1 = 0.01^2, C2 = 0.03^2, zero same-padding, mean over all pixels and
channels. Only the exact float32 path is ported: each blur is a pair of
separable depthwise convolutions (``F.conv2d``, groups = C). The JAX
package's ``fast=True`` path (blurs as banded bf16 matrix products, with
clamps on the variances and on the mean that repair that path's rounding)
exists for the TPU's matrix unit and has no counterpart here; the training
loss uses this exact SSIM.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.device import float32_math

_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


def _gaussian_window(size: int, sigma: float, like: torch.Tensor):
    x = torch.arange(size, dtype=torch.float32, device=like.device) \
        - size // 2
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _blur(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable same-padded blur. img [C, H, W]."""
    c = img.shape[0]
    size = win.shape[0]
    pad = size // 2
    x = img[None]
    x = F.conv2d(x, win.reshape(1, 1, size, 1).expand(c, 1, size, 1),
                 padding=(pad, 0), groups=c)
    x = F.conv2d(x, win.reshape(1, 1, 1, size).expand(c, 1, 1, size),
                 padding=(0, pad), groups=c)
    return x[0]


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM of two images [C, H, W]; a 0-d tensor. The convolutions
    run in full float32 (no TF32) on the card."""
    win = _gaussian_window(window_size, sigma, img1)
    with float32_math():
        mu1 = _blur(img1, win)
        mu2 = _blur(img2, win)
        mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        sigma1_sq = _blur(img1 * img1, win) - mu1_sq
        sigma2_sq = _blur(img2 * img2, win) - mu2_sq
        sigma12 = _blur(img1 * img2, win) - mu12
    ssim_map = ((2.0 * mu12 + _C1) * (2.0 * sigma12 + _C2)) / (
        (mu1_sq + mu2_sq + _C1) * (sigma1_sq + sigma2_sq + _C2))
    return ssim_map.mean()
