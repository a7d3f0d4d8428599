"""Naive per-pixel oracle rasterizer (O(N * pixels), test scale only).

Port of ``gsl_tpu/ops/rasterize_reference.py``. Compositing semantics,
shared by every rasterizer of both packages:
  per pixel, iterate gaussians front-to-back in depth order:
    delta = mean2d - (pixel + 0.5)
    sigma = 0.5*(conic_a*dx^2 + conic_c*dy^2) + conic_b*dx*dy
    alpha = min(0.999, opacity * exp(-sigma))
    skip (continue) if sigma < 0 or alpha < 1/255
    next_T = T * (1 - alpha); if next_T <= 1e-4: break (no composite)
    out += alpha * T * channels;  T = next_T
  final: alpha_out = 1 - T (a caller blends a background with T)
"""
from __future__ import annotations

import torch

ALPHA_THRESHOLD = 1.0 / 255.0
MAX_ALPHA = 0.999
MIN_TRANSMITTANCE = 1e-4


def rasterize_oracle(
    means2d: torch.Tensor,     # [N, 2]
    conics: torch.Tensor,      # [N, 3]
    opacities: torch.Tensor,   # [N]
    channels: torch.Tensor,    # [N, C]
    depths: torch.Tensor,      # [N] front-to-back order
    mask: torch.Tensor,        # [N] visibility from projection
    img_height: int,
    img_width: int,
    tile_rect_min: torch.Tensor | None = None,  # [N, 2] optional: restrict
    tile_rect_max: torch.Tensor | None = None,  # a gaussian to its tiles
    tile_size: int = 16,
):
    """Returns (channels [H, W, C], alpha [H, W])."""
    dev, dt = means2d.device, means2d.dtype
    order = torch.argsort(
        torch.where(mask, depths, torch.full_like(depths, float("inf"))),
        stable=True)
    px = (torch.arange(img_width, dtype=dt, device=dev) + 0.5)[None, :]
    py = (torch.arange(img_height, dtype=dt, device=dev) + 0.5)[:, None]
    tx = (torch.arange(img_width, device=dev) // tile_size)[None, :]
    ty = (torch.arange(img_height, device=dev) // tile_size)[:, None]
    T = torch.ones((img_height, img_width), dtype=dt, device=dev)
    out = torch.zeros((img_height, img_width, channels.shape[1]), dtype=dt,
                      device=dev)
    done = torch.zeros((img_height, img_width), dtype=torch.bool,
                       device=dev)
    for g in order.tolist():
        if not bool(mask[g]):
            continue
        dx = means2d[g, 0] - px
        dy = means2d[g, 1] - py
        a_, b_, c_ = conics[g, 0], conics[g, 1], conics[g, 2]
        sigma = 0.5 * (a_ * dx * dx + c_ * dy * dy) + b_ * dx * dy
        alpha = torch.clamp(opacities[g] * torch.exp(-sigma), max=MAX_ALPHA)
        skip = (sigma < 0.0) | (alpha < ALPHA_THRESHOLD)
        if tile_rect_min is not None:
            skip = skip | ~((tx >= tile_rect_min[g, 0])
                            & (tx < tile_rect_max[g, 0])
                            & (ty >= tile_rect_min[g, 1])
                            & (ty < tile_rect_max[g, 1]))
        next_T = T * (1.0 - alpha)
        brk = ~skip & (next_T <= MIN_TRANSMITTANCE)
        comp = ~done & ~skip & ~brk
        vis = torch.where(comp, alpha * T, torch.zeros_like(T))
        out = out + vis[..., None] * channels[g]
        T = torch.where(comp, next_T, T)
        done = done | brk
    return out, 1.0 - T
