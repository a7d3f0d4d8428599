"""Plain PyTorch StopThePop compositing: the benchmark's own frozen copy
of ``rasterize_fwd_stp_plain`` and ``rasterize_bwd_stp_plain`` in
``gsl_tpu_torch/ops/rasterize_stp.py``, counters left out, one image one
tile group. The arithmetic is unchanged.

Sorted position p belongs to window p // 16 of the sorted stream. A pixel
gives every slot of a window the depth d_p = depth - kz . (mean - pixel)
and composites the window's slots by ascending d_p, ties by position;
windows follow each other in key order. There is no transmittance stop.
The forward leaves T at the start of every window of every tile (window k
of tile t at row bounds[t] // 16 + k + t), from which the backward
recomputes each window's order and T_exc and carries only the suffix sum.
"""
from __future__ import annotations

import torch

from .raster import (ALPHA_THRESHOLD, MAX_ALPHA, MIN_ONE_MINUS_ALPHA,
                     image_to_tiles, pixel_centres, tiles_of,
                     tiles_to_image)

WINDOW = 16
TILE_GROUP = 8192


def checkpoint_rows(n_slots: int, n_tiles: int) -> int:
    return n_slots // WINDOW + n_tiles + 1


def tile_windows(bounds, tl):
    st, end = bounds[tl], bounds[tl + 1]
    w0 = st // WINDOW
    n_win = torch.where(end > st, (end - 1) // WINDOW - w0 + 1,
                        torch.zeros_like(st))
    return st, end, w0, n_win


class Window:
    """One window of every tile of a group, for every pixel: [G, P, 16]."""

    def __init__(self, means2d, conics, opacities, depths, depth_grads,
                 gids, pos, in_rng, px, py):
        g = gids[torch.where(in_rng, pos, 0)]                 # [G, 16]
        self.g = g
        self.ca = conics[g, 0][:, None, :]
        self.cb = conics[g, 1][:, None, :]
        self.cc = conics[g, 2][:, None, :]
        self.dx = means2d[g, 0][:, None, :] - px[:, :, None]
        self.dy = means2d[g, 1][:, None, :] - py[:, :, None]
        dx, dy = self.dx, self.dy
        sigma = (0.5 * (self.ca * dx * dx + self.cc * dy * dy)
                 + self.cb * dx * dy)
        self.e = torch.exp(-sigma)
        self.raw = opacities[g][:, None, :] * self.e
        alpha = torch.clamp(self.raw, max=MAX_ALPHA)
        keep = (in_rng[:, None, :] & (sigma >= 0.0)
                & (alpha >= ALPHA_THRESHOLD))
        self.a = torch.where(keep, alpha, torch.zeros_like(alpha))
        d_p = (depths[g][:, None, :] - depth_grads[g, 0][:, None, :] * dx
               - depth_grads[g, 1][:, None, :] * dy)
        self.order = torch.argsort(d_p, dim=-1, stable=True)

    def in_order(self, x):
        return x.gather(-1, self.order)

    def in_position(self, x_ordered):
        return torch.empty_like(x_ordered).scatter_(-1, self.order,
                                                    x_ordered)

    def transmittance(self, T):
        a_o = self.in_order(self.a)
        t_exc = torch.empty_like(a_o)
        for r in range(WINDOW):
            t_exc[..., r] = T
            T = T * (1.0 - a_o[..., r])
        return self.in_position(t_exc), T


def forward(means2d, conics, opacities, channels, depths, depth_grads, gids,
            bounds, img_height, img_width, tile_size, checkpoints=False):
    """-> (out [H, W, C], T [H, W], checkpoints [rows, P] or None)."""
    dev = means2d.device
    tiles_x, tiles_y = tiles_of(img_height, img_width, tile_size)
    n_tiles = tiles_x * tiles_y
    P = tile_size * tile_size
    C = channels.shape[1]
    out = torch.zeros((n_tiles, P, C), dtype=torch.float32, device=dev)
    t_fin = torch.ones((n_tiles, P), dtype=torch.float32, device=dev)
    ckpt = None
    if checkpoints:
        ckpt = torch.ones((checkpoint_rows(gids.numel(), n_tiles), P),
                          dtype=torch.float32, device=dev)
    lane = torch.arange(WINDOW, device=dev)
    for t0 in range(0, n_tiles, TILE_GROUP):
        tl = torch.arange(t0, min(t0 + TILE_GROUP, n_tiles), device=dev)
        px, py = pixel_centres(tl, tiles_x, tile_size)
        st, end, w0, n_win = tile_windows(bounds, tl)
        T = torch.ones_like(px)
        acc = torch.zeros((len(tl), P, C), dtype=torch.float32, device=dev)
        for k in range(int(n_win.max()) if len(tl) else 0):
            pos = (w0 + k)[:, None] * WINDOW + lane
            in_rng = (pos >= st[:, None]) & (pos < end[:, None])
            win = Window(means2d, conics, opacities, depths, depth_grads,
                         gids, pos, in_rng, px, py)
            if ckpt is not None:
                active = n_win > k
                ckpt[(w0 + k + tl)[active]] = T[active]
            t_exc, T = win.transmittance(T)
            w = win.a * t_exc
            col = channels[win.g]
            for j in range(WINDOW):
                acc = acc + w[..., j, None] * col[:, j, None, :]
        out[tl], t_fin[tl] = acc, T
    dims = (tiles_x, tiles_y, tile_size, img_height, img_width)
    return (tiles_to_image(out, *dims), tiles_to_image(t_fin, *dims)[..., 0],
            ckpt)


def backward(means2d, conics, opacities, channels, depths, depth_grads,
             gids, bounds, g_out, g_alpha, t_final, checkpoints, tile_size):
    """Rows [len(gids), 6 + C], as `raster.backward`'s."""
    dev = means2d.device
    img_height, img_width, C = g_out.shape
    tiles_x, tiles_y = tiles_of(img_height, img_width, tile_size)
    n_tiles = tiles_x * tiles_y
    rows = torch.zeros((gids.numel(), 6 + C), dtype=torch.float32,
                       device=dev)
    gt = image_to_tiles(g_out, tiles_x, tiles_y, tile_size)
    ga = image_to_tiles(g_alpha[..., None], tiles_x, tiles_y,
                        tile_size)[..., 0]
    tf = image_to_tiles(t_final[..., None], tiles_x, tiles_y,
                        tile_size)[..., 0]
    lane = torch.arange(WINDOW, device=dev)
    for t0 in range(0, n_tiles, TILE_GROUP):
        tl = torch.arange(t0, min(t0 + TILE_GROUP, n_tiles), device=dev)
        px, py = pixel_centres(tl, tiles_x, tile_size)
        st, end, w0, n_win = tile_windows(bounds, tl)
        g_pix = gt[tl]
        S = -tf[tl] * ga[tl]
        for k in reversed(range(int(n_win.max()) if len(tl) else 0)):
            pos = (w0 + k)[:, None] * WINDOW + lane
            in_rng = (pos >= st[:, None]) & (pos < end[:, None])
            win = Window(means2d, conics, opacities, depths, depth_grads,
                         gids, pos, in_rng, px, py)
            T0 = checkpoints[torch.where(n_win > k, w0 + k + tl, 0)]
            t_exc, _ = win.transmittance(T0)
            a, dx, dy = win.a, win.dx, win.dy
            col = channels[win.g]
            cg = torch.zeros_like(a)
            for c in range(C):
                cg = cg + g_pix[:, :, None, c] * col[:, None, :, c]
            w = a * t_exc
            q_o = win.in_order(w * cg)
            s_after = torch.empty_like(q_o)
            for r in reversed(range(WINDOW)):
                s_after[..., r] = S
                S = S + q_o[..., r]
            s_after = win.in_position(s_after)
            comp = a > 0.0
            zero = torch.zeros_like(a)
            dalpha = torch.where(
                comp, t_exc * cg - s_after / torch.clamp(
                    1.0 - a, min=MIN_ONE_MINUS_ALPHA), zero)
            unclamped = win.raw < MAX_ALPHA
            dsigma = torch.where(unclamped, -a * dalpha, zero)
            dop = torch.where(unclamped & comp, dalpha * win.e, zero)
            gx = win.ca * dx + win.cb * dy
            gy = win.cc * dy + win.cb * dx
            part = torch.empty((len(tl), WINDOW, 6 + C), dtype=torch.float32,
                               device=dev)
            part[..., :6] = torch.stack(
                [dsigma * gx, dsigma * gy, dsigma * 0.5 * dx * dx,
                 dsigma * dx * dy, dsigma * 0.5 * dy * dy, dop], -1).sum(1)
            part[..., 6:] = (w[..., None] * g_pix[:, :, None, :]).sum(1)
            rows[pos[in_rng]] = part[in_rng]
    return rows
