"""What one view of a scene asks of the rasterizer, counted from the
benchmark's inputs with its own plain code (``reference/``), never from
the program's outputs.

Per view: rows, rows with a valid slot, slots (one per (Gaussian, tile)
pair and a dummy per empty rectangle), valid slots (after the peak-alpha
tile cull), tiles, pixels, and the (pixel, splat) pairs: `visited`, the
pairs each pixel evaluates up to and including its transmittance stop
(StopThePop: every pair of the pixel's tile, having no stop), `before_stop`
(the pairs a backward walks), and `composited` (the pairs with alpha of
at least 1/255 before the stop). The stop is found a chunk of slots at a
time with a cumulative product, which can round a pixel's stop one pair
away from the sequential product's: a count, not a check.
"""
from __future__ import annotations

import torch

from ..reference import model, raster

CHUNK = 32
ELEMENTS = 1 << 23      # per [tiles, pixels, CHUNK] temporary


@torch.no_grad()
def view_counts(params: dict, cam: dict, stp_resort: bool,
                tile: int = 16) -> dict:
    prec = model.Precision()
    H, W = cam["height"], cam["width"]
    proj = model.project(params["means"], torch.exp(params["scales"]),
                         model.normalize_quat(params["rotations"]), cam,
                         prec)
    opac = torch.sigmoid(params["opacities"][:, 0]) * proj["compensations"]
    tiles_x, tiles_y = raster.tiles_of(H, W, tile)
    n_tiles = tiles_x * tiles_y
    offsets, rect, total, n_isects = raster.isect_encode(
        proj["means2d"], proj["conics"], proj["radii"], H, W, tile)
    keys, gids = raster.expand(offsets, rect, total, proj["means2d"],
                               proj["conics"], opac, proj["depths"],
                               tiles_x, tiles_y, tile, stp_resort,
                               proj["depth_grads"])
    gids_s, bounds = raster.sort_and_bound(keys, gids, n_tiles)
    n_valid = int(bounds[-1])
    seen = torch.zeros(params["means"].shape[0], dtype=torch.bool,
                       device=gids_s.device)
    seen[gids_s[:n_valid]] = True
    pairs = _pairs(proj["means2d"], proj["conics"], opac, gids_s, bounds,
                   H, W, tile, tiles_x, stop=not stp_resort)
    return dict(rows=int(params["means"].shape[0]), visible=int(seen.sum()),
                slots=int(total), valid_slots=n_valid, isects=int(n_isects),
                tiles=n_tiles, pixels=H * W, **pairs)


def _pairs(means2d, conics, opac, gids, bounds, H, W, tile, tiles_x,
           stop: bool) -> dict:
    dev = means2d.device
    n_tiles = bounds.numel() - 1
    P = tile * tile
    group = max(1, ELEMENTS // (P * CHUNK))
    lane = torch.arange(CHUNK, device=dev)
    tot = torch.zeros(4, dtype=torch.int64, device=dev)
    # tiles in groups of like length, so a group walks as far as its own
    # longest list
    by_len = torch.argsort(bounds[1:] - bounds[:-1], descending=True)
    for t0 in range(0, n_tiles, group):
        tl = by_len[t0:t0 + group]
        px, py = raster.pixel_centres(tl, tiles_x, tile)
        inside = (px < W) & (py < H)
        st, cnt = bounds[tl], bounds[tl + 1] - bounds[tl]
        T = torch.ones_like(px)
        done = ~inside
        max_cnt = int(cnt.max()) if len(tl) else 0
        for k0 in range(0, max_cnt, CHUNK):
            if stop and bool(done.all()):
                break
            in_rng = (k0 + lane)[None, :] < cnt[:, None]      # [G, K]
            g = gids[torch.where(in_rng, st[:, None] + k0 + lane, 0)]
            dx = means2d[g, 0][:, None, :] - px[..., None]    # [G, P, K]
            dy = means2d[g, 1][:, None, :] - py[..., None]
            sigma = (0.5 * (conics[g, 0][:, None, :] * dx * dx
                            + conics[g, 2][:, None, :] * dy * dy)
                     + conics[g, 1][:, None, :] * dx * dy)
            alpha = torch.clamp(opac[g][:, None, :] * torch.exp(-sigma),
                                max=raster.MAX_ALPHA)
            live = (in_rng[:, None, :] & (sigma >= 0.0)
                    & (alpha >= raster.ALPHA_THRESHOLD)
                    & inside[..., None])
            n_in = torch.clamp(cnt - k0, 0, CHUNK)[:, None]   # [G, 1]
            if not stop:
                tot[0] += (n_in * inside).sum()
                tot[2] += live.sum()
                continue
            live = live & ~done[..., None]
            after = T[..., None] * torch.cumprod(
                torch.where(live, 1.0 - alpha, torch.ones_like(alpha)), -1)
            brk = live & (after <= raster.MIN_TRANSMITTANCE)
            has = brk.any(-1)
            first = torch.where(has, brk.to(torch.int8).argmax(-1),
                                torch.full_like(T, CHUNK, dtype=torch.int64))
            vis = torch.where(has, first + 1, n_in.expand_as(first))
            tot[0] += torch.where(done, torch.zeros_like(vis), vis).sum()
            tot[1] += (has & ~done).sum()
            tot[2] += (live & (lane < first[..., None])).sum()
            T = torch.where(has, T, after[..., -1])
            done = done | has
    visited, stopped, composited, _ = tot.tolist()
    return dict(visited=visited, before_stop=visited - stopped,
                composited=composited)
