"""Tile rasterizer, forward: expand -> sort -> tile ranges -> composite.

Port of the forward half of ``gsl_tpu/ops/rasterize_pallas.py``
(``isect_encode_padded``, ``_expand_sorted``, ``_build_schedule``,
``_fwd_impl``, ``_tiles_to_image``) in its exact mode (``fast=False``,
``exact_sort=True``), with the same outputs:

1. `isect_encode`: per-Gaussian tile rectangles and int64 slot offsets
   (every Gaussian gets ``max(hits, 1)`` slots; a culled one keeps one
   invalid dummy, as in JAX). One host read sizes the slot buffers, so no
   slot is ever dropped.
2. `expand` (kernel K1, ``csrc/expand.cu``): per slot the key
   ``(tile << 32) | bits(max(depth, 0))`` and the Gaussian id; slots that
   fail the peak-alpha tile cull get key INT64_MAX.
3. `sort_slots`: one stable ``torch.sort`` of the keys. Slots are laid out
   in Gaussian order, so the stable sort is JAX's exact
   (tile, f32 depth, slot) order.
4. `tile_bounds`: tile t owns sorted positions [b[t], b[t+1]).
5. `rasterize_fwd` (kernel K2, ``csrc/rasterize_fwd.cu``): per-tile front
   to back compositing; the payload is gathered by Gaussian id.

Each kernel wrapper launches its CUDA kernel for CUDA tensors, or raises,
and runs its plain PyTorch version (``expand_plain``,
``rasterize_fwd_plain``) for CPU tensors. ``<wrapper>.launches`` counts
the kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_build
from .projection import Projections, tile_rect
from .rasterize_reference import (ALPHA_THRESHOLD, MAX_ALPHA,
                                  MIN_TRANSMITTANCE)

NEVER_STOPPED = 2 ** 30     # i_stop of a pixel that never stopped
INVALID_KEY = torch.iinfo(torch.int64).max
PLAIN_TILE_GROUP = 4096     # rasterize_fwd_plain: tiles per group
PLAIN_CHUNK = 64            # rasterize_fwd_plain: slots gathered at a time


class Isects(NamedTuple):
    """Per-Gaussian expansion precompute."""

    offsets: torch.Tensor   # [N] int64 exclusive prefix of max(hits, 1)
    rect: torch.Tensor      # [N, 4] int32 min_x, min_y, width, height
    total: int              # slots, dummies included
    n_isects: int           # real rectangle slots, before culling


class RasterAux(NamedTuple):
    n_isects: int             # tile intersections before culling
    n_dropped: int            # always 0: buffers are sized to the total
    t_final: torch.Tensor     # [H, W] final transmittance
    i_stop: torch.Tensor      # [H, W] int32 sorted position of the stop


def _tiles(img_height, img_width, tile_size):
    return -(-img_width // tile_size), -(-img_height // tile_size)


def isect_encode(projections: Projections, img_height: int, img_width: int,
                 tile_size: int) -> Isects:
    tiles_x, tiles_y = _tiles(img_height, img_width, tile_size)
    rect_min, rect_max = tile_rect(projections, tile_size, tiles_x, tiles_y)
    size = rect_max - rect_min
    hits = (size[:, 0] * size[:, 1]).to(torch.int64)
    slots = torch.clamp(hits, min=1)
    ends = torch.cumsum(slots, 0)
    total, n_isects = (torch.stack([ends[-1], hits.sum()]).tolist()
                       if hits.numel() else (0, 0))
    return Isects(offsets=ends - slots,
                  rect=torch.cat([rect_min, size], 1).to(torch.int32)
                  .contiguous(),
                  total=total, n_isects=n_isects)


def expand_plain(isects: Isects, means2d, conics, opacities, depths,
                 tiles_x: int, tiles_y: int, tile_size: int,
                 tile_based_culling: bool = True):
    """Plain PyTorch version of kernel K1; same arithmetic, same order of
    rounding. Returns (keys [total] int64, gids [total] int32) in slot
    order."""
    dev = means2d.device
    n = means2d.shape[0]
    rect = isects.rect.to(torch.int64)
    hits = rect[:, 2] * rect[:, 3]
    gid = torch.repeat_interleave(
        torch.arange(n, device=dev), torch.clamp(hits, min=1),
        output_size=isects.total)
    local = torch.arange(isects.total, device=dev) - isects.offsets[gid]
    w = torch.clamp(rect[gid, 2], min=1)
    t_y = torch.clamp(rect[gid, 1] + local // w, max=tiles_y - 1)
    t_x = rect[gid, 0] + local % w
    valid = hits[gid] > 0
    if tile_based_culling:
        mx, my = means2d[gid, 0], means2d[gid, 1]
        ca, cb, cc = conics[gid, 0], conics[gid, 1], conics[gid, 2]
        ts = float(tile_size)
        xlo = t_x.to(torch.float32) * ts - mx
        xhi = xlo + ts
        ylo = t_y.to(torch.float32) * ts - my
        yhi = ylo + ts

        def sig(dx, dy):
            return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

        def edge_x(dx):
            return sig(dx, torch.clamp(-cb * dx / torch.clamp(cc, min=1e-12),
                                       ylo, yhi))

        def edge_y(dy):
            return sig(torch.clamp(-cb * dy / torch.clamp(ca, min=1e-12),
                                   xlo, xhi), dy)

        smin = torch.minimum(torch.minimum(edge_x(xlo), edge_x(xhi)),
                             torch.minimum(edge_y(ylo), edge_y(yhi)))
        inside = (xlo <= 0) & (xhi >= 0) & (ylo <= 0) & (yhi >= 0)
        smin = torch.where(inside, torch.zeros_like(smin),
                           torch.clamp(smin, min=0.0))
        peak = opacities[gid] * torch.exp(-smin)
        valid = valid & ~(peak < ALPHA_THRESHOLD)
    dbits = (torch.clamp(depths, min=0.0).view(torch.int32)
             .to(torch.int64))[gid]
    keys = torch.where(valid, ((t_y * tiles_x + t_x) << 32) | dbits,
                       torch.full_like(dbits, INVALID_KEY))
    return keys, gid.to(torch.int32)


def _check_cuda(what, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: every tensor must be contiguous and "
                             f"on {dev}")
    return dev


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _expand_lib():
    lib = cuda_build.load("expand")
    lib.gsl_expand.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3)
    lib.gsl_expand.restype = ctypes.c_int
    return lib


def expand(isects: Isects, means2d, conics, opacities, depths,
           tiles_x: int, tiles_y: int, tile_size: int,
           tile_based_culling: bool = True):
    """Kernel K1 on CUDA tensors, `expand_plain` on CPU tensors.
    Returns (keys [total] int64, gids [total] int32) in slot order."""
    if not means2d.is_cuda:
        return expand_plain(isects, means2d, conics, opacities, depths,
                            tiles_x, tiles_y, tile_size, tile_based_culling)
    f32 = [means2d, conics, opacities, depths]
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError("expand: means2d, conics, opacities and depths "
                        "must be float32")
    dev = _check_cuda("expand", isects.offsets, isects.rect, *f32)
    keys = torch.empty(isects.total, dtype=torch.int64, device=dev)
    gids = torch.empty(isects.total, dtype=torch.int32, device=dev)
    lib = _expand_lib()
    code = lib.gsl_expand(
        _ptr(isects.offsets), _ptr(isects.rect), _ptr(depths),
        _ptr(means2d), _ptr(conics), _ptr(opacities), means2d.shape[0],
        tile_size, tiles_x, tiles_y, int(tile_based_culling), _ptr(keys),
        _ptr(gids), _stream(dev))
    cuda_build.check(lib, code, "expand")
    if means2d.shape[0]:
        expand.launches += 1
    return keys, gids


expand.launches = 0


def sort_slots(keys, gids):
    """Stable sort by key -> (sorted keys, Gaussian ids in that order)."""
    sorted_keys, order = torch.sort(keys, stable=True)
    return sorted_keys, gids[order]


def tile_bounds(sorted_keys, n_tiles: int):
    """[n_tiles + 1] int64: tile t owns sorted positions [b[t], b[t+1]);
    b[n_tiles] is the count of valid slots."""
    starts = torch.arange(n_tiles + 1, dtype=torch.int64,
                          device=sorted_keys.device) << 32
    return torch.searchsorted(sorted_keys, starts)


def rasterize_fwd_plain(means2d, conics, opacities, channels, gids, bounds,
                        img_height: int, img_width: int, tile_size: int):
    """Plain PyTorch version of kernel K2 with the oracle's sequential
    per-splat arithmetic. Walks the tiles PLAIN_TILE_GROUP at a time
    (bounded memory at 1080p) and each group's sorted ranges PLAIN_CHUNK
    slots at a time. Returns (out [H, W, C], T [H, W], i_stop [H, W]
    int32)."""
    dev = means2d.device
    tiles_x, tiles_y = _tiles(img_height, img_width, tile_size)
    n_tiles = tiles_x * tiles_y
    P = tile_size * tile_size
    C = channels.shape[1]
    out = torch.zeros((n_tiles, P, C), dtype=torch.float32, device=dev)
    t_fin = torch.ones((n_tiles, P), dtype=torch.float32, device=dev)
    stop = torch.full((n_tiles, P), NEVER_STOPPED, dtype=torch.int64,
                      device=dev)
    p = torch.arange(P, device=dev)
    lane = torch.arange(PLAIN_CHUNK, device=dev)
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    for t0 in range(0, n_tiles, PLAIN_TILE_GROUP):
        tl = torch.arange(t0, min(t0 + PLAIN_TILE_GROUP, n_tiles),
                          device=dev)
        px = ((tl % tiles_x)[:, None] * tile_size + p % tile_size
              ).to(torch.float32) + 0.5                       # [G, P]
        py = ((tl // tiles_x)[:, None] * tile_size + p // tile_size
              ).to(torch.float32) + 0.5
        st, cnt = starts[tl], counts[tl]
        T = torch.ones_like(px)
        acc = torch.zeros((len(tl), P, C), dtype=torch.float32, device=dev)
        done = torch.zeros(px.shape, dtype=torch.bool, device=dev)
        brk_at = torch.full(px.shape, NEVER_STOPPED, dtype=torch.int64,
                            device=dev)
        max_cnt = int(cnt.max()) if len(tl) else 0
        for k0 in range(0, max_cnt, PLAIN_CHUNK):
            if bool(done.all()):
                break
            pos = st[:, None] + k0 + lane                     # [G, K]
            in_rng = (k0 + lane)[None, :] < cnt[:, None]
            g = gids[torch.where(in_rng, pos, 0)].long()
            mx, my = means2d[g, 0], means2d[g, 1]
            ca, cb, cc = conics[g, 0], conics[g, 1], conics[g, 2]
            op, col = opacities[g], channels[g]               # [G,K], [G,K,C]
            for j in range(PLAIN_CHUNK):
                dx = mx[:, j:j + 1] - px
                dy = my[:, j:j + 1] - py
                sigma = (0.5 * (ca[:, j:j + 1] * dx * dx
                                + cc[:, j:j + 1] * dy * dy)
                         + cb[:, j:j + 1] * dx * dy)
                alpha = torch.clamp(op[:, j:j + 1] * torch.exp(-sigma),
                                    max=MAX_ALPHA)
                live = (in_rng[:, j:j + 1] & ~done & (sigma >= 0.0)
                        & (alpha >= ALPHA_THRESHOLD))
                next_t = T * (1.0 - alpha)
                brk = live & (next_t <= MIN_TRANSMITTANCE)
                brk_at = torch.where(brk, pos[:, j:j + 1], brk_at)
                done = done | brk
                comp = live & ~brk
                w = torch.where(comp, alpha * T, torch.zeros_like(T))
                acc = acc + w[..., None] * col[:, j, None, :]
                T = torch.where(comp, next_t, T)
        out[tl], t_fin[tl], stop[tl] = acc, T, brk_at

    def to_image(x):
        x = x.reshape(tiles_y, tiles_x, tile_size, tile_size, -1)
        x = x.permute(0, 2, 1, 3, 4).reshape(tiles_y * tile_size,
                                             tiles_x * tile_size, -1)
        return x[:img_height, :img_width]

    return (to_image(out), to_image(t_fin)[..., 0],
            to_image(stop)[..., 0].to(torch.int32))


def _fwd_lib():
    lib = cuda_build.load("rasterize_fwd")
    lib.gsl_rasterize_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4)
    lib.gsl_rasterize_fwd.restype = ctypes.c_int
    lib.gsl_rasterize_fwd_max_group.restype = ctypes.c_int
    return lib


def rasterize_fwd(means2d, conics, opacities, channels, gids, bounds,
                  img_height: int, img_width: int, tile_size: int = 16):
    """Kernel K2 on CUDA tensors, `rasterize_fwd_plain` on CPU tensors.
    One launch per group of up to 8 channels (one launch for C <= 8).
    Returns (out [H, W, C], T [H, W], i_stop [H, W] int32)."""
    if not means2d.is_cuda:
        return rasterize_fwd_plain(means2d, conics, opacities, channels,
                                   gids, bounds, img_height, img_width,
                                   tile_size)
    f32 = [means2d, conics, opacities, channels]
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError("rasterize_fwd: means2d, conics, opacities and "
                        "channels must be float32")
    if gids.dtype != torch.int32 or bounds.dtype != torch.int64:
        raise TypeError("rasterize_fwd: gids must be int32, bounds int64")
    if gids.numel() >= NEVER_STOPPED:
        raise ValueError("rasterize_fwd: more than 2^30 sorted slots "
                         "collide with the i_stop sentinel")
    dev = _check_cuda("rasterize_fwd", *f32, gids, bounds)
    tiles_x, tiles_y = _tiles(img_height, img_width, tile_size)
    C = channels.shape[1]
    out = torch.empty((img_height, img_width, C), dtype=torch.float32,
                      device=dev)
    t_fin = torch.empty((img_height, img_width), dtype=torch.float32,
                        device=dev)
    i_stop = torch.empty((img_height, img_width), dtype=torch.int32,
                         device=dev)
    lib = _fwd_lib()
    group = lib.gsl_rasterize_fwd_max_group()
    for c0 in range(0, C, group):
        code = lib.gsl_rasterize_fwd(
            _ptr(means2d), _ptr(conics), _ptr(opacities), _ptr(channels),
            C, c0, min(group, C - c0), _ptr(gids), _ptr(bounds),
            tiles_x * tiles_y, tiles_x, tile_size, img_height, img_width,
            _ptr(out), _ptr(t_fin), _ptr(i_stop), _stream(dev))
        cuda_build.check(lib, code, "rasterize_fwd")
        rasterize_fwd.launches += 1
    return out, t_fin, i_stop


rasterize_fwd.launches = 0


def rasterize(projections: Projections, opacities, channels,
              img_height: int, img_width: int, tile_size: int = 16,
              tile_based_culling: bool = True):
    """Rasterize projected splats front to back.

    projections supplies means2d, conics, depths (sort key) and radii (tile
    rectangles); opacities [N]; channels [N, C] with any C.
    Returns (img_nobg [H, W, C] without background, alpha [H, W], aux).
    Blend a background as ``img + (1 - alpha)[..., None] * bg``."""
    tiles_x, tiles_y = _tiles(img_height, img_width, tile_size)
    means2d = projections.means2d.contiguous()
    conics = projections.conics.contiguous()
    opacities = opacities.contiguous()
    channels = channels.contiguous()
    isects = isect_encode(projections, img_height, img_width, tile_size)
    keys, gids = expand(isects, means2d, conics, opacities,
                        projections.depths.contiguous(), tiles_x, tiles_y,
                        tile_size, tile_based_culling)
    sorted_keys, gids_sorted = sort_slots(keys, gids)
    bounds = tile_bounds(sorted_keys, tiles_x * tiles_y)
    out, t_fin, i_stop = rasterize_fwd(
        means2d, conics, opacities, channels, gids_sorted, bounds,
        img_height, img_width, tile_size)
    aux = RasterAux(n_isects=isects.n_isects, n_dropped=0, t_final=t_fin,
                    i_stop=i_stop)
    return out, 1.0 - t_fin, aux
