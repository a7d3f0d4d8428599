"""Tile rasterizer: expand -> sort -> tile ranges -> composite, and its
gradient.

Port of ``gsl_tpu/ops/rasterize_pallas.py`` (``isect_encode_padded``,
``_expand_sorted``, ``_build_schedule``, ``_fwd_impl``, ``_tiles_to_image``
and the custom VJP ``_rasterize_bwd`` with ``_rasterize_bwd_raw`` and
``_reduce_by_gid``) in its exact mode (``fast=False``, ``exact_sort=True``),
with the same outputs:

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
6. `rasterize_bwd` (kernel K3, ``csrc/rasterize_bwd.cu``): each tile's list
   walked back from the pixels' stops; one gradient row per sorted slot.
7. `reduce_grads` (kernel K4, ``csrc/reduce_grads.cu``): the rows summed
   per Gaussian, with the absolute mean-gradient columns of AbsGS. The
   surfel rasterizer (``ops/surfel_rasterize.py``) sums its 13 + C
   columns with the same kernel.

`rasterize` ties them into one differentiable op (`_Rasterize`). With
``stp_resort=True`` (StopThePop) step 2 keys each slot by its Gaussian's
depth plane at the tile centre, and steps 5 and 6 are the per-pixel-resort
kernels of ``ops/rasterize_stp.py`` (K2s, K3s).

Each kernel wrapper launches its CUDA kernel for CUDA tensors, or raises,
and runs its plain PyTorch version (``expand_plain``,
``rasterize_fwd_plain``, ``rasterize_bwd_plain``, ``reduce_grads_plain``)
for CPU tensors. ``<wrapper>.launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils.tracing import span
from . import cuda_build
from .projection import Projections, tile_rect
from .rasterize_reference import (ALPHA_THRESHOLD, MAX_ALPHA,
                                  MIN_TRANSMITTANCE)

NEVER_STOPPED = 2 ** 30     # i_stop of a pixel that never stopped
INVALID_KEY = torch.iinfo(torch.int64).max
PLAIN_TILE_GROUP = 4096     # plain forward/backward: tiles per group
PLAIN_CHUNK = 64            # plain forward/backward: slots gathered at a time
MIN_ONE_MINUS_ALPHA = 1e-3  # backward: floor of 1 - alpha under the carry


class Isects(NamedTuple):
    """Per-Gaussian expansion precompute."""

    offsets: torch.Tensor   # [N] int64 exclusive prefix of max(hits, 1)
    rect: torch.Tensor      # [N, 4] int32 min_x, min_y, width, height
    total: int              # slots, dummies included
    n_isects: int           # real rectangle slots, before culling


class RasterAux(NamedTuple):
    n_isects: int             # tile intersections before culling
    n_dropped: int            # always 0: buffers are sized to the total
    t_final: torch.Tensor     # [H, W] final transmittance (no gradient)
    i_stop: torch.Tensor      # [H, W] int32 sorted position of the stop


def _tiles(img_height, img_width, tile_size):
    return -(-img_width // tile_size), -(-img_height // tile_size)


def isect_encode(projections: Projections, img_height: int, img_width: int,
                 tile_size: int) -> Isects:
    with span("raster.isect_encode"):
        tiles_x, tiles_y = _tiles(img_height, img_width, tile_size)
        rect_min, rect_max = tile_rect(projections, tile_size, tiles_x,
                                       tiles_y)
        size = rect_max - rect_min
        hits = (size[:, 0] * size[:, 1]).to(torch.int64)
        slots = torch.clamp(hits, min=1)
        ends = torch.cumsum(slots, 0)
        total, n_isects = 0, 0
        if hits.numel():
            counts = torch.stack([ends[-1], hits.sum()])
            with span("wait.slot_count"):
                total, n_isects = counts.tolist()
        return Isects(offsets=ends - slots,
                      rect=torch.cat([rect_min, size], 1).to(torch.int32)
                      .contiguous(),
                      total=total, n_isects=n_isects)


def slot_tiles(isects: Isects, tiles_y: int):
    """Per slot, in slot order: (gid [total] int64, t_x, t_y [total] int64,
    valid [total] bool). A Gaussian with an empty rectangle keeps one
    invalid dummy slot."""
    dev = isects.offsets.device
    n = isects.offsets.shape[0]
    rect = isects.rect.to(torch.int64)
    hits = rect[:, 2] * rect[:, 3]
    gid = torch.repeat_interleave(
        torch.arange(n, device=dev), torch.clamp(hits, min=1),
        output_size=isects.total)
    local = torch.arange(isects.total, device=dev) - isects.offsets[gid]
    w = torch.clamp(rect[gid, 2], min=1)
    t_y = torch.clamp(rect[gid, 1] + local // w, max=tiles_y - 1)
    t_x = rect[gid, 0] + local % w
    return gid, t_x, t_y, hits[gid] > 0


def slot_keys(valid, t_x, t_y, tiles_x: int, depths, gid,
              stp_resort: bool = False, means2d=None, depth_grads=None,
              tile_size: int = 16):
    """[total] int64 (tile << 32) | bits(max(depth, 0)); INVALID_KEY where
    not valid. With `stp_resort` the depth of a slot is the Gaussian's
    depth plane at the centre of the slot's tile,
    depth + kz . (tile centre - mean), kz = depth_grads."""
    depth = depths[gid]
    if stp_resort:
        ts = float(tile_size)
        tcx = (t_x.to(torch.float32) + 0.5) * ts
        tcy = (t_y.to(torch.float32) + 0.5) * ts
        depth = (depth + depth_grads[gid, 0] * (tcx - means2d[gid, 0])
                 + depth_grads[gid, 1] * (tcy - means2d[gid, 1]))
    dbits = torch.clamp(depth, min=0.0).view(torch.int32).to(torch.int64)
    return torch.where(valid, ((t_y * tiles_x + t_x) << 32) | dbits,
                       torch.full_like(dbits, INVALID_KEY))


def expand_plain(isects: Isects, means2d, conics, opacities, depths,
                 tiles_x: int, tiles_y: int, tile_size: int,
                 tile_based_culling: bool = True, stp_resort: bool = False,
                 depth_grads=None):
    """Plain PyTorch version of kernel K1; same arithmetic, same order of
    rounding. Returns (keys [total] int64, gids [total] int32) in slot
    order. `stp_resort` keys each slot by the depth plane at its tile's
    centre (see `slot_keys`) and needs `depth_grads` [N, 2]."""
    gid, t_x, t_y, valid = slot_tiles(isects, tiles_y)
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
    keys = slot_keys(valid, t_x, t_y, tiles_x, depths, gid, stp_resort,
                     means2d, depth_grads, tile_size)
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
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3)
    lib.gsl_expand.restype = ctypes.c_int
    lib.gsl_expand_attributes.argtypes = [ctypes.c_void_p]
    lib.gsl_expand_attributes.restype = ctypes.c_int
    return lib


def expand_attributes():
    """`kernel_attributes` of the K1 kernel (either key kind)."""
    return kernel_attributes(_expand_lib(), "gsl_expand_attributes")


def expand(isects: Isects, means2d, conics, opacities, depths,
           tiles_x: int, tiles_y: int, tile_size: int,
           tile_based_culling: bool = True, stp_resort: bool = False,
           depth_grads=None):
    """Kernel K1 on CUDA tensors, `expand_plain` on CPU tensors.
    Returns (keys [total] int64, gids [total] int32) in slot order.
    `stp_resort`: StopThePop keys, the depth plane (slope `depth_grads`
    [N, 2]) at each slot's tile centre. On the card `isects.rect` must
    start 16-byte aligned, as a tensor of its own does: K1 reads a
    Gaussian's rectangle in one 16-byte load."""
    if stp_resort and depth_grads is None:
        raise ValueError("expand: stp_resort needs depth_grads")
    if not means2d.is_cuda:
        return expand_plain(isects, means2d, conics, opacities, depths,
                            tiles_x, tiles_y, tile_size, tile_based_culling,
                            stp_resort, depth_grads)
    f32 = [means2d, conics, opacities, depths]
    if stp_resort:
        f32.append(depth_grads)
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError("expand: means2d, conics, opacities, depths and "
                        "depth_grads must be float32")
    dev = _check_cuda("expand", isects.offsets, isects.rect, *f32)
    keys = torch.empty(isects.total, dtype=torch.int64, device=dev)
    gids = torch.empty(isects.total, dtype=torch.int32, device=dev)
    lib = _expand_lib()
    code = lib.gsl_expand(
        _ptr(isects.offsets), _ptr(isects.rect), _ptr(depths),
        _ptr(means2d), _ptr(conics), _ptr(opacities),
        _ptr(depth_grads) if stp_resort else None, means2d.shape[0],
        tile_size, tiles_x, tiles_y, int(tile_based_culling),
        int(stp_resort), _ptr(keys), _ptr(gids), _stream(dev))
    cuda_build.check(lib, code, "expand")
    if means2d.shape[0]:
        expand.launches += 1
    return keys, gids


expand.launches = 0


def sort_slots(keys, gids):
    """Stable sort by key -> (sorted keys, Gaussian ids in that order,
    order [total] int64: the slot at each sorted position)."""
    sorted_keys, order = torch.sort(keys, stable=True)
    return sorted_keys, gids[order], order


def invert_order(order):
    """[total] int32: the sorted position of each slot."""
    inv = torch.empty(order.numel(), dtype=torch.int32, device=order.device)
    inv[order] = torch.arange(order.numel(), dtype=torch.int32,
                              device=order.device)
    return inv


def tile_bounds(sorted_keys, n_tiles: int):
    """[n_tiles + 1] int64: tile t owns sorted positions [b[t], b[t+1]);
    b[n_tiles] is the count of valid slots."""
    starts = torch.arange(n_tiles + 1, dtype=torch.int64,
                          device=sorted_keys.device) << 32
    return torch.searchsorted(sorted_keys, starts)


def _tiles_to_image(x, tiles_x: int, tiles_y: int, tile_size: int,
                    img_height: int, img_width: int):
    """[n_tiles, P, K] -> [H, W, K]."""
    x = x.reshape(tiles_y, tiles_x, tile_size, tile_size, -1)
    x = x.permute(0, 2, 1, 3, 4).reshape(tiles_y * tile_size,
                                         tiles_x * tile_size, -1)
    return x[:img_height, :img_width]


def skip_cut(opacities):
    """The sigma beyond which a pair of each splat is skipped for certain,
    as the forward kernels compute it (csrc/alpha_skip.cuh): ln(255 op) +
    1e-3."""
    return torch.log(255.0 * opacities) + 1e-3


def rasterize_fwd_plain(means2d, conics, opacities, channels, gids, bounds,
                        img_height: int, img_width: int, tile_size: int,
                        stats: dict | None = None):
    """Plain PyTorch version of kernel K2 with the oracle's sequential
    per-splat arithmetic. Walks the tiles PLAIN_TILE_GROUP at a time
    (bounded memory at 1080p) and each group's sorted ranges PLAIN_CHUNK
    slots at a time. Returns (out [H, W, C], T [H, W], i_stop [H, W]
    int32). With `stats`, leaves the count of (pixel, splat) pairs that
    pixels of the image visit (up to and including the stop) with sigma at
    or below the splat's `skip_cut` in ``stats["near_pairs"]``: the pairs
    that take the exact test in the kernel."""
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
    near = torch.zeros((), dtype=torch.int64, device=dev)
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
            if stats is not None:
                inside = (px < img_width) & (py < img_height)
                cut = skip_cut(op)
            for j in range(PLAIN_CHUNK):
                dx = mx[:, j:j + 1] - px
                dy = my[:, j:j + 1] - py
                sigma = (0.5 * (ca[:, j:j + 1] * dx * dx
                                + cc[:, j:j + 1] * dy * dy)
                         + cb[:, j:j + 1] * dx * dy)
                alpha = torch.clamp(op[:, j:j + 1] * torch.exp(-sigma),
                                    max=MAX_ALPHA)
                if stats is not None:
                    near += (in_rng[:, j:j + 1] & ~done & inside
                             & ~(sigma > cut[:, j:j + 1])).sum()
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
    if stats is not None:
        stats["near_pairs"] = int(near)

    dims = (tiles_x, tiles_y, tile_size, img_height, img_width)
    return (_tiles_to_image(out, *dims),
            _tiles_to_image(t_fin, *dims)[..., 0],
            _tiles_to_image(stop, *dims)[..., 0].to(torch.int32))


def _fwd_lib(extra: tuple = ()):
    lib = cuda_build.load("rasterize_fwd", extra)
    lib.gsl_rasterize_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4)
    lib.gsl_rasterize_fwd.restype = ctypes.c_int
    lib.gsl_rasterize_fwd_max_group.restype = ctypes.c_int
    lib.gsl_rasterize_fwd_attributes.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.gsl_rasterize_fwd_attributes.restype = ctypes.c_int
    return lib


def rasterize_fwd_attributes(n_channels: int, tile_size: int = 16):
    """`kernel_attributes` of the K2 kernel that composites
    min(n_channels, 8) channels."""
    return kernel_attributes(_fwd_lib(), "gsl_rasterize_fwd_attributes",
                             n_channels, tile_size)


def rasterize_fwd(means2d, conics, opacities, channels, gids, bounds,
                  img_height: int, img_width: int, tile_size: int = 16,
                  contract: bool = True):
    """Kernel K2 on CUDA tensors, `rasterize_fwd_plain` on CPU tensors.
    One launch per group of up to 8 channels (one launch for C <= 8).
    Returns (out [H, W, C], T [H, W], i_stop [H, W] int32).

    `contract=False` launches a build of the same source without
    multiply-add contraction: the kernel contracts sigma and the plain
    version rounds every product, so where alpha sits within a rounding of
    the 1/255 skip or T of the 1e-4 stop the two decide differently; the
    uncontracted build rounds as the plain version does, and the checks on
    the card hold the source's arithmetic to it."""
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
    lib = _fwd_lib(() if contract else cuda_build.NO_CONTRACTION)
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


def _image_to_tiles(x, tiles_x: int, tiles_y: int, tile_size: int):
    """[H, W, K] -> [n_tiles, P, K], zero-padded to whole tiles."""
    h, w, k = x.shape
    x = torch.nn.functional.pad(
        x, (0, 0, 0, tiles_x * tile_size - w, 0, tiles_y * tile_size - h))
    x = x.reshape(tiles_y, tile_size, tiles_x, tile_size, k)
    return x.permute(0, 2, 1, 3, 4).reshape(tiles_x * tiles_y,
                                            tile_size * tile_size, k)


def slot_warps(comp):
    """comp [G, P, K] bool, pixel p of a tile composites slot k: the count
    of (slot, warp) pairs, a warp being 32 consecutive pixels of a tile, in
    which some pixel composites the slot. The backward kernels reduce a
    slot's per-pixel values over a warp exactly there."""
    g, p, k = comp.shape
    pad = -p % 32
    comp = torch.nn.functional.pad(comp, (0, 0, 0, pad))
    return comp.reshape(g, (p + pad) // 32, 32, k).any(2).sum()


N_GEOM = 6   # K3's leading columns: dmx dmy da db dc dop (kGeom in K4)
# channels per K3 launch where the caller gives no group (see
# backward_by_channel_groups): groups of 8 take its path with the
# cotangents in registers and three blocks an SM. On an NVIDIA H100 80GB
# HBM3 at 700 W, at the bench pose (1M Gaussians, 1088x1920), K3 took
# 11.0 / 22.4 / 45.3 ms at C = 32 / 64 / 128 in groups
# of 8, against 18.9 / 39.4 / 72.5 in its largest groups (36) and 22.3 /
# 45.0 / 90.3 in groups of 16 (PERF.md, section 6). K3s and K7 take their
# largest groups: in groups of 8 they were slower (PERF.md).
K3_GROUP = 8


def rasterize_bwd_plain(means2d, conics, opacities, channels, gids, bounds,
                        g_out, g_alpha, t_final, i_stop, tile_size: int,
                        stats: dict | None = None):
    """Plain PyTorch version of kernel K3, the same arithmetic per
    (pixel, splat) pair. g_out [H, W, C] and g_alpha [H, W] are the
    cotangents of the composited channels and of alpha; t_final and i_stop
    are the forward's. Returns rows [n_valid, 6 + C]: per sorted position
    the sums over its tile's pixels of d/d(mean x, mean y, conic a, b, c,
    opacity, channels); `gids` may run past the valid slots, whose rows
    stay zero. With `stats`, leaves the count of composited
    (pixel, splat) pairs in ``stats["composited_pairs"]`` and that of
    (slot, warp)s with at least one such pixel (`slot_warps`) in
    ``stats["composited_slot_warps"]``."""
    dev = means2d.device
    img_height, img_width, C = g_out.shape
    tiles_x, tiles_y = _tiles(img_height, img_width, tile_size)
    n_tiles = tiles_x * tiles_y
    P = tile_size * tile_size
    rows = torch.zeros((gids.numel(), 6 + C), dtype=torch.float32,
                       device=dev)
    gt = _image_to_tiles(g_out, tiles_x, tiles_y, tile_size)
    ga = _image_to_tiles(g_alpha[..., None], tiles_x, tiles_y,
                         tile_size)[..., 0]
    tf = _image_to_tiles(t_final[..., None], tiles_x, tiles_y,
                         tile_size)[..., 0]
    # padding pixels get stop 0: no position lies before it
    stops = _image_to_tiles(i_stop[..., None].to(torch.int64), tiles_x,
                            tiles_y, tile_size)[..., 0]
    p = torch.arange(P, device=dev)
    lane = torch.arange(PLAIN_CHUNK, device=dev)
    n_comp = torch.zeros((), dtype=torch.int64, device=dev)
    n_warps = torch.zeros((), dtype=torch.int64, device=dev)
    for t0 in range(0, n_tiles, PLAIN_TILE_GROUP):
        tl = torch.arange(t0, min(t0 + PLAIN_TILE_GROUP, n_tiles),
                          device=dev)
        px = ((tl % tiles_x)[:, None] * tile_size + p % tile_size
              ).to(torch.float32) + 0.5                       # [G, P]
        py = ((tl // tiles_x)[:, None] * tile_size + p // tile_size
              ).to(torch.float32) + 0.5
        st, end = bounds[tl], bounds[tl + 1]
        stop, g_pix = stops[tl], gt[tl]                   # [G, P], [G, P, C]
        # nothing at or behind the largest stop of a tile was composited
        last = torch.minimum(end, stop.max(dim=1).values)
        cnt = torch.clamp(last - st, min=0)
        T = tf[tl]
        S = -T * ga[tl]
        max_cnt = int(cnt.max()) if len(tl) else 0
        for k0 in reversed(range(0, max_cnt, PLAIN_CHUNK)):
            pos = st[:, None] + k0 + lane                     # [G, K]
            in_rng = (k0 + lane)[None, :] < cnt[:, None]
            g = gids[torch.where(in_rng, pos, 0)].long()
            mx, my = means2d[g, 0], means2d[g, 1]
            ca_, cb_, cc_ = conics[g, 0], conics[g, 1], conics[g, 2]
            op, col = opacities[g], channels[g]               # [G,K], [G,K,C]
            part = torch.zeros((len(tl), PLAIN_CHUNK, 6 + C),
                               dtype=torch.float32, device=dev)
            for j in reversed(range(PLAIN_CHUNK)):
                ca, cb, cc = (ca_[:, j:j + 1], cb_[:, j:j + 1],
                              cc_[:, j:j + 1])
                dx = mx[:, j:j + 1] - px
                dy = my[:, j:j + 1] - py
                sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
                e = torch.exp(-sigma)
                raw = op[:, j:j + 1] * e
                alpha = torch.clamp(raw, max=MAX_ALPHA)
                comp = (in_rng[:, j:j + 1] & (pos[:, j:j + 1] < stop)
                        & (sigma >= 0.0) & (alpha >= ALPHA_THRESHOLD))
                zero = torch.zeros_like(T)
                a = torch.where(comp, alpha, zero)
                one_minus = 1.0 - a
                t_exc = T / one_minus
                cg = (g_pix * col[:, j, None, :]).sum(-1)         # [G, P]
                dalpha = torch.where(
                    comp, t_exc * cg - S / torch.clamp(
                        one_minus, min=MIN_ONE_MINUS_ALPHA), zero)
                w = a * t_exc
                S = S + w * cg
                T = t_exc
                unclamped = raw < MAX_ALPHA
                dsigma = torch.where(unclamped, -a * dalpha, zero)
                dop = torch.where(unclamped & comp, dalpha * e, zero)
                gx = ca * dx + cb * dy
                gy = cc * dy + cb * dx
                geom = torch.stack(
                    [dsigma * gx, dsigma * gy, dsigma * 0.5 * dx * dx,
                     dsigma * dx * dy, dsigma * 0.5 * dy * dy, dop], -1)
                part[:, j, :6] = geom.sum(1)
                part[:, j, 6:] = (w[..., None] * g_pix).sum(1)
                n_comp += comp.sum()
                n_warps += slot_warps(comp[..., None])
            rows[pos[in_rng]] = part[in_rng]
    if stats is not None:
        stats["composited_pairs"] = int(n_comp)
        stats["composited_slot_warps"] = int(n_warps)
    return rows


def _bwd_lib(extra: tuple = ()):
    lib = cuda_build.load("rasterize_bwd", extra)
    lib.gsl_rasterize_bwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6)
    lib.gsl_rasterize_bwd.restype = ctypes.c_int
    lib.gsl_rasterize_bwd_attributes.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.gsl_rasterize_bwd_attributes.restype = ctypes.c_int
    lib.gsl_rasterize_bwd_max_group.argtypes = [ctypes.c_int]
    lib.gsl_rasterize_bwd_max_group.restype = ctypes.c_int
    return lib


def rasterize_bwd_max_group(tile_size: int = 16) -> int:
    """The most channels one K3 launch takes at this tile size (36 at
    16). Needs the built library."""
    return _bwd_lib().gsl_rasterize_bwd_max_group(tile_size)


def kernel_attributes(lib, entry: str, *args: int):
    """What the card's runtime reports for the kernel of C entry point
    `entry` that `args` select (for the raster kernels the channel count
    and the tile size): registers per thread, local (spill) bytes per thread
    (cudaFuncGetAttributes), dynamic shared bytes per block, and resident
    blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Needs a
    card."""
    out = (ctypes.c_int * 4)()
    code = getattr(lib, entry)(*args, out)
    cuda_build.check(lib, code, entry)
    return {"registers": out[0], "local_bytes": out[1],
            "shared_bytes": out[2], "blocks_per_sm": out[3]}


def rasterize_bwd_attributes(n_channels: int, tile_size: int = 16):
    """`kernel_attributes` of the K3 kernel."""
    return kernel_attributes(_bwd_lib(), "gsl_rasterize_bwd_attributes",
                             n_channels, tile_size)


def backward_by_channel_groups(bwd_group, channels, g_out, n_geom: int,
                               group: int, first_only=()):
    """A backward kernel's rows [n, n_geom + C] for any channel count C,
    from calls of `bwd_group(channels_g, g_out_g, *cotangents)` on groups
    of at most `group` consecutive channels, each returning rows
    [n, n_geom + C_g]. A row's channel columns depend on their own
    channels only, and its geometry columns are linear in the cotangents:
    so each group's channel columns are its own, and the geometry columns
    are the groups' sum, added in group order (the same rows in every
    run). The cotangents of what is not a channel (`first_only`: alpha;
    for the surfels, alpha, depth and distortion) go to the first group,
    zeros to the others. With C <= group, one call on the inputs as
    given."""
    C = channels.shape[1]
    if group < 1:
        raise ValueError(f"channel group of {group}")
    if C <= group:
        return bwd_group(channels, g_out, *first_only)
    zeros = tuple(torch.zeros_like(t) for t in first_only)
    rows = None
    for c0 in range(0, C, group):
        c1 = min(C, c0 + group)
        part = bwd_group(channels[:, c0:c1].contiguous(),
                         g_out[..., c0:c1].contiguous(),
                         *(first_only if c0 == 0 else zeros))
        if rows is None:
            rows = part.new_empty((part.shape[0], n_geom + C))
            rows[:, :n_geom] = part[:, :n_geom]
        else:
            rows[:, :n_geom] += part[:, :n_geom]
        rows[:, n_geom + c0:n_geom + c1] = part[:, n_geom:]
    return rows


def bwd_group_size(group, max_group: int, name: str,
                   default=None) -> int:
    """The channels a backward launch takes: `group`, or where None
    `default` (the kernel's largest where that is None too), at most the
    kernel's `max_group` (what its block's shared memory holds)."""
    want = default if group is None else group
    g = max_group if want is None else min(int(want), max_group)
    if g < 1:
        raise ValueError(f"{name}: no channel group fits this tile size")
    return g


def rasterize_bwd(means2d, conics, opacities, channels, gids, bounds,
                  g_out, g_alpha, t_final, i_stop, tile_size: int = 16,
                  contract: bool = True, group=None):
    """Kernel K3 on CUDA tensors, `rasterize_bwd_plain` on CPU tensors.
    Any channel count: one launch per group of up to `group` channels
    (`bwd_group_size`: K3_GROUP by default, at most
    `rasterize_bwd_max_group(tile_size)`), the groups joined by
    `backward_by_channel_groups`; one launch for C <= the group. Returns
    rows [len(gids), 6 + C].

    `contract=False` launches a build of the same source without
    multiply-add contraction. The kernel contracts sigma and the gradient
    terms to multiply-adds and the plain version does not, so where alpha
    sits within a rounding of the 1/255 skip the two take different
    decisions; the uncontracted build rounds as the plain version does, and
    the checks on the card hold the source's arithmetic to it through that
    build."""
    if not means2d.is_cuda:
        return rasterize_bwd_plain(means2d, conics, opacities, channels,
                                   gids, bounds, g_out, g_alpha, t_final,
                                   i_stop, tile_size)
    f32 = [means2d, conics, opacities, channels, g_out, g_alpha, t_final]
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError("rasterize_bwd: means2d, conics, opacities, "
                        "channels, g_out, g_alpha and t_final must be "
                        "float32")
    if (gids.dtype != torch.int32 or bounds.dtype != torch.int64
            or i_stop.dtype != torch.int32):
        raise TypeError("rasterize_bwd: gids and i_stop must be int32, "
                        "bounds int64")
    if (tile_size * tile_size) % 32:
        raise ValueError("rasterize_bwd: tile_size^2 must be a multiple of "
                         "32 (whole warps)")
    dev = _check_cuda("rasterize_bwd", *f32, gids, bounds, i_stop)
    img_height, img_width, C = g_out.shape
    if channels.shape[1] != C or t_final.shape != (img_height, img_width):
        raise ValueError("rasterize_bwd: cotangent shapes do not match the "
                         "forward's")
    tiles_x, tiles_y = _tiles(img_height, img_width, tile_size)
    lib = _bwd_lib(() if contract else cuda_build.NO_CONTRACTION)

    def launch(ch, g_o, g_a):
        cg = ch.shape[1]
        # zeroed: the kernel writes only positions before a tile's largest
        # stop
        rows = torch.zeros((gids.numel(), 6 + cg), dtype=torch.float32,
                           device=dev)
        code = lib.gsl_rasterize_bwd(
            _ptr(means2d), _ptr(conics), _ptr(opacities), _ptr(ch), cg,
            _ptr(gids), _ptr(bounds), tiles_x * tiles_y, tiles_x, tile_size,
            img_height, img_width, _ptr(g_o), _ptr(g_a), _ptr(t_final),
            _ptr(i_stop), _ptr(rows), _stream(dev))
        cuda_build.check(lib, code, "rasterize_bwd")
        rasterize_bwd.launches += 1
        return rows

    return backward_by_channel_groups(
        launch, channels, g_out, N_GEOM,
        bwd_group_size(group, lib.gsl_rasterize_bwd_max_group(tile_size),
                       "rasterize_bwd", K3_GROUP), (g_alpha,))


rasterize_bwd.launches = 0


def reduce_grads_plain(rows, gids, n: int, n_abs: int = 2):
    """Plain PyTorch version of kernel K4: `index_add_` of the rows, and of
    the absolute values of their first `n_abs` columns, by Gaussian id.
    rows [n_rows, R], gids [n_rows] -> [n, R + n_abs]. With n_abs = 2 and
    K3's rows (R = 6 + C) the columns are dmx dmy da db dc dop |dmx| |dmy|
    channels; with n_abs = 0 the sums keep the rows' columns. Rows of
    invalid slots (sorted behind the valid ones) are zero, as the backward
    kernels leave them, and add nothing."""
    full = _with_absolute_columns(rows, n_abs)
    out = torch.zeros((n, full.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    return out.index_add_(0, gids.long(), full)


def _with_absolute_columns(rows, n_abs: int):
    """rows with the absolute values of their first `n_abs` columns placed
    behind column N_GEOM: K4's output columns."""
    if not n_abs:
        return rows
    return torch.cat([rows[:, :N_GEOM], rows[:, :n_abs].abs(),
                      rows[:, N_GEOM:]], 1)


def reduce_grads_slot_order(rows, offsets, inv_order, n_valid, n: int,
                            n_abs: int = 2):
    """K4's sums in the order K4 adds them, for holding it bit for bit:
    per Gaussian, from 0, the rows of its valid slots one after another in
    slot order, each addition rounded to float32 (`reduce_grads_plain`
    adds in another order). A slot without a row (sorted position >=
    n_valid) adds nothing. Arguments as `reduce_grads`'s."""
    full = _with_absolute_columns(rows, n_abs)
    total = inv_order.numel()
    counts = torch.diff(offsets, append=offsets.new_tensor([total]))
    out = torch.zeros((n, full.shape[1]), dtype=torch.float32,
                      device=rows.device)
    for k in range(int(counts.max()) if n else 0):
        g = torch.nonzero(counts > k)[:, 0]
        pos = inv_order[offsets[g] + k].long()
        keep = pos < n_valid
        out[g[keep]] = out[g[keep]] + full[pos[keep]]
    return out


def _reduce_lib():
    lib = cuda_build.load("reduce_grads")
    lib.gsl_reduce_grads.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.gsl_reduce_grads.restype = ctypes.c_int
    lib.gsl_reduce_grads_attributes.argtypes = [ctypes.c_int, ctypes.c_int,
                                                ctypes.c_void_p]
    lib.gsl_reduce_grads_attributes.restype = ctypes.c_int
    return lib


def reduce_grads_attributes(n_cols: int, n_abs: int = 2):
    """`kernel_attributes` of the K4 kernel for rows of `n_cols` columns."""
    return kernel_attributes(_reduce_lib(), "gsl_reduce_grads_attributes",
                             n_cols, n_abs)


def reduce_grads(rows, gids, offsets, inv_order, n_valid, n: int,
                 n_abs: int = 2):
    """Kernel K4 on CUDA tensors, `reduce_grads_plain` on CPU tensors.
    rows [n_rows, R] per sorted position, zero behind the valid ones;
    gids [n_rows] the sorted ids (the plain version's index); offsets [n]
    int64 each Gaussian's first slot; inv_order [total] int32 each slot's
    sorted position; n_valid [1] int64 on the device (``bounds[-1:]``), so
    no host read is needed. `n_abs`: how many leading columns also get
    their absolute sums, placed behind column N_GEOM (2 for the AbsGS
    statistic of K3's rows, 0 for the surfel rows). Returns
    [n, R + n_abs]."""
    if not rows.is_cuda:
        return reduce_grads_plain(rows, gids, n, n_abs)
    if (rows.dtype != torch.float32 or offsets.dtype != torch.int64
            or inv_order.dtype != torch.int32
            or n_valid.dtype != torch.int64):
        raise TypeError("reduce_grads: rows must be float32, offsets and "
                        "n_valid int64, inv_order int32")
    if offsets.numel() != n or rows.shape[0] > inv_order.numel():
        raise ValueError("reduce_grads: offsets must have one entry per "
                         "Gaussian and inv_order one per slot")
    if n_abs and not n_abs <= N_GEOM <= rows.shape[1]:
        raise ValueError("reduce_grads: absolute sums need rows with the "
                         f"{N_GEOM} geometry columns in front")
    dev = _check_cuda("reduce_grads", rows, offsets, inv_order, n_valid)
    out = torch.empty((n, rows.shape[1] + n_abs), dtype=torch.float32,
                      device=dev)
    lib = _reduce_lib()
    code = lib.gsl_reduce_grads(
        _ptr(rows), rows.shape[1], n_abs, _ptr(offsets), inv_order.numel(),
        _ptr(inv_order), _ptr(n_valid), n, _ptr(out), _stream(dev))
    cuda_build.check(lib, code, "reduce_grads")
    if n:
        reduce_grads.launches += 1
    return out


reduce_grads.launches = 0


def _stp():
    # rasterize_stp imports this module's helpers, so it is imported late
    from . import rasterize_stp
    return rasterize_stp


class _Rasterize(torch.autograd.Function):
    """expand -> sort -> ranges -> K2 with K3 + K4 as its gradient; with
    `stp_resort`, K2s with K3s + K4 (``ops/rasterize_stp.py``).

    Differentiable inputs: means2d, conics, opacities, channels and
    absgrad_tap [N, 2], whose "gradient" is the AbsGS statistic (the sum
    over tiles of |per-(tile, Gaussian) mean gradient|), as in
    ``rasterize_pallas``. depths, depth_grads and radii only order and
    place the splats and carry no gradient. `checkpoints`: a backward will
    follow (K3s needs the forward's per-window T). `info` is filled with
    n_isects, t_final and i_stop."""

    @staticmethod
    def forward(ctx, means2d, conics, opacities, channels, absgrad_tap,
                depths, depth_grads, radii, img_height, img_width,
                tile_size, tile_based_culling, stp_resort, checkpoints,
                info):
        tiles_x, tiles_y = _tiles(img_height, img_width, tile_size)
        means2d = means2d.contiguous()
        conics = conics.contiguous()
        opacities = opacities.contiguous()
        channels = channels.contiguous()
        depths = depths.contiguous()
        if stp_resort:
            depth_grads = depth_grads.contiguous()
        proj = Projections(means2d=means2d, depths=depths, radii=radii,
                           conics=conics, compensations=None, mask=None)
        isects = isect_encode(proj, img_height, img_width, tile_size)
        with span("raster.expand"):
            keys, gids = expand(isects, means2d, conics, opacities, depths,
                                tiles_x, tiles_y, tile_size,
                                tile_based_culling, stp_resort, depth_grads)
        with span("raster.sort"):
            sorted_keys, gids_sorted, order = sort_slots(keys, gids)
        with span("raster.tile_bounds"):
            bounds = tile_bounds(sorted_keys, tiles_x * tiles_y)
        ckpt = None
        with span("raster.fwd"):
            if stp_resort:
                out, t_fin, i_stop, ckpt = _stp().rasterize_fwd_stp(
                    means2d, conics, opacities, channels, depths,
                    depth_grads, gids_sorted, bounds, img_height, img_width,
                    tile_size, checkpoints=checkpoints)
            else:
                out, t_fin, i_stop = rasterize_fwd(
                    means2d, conics, opacities, channels, gids_sorted,
                    bounds, img_height, img_width, tile_size)
        info.update(n_isects=isects.n_isects, t_final=t_fin, i_stop=i_stop)
        ctx.save_for_backward(means2d, conics, opacities, channels,
                              gids_sorted, bounds, t_fin, i_stop, order,
                              isects.offsets, depths, depth_grads, ckpt)
        ctx.tile_size = tile_size
        ctx.stp_resort = stp_resort
        return out, 1.0 - t_fin

    @staticmethod
    def backward(ctx, g_out, g_alpha):
        (means2d, conics, opacities, channels, gids_sorted, bounds, t_fin,
         i_stop, order, offsets, depths, depth_grads,
         ckpt) = ctx.saved_tensors
        n = means2d.shape[0]
        # on autograd's own thread where the tensors are on the card
        with span("raster.backward"):
            # invalid keys sort last: the valid slots are the first
            # bounds[-1], and the rows behind them stay zero
            with span("raster.bwd"):
                if ctx.stp_resort:
                    rows = _stp().rasterize_bwd_stp(
                        means2d, conics, opacities, channels, depths,
                        depth_grads, gids_sorted, bounds, g_out.contiguous(),
                        g_alpha.contiguous(), t_fin, ckpt, ctx.tile_size)
                else:
                    rows = rasterize_bwd(
                        means2d, conics, opacities, channels, gids_sorted,
                        bounds, g_out.contiguous(), g_alpha.contiguous(),
                        t_fin, i_stop, ctx.tile_size)
            with span("raster.reduce"):
                summed = reduce_grads(rows, gids_sorted, offsets,
                                      invert_order(order), bounds[-1:], n)
            return (summed[:, 0:2], summed[:, 2:5], summed[:, 5],
                    summed[:, 8:], summed[:, 6:8]) + (None,) * 10


def rasterize(projections: Projections, opacities, channels,
              img_height: int, img_width: int, tile_size: int = 16,
              tile_based_culling: bool = True, absgrad_tap=None,
              stp_resort: bool = False):
    """Rasterize projected splats front to back; differentiable in
    projections.means2d, projections.conics, opacities and channels.

    projections supplies means2d, conics, depths (sort key) and radii (tile
    rectangles); opacities [N]; channels [N, C] with any C. The gradient
    that arrives at `absgrad_tap` ([N, 2] zeros) is the AbsGS statistic.
    `stp_resort` is StopThePop: slots keyed by the depth plane
    (projections.depth_grads) at the tile centre, every pixel re-sorting
    windows of 16 by its own depth, and no transmittance stop
    (``ops/rasterize_stp.py``).
    Returns (img_nobg [H, W, C] without background, alpha [H, W], aux).
    Blend a background as ``img + (1 - alpha)[..., None] * bg``."""
    if absgrad_tap is None:
        absgrad_tap = torch.zeros_like(projections.means2d)
    depth_grads = None
    if stp_resort:
        if projections.depth_grads is None:
            raise ValueError("rasterize: stp_resort needs "
                             "projections.depth_grads")
        depth_grads = projections.depth_grads.detach()
    differentiable = (projections.means2d, projections.conics, opacities,
                      channels, absgrad_tap)
    wants_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in differentiable)
    info = {}
    out, alpha = _Rasterize.apply(
        projections.means2d, projections.conics, opacities, channels,
        absgrad_tap, projections.depths.detach(), depth_grads,
        projections.radii, img_height, img_width, tile_size,
        tile_based_culling, stp_resort, stp_resort and wants_grad, info)
    aux = RasterAux(n_isects=info["n_isects"], n_dropped=0,
                    t_final=info["t_final"], i_stop=info["i_stop"])
    return out, alpha, aux
