"""2DGS surfel rasterizer: expand -> sort -> tile ranges -> composite, and
its hand-derived gradient.

Port of ``gsl_tpu/ops/surfel_pallas.py`` (``_expand_sorted_s``,
``_fwd_impl_s`` and the custom VJP ``_surfel_bwd``) with the compositing
semantics of the oracle ``gsl_tpu/ops/surfel.py::rasterize_surfels``. It
shares the slot layout, the sort and the tile ranges with the 3DGS
rasterizer (``ops/rasterize.py``):

1. `surfel_isect_encode`: tile rectangles from the surfels' centers and
   radii (an isotropic 9 / r^2 conic makes `tile_rect` return the
   radius-r box) and int64 slot offsets; one host read sizes the buffers,
   so no slot is ever dropped.
2. `surfel_expand` (kernel K5, ``csrc/surfel_expand.cu``): per slot the key
   ``(tile << 32) | bits(max(depth, 0))`` and the surfel id. There is no
   peak-alpha cull on this path.
3. `sort_slots`, `tile_bounds` of ``ops/rasterize.py``. The key keeps all
   32 depth bits, so the order is the oracle's exact (tile, depth, slot)
   order; the Pallas kernel packs ``32 - tile_bits`` of them.
4. `rasterize_surfels_fwd` (kernel K6, ``csrc/surfel_fwd.cu``): per pixel
   and surfel the ray-splat plane-cross solve, the screen-space low-pass,
   and front-to-back compositing of the channels, expected depth, median
   depth and depth distortion.
5. `rasterize_surfels_bwd` (kernel K7, ``csrc/surfel_bwd.cu``): each
   tile's list walked back from the pixels' stops; one gradient row of
   13 + C values per sorted slot.
6. `reduce_grads` (kernel K4): the rows summed per surfel.

`rasterize_surfels` ties them into one differentiable op
(`_RasterizeSurfels`). The kernels read the per-surfel geometry as one
table ``geom [N, 13]`` = Tu, Tv, Tw, zcoef (zu, zv, z0), opacity
(`pack_surfels`), and the gradient rows have the same columns followed by
the C channels.

The backward, per (pixel, surfel) pair walking a list back to front
(A, M1, M2: the forward's final sums of w, w m, w m^2 over the pixel's
composited surfels; m the NDC-mapped depth):

    T_exc  = T / (1 - a)
    w      = a T_exc
    dw     = g . ch + g_depth depth
             + g_dist (m^2 (A - w) + (M2 - w m^2) - 2 m (M1 - w m))
    dalpha = T_exc dw - S / max(1 - a, 1e-3),   S += w dw,
             S starts at -T_final g_alpha
    ddepth = w (g_depth + 2 g_dist (m (A - w) - (M1 - w m)) dm/dd)

then through alpha = min(0.99, op G), G = exp(-rho / 2),
rho = min(rho3d, rho2d), the plane cross s = hx x hy (dhx = hy x ds,
dhy = ds x hx) and hx_i = px T_i[2] - T_i[0], hy_i = py T_i[2] - T_i[1]
into the nine T entries; depth = z0 + u zu + v zv into zcoef where the 3D
branch won, z0 alone otherwise.

The distortion sum_i sum_{j<i} w_i w_j (m_i - m_j)^2 is symmetric in its
pairs, so its derivative by w_i runs over every other surfel of the pixel,
in front and behind: the reference's prefix (total - suffix - self) plus
suffix is the total less the surfel itself, and no suffix sums are kept.

Each kernel wrapper launches its CUDA kernel for CUDA tensors, or raises,
and runs its plain PyTorch version (``surfel_expand_plain``,
``rasterize_surfels_fwd_plain``, ``rasterize_surfels_bwd_plain``) for CPU
tensors. ``<wrapper>.launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_build
from .projection import Projections
from .rasterize import (MIN_ONE_MINUS_ALPHA, NEVER_STOPPED, PLAIN_CHUNK,
                        PLAIN_TILE_GROUP, Isects, _check_cuda,
                        _image_to_tiles, _ptr, _stream, _tiles,
                        _tiles_to_image, invert_order, isect_encode,
                        kernel_attributes, reduce_grads, slot_keys,
                        slot_tiles, slot_warps, sort_slots, tile_bounds)
from .rasterize_reference import ALPHA_THRESHOLD, MIN_TRANSMITTANCE
from .surfel import (FAR_2D, FILTER_INV_SQUARE, MAX_ALPHA_2D, NEAR_2D,
                     SurfelProjections, SurfelRenderResult, _map_depth)

N_GEOM_S = 13        # Tu(3) Tv(3) Tw(3) zcoef(3) opacity(1)
SZ_EPS = 1e-12       # below it the plane-cross solve is degenerate
# planes of the forward's aux [7, H, W]
AUX_T, AUX_DEPTH, AUX_MEDIAN, AUX_DIST, AUX_A, AUX_M1, AUX_M2 = range(7)


class SurfelRasterAux(NamedTuple):
    n_isects: int             # tile intersections
    n_slots: int              # sort slots, dummies included
    i_stop: torch.Tensor      # [H, W] int32 sorted position of the stop


def surfel_isect_encode(means2d, depths, radii, img_height: int,
                        img_width: int, tile_size: int) -> Isects:
    """Tile rectangles of radius-r boxes around the projected centers."""
    r2 = torch.clamp(radii.to(torch.float32), min=1.0) ** 2
    iso = 9.0 / r2
    shim = Projections(
        means2d=means2d, depths=depths, radii=radii,
        conics=torch.stack([iso, torch.zeros_like(iso), iso], dim=-1),
        compensations=None, mask=None)
    return isect_encode(shim, img_height, img_width, tile_size)


def pack_surfels(Tu, Tv, Tw, zcoef, opacities):
    """[N, 13] float32 table the kernels gather from."""
    return torch.cat([Tu, Tv, Tw, zcoef, opacities[:, None]], 1).contiguous()


def surfel_expand_plain(isects: Isects, depths, tiles_x: int, tiles_y: int):
    """Plain PyTorch version of kernel K5. Returns (keys [total] int64,
    gids [total] int32) in slot order."""
    gid, t_x, t_y, valid = slot_tiles(isects, tiles_y)
    keys = slot_keys(valid, t_x, t_y, tiles_x, depths, gid)
    return keys, gid.to(torch.int32)


def _expand_lib():
    lib = cuda_build.load("surfel_expand")
    lib.gsl_expand_surfel.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
    lib.gsl_expand_surfel.restype = ctypes.c_int
    return lib


def surfel_expand(isects: Isects, depths, tiles_x: int, tiles_y: int):
    """Kernel K5 on CUDA tensors, `surfel_expand_plain` on CPU tensors.
    Returns (keys [total] int64, gids [total] int32) in slot order."""
    if not depths.is_cuda:
        return surfel_expand_plain(isects, depths, tiles_x, tiles_y)
    if depths.dtype != torch.float32:
        raise TypeError("surfel_expand: depths must be float32")
    dev = _check_cuda("surfel_expand", isects.offsets, isects.rect, depths)
    n = depths.shape[0]
    keys = torch.empty(isects.total, dtype=torch.int64, device=dev)
    gids = torch.empty(isects.total, dtype=torch.int32, device=dev)
    lib = _expand_lib()
    code = lib.gsl_expand_surfel(
        _ptr(isects.offsets), _ptr(isects.rect), _ptr(depths), n, tiles_x,
        tiles_y, _ptr(keys), _ptr(gids), _stream(dev))
    cuda_build.check(lib, code, "surfel_expand")
    if n:
        surfel_expand.launches += 1
    return keys, gids


surfel_expand.launches = 0


def _pixel_centers(tl, tiles_x: int, tile_size: int):
    p = torch.arange(tile_size * tile_size, device=tl.device)
    px = ((tl % tiles_x)[:, None] * tile_size + p % tile_size
          ).to(torch.float32) + 0.5                           # [G, P]
    py = ((tl // tiles_x)[:, None] * tile_size + p // tile_size
          ).to(torch.float32) + 0.5
    return px, py


def _surfel_terms(gm, px, py):
    """The ray-splat solve of one surfel per tile against the tile's
    pixels. gm [G, 13]; px, py [G, P]. Returns a dict of [G, P] (or
    [G, 1]) terms."""
    col = [gm[:, i:i + 1] for i in range(N_GEOM_S)]
    T3 = (col[0:3], col[3:6], col[6:9])
    zc, op = col[9:12], col[12]
    hx = [px * t[2] - t[0] for t in T3]                # u, v, w
    hy = [py * t[2] - t[1] for t in T3]
    sx = hx[1] * hy[2] - hx[2] * hy[1]
    sy = hx[2] * hy[0] - hx[0] * hy[2]
    sz = hx[0] * hy[1] - hx[1] * hy[0]
    sz_ok = sz.abs() >= SZ_EPS
    cz = torch.where(sz_ok, sz, torch.ones_like(sz))
    u = sx / cz
    v = sy / cz
    rho3d = u * u + v * v

    Tw = T3[2]
    twz_s = torch.where(Tw[2] == 0, torch.ones_like(Tw[2]), Tw[2])
    dxp = px - Tw[0] / twz_s
    dyp = py - Tw[1] / twz_s
    rho2d = FILTER_INV_SQUARE * (dxp * dxp + dyp * dyp)
    use3d = rho3d <= rho2d
    rho = torch.minimum(rho3d, rho2d)
    # the center depth where the 2D low-pass branch wins: a near-degenerate
    # solve puts u, v near 1e24 while the filter keeps alpha alive
    depth = torch.where(use3d, zc[2] + u * zc[0] + v * zc[1], zc[2])
    G = torch.exp(-0.5 * rho)
    raw = op * G
    alpha = torch.clamp(raw, max=MAX_ALPHA_2D)
    keep = (alpha >= ALPHA_THRESHOLD) & sz_ok & (depth >= NEAR_2D)
    return dict(hx=hx, hy=hy, cz=cz, u=u, v=v, use3d=use3d, dxp=dxp,
                dyp=dyp, twz_s=twz_s, Tw=Tw, zc=zc, op=op, G=G, raw=raw,
                alpha=alpha, keep=keep, depth=depth)


def rasterize_surfels_fwd_plain(geom, channels, gids, bounds,
                                img_height: int, img_width: int,
                                tile_size: int):
    """Plain PyTorch version of kernel K6 with the oracle's sequential
    per-surfel arithmetic. Returns (out [H, W, C], aux [7, H, W] with the
    planes T, sum w depth, median depth, distortion and the final A, M1,
    M2, i_stop [H, W] int32)."""
    dev = geom.device
    tiles_x, tiles_y = _tiles(img_height, img_width, tile_size)
    n_tiles = tiles_x * tiles_y
    P = tile_size * tile_size
    C = channels.shape[1]
    out = torch.zeros((n_tiles, P, C), dtype=torch.float32, device=dev)
    aux = torch.zeros((n_tiles, P, 7), dtype=torch.float32, device=dev)
    aux[..., AUX_T] = 1.0
    stop = torch.full((n_tiles, P), NEVER_STOPPED, dtype=torch.int64,
                      device=dev)
    lane = torch.arange(PLAIN_CHUNK, device=dev)
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    for t0 in range(0, n_tiles, PLAIN_TILE_GROUP):
        tl = torch.arange(t0, min(t0 + PLAIN_TILE_GROUP, n_tiles),
                          device=dev)
        px, py = _pixel_centers(tl, tiles_x, tile_size)
        st, cnt = starts[tl], counts[tl]
        T = torch.ones_like(px)
        zero = torch.zeros_like(px)
        acc = torch.zeros((len(tl), P, C), dtype=torch.float32, device=dev)
        dacc, med, dist, A, M1, M2 = (zero.clone() for _ in range(6))
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
            gm, col = geom[g], channels[g]            # [G,K,13], [G,K,C]
            for j in range(PLAIN_CHUNK):
                t = _surfel_terms(gm[:, j], px, py)
                alpha, depth = t["alpha"], t["depth"]
                live = in_rng[:, j:j + 1] & ~done & t["keep"]
                next_t = T * (1.0 - alpha)
                brk = live & (next_t <= MIN_TRANSMITTANCE)
                brk_at = torch.where(brk, pos[:, j:j + 1], brk_at)
                done = done | brk
                comp = live & ~brk
                w = torch.where(comp, alpha * T, zero)
                acc = acc + w[..., None] * col[:, j, None, :]
                dacc = dacc + w * depth
                crossed = comp & (T > 0.5) & (next_t <= 0.5)
                med = torch.where(crossed, depth, med)
                m = torch.where(comp, _map_depth(depth), zero)
                wm = w * m
                wm2 = wm * m
                dist = dist + w * (m * m * A + M2 - 2.0 * m * M1)
                A = A + w
                M1 = M1 + wm
                M2 = M2 + wm2
                T = torch.where(comp, next_t, T)
        out[tl], stop[tl] = acc, brk_at
        aux[tl] = torch.stack([T, dacc, med, dist, A, M1, M2], -1)

    dims = (tiles_x, tiles_y, tile_size, img_height, img_width)
    return (_tiles_to_image(out, *dims),
            _tiles_to_image(aux, *dims).permute(2, 0, 1).contiguous(),
            _tiles_to_image(stop, *dims)[..., 0].to(torch.int32))


def _fwd_lib(extra: tuple = ()):
    lib = cuda_build.load("surfel_fwd", extra)
    lib.gsl_rasterize_surfels_fwd.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4)
    lib.gsl_rasterize_surfels_fwd.restype = ctypes.c_int
    lib.gsl_rasterize_surfels_fwd_max_group.restype = ctypes.c_int
    lib.gsl_rasterize_surfels_fwd_attributes.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.gsl_rasterize_surfels_fwd_attributes.restype = ctypes.c_int
    return lib


def rasterize_surfels_fwd_attributes(n_channels: int, tile_size: int = 16):
    """`kernel_attributes` of the K6 kernel that composites
    min(n_channels, 8) channels a launch."""
    return kernel_attributes(_fwd_lib(),
                             "gsl_rasterize_surfels_fwd_attributes",
                             n_channels, tile_size)


def rasterize_surfels_fwd(geom, channels, gids, bounds, img_height: int,
                          img_width: int, tile_size: int = 16,
                          contract: bool = True):
    """Kernel K6 on CUDA tensors, `rasterize_surfels_fwd_plain` on CPU
    tensors. One launch per group of up to 8 channels (one launch for
    C <= 8, as on the renderer's C = 6 path), as K2 does; every launch
    repeats the solve and writes the same aux and i_stop, so a forward
    with C > 8 costs ceil(C / 8) times one launch. Returns
    (out [H, W, C], aux [7, H, W], i_stop [H, W] int32). `contract=False`:
    see `rasterize_surfels_bwd`."""
    if not geom.is_cuda:
        return rasterize_surfels_fwd_plain(geom, channels, gids, bounds,
                                           img_height, img_width, tile_size)
    if geom.dtype != torch.float32 or channels.dtype != torch.float32:
        raise TypeError("rasterize_surfels_fwd: geom and channels must be "
                        "float32")
    if gids.dtype != torch.int32 or bounds.dtype != torch.int64:
        raise TypeError("rasterize_surfels_fwd: gids must be int32, bounds "
                        "int64")
    if geom.ndim != 2 or geom.shape[1] != N_GEOM_S:
        raise ValueError(f"rasterize_surfels_fwd: geom must be "
                         f"[N, {N_GEOM_S}]")
    if gids.numel() >= NEVER_STOPPED:
        raise ValueError("rasterize_surfels_fwd: more than 2^30 sorted "
                         "slots collide with the i_stop sentinel")
    if (tile_size * tile_size) % 32:
        raise ValueError("rasterize_surfels_fwd: tile_size^2 must be a "
                         "multiple of 32 (whole warps)")
    dev = _check_cuda("rasterize_surfels_fwd", geom, channels, gids, bounds)
    tiles_x, tiles_y = _tiles(img_height, img_width, tile_size)
    C = channels.shape[1]
    out = torch.empty((img_height, img_width, C), dtype=torch.float32,
                      device=dev)
    aux = torch.empty((7, img_height, img_width), dtype=torch.float32,
                      device=dev)
    i_stop = torch.empty((img_height, img_width), dtype=torch.int32,
                         device=dev)
    lib = _fwd_lib(() if contract else cuda_build.NO_CONTRACTION)
    group = lib.gsl_rasterize_surfels_fwd_max_group()
    for c0 in range(0, C, group):
        code = lib.gsl_rasterize_surfels_fwd(
            _ptr(geom), _ptr(channels), C, c0, min(group, C - c0),
            _ptr(gids), _ptr(bounds), tiles_x * tiles_y, tiles_x, tile_size,
            img_height, img_width, _ptr(out), _ptr(aux), _ptr(i_stop),
            _stream(dev))
        cuda_build.check(lib, code, "rasterize_surfels_fwd")
        rasterize_surfels_fwd.launches += 1
    return out, aux, i_stop


rasterize_surfels_fwd.launches = 0


def _dmap_ddepth(d):
    dm = FAR_2D * NEAR_2D / ((FAR_2D - NEAR_2D)
                             * torch.clamp(d, min=1e-6) ** 2)
    return torch.where(d > 1e-6, dm, torch.zeros_like(dm))


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def rasterize_surfels_bwd_plain(geom, channels, gids, bounds, g_out, g_aux,
                                aux, i_stop, tile_size: int,
                                stats: dict | None = None):
    """Plain PyTorch version of kernel K7, the same arithmetic per
    (pixel, surfel) pair. g_out [H, W, C] is the cotangent of the
    composited channels, g_aux [3, H, W] those of alpha, sum w depth and
    the distortion; aux and i_stop are the forward's. Returns rows
    [len(gids), 13 + C]: per sorted position the sums over its tile's
    pixels of d/d(Tu, Tv, Tw, zcoef, opacity, channels); rows at or behind
    a tile's largest stop stay zero. With `stats`, leaves the count of
    composited (pixel, surfel) pairs in ``stats["composited_pairs"]`` and
    that of (slot, warp)s with at least one such pixel (`slot_warps`) in
    ``stats["composited_slot_warps"]``."""
    dev = geom.device
    img_height, img_width, C = g_out.shape
    tiles_x, tiles_y = _tiles(img_height, img_width, tile_size)
    n_tiles = tiles_x * tiles_y
    R = N_GEOM_S + C
    rows = torch.zeros((gids.numel(), R), dtype=torch.float32, device=dev)

    def tiles_of(x):   # [K, H, W] -> [n_tiles, P, K]
        return _image_to_tiles(x.permute(1, 2, 0), tiles_x, tiles_y,
                               tile_size)

    gt = _image_to_tiles(g_out, tiles_x, tiles_y, tile_size)
    ga_t, aux_t = tiles_of(g_aux), tiles_of(aux)
    # padding pixels get stop 0: no position lies before it
    stops = tiles_of(i_stop[None].to(torch.int64))[..., 0]
    lane = torch.arange(PLAIN_CHUNK, device=dev)
    n_comp = torch.zeros((), dtype=torch.int64, device=dev)
    n_warps = torch.zeros((), dtype=torch.int64, device=dev)
    for t0 in range(0, n_tiles, PLAIN_TILE_GROUP):
        tl = torch.arange(t0, min(t0 + PLAIN_TILE_GROUP, n_tiles),
                          device=dev)
        px, py = _pixel_centers(tl, tiles_x, tile_size)
        st, end = bounds[tl], bounds[tl + 1]
        stop, g_pix = stops[tl], gt[tl]                   # [G, P], [G, P, C]
        g_alpha, gd, gD = (ga_t[tl][..., i] for i in range(3))
        fin = aux_t[tl]
        T = fin[..., AUX_T]
        Afin, M1fin, M2fin = (fin[..., AUX_A], fin[..., AUX_M1],
                              fin[..., AUX_M2])
        S = -T * g_alpha
        zero = torch.zeros_like(T)
        # nothing at or behind the largest stop of a tile was composited
        last = torch.minimum(end, stop.max(dim=1).values)
        cnt = torch.clamp(last - st, min=0)
        max_cnt = int(cnt.max()) if len(tl) else 0
        for k0 in reversed(range(0, max_cnt, PLAIN_CHUNK)):
            pos = st[:, None] + k0 + lane                     # [G, K]
            in_rng = (k0 + lane)[None, :] < cnt[:, None]
            g = gids[torch.where(in_rng, pos, 0)].long()
            gm, col = geom[g], channels[g]
            part = torch.zeros((len(tl), PLAIN_CHUNK, R),
                               dtype=torch.float32, device=dev)
            for j in reversed(range(PLAIN_CHUNK)):
                t = _surfel_terms(gm[:, j], px, py)
                comp = (in_rng[:, j:j + 1] & (pos[:, j:j + 1] < stop)
                        & t["keep"])
                a = torch.where(comp, t["alpha"], zero)
                one_minus = 1.0 - a
                t_exc = T / one_minus
                w = a * t_exc
                depth, u, v = t["depth"], t["u"], t["v"]
                m = torch.where(comp, _map_depth(depth), zero)
                wm = w * m
                wm2 = wm * m
                cg = (g_pix * col[:, j, None, :]).sum(-1)         # [G, P]
                A_all = Afin - w            # every other surfel's sums
                M1_all = M1fin - wm
                M2_all = M2fin - wm2
                dw = (cg + gd * depth
                      + gD * (m * m * A_all + M2_all - 2.0 * m * M1_all))
                dalpha = torch.where(
                    comp, t_exc * dw - S / torch.clamp(
                        one_minus, min=MIN_ONE_MINUS_ALPHA), zero)
                ddepth = torch.where(
                    comp, w * (gd + 2.0 * gD * (m * A_all - M1_all)
                               * _dmap_ddepth(depth)), zero)
                S = S + w * dw
                T = t_exc

                nc = t["raw"] < MAX_ALPHA_2D
                dG = torch.where(nc, dalpha * t["op"], zero)
                dop = torch.where(nc & comp, dalpha * t["G"], zero)
                drho = -0.5 * t["G"] * dG
                drho3 = torch.where(t["use3d"], drho, zero)
                drho2 = torch.where(t["use3d"], zero, drho)
                dd3 = torch.where(t["use3d"], ddepth, zero)
                zc, cz = t["zc"], t["cz"]
                du = 2.0 * u * drho3 + dd3 * zc[0]
                dv = 2.0 * v * drho3 + dd3 * zc[1]
                ds = [du / cz, dv / cz, -(du * u + dv * v) / cz]
                dhx = _cross(t["hy"], ds)
                dhy = _cross(ds, t["hx"])
                # the low-pass branch reaches Tw through the projected
                # center
                dcxp = -(FILTER_INV_SQUARE * 2.0 * t["dxp"] * drho2)
                dcyp = -(FILTER_INV_SQUARE * 2.0 * t["dyp"] * drho2)
                twz_s, Tw = t["twz_s"], t["Tw"]
                r = []
                for i in range(3):                     # Tu, Tv, Tw rows
                    d0, d1 = -dhx[i], -dhy[i]
                    d2 = px * dhx[i] + py * dhy[i]
                    if i == 2:
                        d0 = d0 + dcxp / twz_s
                        d1 = d1 + dcyp / twz_s
                        d2 = d2 - (dcxp * Tw[0] + dcyp * Tw[1]) \
                            / (twz_s * twz_s)
                    r += [d0, d1, d2]
                r += [dd3 * u, dd3 * v, ddepth, dop]
                part[:, j, :N_GEOM_S] = torch.stack(r, -1).sum(1)
                part[:, j, N_GEOM_S:] = (w[..., None] * g_pix).sum(1)
                n_comp += comp.sum()
                n_warps += slot_warps(comp[..., None])
            rows[pos[in_rng]] = part[in_rng]
    if stats is not None:
        stats["composited_pairs"] = int(n_comp)
        stats["composited_slot_warps"] = int(n_warps)
    return rows


def _bwd_lib(extra: tuple = ()):
    lib = cuda_build.load("surfel_bwd", extra)
    lib.gsl_rasterize_surfels_bwd.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5)
    lib.gsl_rasterize_surfels_bwd.restype = ctypes.c_int
    lib.gsl_rasterize_surfels_bwd_attributes.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.gsl_rasterize_surfels_bwd_attributes.restype = ctypes.c_int
    return lib


def rasterize_surfels_bwd_attributes(n_channels: int, tile_size: int = 16):
    """`kernel_attributes` of the K7 kernel."""
    return kernel_attributes(_bwd_lib(),
                             "gsl_rasterize_surfels_bwd_attributes",
                             n_channels, tile_size)


def rasterize_surfels_bwd(geom, channels, gids, bounds, g_out, g_aux, aux,
                          i_stop, tile_size: int = 16, contract: bool = True):
    """Kernel K7 on CUDA tensors, `rasterize_surfels_bwd_plain` on CPU
    tensors: one launch for any channel count. Returns rows
    [len(gids), 13 + C].

    `contract=False` launches a build of the same source without
    multiply-add contraction. The solve's hx = px Tw - Tu and hx x hy are
    differences of products far larger than their result, so the usual
    build (contracted, each such difference rounded once) and the plain
    version (every product rounded) differ in a share of the pairs; the
    uncontracted build rounds as the plain version does, and the checks on
    the card hold the source's arithmetic to it through that build."""
    if not geom.is_cuda:
        return rasterize_surfels_bwd_plain(geom, channels, gids, bounds,
                                           g_out, g_aux, aux, i_stop,
                                           tile_size)
    f32 = [geom, channels, g_out, g_aux, aux]
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError("rasterize_surfels_bwd: geom, channels, g_out, "
                        "g_aux and aux must be float32")
    if (gids.dtype != torch.int32 or bounds.dtype != torch.int64
            or i_stop.dtype != torch.int32):
        raise TypeError("rasterize_surfels_bwd: gids and i_stop must be "
                        "int32, bounds int64")
    if (tile_size * tile_size) % 32:
        raise ValueError("rasterize_surfels_bwd: tile_size^2 must be a "
                         "multiple of 32 (whole warps)")
    dev = _check_cuda("rasterize_surfels_bwd", *f32, gids, bounds, i_stop)
    img_height, img_width, C = g_out.shape
    hw = (img_height, img_width)
    if (geom.ndim != 2 or geom.shape[1] != N_GEOM_S
            or channels.shape[1] != C or g_aux.shape != (3,) + hw
            or aux.shape != (7,) + hw or i_stop.shape != hw):
        raise ValueError("rasterize_surfels_bwd: shapes do not match the "
                         "forward's")
    tiles_x, tiles_y = _tiles(img_height, img_width, tile_size)
    # zeroed: the kernel writes only positions before a tile's largest stop
    rows = torch.zeros((gids.numel(), N_GEOM_S + C), dtype=torch.float32,
                       device=dev)
    lib = _bwd_lib(() if contract else cuda_build.NO_CONTRACTION)
    code = lib.gsl_rasterize_surfels_bwd(
        _ptr(geom), _ptr(channels), C, _ptr(gids), _ptr(bounds),
        tiles_x * tiles_y, tiles_x, tile_size, img_height, img_width,
        _ptr(g_out), _ptr(g_aux), _ptr(aux), _ptr(i_stop), _ptr(rows),
        _stream(dev))
    cuda_build.check(lib, code, "rasterize_surfels_bwd")
    rasterize_surfels_bwd.launches += 1
    return rows


rasterize_surfels_bwd.launches = 0


class _RasterizeSurfels(torch.autograd.Function):
    """K5 -> sort -> ranges -> K6 with K7 + K4 as its gradient.

    Differentiable inputs: Tu, Tv, Tw, zcoef, opacities, channels.
    means2d, depths and radii only place and order the surfels and carry
    no gradient. Outputs: channels, alpha, sum w depth, median depth (no
    gradient) and distortion. `info` is filled with n_isects, n_slots and
    i_stop."""

    @staticmethod
    def forward(ctx, Tu, Tv, Tw, zcoef, opacities, channels, means2d,
                depths, radii, img_height, img_width, tile_size, info):
        tiles_x, tiles_y = _tiles(img_height, img_width, tile_size)
        geom = pack_surfels(Tu, Tv, Tw, zcoef, opacities)
        channels = channels.contiguous()
        isects = surfel_isect_encode(means2d, depths, radii, img_height,
                                     img_width, tile_size)
        keys, gids = surfel_expand(isects, depths.contiguous(), tiles_x,
                                   tiles_y)
        sorted_keys, gids_sorted, order = sort_slots(keys, gids)
        bounds = tile_bounds(sorted_keys, tiles_x * tiles_y)
        out, aux, i_stop = rasterize_surfels_fwd(
            geom, channels, gids_sorted, bounds, img_height, img_width,
            tile_size)
        info.update(n_isects=isects.n_isects, n_slots=isects.total,
                    i_stop=i_stop)
        ctx.save_for_backward(geom, channels, gids_sorted, bounds, aux,
                              i_stop, order, isects.offsets)
        ctx.tile_size = tile_size
        median = aux[AUX_MEDIAN]
        ctx.mark_non_differentiable(median)
        return (out, 1.0 - aux[AUX_T], aux[AUX_DEPTH], median,
                aux[AUX_DIST])

    @staticmethod
    def backward(ctx, g_out, g_alpha, g_depth, g_median, g_dist):
        (geom, channels, gids_sorted, bounds, aux, i_stop, order,
         offsets) = ctx.saved_tensors
        n = geom.shape[0]
        rows = rasterize_surfels_bwd(
            geom, channels, gids_sorted, bounds, g_out.contiguous(),
            torch.stack([g_alpha, g_depth, g_dist]), aux, i_stop,
            ctx.tile_size)
        # invalid keys sort last: the valid slots are the first bounds[-1],
        # and the rows behind them stay zero
        s = reduce_grads(rows, gids_sorted, offsets, invert_order(order),
                         bounds[-1:], n, n_abs=0)
        return (s[:, 0:3], s[:, 3:6], s[:, 6:9], s[:, 9:12], s[:, 12],
                s[:, N_GEOM_S:]) + (None,) * 7


def rasterize_surfels(proj: SurfelProjections, opacities, channels,
                      img_height: int, img_width: int, tile_size: int = 16):
    """Rasterize projected surfels front to back; differentiable in
    proj.Tu, proj.Tv, proj.Tw, proj.zcoef, opacities and channels.

    channels [N, C] with any C (rgb + constant per-splat channels),
    composited without background. Returns (SurfelRenderResult,
    SurfelRasterAux)."""
    info = {}
    out, alpha, exp_depth, median, dist = _RasterizeSurfels.apply(
        proj.Tu, proj.Tv, proj.Tw, proj.zcoef, opacities, channels,
        proj.means2d.detach(), proj.depths.detach(), proj.radii,
        img_height, img_width, tile_size, info)
    return (SurfelRenderResult(channels=out, alpha=alpha,
                               exp_depth=exp_depth, median_depth=median,
                               distortion=dist),
            SurfelRasterAux(**info))
