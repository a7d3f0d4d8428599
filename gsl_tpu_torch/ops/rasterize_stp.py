"""StopThePop compositing: every pixel re-sorts each window of its tile's
list by its own depth. Forward, backward, and their plain versions.

Port of the ``stp_resort=True`` branches of
``gsl_tpu/ops/rasterize_pallas.py`` (``_fwd_kernel`` with
``_window_before`` and ``_stp_depths``, ``_bwd_kernel``), exact mode.
`ops.rasterize.expand(stp_resort=True)` keys each (Gaussian, tile) slot by
the Gaussian's depth plane at the tile's centre; this module composites the
sorted stream:

- **Windows.** Sorted position p belongs to window ``p // STP_WINDOW`` of
  the whole sorted stream, wherever its tile's range starts: a tile whose
  range is [37, 90) has the windows [37, 48), [48, 64), [64, 80), [80, 90).
- **Order.** A pixel at (px, py) gives every slot of a window the depth
  ``d_p = depth - kz_x (mean_x - px) - kz_y (mean_y - py)`` (the centre
  depth and the plane's slope `depth_grads`, not the key's depth) and
  composites the window's slots by ascending ``d_p``, ties by position;
  windows follow each other in key order.
- **No stop.** Every slot of the tile's list is composited with
  ``w = a T; T *= 1 - a``; ``i_stop`` is NEVER_STOPPED everywhere. Slots
  with sigma < 0 or alpha < 1/255 take part in the order and add nothing.
- **Gradient.** The order is a constant. Given it,
  ``dalpha_i = T_exc,i (c_i . g) - S_after,i / max(1 - a_i, 1e-3)`` with
  ``S_after,i = -T_final g_alpha + sum_{j after i} a_j T_exc,j (c_j . g)``
  and "after" read in the pixel's own order; from `dalpha` on it is K3's
  arithmetic (``csrc/rasterize_bwd.cu``).

With no stop a dense tile drives T to 0, so the backward cannot rebuild T
by dividing T_final as K3 does. When a gradient is wanted the forward
leaves T at the start of every window of every tile (`checkpoints`,
[n_rows, tile_size^2]; window k of tile t at row ``bounds[t] // 16 + k +
t``, 64 bytes per sorted slot); the backward walks the windows back to
front, recomputes each window's order and T_exc from its checkpoint exactly
as the forward did, and carries only the suffix sum S. Every term is then
a product with T_exc: a slot whose T_exc is 0 gets exactly 0, and nothing
is ever divided by a transmittance.

`rasterize_fwd_stp` (kernel K2s, ``csrc/rasterize_fwd_stp.cu``) and
`rasterize_bwd_stp` (kernel K3s, ``csrc/rasterize_bwd_stp.cu``) launch
their kernels for CUDA tensors, or raise, and run the plain versions for
CPU tensors. ``<wrapper>.launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .cuda_build import check_cuda, kernel_attributes, ptr, stream
from .rasterize import (MIN_ONE_MINUS_ALPHA, N_GEOM, NEVER_STOPPED,
                        _image_to_tiles, _tiles, _tiles_to_image,
                        backward_by_channel_groups, bwd_group_size, skip_cut,
                        slot_warps)
from .rasterize_reference import ALPHA_THRESHOLD, MAX_ALPHA

STP_WINDOW = 16         # sorted positions a pixel re-sorts together
PLAIN_TILE_GROUP = 1024  # plain versions: tiles per group


def checkpoint_rows(n_slots: int, n_tiles: int) -> int:
    """Rows of the checkpoint buffer: a tile's first window may be shared
    with the tile before it, so the windows of all tiles number at most
    n_slots // 16 + n_tiles + 1."""
    return n_slots // STP_WINDOW + n_tiles + 1


def _pixel_centres(tl, tiles_x: int, tile_size: int):
    p = torch.arange(tile_size * tile_size, device=tl.device)
    px = ((tl % tiles_x)[:, None] * tile_size + p % tile_size
          ).to(torch.float32) + 0.5                           # [G, P]
    py = ((tl // tiles_x)[:, None] * tile_size + p // tile_size
          ).to(torch.float32) + 0.5
    return px, py


def _tile_windows(bounds, tl):
    """Per tile of `tl`: range start, range end, first window, count of
    windows its range touches."""
    st, end = bounds[tl], bounds[tl + 1]
    w0 = st // STP_WINDOW
    n_win = torch.where(end > st, (end - 1) // STP_WINDOW - w0 + 1,
                        torch.zeros_like(st))
    return st, end, w0, n_win


class _Window:
    """One window of every tile of a group, for every pixel: [G, P, 16]
    terms of the (pixel, slot) pairs; slots outside the tile's range have
    a = 0."""

    def __init__(self, means2d, conics, opacities, depths, depth_grads,
                 gids, pos, in_rng, px, py):
        g = gids[torch.where(in_rng, pos, 0)].long()          # [G, 16]
        self.g = g
        self.ca = conics[g, 0][:, None, :]
        self.cb = conics[g, 1][:, None, :]
        self.cc = conics[g, 2][:, None, :]
        self.dx = means2d[g, 0][:, None, :] - px[:, :, None]
        self.dy = means2d[g, 1][:, None, :] - py[:, :, None]
        dx, dy = self.dx, self.dy
        sigma = (0.5 * (self.ca * dx * dx + self.cc * dy * dy)
                 + self.cb * dx * dy)
        self.sigma, self.in_rng, self.op = sigma, in_rng, opacities[g]
        self.e = torch.exp(-sigma)
        self.raw = opacities[g][:, None, :] * self.e
        alpha = torch.clamp(self.raw, max=MAX_ALPHA)
        keep = (in_rng[:, None, :] & (sigma >= 0.0)
                & (alpha >= ALPHA_THRESHOLD))
        self.a = torch.where(keep, alpha, torch.zeros_like(alpha))
        d_p = (depths[g][:, None, :] - depth_grads[g, 0][:, None, :] * dx
               - depth_grads[g, 1][:, None, :] * dy)
        self.d_p = d_p
        # ascending d_p, ties by position: the pixel's order of the window
        self.order = torch.argsort(d_p, dim=-1, stable=True)

    def near(self):
        """[G, P, 16] bool: the pairs the kernel takes to the exact test,
        sigma at or below the slot's `skip_cut`."""
        return self.in_rng[:, None, :] & ~(
            self.sigma > skip_cut(self.op)[:, None, :])

    def out_of_order(self):
        """[G, P] bool: the window's entries with a > 0 do not already
        stand in the pixel's order (the kernels then count ranks)."""
        live = self.a > 0.0
        d_live = torch.where(live, self.d_p,
                             torch.full_like(self.d_p, float("-inf")))
        before = torch.cummax(d_live, dim=-1).values
        return (live[..., 1:] & (self.d_p[..., 1:] < before[..., :-1])
                ).any(-1)

    def in_order(self, x):
        return x.gather(-1, self.order)

    def in_position(self, x_ordered):
        return torch.empty_like(x_ordered).scatter_(-1, self.order,
                                                    x_ordered)

    def transmittance(self, T):
        """T_exc [G, P, 16] in front of each slot in the pixel's order,
        and T behind the window, from T [G, P] in front of it."""
        a_o = self.in_order(self.a)
        t_exc = torch.empty_like(a_o)
        for r in range(STP_WINDOW):
            t_exc[..., r] = T
            T = T * (1.0 - a_o[..., r])
        return self.in_position(t_exc), T


def rasterize_fwd_stp_plain(means2d, conics, opacities, channels, depths,
                            depth_grads, gids, bounds, img_height: int,
                            img_width: int, tile_size: int,
                            checkpoints: bool = False,
                            stats: dict | None = None):
    """Plain PyTorch version of kernel K2s, the same arithmetic per
    (pixel, slot) pair and window. Returns (out [H, W, C], T [H, W],
    i_stop [H, W] int32, all NEVER_STOPPED, checkpoints
    [n_rows, tile_size^2] or None). With `stats`, leaves the count of
    (pixel, window) pairs whose live entries (a > 0) were out of order in
    ``stats["unordered_windows"]``, that of (window, warp)s with such a
    pixel, a warp being 32 consecutive pixels of a tile (`slot_warps`), in
    ``stats["unordered_warp_windows"]``, the (pixel, window) pairs in
    ``stats["pixel_windows"]``, their live entries in
    ``stats["live_entries"]``, those of the out-of-order ones in
    ``stats["unordered_live_entries"]``, the sum over the out-of-order ones
    of their live entries squared in ``stats["unordered_live_squares"]``,
    and the (pixel, slot) pairs with sigma at or below the slot's
    `skip_cut` in ``stats["near_pairs"]``; pixels outside the image count
    only in the warps."""
    dev = means2d.device
    tiles_x, tiles_y = _tiles(img_height, img_width, tile_size)
    n_tiles = tiles_x * tiles_y
    P = tile_size * tile_size
    C = channels.shape[1]
    out = torch.zeros((n_tiles, P, C), dtype=torch.float32, device=dev)
    t_fin = torch.ones((n_tiles, P), dtype=torch.float32, device=dev)
    ckpt = None
    if checkpoints:
        ckpt = torch.ones((checkpoint_rows(gids.numel(), n_tiles), P),
                          dtype=torch.float32, device=dev)
    lane = torch.arange(STP_WINDOW, device=dev)
    counts = torch.zeros(7, dtype=torch.int64, device=dev)
    for t0 in range(0, n_tiles, PLAIN_TILE_GROUP):
        tl = torch.arange(t0, min(t0 + PLAIN_TILE_GROUP, n_tiles),
                          device=dev)
        px, py = _pixel_centres(tl, tiles_x, tile_size)
        inside = (px < img_width) & (py < img_height)
        st, end, w0, n_win = _tile_windows(bounds, tl)
        T = torch.ones_like(px)
        acc = torch.zeros((len(tl), P, C), dtype=torch.float32, device=dev)
        for k in range(int(n_win.max()) if len(tl) else 0):
            pos = (w0 + k)[:, None] * STP_WINDOW + lane       # [G, 16]
            in_rng = (pos >= st[:, None]) & (pos < end[:, None])
            win = _Window(means2d, conics, opacities, depths, depth_grads,
                          gids, pos, in_rng, px, py)
            if ckpt is not None:
                active = n_win > k
                ckpt[(w0 + k + tl)[active]] = T[active]
            t_exc, T = win.transmittance(T)
            w = win.a * t_exc
            col = channels[win.g]                             # [G, 16, C]
            for j in range(STP_WINDOW):
                acc = acc + w[..., j, None] * col[:, j, None, :]
            if stats is not None:
                unordered = win.out_of_order()
                live = ((win.a > 0.0) & inside[..., None]).sum(-1)
                counts += torch.stack([
                    (unordered & inside).sum(),
                    slot_warps(unordered[..., None]),
                    (inside & (n_win > k)[:, None]).sum(), live.sum(),
                    (live * (unordered & inside)).sum(),
                    (live * live * (unordered & inside)).sum(),
                    (win.near() & inside[..., None]).sum()])
        out[tl], t_fin[tl] = acc, T
    if stats is not None:
        stats.update(zip(("unordered_windows", "unordered_warp_windows",
                          "pixel_windows", "live_entries",
                          "unordered_live_entries", "unordered_live_squares",
                          "near_pairs"), counts.tolist()))

    dims = (tiles_x, tiles_y, tile_size, img_height, img_width)
    i_stop = torch.full((img_height, img_width), NEVER_STOPPED,
                        dtype=torch.int32, device=dev)
    return (_tiles_to_image(out, *dims),
            _tiles_to_image(t_fin, *dims)[..., 0], i_stop, ckpt)


def _fwd_lib(extra: tuple = ()):
    lib = cuda_build.load("rasterize_fwd_stp", extra)
    lib.gsl_rasterize_fwd_stp.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5)
    lib.gsl_rasterize_fwd_stp.restype = ctypes.c_int
    lib.gsl_rasterize_fwd_stp_max_group.restype = ctypes.c_int
    lib.gsl_rasterize_fwd_stp_attributes.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.gsl_rasterize_fwd_stp_attributes.restype = ctypes.c_int
    return lib


def rasterize_fwd_stp_attributes(n_channels: int, tile_size: int = 16):
    """`kernel_attributes` of the K2s kernel that composites
    min(n_channels, 8) channels."""
    return kernel_attributes(_fwd_lib(), "gsl_rasterize_fwd_stp_attributes",
                             n_channels, tile_size)


def _check_stp_inputs(what, f32, gids, bounds, tile_size):
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError(f"{what}: every floating tensor must be float32")
    if gids.dtype != torch.int32 or bounds.dtype != torch.int64:
        raise TypeError(f"{what}: gids must be int32, bounds int64")
    if gids.numel() >= NEVER_STOPPED:
        raise ValueError(f"{what}: more than 2^30 sorted slots")
    if (tile_size * tile_size) % 32:
        raise ValueError(f"{what}: tile_size^2 must be a multiple of 32 "
                         "(whole warps)")
    return check_cuda(what, *f32, gids, bounds)


def rasterize_fwd_stp(means2d, conics, opacities, channels, depths,
                      depth_grads, gids, bounds, img_height: int,
                      img_width: int, tile_size: int = 16,
                      checkpoints: bool = False, contract: bool = True):
    """Kernel K2s on CUDA tensors, `rasterize_fwd_stp_plain` on CPU
    tensors. One launch per group of up to 8 channels; every launch orders
    the windows and computes T again, so C > 8 costs ceil(C / 8) times the
    kernel. Returns (out [H, W, C], T [H, W], i_stop [H, W] int32 (all
    NEVER_STOPPED), checkpoints or None); `checkpoints=True` also leaves T
    at the start of every window for `rasterize_bwd_stp`.

    `contract=False` launches a build of the same source without
    multiply-add contraction: two slots whose d_p differ by a rounding may
    swap between the usual build and the plain version, which rounds every
    product; the uncontracted build rounds as the plain version does, and
    the checks on the card hold the source's arithmetic to it."""
    if not means2d.is_cuda:
        return rasterize_fwd_stp_plain(
            means2d, conics, opacities, channels, depths, depth_grads, gids,
            bounds, img_height, img_width, tile_size, checkpoints)
    f32 = [means2d, conics, opacities, channels, depths, depth_grads]
    dev = _check_stp_inputs("rasterize_fwd_stp", f32, gids, bounds,
                            tile_size)
    tiles_x, tiles_y = _tiles(img_height, img_width, tile_size)
    n_tiles = tiles_x * tiles_y
    C = channels.shape[1]
    out = torch.empty((img_height, img_width, C), dtype=torch.float32,
                      device=dev)
    t_fin = torch.empty((img_height, img_width), dtype=torch.float32,
                        device=dev)
    i_stop = torch.empty((img_height, img_width), dtype=torch.int32,
                         device=dev)
    ckpt = None
    if checkpoints:
        ckpt = torch.empty(
            (checkpoint_rows(gids.numel(), n_tiles), tile_size * tile_size),
            dtype=torch.float32, device=dev)
    lib = _fwd_lib(() if contract else cuda_build.NO_CONTRACTION)
    group = lib.gsl_rasterize_fwd_stp_max_group()
    for c0 in range(0, C, group):
        code = lib.gsl_rasterize_fwd_stp(
            ptr(means2d), ptr(conics), ptr(opacities), ptr(channels),
            ptr(depths), ptr(depth_grads), C, c0, min(group, C - c0),
            ptr(gids), ptr(bounds), n_tiles, tiles_x, tile_size,
            img_height, img_width, ptr(out), ptr(t_fin), ptr(i_stop),
            ptr(ckpt) if checkpoints and c0 == 0 else None, stream(dev))
        cuda_build.check(lib, code, "rasterize_fwd_stp")
        rasterize_fwd_stp.launches += 1
    return out, t_fin, i_stop, ckpt


rasterize_fwd_stp.launches = 0


def rasterize_bwd_stp_plain(means2d, conics, opacities, channels, depths,
                            depth_grads, gids, bounds, g_out, g_alpha,
                            t_final, checkpoints, tile_size: int,
                            stats: dict | None = None):
    """Plain PyTorch version of kernel K3s, written out from the formulas
    in the module's docstring. g_out [H, W, C] and g_alpha [H, W] are the
    cotangents of the composited channels and of alpha; t_final and
    checkpoints are the forward's. Returns rows [len(gids), 6 + C]: per
    sorted position the sums over its tile's pixels of d/d(mean x, mean y,
    conic a, b, c, opacity, channels); rows behind the valid slots stay
    zero. With `stats`, leaves the count of (pixel, slot) pairs with
    alpha >= 1/255 in ``stats["composited_pairs"]`` and that of (slot,
    warp)s with at least one such pixel (`slot_warps`) in
    ``stats["composited_slot_warps"]``."""
    dev = means2d.device
    img_height, img_width, C = g_out.shape
    tiles_x, tiles_y = _tiles(img_height, img_width, tile_size)
    n_tiles = tiles_x * tiles_y
    rows = torch.zeros((gids.numel(), 6 + C), dtype=torch.float32,
                       device=dev)
    gt = _image_to_tiles(g_out, tiles_x, tiles_y, tile_size)
    ga = _image_to_tiles(g_alpha[..., None], tiles_x, tiles_y,
                         tile_size)[..., 0]
    # padding pixels: zero cotangents and T_final, so they add nothing
    tf = _image_to_tiles(t_final[..., None], tiles_x, tiles_y,
                         tile_size)[..., 0]
    lane = torch.arange(STP_WINDOW, device=dev)
    n_comp = torch.zeros((), dtype=torch.int64, device=dev)
    n_warps = torch.zeros((), dtype=torch.int64, device=dev)
    for t0 in range(0, n_tiles, PLAIN_TILE_GROUP):
        tl = torch.arange(t0, min(t0 + PLAIN_TILE_GROUP, n_tiles),
                          device=dev)
        px, py = _pixel_centres(tl, tiles_x, tile_size)
        inside = (px < img_width) & (py < img_height)
        st, end, w0, n_win = _tile_windows(bounds, tl)
        g_pix = gt[tl]                                        # [G, P, C]
        S = -tf[tl] * ga[tl]
        for k in reversed(range(int(n_win.max()) if len(tl) else 0)):
            pos = (w0 + k)[:, None] * STP_WINDOW + lane       # [G, 16]
            in_rng = (pos >= st[:, None]) & (pos < end[:, None])
            win = _Window(means2d, conics, opacities, depths, depth_grads,
                          gids, pos, in_rng, px, py)
            T0 = checkpoints[torch.where(n_win > k, w0 + k + tl, 0)]
            t_exc, _ = win.transmittance(T0)
            a, dx, dy = win.a, win.dx, win.dy
            col = channels[win.g]                             # [G, 16, C]
            cg = torch.zeros_like(a)
            for c in range(C):
                cg = cg + g_pix[:, :, None, c] * col[:, None, :, c]
            w = a * t_exc
            # S_after: the suffix of q = w cg in the pixel's own order
            q_o = win.in_order(w * cg)
            s_after = torch.empty_like(q_o)
            for r in reversed(range(STP_WINDOW)):
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
            part = torch.empty((len(tl), STP_WINDOW, 6 + C),
                               dtype=torch.float32, device=dev)
            part[..., :6] = torch.stack(
                [dsigma * gx, dsigma * gy, dsigma * 0.5 * dx * dx,
                 dsigma * dx * dy, dsigma * 0.5 * dy * dy, dop], -1).sum(1)
            part[..., 6:] = (w[..., None] * g_pix[:, :, None, :]).sum(1)
            rows[pos[in_rng]] = part[in_rng]
            n_comp += (comp & inside[:, :, None]).sum()
            n_warps += slot_warps(comp)
    if stats is not None:
        stats["composited_pairs"] = int(n_comp)
        stats["composited_slot_warps"] = int(n_warps)
    return rows


def _bwd_lib(extra: tuple = ()):
    lib = cuda_build.load("rasterize_bwd_stp", extra)
    lib.gsl_rasterize_bwd_stp.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6)
    lib.gsl_rasterize_bwd_stp.restype = ctypes.c_int
    lib.gsl_rasterize_bwd_stp_attributes.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.gsl_rasterize_bwd_stp_attributes.restype = ctypes.c_int
    lib.gsl_rasterize_bwd_stp_max_group.argtypes = [ctypes.c_int]
    lib.gsl_rasterize_bwd_stp_max_group.restype = ctypes.c_int
    return lib


def rasterize_bwd_stp_max_group(tile_size: int = 16) -> int:
    """The most channels one K3s launch takes at this tile size (88 at
    16). Needs the built library."""
    return _bwd_lib().gsl_rasterize_bwd_stp_max_group(tile_size)


def rasterize_bwd_stp_attributes(n_channels: int, tile_size: int = 16):
    """`kernel_attributes` of the K3s kernel."""
    return kernel_attributes(_bwd_lib(), "gsl_rasterize_bwd_stp_attributes",
                             n_channels, tile_size)


def rasterize_bwd_stp(means2d, conics, opacities, channels, depths,
                      depth_grads, gids, bounds, g_out, g_alpha, t_final,
                      checkpoints, tile_size: int = 16,
                      contract: bool = True, group=None):
    """Kernel K3s on CUDA tensors, `rasterize_bwd_stp_plain` on CPU
    tensors. Any channel count: one launch per group of up to `group`
    channels (`ops.rasterize.bwd_group_size`; by default, and at most,
    `rasterize_bwd_stp_max_group(tile_size)`), joined by
    `ops.rasterize.backward_by_channel_groups`; the checkpoints hold T
    per window, no channel, so every group reads them whole.
    `checkpoints` is what `rasterize_fwd_stp(checkpoints=True)` returned
    for the same inputs. Returns rows [len(gids), 6 + C].
    `contract=False`: see `rasterize_fwd_stp`."""
    if not means2d.is_cuda:
        return rasterize_bwd_stp_plain(
            means2d, conics, opacities, channels, depths, depth_grads, gids,
            bounds, g_out, g_alpha, t_final, checkpoints, tile_size)
    f32 = [means2d, conics, opacities, channels, depths, depth_grads, g_out,
           g_alpha, t_final, checkpoints]
    dev = _check_stp_inputs("rasterize_bwd_stp", f32, gids, bounds,
                            tile_size)
    img_height, img_width, C = g_out.shape
    tiles_x, tiles_y = _tiles(img_height, img_width, tile_size)
    n_tiles = tiles_x * tiles_y
    if (channels.shape[1] != C or t_final.shape != (img_height, img_width)
            or checkpoints.shape != (checkpoint_rows(gids.numel(), n_tiles),
                                     tile_size * tile_size)):
        raise ValueError("rasterize_bwd_stp: cotangent or checkpoint "
                         "shapes do not match the forward's")
    lib = _bwd_lib(() if contract else cuda_build.NO_CONTRACTION)

    def launch(ch, g_o, g_a):
        cg = ch.shape[1]
        # zeroed: the kernel writes only the valid positions
        rows = torch.zeros((gids.numel(), 6 + cg), dtype=torch.float32,
                           device=dev)
        code = lib.gsl_rasterize_bwd_stp(
            ptr(means2d), ptr(conics), ptr(opacities), ptr(ch),
            ptr(depths), ptr(depth_grads), cg, ptr(gids), ptr(bounds),
            n_tiles, tiles_x, tile_size, img_height, img_width, ptr(g_o),
            ptr(g_a), ptr(t_final), ptr(checkpoints), ptr(rows),
            stream(dev))
        cuda_build.check(lib, code, "rasterize_bwd_stp")
        rasterize_bwd_stp.launches += 1
        return rows

    return backward_by_channel_groups(
        launch, channels, g_out, N_GEOM,
        bwd_group_size(group, lib.gsl_rasterize_bwd_stp_max_group(tile_size),
                       "rasterize_bwd_stp"), (g_alpha,))


rasterize_bwd_stp.launches = 0
