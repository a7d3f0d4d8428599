"""Plain PyTorch tile rasterizer: the benchmark's own frozen copy.

A copy of the plain versions in ``gsl_tpu_torch/ops/rasterize.py``
(``isect_encode``, ``expand_plain``, the stable sort, ``tile_bounds``,
``rasterize_fwd_plain``, ``rasterize_bwd_plain``, ``reduce_grads_plain``)
and of ``projection.tile_rect``, with their counters left out and the
tile groups widened so that one image is one group on a large card. The
arithmetic is unchanged. It is kept here, and not imported, so that a
change to the program cannot move the yardstick it is held to.

Compositing, per pixel, front to back in (tile, depth) order:
    sigma = 0.5 (a dx^2 + c dy^2) + b dx dy, alpha = min(0.999, o e^-sigma)
    skip if sigma < 0 or alpha < 1/255
    next_T = T (1 - alpha); if next_T <= 1e-4: stop (no composite)
    out += alpha T channels; T = next_T
"""
from __future__ import annotations

import torch

ALPHA_THRESHOLD = 1.0 / 255.0
MAX_ALPHA = 0.999
MIN_TRANSMITTANCE = 1e-4
MIN_ONE_MINUS_ALPHA = 1e-3
NEVER_STOPPED = 2 ** 30
INVALID_KEY = torch.iinfo(torch.int64).max
TILE_GROUP = 8192   # tiles per group: a 1920x1080 image in one
CHUNK = 64          # slots gathered at a time


def tiles_of(img_height: int, img_width: int, tile_size: int):
    return -(-img_width // tile_size), -(-img_height // tile_size)


def tile_rect(means2d, conics, radii, tile_size: int, tiles_x: int,
              tiles_y: int):
    """Inclusive-min / exclusive-max tile rectangle of each splat's
    3-sigma box; empty where radii == 0."""
    r = radii.to(torch.float32)
    ca, cb, cc = conics[..., 0], conics[..., 1], conics[..., 2]
    det = torch.clamp(ca * cc - cb * cb, min=1e-12)
    rx = torch.minimum(
        torch.ceil(3.0 * torch.sqrt(torch.clamp(cc / det, min=0.0))), r)
    ry = torch.minimum(
        torch.ceil(3.0 * torch.sqrt(torch.clamp(ca / det, min=0.0))), r)
    x, y = means2d[..., 0], means2d[..., 1]
    min_x = torch.clamp(((x - rx) / tile_size).to(torch.int32), 0, tiles_x)
    min_y = torch.clamp(((y - ry) / tile_size).to(torch.int32), 0, tiles_y)
    max_x = torch.clamp(((x + rx) / tile_size).to(torch.int32) + 1, 0,
                        tiles_x)
    max_y = torch.clamp(((y + ry) / tile_size).to(torch.int32) + 1, 0,
                        tiles_y)
    empty = radii <= 0
    max_x = torch.where(empty, min_x, max_x)
    max_y = torch.where(empty, min_y, max_y)
    return torch.stack([min_x, min_y], -1), torch.stack([max_x, max_y], -1)


def isect_encode(means2d, conics, radii, img_height, img_width, tile_size):
    """-> (offsets [N] int64, rect [N, 4] int64 (min x, min y, w, h),
    total slots, tile intersections). Every splat gets max(hits, 1)
    slots; an empty one keeps one invalid dummy."""
    tiles_x, tiles_y = tiles_of(img_height, img_width, tile_size)
    rect_min, rect_max = tile_rect(means2d, conics, radii, tile_size,
                                   tiles_x, tiles_y)
    size = rect_max - rect_min
    hits = (size[:, 0] * size[:, 1]).to(torch.int64)
    slots = torch.clamp(hits, min=1)
    ends = torch.cumsum(slots, 0)
    total, n_isects = (torch.stack([ends[-1], hits.sum()]).tolist()
                       if hits.numel() else (0, 0))
    rect = torch.cat([rect_min, size], 1).to(torch.int64)
    return ends - slots, rect, total, n_isects


def slot_tiles(offsets, rect, total: int, tiles_y: int):
    dev = offsets.device
    n = offsets.shape[0]
    hits = rect[:, 2] * rect[:, 3]
    gid = torch.repeat_interleave(torch.arange(n, device=dev),
                                  torch.clamp(hits, min=1),
                                  output_size=total)
    local = torch.arange(total, device=dev) - offsets[gid]
    w = torch.clamp(rect[gid, 2], min=1)
    t_y = torch.clamp(rect[gid, 1] + local // w, max=tiles_y - 1)
    t_x = rect[gid, 0] + local % w
    return gid, t_x, t_y, hits[gid] > 0


def expand(offsets, rect, total, means2d, conics, opacities, depths,
           tiles_x, tiles_y, tile_size, stp_resort=False, depth_grads=None):
    """Per slot, in slot order: (keys [total] int64, gids [total] int64).
    The key is (tile << 32) | bits(max(depth, 0)), INVALID_KEY for a slot
    whose splat's peak alpha over the tile is under 1/255; with
    `stp_resort` the depth is the splat's depth plane at the tile centre."""
    gid, t_x, t_y, valid = slot_tiles(offsets, rect, total, tiles_y)
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
    depth = depths[gid]
    if stp_resort:
        tcx = (t_x.to(torch.float32) + 0.5) * ts
        tcy = (t_y.to(torch.float32) + 0.5) * ts
        depth = (depth + depth_grads[gid, 0] * (tcx - means2d[gid, 0])
                 + depth_grads[gid, 1] * (tcy - means2d[gid, 1]))
    dbits = torch.clamp(depth, min=0.0).view(torch.int32).to(torch.int64)
    keys = torch.where(valid, ((t_y * tiles_x + t_x) << 32) | dbits,
                       torch.full_like(dbits, INVALID_KEY))
    return keys, gid


def sort_and_bound(keys, gids, n_tiles: int):
    """Stable sort by key -> (sorted Gaussian ids, bounds [n_tiles + 1]:
    tile t owns sorted positions [b[t], b[t+1]))."""
    sorted_keys, order = torch.sort(keys, stable=True)
    starts = torch.arange(n_tiles + 1, dtype=torch.int64,
                          device=keys.device) << 32
    return gids[order], torch.searchsorted(sorted_keys, starts)


def tiles_to_image(x, tiles_x, tiles_y, tile_size, img_height, img_width):
    """[n_tiles, P, K] -> [H, W, K]."""
    x = x.reshape(tiles_y, tiles_x, tile_size, tile_size, -1)
    x = x.permute(0, 2, 1, 3, 4).reshape(tiles_y * tile_size,
                                         tiles_x * tile_size, -1)
    return x[:img_height, :img_width]


def image_to_tiles(x, tiles_x, tiles_y, tile_size):
    """[H, W, K] -> [n_tiles, P, K], zero-padded to whole tiles."""
    h, w, k = x.shape
    x = torch.nn.functional.pad(
        x, (0, 0, 0, tiles_x * tile_size - w, 0, tiles_y * tile_size - h))
    x = x.reshape(tiles_y, tile_size, tiles_x, tile_size, k)
    return x.permute(0, 2, 1, 3, 4).reshape(tiles_x * tiles_y,
                                            tile_size * tile_size, k)


def pixel_centres(tl, tiles_x, tile_size):
    p = torch.arange(tile_size * tile_size, device=tl.device)
    px = ((tl % tiles_x)[:, None] * tile_size + p % tile_size
          ).to(torch.float32) + 0.5                           # [G, P]
    py = ((tl // tiles_x)[:, None] * tile_size + p // tile_size
          ).to(torch.float32) + 0.5
    return px, py


def forward(means2d, conics, opacities, channels, gids, bounds,
            img_height, img_width, tile_size):
    """-> (out [H, W, C], T [H, W], i_stop [H, W] int64)."""
    dev = means2d.device
    tiles_x, tiles_y = tiles_of(img_height, img_width, tile_size)
    n_tiles = tiles_x * tiles_y
    P = tile_size * tile_size
    C = channels.shape[1]
    out = torch.zeros((n_tiles, P, C), dtype=torch.float32, device=dev)
    t_fin = torch.ones((n_tiles, P), dtype=torch.float32, device=dev)
    stop = torch.full((n_tiles, P), NEVER_STOPPED, dtype=torch.int64,
                      device=dev)
    lane = torch.arange(CHUNK, device=dev)
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    for t0 in range(0, n_tiles, TILE_GROUP):
        tl = torch.arange(t0, min(t0 + TILE_GROUP, n_tiles), device=dev)
        px, py = pixel_centres(tl, tiles_x, tile_size)
        st, cnt = starts[tl], counts[tl]
        T = torch.ones_like(px)
        acc = torch.zeros((len(tl), P, C), dtype=torch.float32, device=dev)
        done = torch.zeros(px.shape, dtype=torch.bool, device=dev)
        brk_at = torch.full(px.shape, NEVER_STOPPED, dtype=torch.int64,
                            device=dev)
        max_cnt = int(cnt.max()) if len(tl) else 0
        for k0 in range(0, max_cnt, CHUNK):
            if bool(done.all()):
                break
            pos = st[:, None] + k0 + lane                     # [G, K]
            in_rng = (k0 + lane)[None, :] < cnt[:, None]
            g = gids[torch.where(in_rng, pos, 0)]
            mx, my = means2d[g, 0], means2d[g, 1]
            ca, cb, cc = conics[g, 0], conics[g, 1], conics[g, 2]
            op, col = opacities[g], channels[g]               # [G,K], [G,K,C]
            for j in range(CHUNK):
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
    dims = (tiles_x, tiles_y, tile_size, img_height, img_width)
    return (tiles_to_image(out, *dims), tiles_to_image(t_fin, *dims)[..., 0],
            tiles_to_image(stop, *dims)[..., 0])


def backward(means2d, conics, opacities, channels, gids, bounds, g_out,
             g_alpha, t_final, i_stop, tile_size):
    """Rows [len(gids), 6 + C]: per sorted position the sums over its
    tile's pixels of d/d(mean x, mean y, conic a, b, c, opacity,
    channels), walking each tile back from its pixels' stops."""
    dev = means2d.device
    img_height, img_width, C = g_out.shape
    tiles_x, tiles_y = tiles_of(img_height, img_width, tile_size)
    n_tiles = tiles_x * tiles_y
    P = tile_size * tile_size
    rows = torch.zeros((gids.numel(), 6 + C), dtype=torch.float32,
                       device=dev)
    gt = image_to_tiles(g_out, tiles_x, tiles_y, tile_size)
    ga = image_to_tiles(g_alpha[..., None], tiles_x, tiles_y,
                        tile_size)[..., 0]
    tf = image_to_tiles(t_final[..., None], tiles_x, tiles_y,
                        tile_size)[..., 0]
    stops = image_to_tiles(i_stop[..., None], tiles_x, tiles_y,
                           tile_size)[..., 0]
    lane = torch.arange(CHUNK, device=dev)
    for t0 in range(0, n_tiles, TILE_GROUP):
        tl = torch.arange(t0, min(t0 + TILE_GROUP, n_tiles), device=dev)
        px, py = pixel_centres(tl, tiles_x, tile_size)
        st, end = bounds[tl], bounds[tl + 1]
        stop, g_pix = stops[tl], gt[tl]
        last = torch.minimum(end, stop.max(dim=1).values)
        cnt = torch.clamp(last - st, min=0)
        T = tf[tl]
        S = -T * ga[tl]
        max_cnt = int(cnt.max()) if len(tl) else 0
        for k0 in reversed(range(0, max_cnt, CHUNK)):
            pos = st[:, None] + k0 + lane
            in_rng = (k0 + lane)[None, :] < cnt[:, None]
            g = gids[torch.where(in_rng, pos, 0)]
            mx, my = means2d[g, 0], means2d[g, 1]
            ca_, cb_, cc_ = conics[g, 0], conics[g, 1], conics[g, 2]
            op, col = opacities[g], channels[g]
            part = torch.zeros((len(tl), CHUNK, 6 + C), dtype=torch.float32,
                               device=dev)
            for j in reversed(range(CHUNK)):
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
                cg = (g_pix * col[:, j, None, :]).sum(-1)
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
            rows[pos[in_rng]] = part[in_rng]
    return rows


def reduce_rows(rows, gids, n: int):
    """Per Gaussian: the sum of its slots' rows."""
    out = torch.zeros((n, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    return out.index_add_(0, gids, rows)
