"""Inputs of the slot kernels K1 (expand), K4 (reduce_grads) and K5
(surfel_expand) with their edge cases, shared by the host emulation of the
CUDA sources (`test_torch_kernel_emulation_slots.py`) and the card tests
(`test_torch_kernels.py`).

The projections are drawn directly (no camera): splats a few pixels wide
over an image a little larger than the screen, so some rectangles are
clipped empty; a tenth culled by projection (radius 0), which keeps one
dummy slot each; and one splat whose rectangle covers the whole image, more
slots than one run of K1 or one staging pass of K4 holds. K5 takes the same
projections as surfels, and three cases made by hand."""
import numpy as np
import torch

from gsl_tpu_torch.ops import rasterize as R
from gsl_tpu_torch.ops import surfel_rasterize as SR
from gsl_tpu_torch.ops.projection import Projections

# (tile size, image width, height, Gaussians): 40 x 40 tiles of 4 pixels
# hold the big splat's 1,600 slots; n is a multiple of no run (128
# Gaussians in K1, 32 to 256 in K4)
K1_CASES = {"tile4-big": (4, 160, 160, 1001), "tile16": (16, 320, 240, 1500)}
# K5: K1's cases as surfels; rectangles made by hand whose rows pass tiles_y
# (the row clamp), with negative depths (keyed as 0); one surfel over the
# whole image (more slots than a run has threads); no surfel
K5_CASES = (*sorted(K1_CASES), "rows-past-tiles_y", "one-surfel",
            "no-surfels")


def projections(n, tile_size, width, height, seed=0, big=True):
    """Projections of n splats and their opacities, on the CPU."""
    rng = np.random.RandomState(seed)
    m2d = rng.uniform([-0.1 * width, -0.1 * height],
                      [1.1 * width, 1.1 * height], (n, 2))
    sx, sy = rng.uniform(0.3, 1.5 * tile_size, (2, n))
    th = rng.uniform(0, np.pi, n)
    if big:
        k = n // 2
        m2d[k] = (width / 2, height / 2)
        sx[k], sy[k] = width, 0.8 * height
    c, s = np.cos(th), np.sin(th)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    cov = rot @ (np.stack([sx, sy], -1)[..., None] ** 2 * np.eye(2)) @ (
        np.swapaxes(rot, -1, -2))
    inv = np.linalg.inv(cov)
    radii = np.ceil(3 * np.maximum(sx, sy)).astype(np.int32)
    radii[rng.rand(n) < 0.1] = 0
    if big:
        radii[n // 2] = 4 * width
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    proj = Projections(
        means2d=f32(m2d), depths=f32(rng.uniform(0.5, 10.0, n)),
        radii=torch.from_numpy(radii),
        conics=f32(np.stack([inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 1]], -1)),
        compensations=None, mask=None,
        depth_grads=f32(rng.normal(size=(n, 2)) * 0.01))
    return proj, f32(rng.uniform(0.001, 1.0, n))


def expand_args(name, stp=False, culling=True, device="cpu", seed=0):
    """K1's wrapper's arguments for a case of K1_CASES."""
    ts, width, height, n = K1_CASES[name]
    proj, op = projections(n, ts, width, height, seed)
    isects = R.isect_encode(proj, height, width, ts)
    dev = torch.device(device)
    isects = isects._replace(offsets=isects.offsets.to(dev),
                             rect=isects.rect.to(dev))
    tiles_x, tiles_y = -(-width // ts), -(-height // ts)
    return (isects, proj.means2d.to(dev), proj.conics.to(dev), op.to(dev),
            proj.depths.to(dev), tiles_x, tiles_y, ts, culling, stp,
            proj.depth_grads.to(dev) if stp else None)


def _rows_past_tiles_y(seed, n=300, tiles_x=8, tiles_y=6):
    """Rectangles up to twice as tall as the image, a sixth of them empty,
    and depths of either sign."""
    rng = np.random.RandomState(seed)
    min_x = rng.randint(0, tiles_x, n)
    w = rng.randint(1, tiles_x - min_x + 1)
    min_y = rng.randint(0, tiles_y, n)
    h = rng.randint(1, 2 * tiles_y + 1, n)
    w[rng.rand(n) < 1 / 6] = 0
    slots = np.maximum(w * h, 1)
    assert bool((min_y + h > tiles_y).any())
    isects = R.Isects(
        offsets=torch.from_numpy(np.cumsum(slots) - slots),
        rect=torch.from_numpy(np.stack([min_x, min_y, w, h], 1)
                              .astype(np.int32)),
        total=int(slots.sum()), n_isects=int((w * h).sum()))
    depths = torch.from_numpy(rng.uniform(-2.0, 10.0, n).astype(np.float32))
    return isects, depths, tiles_x, tiles_y


def surfel_expand_args(case, device="cpu", seed=0):
    """K5's wrapper's arguments (isects, depths, tiles_x, tiles_y) for a
    case of K5_CASES."""
    if case == "rows-past-tiles_y":
        isects, depths, tiles_x, tiles_y = _rows_past_tiles_y(seed)
    else:
        ts, width, height, n = K1_CASES.get(case, K1_CASES["tile16"])
        n = {"one-surfel": 1, "no-surfels": 0}.get(case, n)
        proj, _ = projections(n, ts, width, height, seed, big=n > 0)
        isects = SR.surfel_isect_encode(proj.means2d, proj.depths,
                                        proj.radii, height, width, ts)
        depths = proj.depths
        tiles_x, tiles_y = -(-width // ts), -(-height // ts)
    dev = torch.device(device)
    isects = isects._replace(offsets=isects.offsets.to(dev),
                             rect=isects.rect.to(dev))
    return isects, depths.to(dev), tiles_x, tiles_y


def reduce_args(n_cols, all_invalid=False, without_slots=False,
                device="cpu", seed=0):
    """K4's wrapper's arguments (rows, gids, offsets, inv_order, n_valid,
    n) at the slots of K1's "tile4-big" case: random rows of n_cols
    columns, a twentieth of them -0.0, at the valid sorted positions, zero
    behind them. `all_invalid`: no slot has a row (n_valid = 0).
    `without_slots`: a Gaussian without slots behind every Gaussian (2n
    Gaussians), so one starts wherever a Gaussian's slots end: at every
    boundary of K4's staging passes that falls between two Gaussians, and
    at the end of every run of an even length."""
    args = expand_args("tile4-big", seed=seed)
    isects, n = args[0], args[1].shape[0]
    keys, gids = R.expand_plain(*args)
    offsets = isects.offsets
    if without_slots:
        ends = torch.cat([offsets[1:], offsets.new_tensor([isects.total])])
        offsets = torch.stack([offsets, ends], 1).reshape(-1)
        gids, n = 2 * gids, 2 * n
    sk, gs, order = R.sort_slots(keys, gids)
    n_valid = 0 if all_invalid else int((sk != R.INVALID_KEY).sum())
    assert 0 < int((sk != R.INVALID_KEY).sum()) < isects.total
    rng = np.random.RandomState(seed + 1)
    rows = rng.normal(size=(isects.total, n_cols)).astype(np.float32)
    rows[rng.rand(*rows.shape) < 0.05] = -0.0
    rows[n_valid:] = 0.0
    dev = torch.device(device)
    return (torch.from_numpy(rows).to(dev), gs.to(dev),
            offsets.to(dev), R.invert_order(order).to(dev),
            torch.tensor([n_valid], dtype=torch.int64, device=dev), n)
