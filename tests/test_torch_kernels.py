"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor gsl_tpu, so the card host runs it as the README says:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

K1 (expand) must equal expand_plain bit for bit. K2 (forward) must agree
with rasterize_fwd_plain on i_stop at >= 99.9% of pixels and on values
within rtol 1e-3 / atol 2e-4: the kernel contracts multiply-adds and the
plain version does not, so they round differently; where a splat sits
within rounding of the 1/255 skip or the 1e-4 stop, one composites it
and the other does not, moving that pixel by up to the splat's weight
(hence a share of values, not all of them). K2 built without contraction
(`contract=False`) rounds as the plain version does and is held to the
same shares here, at >= 99.999% at full width by `chip_smoke.py`. K3 (backward) recomputes the
same alphas, so the same flips move single gradient rows: its rows, and
K4's per-Gaussian sums of them, are held to rtol 1e-3 / atol 1e-3 at
>= 99.9% of the values (the gradients of the test loss reach the
hundreds, and T / (1 - alpha) walked backwards rounds differently with
and without contraction); K3 built without contraction (`contract=False`)
rounds as the plain version does and is held column by column. K4 on
identical rows differs from `index_add_` only in the order of its float32
additions.

The surfel kernels follow the same pattern. K5 (surfel expand) is integer
work and must equal surfel_expand_plain bit for bit, without spilling. K6 (surfel forward)
decides more per pair than K2 (alpha >= 1/255, rho3d <= rho2d,
depth >= 0.2, the 0.5 crossing of the median, the stop), all on rounded
values, so its images are held at a share of values like K2's; the median
depth gets its own share, since a crossing that flips moves a pixel by a
whole depth step; K6 built without contraction is held to the same
shares. K7's rows are held column by column: the columns have
different units, and near-degenerate solves put a few rows far above a
column's typical magnitude, so each column gets 1e-4 of its own scale (the
99th percentile of the reference's nonzero magnitudes) + rtol 1e-3 at
>= 99.5% of its values: the solve's hx = px Tw - Tu and the cross product
hx x hy are differences of products far larger than their result, which
the kernel contracts to multiply-adds and the plain version does not, so
more pairs round apart than in K3. Built without contraction
(`contract=False`) the same source rounds as the plain version does and is
held at >= 99.9% here, at >= 99.999% at full width by `chip_smoke.py`. The K4 sums of those rows (no absolute columns
there) may differ from `index_add_`'s by 1e-5 of the summed magnitudes of
the rows that went into each sum, and by nothing more.

The StopThePop kernels: K1 with `stp_resort` is bit-identical to
`expand_plain` like K1 without. K2s has no skip-or-stop decision but the
1/255 skip, and one more on rounded values: two slots of a window whose
depths at a pixel differ by a rounding may swap between the contracted
kernel and the plain version, moving the pixel by up to one weight; image,
alpha and K3s's rows are held at the shares of K2 and K3. A saturated tile
(T_final == 0) must give finite gradients equal to the CPU's.

The SH colour pair (`csrc/sh_fwd.cu`, `csrc/sh_bwd.cu`) rounds every
operation as its plain versions do, but the plain versions normalise the
view direction with `torch.linalg.norm`, whose sum of squares the card's
reduction may round otherwise than the kernels' chain of fused
multiply-adds (the CPU's; the emulated sources are held to the CPU's plain
versions bit for bit). A direction an ulp apart moves a colour or a
gradient by a few ulps of the terms' magnitudes (atol and rtol 2e-5) and,
where SH + 0.5 lies within that of 0, flips the clamp: the masks must agree
at >= 99.99% of rows, and the gradients are compared where they agree.
"""
import dataclasses
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import slot_cases
from gsl_tpu_torch.data.cameras import make_camera, stack_cameras
from gsl_tpu_torch.models.gaussian import PARAM_FIELDS, grow_capacity
from gsl_tpu_torch.ops import rasterize as R
from gsl_tpu_torch.ops import rasterize_stp as STP
from gsl_tpu_torch.ops import sh as SH
from gsl_tpu_torch.ops import surfel_rasterize as SR
from gsl_tpu_torch.ops.projection import Projections, project_gaussians
from gsl_tpu_torch.ops.surfel import project_surfels
from gsl_tpu_torch.renderers.surfel_renderer import SurfelRendererConfig
from gsl_tpu_torch.renderers.tile_renderer import TileRendererConfig
from gsl_tpu_torch.utils.convert import state_from_raw_arrays

REPO = pathlib.Path(__file__).resolve().parent.parent
W, H, TS = 128, 96, 16
RTOL, ATOL, SHARE = 1e-3, 2e-4, 0.999


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU host)")
    return torch.device("cuda")


def scene(n, seed=0):
    rng = np.random.RandomState(seed)
    means = np.concatenate([rng.uniform(-1, 1, (n, 2)),
                            rng.uniform(2, 6, (n, 1))], 1)
    return {k: v.astype(np.float32) for k, v in dict(
        means=means, scales=rng.uniform(-3.5, -1.5, (n, 3)),
        rotations=rng.normal(size=(n, 4)),
        opacities=rng.uniform(-1, 2, (n, 1)),
        shs_dc=rng.normal(size=(n, 1, 3)) * 0.3,
        shs_rest=rng.normal(size=(n, 15, 3)) * 0.1).items()}


def camera(device, width=W, height=H):
    return make_camera(R=np.eye(3), T=np.zeros(3), fx=110.0, fy=110.0,
                       cx=width / 2, cy=height / 2, width=width,
                       height=height, device=device)


def close_share(got, want):
    bad = (got - want).abs() > ATOL + RTOL * want.abs()
    return 1.0 - float(bad.float().mean())


def _cases(*cases):
    """pytest params with the ids "C", "C-tileT" and "C-cut"."""
    return [pytest.param(c, ts, cut, id=f"{c}" + (
        "" if ts == TS else f"-tile{ts}") + ("-cut" if cut else ""))
        for c, ts, cut in cases]


# (channels, tile size, cut lists): C above 8 takes the kernels' path with
# the cotangents in shared memory; 6 + C or 13 + C above 32 sums each row in
# chunks of 32; tile size 8 is two warps a tile; cut lists end one past a
# window (16) or batch (32), and a tile has one slot
# C = 1, 4 and 7: the hard inverse depth alone, rgb + inverse depth, and
# rgb + depth + normal, the widths the depth and normal regularisers train at
KERNEL_CASES = {"k2": _cases((3, TS, False), (8, TS, False),
                             (11, TS, False), (3, 8, False), (3, TS, True),
                             (1, TS, False), (4, TS, False), (7, TS, False)),
                "k3": _cases((3, TS, False), (8, TS, False),
                             (11, TS, False), (27, TS, False),
                             (3, 8, False), (3, TS, True), (1, TS, False),
                             (4, TS, False), (7, TS, False)),
                "stp": _cases((3, TS, False), (8, TS, False),
                              (11, TS, False), (27, TS, False),
                              (3, 8, False), (3, TS, True)),
                "surfel": _cases((3, TS, False), (6, TS, False),
                                 (9, TS, False), (20, TS, False),
                                 (6, 8, False), (6, TS, True))}


def assert_attributes(info):
    """What a kernel's *_attributes helper reports, as the card's runtime
    gives it."""
    assert 0 < info["registers"] <= 255 and info["shared_bytes"] > 0
    assert info["local_bytes"] >= 0 and info["blocks_per_sm"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("n_channels,ts,cut", KERNEL_CASES["k2"])
def test_kernels_match_plain(cuda, n_channels, ts, cut):
    """C = 11 takes two launches of channel groups (8 + 3); tile size 8 is
    one warp of two pixels a thread. `cut`: the tiles' lists cut to 1, 17,
    65, 0, 47, 2 and 129 slots, so K2's batches of 64 end one slot past a
    batch and a tile has one slot."""
    state = state_from_raw_arrays(scene(3000), device=cuda)
    cam = camera(cuda)
    proj = project_gaussians(state.get_means(), state.get_scales(),
                             state.get_rotations(), cam.world_to_camera,
                             cam.fx, cam.fy, cam.cx, cam.cy, W, H)
    op = state.get_opacities().contiguous()
    ch = torch.rand((3000, n_channels), generator=torch.Generator(
        device="cpu").manual_seed(0)).to(cuda)
    tiles_x, tiles_y = -(-W // ts), -(-H // ts)
    isects = R.isect_encode(proj, H, W, ts)
    args = (isects, proj.means2d, proj.conics, op, proj.depths, tiles_x,
            tiles_y, ts, True)
    before = R.expand.launches
    keys, gids = R.expand(*args)
    assert R.expand.launches == before + 1
    keys_p, gids_p = R.expand_plain(*args)
    assert torch.equal(keys, keys_p) and torch.equal(gids, gids_p)
    sk, gs, _ = R.sort_slots(keys, gids)
    bounds = R.tile_bounds(sk, tiles_x * tiles_y)
    if cut:
        gs, bounds = _cut_lists(gs, bounds, FWD_CUT_LENGTHS)
        counts = bounds[1:] - bounds[:-1]
        assert bool((counts == 1).any()) and bool((counts == 65).any())
        assert bool((counts == 129).any())
    fwd = (proj.means2d, proj.conics, op, ch, gs, bounds, H, W, ts)
    before = R.rasterize_fwd.launches
    out, t_fin, stop = R.rasterize_fwd(*fwd)
    torch.cuda.synchronize()
    assert R.rasterize_fwd.launches == before + -(-n_channels // 8)
    out_p, t_p, stop_p = R.rasterize_fwd_plain(*fwd)
    assert float((stop == stop_p).float().mean()) >= SHARE
    if not cut:
        assert bool((stop < R.NEVER_STOPPED).any())
    assert close_share(out, out_p) >= SHARE
    assert close_share(t_fin, t_p) >= SHARE
    # the same source built without contraction rounds as the plain version
    out_u, t_u, stop_u = R.rasterize_fwd(*fwd, contract=False)
    assert float((stop_u == stop_p).float().mean()) >= SHARE
    assert close_share(out_u, out_p) >= SHARE
    assert close_share(t_u, t_p) >= SHARE
    # twice the same: no atomics
    again = R.rasterize_fwd(*fwd)
    assert all(torch.equal(a, b) for a, b in zip((out, t_fin, stop), again))
    assert_attributes(R.rasterize_fwd_attributes(n_channels, ts))


def _backward_inputs(cuda, n_channels, n=3000, ts=TS, cut=False):
    """K3's arguments after K1, the sort and K2; `cut`: the tiles' lists
    cut to CUT_LENGTHS first."""
    state = state_from_raw_arrays(scene(n), device=cuda)
    cam = camera(cuda)
    proj = project_gaussians(state.get_means(), state.get_scales(),
                             state.get_rotations(), cam.world_to_camera,
                             cam.fx, cam.fy, cam.cx, cam.cy, W, H)
    op = state.get_opacities().contiguous()
    gen = torch.Generator(device="cpu").manual_seed(0)
    ch = torch.rand((n, n_channels), generator=gen).to(cuda)
    tiles_x, tiles_y = -(-W // ts), -(-H // ts)
    isects = R.isect_encode(proj, H, W, ts)
    keys, gids = R.expand(isects, proj.means2d, proj.conics, op,
                          proj.depths, tiles_x, tiles_y, ts, True)
    sk, gs, order = R.sort_slots(keys, gids)
    bounds = R.tile_bounds(sk, tiles_x * tiles_y)
    if cut:
        gs, bounds = _cut_lists(gs, bounds, CUT_LENGTHS)
        counts = bounds[1:] - bounds[:-1]
        assert bool((counts == 1).any()) and bool((counts % 32 == 1).any())
    out, t_fin, stop = R.rasterize_fwd(proj.means2d, proj.conics, op, ch,
                                       gs, bounds, H, W, ts)
    g_out = torch.randn((H, W, n_channels), generator=gen).to(cuda)
    g_alpha = torch.randn((H, W), generator=gen).to(cuda)
    bwd = (proj.means2d, proj.conics, op, ch, gs, bounds, g_out, g_alpha,
           t_fin, stop, ts)
    return bwd, isects, order, n


def close_share_grad(got, want):
    bad = (got - want).abs() > 1e-3 + RTOL * want.abs()
    return 1.0 - float(bad.float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("n_channels,ts,cut", KERNEL_CASES["k3"])
def test_backward_kernels_match_plain(cuda, n_channels, ts, cut):
    """C = 11 and 27 take ceil(C / 8) K3 launches of channel groups
    (K3_GROUP), and in one group (`group`) one launch on K3's path with
    the cotangents in shared memory, which at C = 27 sums 33 values a row
    in two chunks. `cut`: the
    tiles' lists cut to 1, 17, 33, 0, 47, 2 and 49 slots, so K3's batches
    of 32 end ragged and a tile has one slot."""
    bwd, isects, order, n = _backward_inputs(cuda, n_channels, ts=ts,
                                             cut=cut)
    gs, bounds = bwd[4], bwd[5]
    before = R.rasterize_bwd.launches
    rows = R.rasterize_bwd(*bwd)
    torch.cuda.synchronize()
    assert R.rasterize_bwd.launches == before + bwd_launches(
        n_channels, R.rasterize_bwd_max_group(ts), default=R.K3_GROUP)
    rows_p = R.rasterize_bwd_plain(*bwd)
    assert rows.shape == rows_p.shape == (gs.numel(), 6 + n_channels)
    assert bool(torch.isfinite(rows).all())
    assert float(rows_p.abs().max()) > 1.0
    assert close_share_grad(rows, rows_p) >= SHARE
    # the same source built without contraction rounds as the plain version
    loose = R.rasterize_bwd(*bwd, contract=False)
    shares = column_shares(loose, rows_p)
    assert min(shares) >= SHARE, shares
    # twice the same: no atomics
    assert torch.equal(rows, R.rasterize_bwd(*bwd))
    # the whole width in one launch, where the kernel's block takes it
    whole = R.rasterize_bwd(*bwd, group=n_channels)
    assert close_share_grad(whole, rows_p) >= SHARE
    assert_attributes(R.rasterize_bwd_attributes(n_channels, ts))
    if cut:     # K4 needs every slot of the expand's output
        return

    before = R.reduce_grads.launches
    summed = R.reduce_grads(rows, gs, isects.offsets,
                            R.invert_order(order), bounds[-1:], n)
    torch.cuda.synchronize()
    assert R.reduce_grads.launches == before + 1
    summed_p = R.reduce_grads_plain(rows, gs, n)
    assert summed.shape == (n, 8 + n_channels)
    torch.testing.assert_close(summed, summed_p, rtol=1e-4, atol=1e-4)
    assert bool((summed[:, 6:8] >= summed[:, 0:2].abs() - 1e-4).all())
    assert torch.equal(summed, R.reduce_grads(
        rows, gs, isects.offsets, R.invert_order(order), bounds[-1:], n))


@pytest.mark.cuda
def test_parameter_gradients_on_card_match_cpu(cuda):
    """A scalar loss through the whole renderer: the card's gradients
    (kernels) against the CPU's (plain versions) for all six tensors."""
    arrays = scene(1500, seed=1)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        state = state_from_raw_arrays(arrays, device=dev)
        leaves = state.params.map(lambda _, x: x.requires_grad_(True))
        state.params = leaves
        renderer = TileRendererConfig().instantiate()
        out = renderer.forward(state, camera(dev), H, W,
                               torch.tensor([0.1, 0.2, 0.3], device=dev), 3)
        target = torch.rand((H, W, 3), generator=torch.Generator(
            device="cpu").manual_seed(2)).to(dev)
        ((out.render - target) ** 2).sum().backward()
        grads.append({k: getattr(leaves, k).grad.cpu()
                      for k in ("means", "scales", "rotations", "opacities",
                                "shs_dc", "shs_rest")})
    for k, got in grads[0].items():
        want = grads[1][k]
        assert bool(torch.isfinite(got).all()), k
        scale = float(want.abs().max())
        bad = (got - want).abs() > 1e-3 * scale + 1e-2 * want.abs()
        assert float(bad.float().mean()) <= 1e-3, k


@pytest.mark.cuda
def test_renderer_on_card_matches_cpu(cuda):
    arrays = scene(1500, seed=1)
    types = frozenset({"rgb", "alpha", "exp_depth", "inverse_depth",
                       "normal", "hard_inverse_depth"})
    outs = []
    for dev in (cuda, torch.device("cpu")):
        renderer = TileRendererConfig().instantiate()
        outs.append(renderer.forward(
            state_from_raw_arrays(arrays, device=dev), camera(dev), H, W,
            torch.tensor([0.1, 0.2, 0.3], device=dev), 3,
            render_types=types))
    for key in ("render", "alpha", "exp_depth", "inverse_depth", "normal",
                "hard_inverse_depth"):
        got, want = getattr(outs[0], key).cpu(), getattr(outs[1], key)
        assert bool(torch.isfinite(got).all()), key
        assert close_share(got, want) >= SHARE, key
    assert outs[0].n_isects == outs[1].n_isects


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    state = state_from_raw_arrays(scene(100), device=cuda)
    cam = camera(cuda)
    proj = project_gaussians(state.get_means(), state.get_scales(),
                             state.get_rotations(), cam.world_to_camera,
                             cam.fx, cam.fy, cam.cx, cam.cy, W, H)
    op = state.get_opacities().contiguous()
    isects = R.isect_encode(proj, H, W, TS)
    with pytest.raises(TypeError):
        R.expand(isects, proj.means2d.double(), proj.conics, op,
                 proj.depths, W // TS, H // TS, TS, True)
    with pytest.raises(ValueError):
        R.expand(isects, proj.means2d, proj.conics, op.cpu(), proj.depths,
                 W // TS, H // TS, TS, True)
    rect = torch.empty(isects.rect.numel() + 1, dtype=torch.int32,
                       device=cuda)[1:].view(-1, 4).copy_(isects.rect)
    with pytest.raises(RuntimeError):      # K1 reads rect 16 bytes a time
        R.expand(isects._replace(rect=rect), proj.means2d, proj.conics, op,
                 proj.depths, W // TS, H // TS, TS, True)
    bwd, isects, order, n = _backward_inputs(cuda, 3, n=100)
    with pytest.raises(TypeError):
        R.rasterize_bwd(*bwd[:6], bwd[6].double(), *bwd[7:])
    with pytest.raises(ValueError):
        R.rasterize_bwd(*bwd[:10], 5)      # 25 threads: no whole warp
    rows = R.rasterize_bwd(*bwd)
    with pytest.raises(TypeError):
        R.reduce_grads(rows, bwd[4], isects.offsets, order, bwd[5][-1:], n)
    inv = R.invert_order(order)
    wide = torch.zeros((rows.shape[0], 5000), device=cuda)
    with pytest.raises(RuntimeError):      # no pass of one slot in 48 KB
        R.reduce_grads(wide, bwd[4], isects.offsets, inv, bwd[5][-1:], n)


def _cut_lists(gids, bounds, lengths):
    """The sorted lists cut short, tile t to at most lengths[t % len]:
    lists of 1 slot, lists that end one past a window (16) or batch (32),
    empty tiles. Returns (gids, bounds) of the cut lists."""
    counts = (bounds[1:] - bounds[:-1]).cpu()
    want = torch.tensor(lengths)[torch.arange(counts.numel()) % len(lengths)]
    keep = torch.minimum(counts, want)
    starts = bounds[:-1].cpu()
    idx = torch.cat([torch.arange(int(s), int(s) + int(k))
                     for s, k in zip(starts, keep)])
    new_bounds = torch.zeros(counts.numel() + 1, dtype=torch.int64)
    new_bounds[1:] = torch.cumsum(keep, 0)
    return (gids[idx.to(gids.device)].contiguous(),
            new_bounds.to(bounds.device))


CUT_LENGTHS = (1, 17, 33, 0, 47, 2, 49)
# the forward kernels' batches of 64: 65 and 129 end one past a batch
FWD_CUT_LENGTHS = (1, 17, 65, 0, 47, 2, 129)


def _surfel_inputs(cuda, n_channels, n=3000, ts=TS):
    arrays = scene(n)
    state = state_from_raw_arrays(
        dict(arrays, scales=arrays["scales"][:, :2]), device=cuda)
    cam = camera(cuda)
    proj = project_surfels(state.get_means(), state.get_scales(),
                           state.get_rotations(), cam.world_to_camera,
                           cam.fx, cam.fy, cam.cx, cam.cy, W, H)
    gen = torch.Generator(device="cpu").manual_seed(0)
    ch = torch.rand((n, n_channels), generator=gen).to(cuda)
    geom = SR.pack_surfels(proj.Tu, proj.Tv, proj.Tw, proj.zcoef,
                           state.get_opacities())
    isects = SR.surfel_isect_encode(proj.means2d, proj.depths, proj.radii,
                                    H, W, ts)
    return proj, geom, ch, isects, gen


MEDIAN_SHARE = 0.995
SURFEL_GRAD_SHARE = 0.995


def column_shares(got, want):
    """Per column, the share of values within 1e-4 of the column's scale
    + RTOL |want|."""
    shares = []
    for c in range(want.shape[1]):
        mag = want[:, c].abs()
        nonzero = mag[mag > 0]
        assert nonzero.numel() > 0, c
        k = max(1, math.ceil(0.99 * nonzero.numel()))
        scale = float(nonzero.kthvalue(k).values)
        bad = (got[:, c] - want[:, c]).abs() > 1e-4 * scale + RTOL * mag
        shares.append(1.0 - float(bad.float().mean()))
    return shares


@pytest.mark.cuda
@pytest.mark.parametrize("n_channels,ts,cut", KERNEL_CASES["surfel"])
def test_surfel_kernels_match_plain(cuda, n_channels, ts, cut):
    """C = 9 and 20 take ceil(C / 8) K6 launches and one of K7's path with
    the cotangents in shared memory; at C = 20 K7 sums 33 values a row, in
    two chunks; in groups of 8 (`group`) K7 takes ceil(C / 8) launches. `cut`: the tiles' lists cut to 1, 17, 33, 0, 47, 2 and 49
    slots, so K7's batches of 32 end ragged and a tile has one slot."""
    n = 3000
    proj, geom, ch, isects, gen = _surfel_inputs(cuda, n_channels, n, ts)
    tiles_x, tiles_y = -(-W // ts), -(-H // ts)
    args = (isects, proj.depths.contiguous(), tiles_x, tiles_y)
    before = SR.surfel_expand.launches
    keys, gids = SR.surfel_expand(*args)
    assert SR.surfel_expand.launches == before + 1
    keys_p, gids_p = SR.surfel_expand_plain(*args)
    assert torch.equal(keys, keys_p) and torch.equal(gids, gids_p)
    sk, gs, order = R.sort_slots(keys, gids)
    bounds = R.tile_bounds(sk, tiles_x * tiles_y)
    if cut:
        gs, bounds = _cut_lists(gs, bounds, CUT_LENGTHS)
        counts = bounds[1:] - bounds[:-1]
        assert bool((counts == 1).any()) and bool((counts % 32 == 1).any())

    fwd = (geom, ch, gs, bounds, H, W, ts)
    before = SR.rasterize_surfels_fwd.launches
    out, aux, stop = SR.rasterize_surfels_fwd(*fwd)
    torch.cuda.synchronize()
    assert SR.rasterize_surfels_fwd.launches == before + -(-n_channels // 8)
    out_p, aux_p, stop_p = SR.rasterize_surfels_fwd_plain(*fwd)
    assert float((stop == stop_p).float().mean()) >= SHARE
    # lists cut to at most 49 slots leave T above the stop everywhere
    assert bool((stop < R.NEVER_STOPPED).any()) != cut
    assert bool(torch.isfinite(out).all() and torch.isfinite(aux).all())
    assert close_share(out, out_p) >= SHARE
    for plane in range(7):
        share = MEDIAN_SHARE if plane == SR.AUX_MEDIAN else SHARE
        assert close_share(aux[plane], aux_p[plane]) >= share, plane
    assert float(aux[SR.AUX_DIST].max()) > 0.0
    assert float(aux[SR.AUX_MEDIAN].max()) > 1.0
    # the same source built without contraction rounds as the plain version
    out_u, aux_u, stop_u = SR.rasterize_surfels_fwd(*fwd, contract=False)
    assert float((stop_u == stop_p).float().mean()) >= SHARE
    assert close_share(out_u, out_p) >= SHARE
    for plane in range(7):
        share = MEDIAN_SHARE if plane == SR.AUX_MEDIAN else SHARE
        assert close_share(aux_u[plane], aux_p[plane]) >= share, plane
    assert_attributes(SR.rasterize_surfels_fwd_attributes(n_channels, ts))

    g_out = torch.randn((H, W, n_channels), generator=gen).to(cuda)
    g_aux = torch.randn((3, H, W), generator=gen).to(cuda)
    bwd = (geom, ch, gs, bounds, g_out, g_aux, aux, stop, ts)
    before = SR.rasterize_surfels_bwd.launches
    rows = SR.rasterize_surfels_bwd(*bwd)
    torch.cuda.synchronize()
    assert SR.rasterize_surfels_bwd.launches == before + bwd_launches(
        n_channels, SR.rasterize_surfels_bwd_max_group(ts))
    rows_p = SR.rasterize_surfels_bwd_plain(*bwd)
    assert rows.shape == rows_p.shape == (gs.numel(), 13 + n_channels)
    assert bool(torch.isfinite(rows).all())
    assert float(rows_p.abs().max()) > 1.0
    shares = column_shares(rows, rows_p)
    assert min(shares) >= SURFEL_GRAD_SHARE, shares
    # the same source built without contraction rounds as the plain version
    uncontracted = SR.rasterize_surfels_bwd(*bwd, contract=False)
    shares = column_shares(uncontracted, rows_p)
    assert min(shares) >= SHARE, shares
    assert torch.equal(rows, SR.rasterize_surfels_bwd(*bwd))   # no atomics
    shares = column_shares(SR.rasterize_surfels_bwd(*bwd, group=8), rows_p)
    assert min(shares) >= SURFEL_GRAD_SHARE, shares
    assert_attributes(SR.rasterize_surfels_bwd_attributes(n_channels, ts))
    if cut:     # K4 needs every slot of the expand's output
        return

    red = (rows, gs, isects.offsets, R.invert_order(order), bounds[-1:], n)
    before = R.reduce_grads.launches
    summed = R.reduce_grads(*red, n_abs=0)
    torch.cuda.synchronize()
    assert R.reduce_grads.launches == before + 1
    summed_p = R.reduce_grads_plain(rows, gs, n, n_abs=0)
    assert summed.shape == (n, 13 + n_channels)
    into = R.reduce_grads_plain(rows.abs(), gs, n, n_abs=0)
    assert bool(((summed - summed_p).abs() <= 1e-5 * into).all())
    assert torch.equal(summed, R.reduce_grads(*red, n_abs=0))


@pytest.mark.cuda
@pytest.mark.parametrize("w,h", [(W, H), (100, 70)])
def test_surfel_renderer_and_gradients_on_card_match_cpu(cuda, w, h):
    """All seven outputs and the gradients of a loss that reaches the
    channels, alpha, the depth and the distortion: the card (kernels)
    against the CPU (plain versions); 100x70 leaves the tiles of the last
    row and column partly outside the image."""
    arrays = scene(1500, seed=1)
    arrays = dict(arrays, scales=arrays["scales"][:, :2])
    outs, grads = [], []
    for dev in (cuda, torch.device("cpu")):
        state = state_from_raw_arrays(arrays, device=dev)
        leaves = state.params.map(lambda _, x: x.requires_grad_(True))
        state.params = leaves
        out = SurfelRendererConfig().instantiate().forward(
            state, camera(dev, w, h), h, w,
            torch.tensor([0.1, 0.2, 0.3], device=dev), 3)
        target = torch.rand((h, w, 3), generator=torch.Generator(
            device="cpu").manual_seed(2)).to(dev)
        loss = (((out.render - target) ** 2).sum()
                + 100.0 * out.rend_dist.sum()
                + (1.0 - (out.rend_normal * out.surf_normal).sum(-1)).sum())
        loss.backward()
        outs.append(out)
        grads.append({k: getattr(leaves, k).grad.cpu()
                      for k in ("means", "scales", "rotations", "opacities",
                                "shs_dc", "shs_rest")})
    for key in ("render", "alpha", "rend_normal", "view_normal",
                "rend_dist", "surf_depth", "surf_normal"):
        got = getattr(outs[0], key).detach().cpu()
        want = getattr(outs[1], key).detach()
        assert bool(torch.isfinite(got).all()), key
        # the finite-difference normals spread one flipped pixel to four
        share = 0.99 if key == "surf_normal" else SHARE
        assert close_share(got, want) >= share, key
    assert outs[0].n_isects == outs[1].n_isects
    for k, got in grads[0].items():
        want = grads[1][k]
        assert bool(torch.isfinite(got).all()), k
        scale = float(want.abs().max())
        bad = (got - want).abs() > 1e-3 * scale + 1e-2 * want.abs()
        assert float(bad.float().mean()) <= 1e-3, k


@pytest.mark.cuda
def test_surfel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    proj, geom, ch, isects, gen = _surfel_inputs(cuda, 6, n=100)
    depths = proj.depths.contiguous()
    with pytest.raises(TypeError):
        SR.surfel_expand(isects, depths.double(), W // TS, H // TS)
    rect = torch.empty(isects.rect.numel() + 1, dtype=torch.int32,
                       device=cuda)[1:].view(-1, 4).copy_(isects.rect)
    with pytest.raises(RuntimeError):      # K5 reads rect 16 bytes a time
        SR.surfel_expand(isects._replace(rect=rect), depths, W // TS, H // TS)
    with pytest.raises(RuntimeError):      # a run's slots could pass 2^31
        SR.surfel_expand(isects, depths, 4096, 4097)
    keys, gids = SR.surfel_expand(isects, depths, W // TS, H // TS)
    sk, gs, order = R.sort_slots(keys, gids)
    bounds = R.tile_bounds(sk, (W // TS) * (H // TS))
    with pytest.raises(ValueError):
        SR.rasterize_surfels_fwd(geom[:, :12].contiguous(), ch, gs, bounds,
                                 H, W, TS)
    with pytest.raises(ValueError):
        SR.rasterize_surfels_fwd(geom, ch.cpu(), gs, bounds, H, W, TS)
    with pytest.raises(ValueError):    # 25 threads: no whole warp
        SR.rasterize_surfels_fwd(geom, ch, gs, bounds, H, W, 5)
    out, aux, stop = SR.rasterize_surfels_fwd(geom, ch, gs, bounds, H, W, TS)
    g_out = torch.zeros_like(out)
    g_aux = torch.zeros((3, H, W), device=cuda)
    with pytest.raises(TypeError):
        SR.rasterize_surfels_bwd(geom, ch, gs, bounds, g_out.double(), g_aux,
                                 aux, stop, TS)
    with pytest.raises(ValueError):
        SR.rasterize_surfels_bwd(geom, ch, gs, bounds, g_out, g_aux[:2],
                                 aux, stop, TS)
    rows = SR.rasterize_surfels_bwd(geom, ch, gs, bounds, g_out, g_aux, aux,
                                    stop, TS)
    with pytest.raises(ValueError):    # absolute columns need K3's layout
        R.reduce_grads(rows[:, :4].contiguous(), gs, isects.offsets,
                       R.invert_order(order), bounds[-1:], 100, n_abs=2)


def _stp_inputs(cuda, n_channels, n=3000, ts=TS):
    state = state_from_raw_arrays(scene(n), device=cuda)
    cam = camera(cuda)
    proj = project_gaussians(state.get_means(), state.get_scales(),
                             state.get_rotations(), cam.world_to_camera,
                             cam.fx, cam.fy, cam.cx, cam.cy, W, H)
    op = state.get_opacities().contiguous()
    gen = torch.Generator(device="cpu").manual_seed(0)
    ch = torch.rand((n, n_channels), generator=gen).to(cuda)
    isects = R.isect_encode(proj, H, W, ts)
    args = (isects, proj.means2d, proj.conics, op, proj.depths, -(-W // ts),
            -(-H // ts), ts, True, True, proj.depth_grads.contiguous())
    return proj, op, ch, isects, args, gen


@pytest.mark.cuda
@pytest.mark.parametrize("n_channels,ts,cut", KERNEL_CASES["stp"])
def test_stp_kernels_match_plain(cuda, n_channels, ts, cut):
    """C = 11 and 27 take ceil(C / 8) K2s launches and one of K3s's path
    with the cotangents in shared memory; at C = 27 K3s sums 33 values a
    row, in two chunks; in groups of 8 (`group`) K3s takes ceil(C / 8)
    launches. `cut`: the tiles' lists cut to 1, 17, 65, 0, 47, 2 and 129
    slots, so they end one past a window or one past K2s's batch of 64, and
    a tile has one slot."""
    proj, op, ch, isects, args, gen = _stp_inputs(cuda, n_channels, ts=ts)
    tiles_x, tiles_y = args[5], args[6]
    before = R.expand.launches
    keys, gids = R.expand(*args)
    assert R.expand.launches == before + 1
    keys_p, gids_p = R.expand_plain(*args)
    assert torch.equal(keys, keys_p) and torch.equal(gids, gids_p)
    assert not torch.equal(keys, R.expand(*args[:9])[0])
    sk, gs, order = R.sort_slots(keys, gids)
    bounds = R.tile_bounds(sk, tiles_x * tiles_y)
    assert bool((bounds[:-1] % STP.STP_WINDOW != 0).any())
    if cut:
        gs, bounds = _cut_lists(gs, bounds, FWD_CUT_LENGTHS)
        counts = bounds[1:] - bounds[:-1]
        assert bool((counts == 1).any()) and bool((counts % 16 == 1).any())
        assert bool((counts == 65).any())
    fwd = (proj.means2d, proj.conics, op, ch, proj.depths,
           proj.depth_grads.contiguous(), gs, bounds, H, W, ts)
    before = STP.rasterize_fwd_stp.launches
    out, t_fin, stop, ckpt = STP.rasterize_fwd_stp(*fwd, checkpoints=True)
    torch.cuda.synchronize()
    assert STP.rasterize_fwd_stp.launches == before + -(-n_channels // 8)
    out_p, t_p, stop_p, ckpt_p = STP.rasterize_fwd_stp_plain(
        *fwd, checkpoints=True)
    assert bool((stop == R.NEVER_STOPPED).all()) and torch.equal(stop, stop_p)
    assert close_share(out, out_p) >= SHARE
    assert close_share(t_fin, t_p) >= SHARE
    assert STP.rasterize_fwd_stp(*fwd)[3] is None
    loose = STP.rasterize_fwd_stp(*fwd, checkpoints=True, contract=False)
    assert close_share(loose[0], out_p) >= SHARE

    g_out = torch.randn((H, W, n_channels), generator=gen).to(cuda)
    g_alpha = torch.randn((H, W), generator=gen).to(cuda)
    before = STP.rasterize_bwd_stp.launches
    rows = STP.rasterize_bwd_stp(*fwd[:8], g_out, g_alpha, t_fin, ckpt, ts)
    torch.cuda.synchronize()
    assert STP.rasterize_bwd_stp.launches == before + bwd_launches(
        n_channels, STP.rasterize_bwd_stp_max_group(ts))
    rows_p = STP.rasterize_bwd_stp_plain(*fwd[:8], g_out, g_alpha, t_p,
                                         ckpt_p, ts)
    assert rows.shape == rows_p.shape == (gs.numel(), 6 + n_channels)
    assert bool(torch.isfinite(rows).all())
    assert float(rows_p.abs().max()) > 1.0
    assert close_share_grad(rows, rows_p) >= SHARE
    # the same source built without contraction rounds as the plain version
    loose_rows = STP.rasterize_bwd_stp(*fwd[:8], g_out, g_alpha, loose[1],
                                       loose[3], ts, contract=False)
    assert close_share_grad(loose_rows, rows_p) >= SHARE
    assert torch.equal(rows, STP.rasterize_bwd_stp(          # no atomics
        *fwd[:8], g_out, g_alpha, t_fin, ckpt, ts))
    grouped = STP.rasterize_bwd_stp(*fwd[:8], g_out, g_alpha, t_fin, ckpt,
                                    ts, group=8)
    assert close_share_grad(grouped, rows_p) >= SHARE
    assert_attributes(STP.rasterize_bwd_stp_attributes(n_channels, ts))
    if cut:     # K4 needs every slot of the expand's output
        return
    n = proj.means2d.shape[0]
    summed = R.reduce_grads(rows, gs, isects.offsets, R.invert_order(order),
                            bounds[-1:], n)
    torch.testing.assert_close(summed, R.reduce_grads_plain(rows, gs, n),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_stp_renderer_and_gradients_on_card_match_cpu(cuda):
    arrays = scene(1500, seed=1)
    types = frozenset({"rgb", "alpha", "exp_depth", "inverse_depth",
                       "normal", "hard_inverse_depth"})
    outs, grads = [], []
    for dev in (cuda, torch.device("cpu")):
        state = state_from_raw_arrays(arrays, device=dev)
        leaves = state.params.map(lambda _, x: x.requires_grad_(True))
        state.params = leaves
        renderer = TileRendererConfig(stp_resort=True).instantiate()
        out = renderer.forward(state, camera(dev), H, W,
                               torch.tensor([0.1, 0.2, 0.3], device=dev), 3,
                               render_types=types)
        target = torch.rand((H, W, 3), generator=torch.Generator(
            device="cpu").manual_seed(2)).to(dev)
        ((out.render - target) ** 2).sum().backward()
        outs.append(out)
        grads.append({k: getattr(leaves, k).grad.cpu()
                      for k in ("means", "scales", "rotations", "opacities",
                                "shs_dc", "shs_rest")})
    for key in ("render", "alpha", "exp_depth", "inverse_depth", "normal",
                "hard_inverse_depth"):
        got = getattr(outs[0], key).detach().cpu()
        assert bool(torch.isfinite(got).all()), key
        assert close_share(got, getattr(outs[1], key).detach()) >= SHARE, key
    for k, got in grads[0].items():
        want = grads[1][k]
        assert bool(torch.isfinite(got).all()), k
        scale = float(want.abs().max())
        bad = (got - want).abs() > 1e-3 * scale + 1e-2 * want.abs()
        assert float(bad.float().mean()) <= 1e-3, k


@pytest.mark.cuda
def test_stp_saturated_tile_is_finite_on_the_card(cuda):
    """64 Gaussians of opacity 0.99 on one spot: T_final is 0 there, and
    the card's gradients are finite and the CPU's."""
    rng = np.random.RandomState(5)
    n = 64
    arrays = dict(means2d=8.0 + 0.05 * rng.randn(n, 2),
                  conics=np.tile([0.05, 0.0, 0.05], (n, 1)),
                  opac=np.full(n, 0.99), ch=rng.rand(n, 3))
    depths, kz = rng.rand(n) * 3 + 1, rng.rand(n, 2) * 0.2
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [torch.tensor(arrays[k], dtype=torch.float32, device=dev,
                               requires_grad=True)
                  for k in ("means2d", "conics", "opac", "ch")]
        proj = Projections(
            means2d=leaves[0], conics=leaves[1],
            depths=torch.tensor(depths, dtype=torch.float32, device=dev),
            radii=torch.full((n,), 8, dtype=torch.int32, device=dev),
            compensations=None, mask=None,
            depth_grads=torch.tensor(kz, dtype=torch.float32, device=dev))
        img, alpha, aux = R.rasterize(proj, leaves[2], leaves[3], 16, 16, TS,
                                      True, stp_resort=True)
        assert float(aux.t_final.min()) == 0.0
        (img.sum() + 2.0 * alpha.sum()).backward()
        grads.append([x.grad.cpu() for x in leaves])
    for got, want in zip(*grads):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, rtol=1e-2,
                                   atol=1e-3 * float(want.abs().max()))


@pytest.mark.cuda
def test_stp_wrappers_reject_what_the_kernels_do_not_take(cuda):
    proj, op, ch, isects, args, gen = _stp_inputs(cuda, 3, n=100)
    with pytest.raises(ValueError):
        R.expand(*args[:9], True)                  # no depth_grads
    with pytest.raises(TypeError):
        R.expand(*args[:10], args[10].double())
    keys, gids = R.expand(*args)
    sk, gs, _ = R.sort_slots(keys, gids)
    bounds = R.tile_bounds(sk, (W // TS) * (H // TS))
    fwd = (proj.means2d, proj.conics, op, ch, proj.depths,
           proj.depth_grads.contiguous(), gs, bounds, H, W, TS)
    with pytest.raises(TypeError):
        STP.rasterize_fwd_stp(*fwd[:4], fwd[4].double(), *fwd[5:])
    with pytest.raises(ValueError):
        STP.rasterize_fwd_stp(*fwd[:5], fwd[5].cpu(), *fwd[6:])
    out, t_fin, _, ckpt = STP.rasterize_fwd_stp(*fwd, checkpoints=True)
    g_out, g_alpha = torch.zeros_like(out), torch.zeros_like(t_fin)
    with pytest.raises(ValueError):                # another scene's rows
        STP.rasterize_bwd_stp(*fwd[:8], g_out, g_alpha, t_fin, ckpt[:-1], TS)
    with pytest.raises(TypeError):
        STP.rasterize_bwd_stp(*fwd[:8], g_out.double(), g_alpha, t_fin, ckpt,
                              TS)


@pytest.mark.cuda
@pytest.mark.parametrize("stp", [False, True], ids=["depth", "stp"])
@pytest.mark.parametrize("case", sorted(slot_cases.K1_CASES))
def test_k1_edge_cases_equal_plain(cuda, case, stp):
    """K1 over runs that a Gaussian count fills unevenly, empty rectangles
    and a rectangle of 40 x 40 tiles (slot_cases): bit for bit, twice."""
    args = slot_cases.expand_args(case, stp=stp, device=cuda)
    before = R.expand.launches
    keys, gids = R.expand(*args)
    assert R.expand.launches == before + 1
    keys_p, gids_p = R.expand_plain(*args)
    assert torch.equal(keys, keys_p) and torch.equal(gids, gids_p)
    again = R.expand(*args)
    assert torch.equal(keys, again[0]) and torch.equal(gids, again[1])
    assert_attributes(R.expand_attributes())


@pytest.mark.cuda
@pytest.mark.parametrize("case", slot_cases.K5_CASES)
def test_k5_edge_cases_equal_plain(cuda, case):
    """K5 over K1's slot cases as surfels, rectangles whose rows pass
    tiles_y, one surfel and none (slot_cases): bit for bit, twice."""
    args = slot_cases.surfel_expand_args(case, device=cuda)
    n = args[1].shape[0]
    before = SR.surfel_expand.launches
    keys, gids = SR.surfel_expand(*args)
    assert SR.surfel_expand.launches == before + (n > 0)
    keys_p, gids_p = SR.surfel_expand_plain(*args)
    assert torch.equal(keys, keys_p) and torch.equal(gids, gids_p)
    again = SR.surfel_expand(*args)
    assert torch.equal(keys, again[0]) and torch.equal(gids, again[1])
    attrs = SR.surfel_expand_attributes()
    assert_attributes(attrs)
    assert attrs["local_bytes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_abs", [0, 2])
@pytest.mark.parametrize("n_cols", [9, 14, 19, 33, 300])
def test_k4_edge_cases_sum_in_slot_order(cuda, n_cols, n_abs):
    """K4 over the same slots, with fewer valid rows than slots and a
    Gaussian of more slots than a staging pass: equal to the float32 sums
    in slot order bit for bit, twice, and within 1e-5 of the summed
    magnitudes of index_add_'s."""
    rows, gids, offsets, inv, n_valid, n = slot_cases.reduce_args(
        n_cols, device=cuda)
    before = R.reduce_grads.launches
    got = R.reduce_grads(rows, gids, offsets, inv, n_valid, n, n_abs)
    assert R.reduce_grads.launches == before + 1
    want = R.reduce_grads_slot_order(rows, offsets, inv, n_valid, n, n_abs)
    assert torch.equal(got, want)
    assert torch.equal(got, R.reduce_grads(rows, gids, offsets, inv,
                                           n_valid, n, n_abs))
    plain = R.reduce_grads_plain(rows, gids, n, n_abs)
    into = R.reduce_grads_plain(rows.abs(), gids, n, n_abs)
    assert bool(((got - plain).abs() <= 1e-5 * into).all())
    assert_attributes(R.reduce_grads_attributes(n_cols, n_abs))


@pytest.mark.cuda
@pytest.mark.parametrize("n_cols", [9, 33, 300])
def test_k4_with_gaussians_without_slots(cuda, n_cols):
    """Zeros for a Gaussian without slots where a staging pass begins or a
    run of several passes ends, in every run."""
    rows, gids, offsets, inv, n_valid, n = slot_cases.reduce_args(
        n_cols, without_slots=True, device=cuda)
    got = R.reduce_grads(rows, gids, offsets, inv, n_valid, n)
    want = R.reduce_grads_slot_order(rows, offsets, inv, n_valid, n)
    assert torch.equal(got, want)
    assert torch.equal(got[1::2], torch.zeros_like(got[1::2]))
    assert torch.equal(got, R.reduce_grads(rows, gids, offsets, inv,
                                           n_valid, n))


@pytest.mark.cuda
def test_k4_with_no_valid_slot(cuda):
    rows, gids, offsets, inv, n_valid, n = slot_cases.reduce_args(
        9, all_invalid=True, device=cuda)
    got = R.reduce_grads(rows, gids, offsets, inv, n_valid, n)
    assert torch.equal(got, torch.zeros_like(got))
    assert not bool(torch.signbit(got).any())


def _variant_grads(trainer, state, dev, target):
    """The loss of `trainer`'s render_losses on one view and its gradients
    for the six parameter tensors, on `dev`."""
    leaves = state.params.map(lambda _, x: x.detach().requires_grad_(True))
    tap = torch.zeros((state.capacity, 2), device=dev, requires_grad=True)
    loss, (_, _, _) = trainer.render_losses(
        dataclasses.replace(state, params=leaves), camera(dev), H, W,
        torch.tensor([0.1, 0.2, 0.3], device=dev), 3, target, None, tap,
        None, 0)
    grads = torch.autograd.grad(loss, [getattr(leaves, k)
                                       for k in PARAM_FIELDS])
    return float(loss.detach()), {k: g.cpu()
                                  for k, g in zip(PARAM_FIELDS, grads)}


def _assert_grads_close(got, want):
    """The rule of test_parameter_gradients_on_card_match_cpu: 1e-3 of the
    tensor's largest gradient + 1e-2 |ref| at all but 1e-3 of the values."""
    for k, g in got.items():
        w = want[k]
        assert bool(torch.isfinite(g).all()), k
        bad = (g - w).abs() > 1e-3 * float(w.abs().max()) + 1e-2 * w.abs()
        assert float(bad.float().mean()) <= 1e-3, k


@pytest.mark.cuda
def test_mip_splatting_on_card_matches_cpu(cuda):
    """A small scene with a 3D filter through MipSplattingRenderer: the
    card's frame and the gradients of one step's loss (through the
    filtered scales and the compensated opacities) against the CPU's."""
    from gsl_tpu_torch.models.mip_splatting import (MipSplattingConfig,
                                                    compute_3d_filter)
    from gsl_tpu_torch.renderers.mip_splatting_renderer import \
        MipSplattingRendererConfig
    from gsl_tpu_torch.training.trainer import Trainer
    arrays = scene(1500, seed=3)
    trainer = Trainer(model=MipSplattingConfig(),
                      renderer=MipSplattingRendererConfig())
    target = torch.rand((H, W, 3), generator=torch.Generator(
        device="cpu").manual_seed(4))
    frames, losses, grads = [], [], []
    for dev in (cuda, torch.device("cpu")):
        state = state_from_raw_arrays(arrays, device=dev)
        state.extra = {"filter_3d": compute_3d_filter(
            state.params.means, state.alive,
            stack_cameras([camera(dev), camera(dev, W // 2, H // 2)]))}
        with torch.no_grad():
            frames.append(trainer.renderer.forward(
                state, camera(dev), H, W, torch.zeros(3, device=dev),
                3).render.cpu())
        loss, g = _variant_grads(trainer, state, dev, target.to(dev))
        losses.append(loss)
        grads.append(g)
    assert close_share(frames[0], frames[1]) >= SHARE
    assert losses[0] == pytest.approx(losses[1], rel=1e-4)
    _assert_grads_close(grads[0], grads[1])


@pytest.mark.cuda
def test_mcmc_on_card_matches_cpu_and_repeats(cuda):
    """One step's MCMC loss (with its opacity and scale terms) and
    gradients, card against CPU; the noise and a relocation and growth
    round from the same draws, card against CPU (float32 reductions in
    another order: rtol 1e-5); and a round from a card generator twice
    from one generator state: identical."""
    from gsl_tpu_torch.training.mcmc import (MCMCDensityControllerConfig,
                                             grow_target, mcmc_densify,
                                             mcmc_noise_step)
    from gsl_tpu_torch.training.metrics import MCMCMetricsConfig
    from gsl_tpu_torch.training.trainer import Trainer
    arrays = scene(1500, seed=5)
    arrays["opacities"][:75] = -7.0              # 5% dead
    cfg = MCMCDensityControllerConfig(cap_max=4000)
    n_new = grow_target(1500, cfg) - 1500
    trainer = Trainer(density=cfg, metrics=MCMCMetricsConfig())
    target = torch.rand((H, W, 3), generator=torch.Generator(
        device="cpu").manual_seed(6))
    rng = np.random.RandomState(7)
    eps = torch.from_numpy(rng.normal(size=(2048, 3)).astype(np.float32))
    draws = (torch.from_numpy(rng.randint(75, 1500, 75)),
             torch.from_numpy(rng.randint(0, 1500, n_new)))
    losses, grads, rounds = [], [], []
    for dev in (cuda, torch.device("cpu")):
        state = trainer.setup(grow_capacity(state_from_raw_arrays(
            arrays, device=dev), 2048), 1.0)
        loss, g = _variant_grads(trainer, state.gaussians, dev,
                                 target.to(dev))
        losses.append(loss)
        grads.append(g)
        noisy = mcmc_noise_step(eps.to(dev), state.gaussians,
                                torch.tensor(1e-4), cfg.noise_lr)
        got, _, added = mcmc_densify(
            tuple(d.to(dev) for d in draws), noisy, state.opt_state, cfg)
        assert added == n_new > 70
        rounds.append(got)
    assert losses[0] == pytest.approx(losses[1], rel=1e-4)
    _assert_grads_close(grads[0], grads[1])
    assert torch.equal(rounds[0].alive.cpu(), rounds[1].alive)
    for k in PARAM_FIELDS:
        np.testing.assert_allclose(
            getattr(rounds[0].params, k).cpu().numpy(),
            getattr(rounds[1].params, k).numpy(), rtol=1e-5, atol=1e-6,
            err_msg=k)

    state = trainer.setup(grow_capacity(state_from_raw_arrays(
        arrays, device=cuda), 2048), 1.0)
    gen = torch.Generator(device=cuda).manual_seed(8)
    saved = gen.get_state()
    twice = []
    for _ in range(2):
        gen.set_state(saved)
        twice.append(mcmc_densify(gen, state.gaussians, state.opt_state,
                                  cfg))
    (a, a_opt, n_a), (b, b_opt, n_b) = twice
    assert n_a == n_b == n_new and torch.equal(a.alive, b.alive)
    for k in PARAM_FIELDS:
        assert torch.equal(getattr(a.params, k), getattr(b.params, k)), k
        assert torch.equal(a_opt.exp_avg[k], b_opt.exp_avg[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["mlp", "hexplane", "pvg"])
def test_deform_and_pvg_steps_on_card_match_cpu(cuda, variant):
    """One DeformTrainer step after the warm-up (the MLP at 4 x 32 with
    its skip at 2, given the AST draw; HexPlane at its defaults) and one
    PVG step at time 0.4, card against CPU from the same state and
    weights: the loss, the Gaussians' gradients (first moments / 0.1) by
    the rule of test_parameter_gradients_on_card_match_cpu, and the
    field's by the same rule; K1-K4 launched once each in the card's
    step."""
    from gsl_tpu_torch.models.deform import DeformModelConfig
    from gsl_tpu_torch.models.gaussian import VanillaGaussianConfig
    from gsl_tpu_torch.models.pvg import PVGConfig, PVGRendererConfig
    from gsl_tpu_torch.training.deform_trainer import DeformTrainer
    from gsl_tpu_torch.training.trainer import Trainer
    arrays = scene(1500, seed=9)
    pvg = variant == "pvg"
    model = (PVGConfig if pvg else VanillaGaussianConfig)(sh_degree=1)
    if pvg:
        trainer = Trainer(model=model, renderer=PVGRendererConfig())
    else:
        trainer = DeformTrainer(model=model, field=variant,
                                deform_cfg=DeformModelConfig(
                                    n_neurons=32, n_layers=4,
                                    skip_layers=(2,)))
        # heads away from zero, so every layer of the field has a gradient
        gen = torch.Generator().manual_seed(10)
        with torch.no_grad():
            for layer in list(trainer.deform_net.layers)[-3:]:
                layer.weight.normal_(0.0, 0.02, generator=gen)
    rgb = np.random.RandomState(11).uniform(0, 1, (1500, 3))
    velocities = torch.from_numpy(np.random.RandomState(13).normal(
        size=(2000, 3)).astype(np.float32))
    target = torch.rand((H, W, 3), generator=torch.Generator(
        device="cpu").manual_seed(12))
    states, losses, launches = [], [], {}
    for dev in (cuda, torch.device("cpu")):
        gaussians = model.init_from_pcd(arrays["means"], rgb, 2000, dev)
        if pvg:
            gaussians.params.velocities = velocities.to(dev)
        state = trainer.setup(gaussians, 1.0)
        cam = dataclasses.replace(camera(dev),
                                  time=torch.tensor(0.4, device=dev))
        for w in (R.expand, R.rasterize_fwd, R.rasterize_bwd,
                  R.reduce_grads):
            w.launches = 0
        bg = torch.zeros(3, device=dev)
        if pvg:
            out, sc = trainer.train_step(state, cam, target.to(dev), H, W,
                                         1, bg)
        else:
            out, sc = trainer.train_step_deform(
                state, cam, target.to(dev), H, W, 1, bg, False,
                ast_draw=torch.tensor(0.7, device=dev))
        if dev.type == "cuda":
            launches = {w.__name__: w.launches for w in (
                R.expand, R.rasterize_fwd, R.rasterize_bwd,
                R.reduce_grads)}
        states.append(out)
        losses.append(float(sc["loss"]))
    assert set(launches.values()) == {1}, launches
    assert losses[0] == pytest.approx(losses[1], rel=1e-4)
    got, want = states
    fields = want.params.fields()
    _assert_grads_close(
        {k: got.opt_state.exp_avg[k].cpu() / 0.1 for k in fields},
        {k: want.opt_state.exp_avg[k] / 0.1 for k in fields})
    if not pvg:
        net, wnet = got.extra["__deform__"], want.extra["__deform__"]
        assert net["opt"]["count"] == wnet["opt"]["count"] == 1
        _assert_grads_close(
            {k: v.cpu() / 0.1 for k, v in net["opt"]["exp_avg"].items()},
            {k: v / 0.1 for k, v in wnet["opt"]["exp_avg"].items()})


@pytest.mark.cuda
def test_chip_smoke_passes(cuda):
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1].startswith('{"ok": true')


# ---- any channel count through the backward kernels -------------------------

def bwd_launches(n_channels, max_group, group=None, default=None):
    """The launches of a backward wrapper at C channels: one per group of
    `group`, or where None of `default` (the kernel's largest where that
    is None too: K3s, K7), at most the kernel's largest."""
    want = default if group is None else group
    g = max_group if want is None else min(want, max_group)
    return -(-n_channels // g)


@pytest.mark.cuda
@pytest.mark.parametrize("n_channels", [37, 64, 128])
def test_backward_kernel_takes_any_channel_count(cuda, n_channels):
    """K3 past its largest group (36 at tile 16, from its shared memory):
    the wrapper launches once per channel group and adds the groups'
    geometry columns. The rows, by default and in groups of 8 and of 36,
    are held to the plain version's one pass as at C <= 36; the build
    without contraction column by column; identical in two runs. K4 sums
    the 8 + C columns equal to the sums in slot order, twice."""
    assert R.rasterize_bwd_max_group(TS) == 36
    bwd, isects, order, n = _backward_inputs(cuda, n_channels, n=1500)
    gs, bounds = bwd[4], bwd[5]
    before = R.rasterize_bwd.launches
    rows = R.rasterize_bwd(*bwd)
    torch.cuda.synchronize()
    assert R.rasterize_bwd.launches == before + bwd_launches(
        n_channels, 36, default=R.K3_GROUP)
    rows_p = R.rasterize_bwd_plain(*bwd)
    assert rows.shape == rows_p.shape == (gs.numel(), 6 + n_channels)
    assert bool(torch.isfinite(rows).all())
    assert float(rows_p.abs().max()) > 1.0
    assert close_share_grad(rows, rows_p) >= SHARE
    for group in (8, 36):
        before = R.rasterize_bwd.launches
        got = R.rasterize_bwd(*bwd, group=group)
        assert R.rasterize_bwd.launches == before + bwd_launches(
            n_channels, 36, group)
        assert close_share_grad(got, rows_p) >= SHARE
    loose = R.rasterize_bwd(*bwd, contract=False)
    shares = column_shares(loose, rows_p)
    assert min(shares) >= SHARE, shares
    assert torch.equal(rows, R.rasterize_bwd(*bwd))          # no atomics
    red = (rows, gs, isects.offsets, R.invert_order(order), bounds[-1:], n)
    summed = R.reduce_grads(*red)
    assert summed.shape == (n, 8 + n_channels)
    assert torch.equal(summed, R.reduce_grads_slot_order(rows, *red[2:]))
    assert torch.equal(summed, R.reduce_grads(*red))
    into = R.reduce_grads_plain(rows.abs(), gs, n)
    assert bool(((summed - R.reduce_grads_plain(rows, gs, n)).abs()
                 <= 1e-5 * into).all())


@pytest.mark.cuda
def test_stp_backward_kernel_takes_any_channel_count(cuda):
    """K3s past its largest group (88 at tile 16): C = 96 in two launches
    by default and in 12 of 8 channels, held to the plain version as at
    C = 27; identical in two runs."""
    n_channels = 96
    assert STP.rasterize_bwd_stp_max_group(TS) == 88
    proj, op, ch, isects, args, gen = _stp_inputs(cuda, n_channels, n=1500)
    keys, gids = R.expand(*args)
    sk, gs, order = R.sort_slots(keys, gids)
    bounds = R.tile_bounds(sk, args[5] * args[6])
    fwd = (proj.means2d, proj.conics, op, ch, proj.depths,
           proj.depth_grads.contiguous(), gs, bounds, H, W, TS)
    out, t_fin, stop, ckpt = STP.rasterize_fwd_stp(*fwd, checkpoints=True)
    _, t_p, _, ckpt_p = STP.rasterize_fwd_stp_plain(*fwd, checkpoints=True)
    g_out = torch.randn((H, W, n_channels), generator=gen).to(cuda)
    g_alpha = torch.randn((H, W), generator=gen).to(cuda)
    bwd = (*fwd[:8], g_out, g_alpha, t_fin, ckpt, TS)
    before = STP.rasterize_bwd_stp.launches
    rows = STP.rasterize_bwd_stp(*bwd)
    torch.cuda.synchronize()
    assert STP.rasterize_bwd_stp.launches == before + bwd_launches(
        n_channels, 88)
    rows_p = STP.rasterize_bwd_stp_plain(*fwd[:8], g_out, g_alpha, t_p,
                                         ckpt_p, TS)
    assert rows.shape == rows_p.shape == (gs.numel(), 6 + n_channels)
    assert bool(torch.isfinite(rows).all())
    assert close_share_grad(rows, rows_p) >= SHARE
    before = STP.rasterize_bwd_stp.launches
    got = STP.rasterize_bwd_stp(*bwd, group=8)
    assert STP.rasterize_bwd_stp.launches == before + 12
    assert close_share_grad(got, rows_p) >= SHARE
    assert torch.equal(rows, STP.rasterize_bwd_stp(*bwd))    # no atomics


@pytest.mark.cuda
def test_surfel_backward_kernel_takes_any_channel_count(cuda):
    """K7 past its largest group (60 at tile 16): C = 64 in two launches
    by default and in groups of 8, alpha, depth and distortion cotangents
    with the first group, held to the plain version column by column as
    at C = 20; identical in two runs."""
    n_channels, n = 64, 1500
    assert SR.rasterize_surfels_bwd_max_group(TS) == 60
    proj, geom, ch, isects, gen = _surfel_inputs(cuda, n_channels, n)
    keys, gids = SR.surfel_expand(isects, proj.depths.contiguous(),
                                  -(-W // TS), -(-H // TS))
    sk, gs, order = R.sort_slots(keys, gids)
    bounds = R.tile_bounds(sk, (-(-W // TS)) * (-(-H // TS)))
    out, aux, stop = SR.rasterize_surfels_fwd(geom, ch, gs, bounds, H, W,
                                              TS)
    g_out = torch.randn((H, W, n_channels), generator=gen).to(cuda)
    g_aux = torch.randn((3, H, W), generator=gen).to(cuda)
    bwd = (geom, ch, gs, bounds, g_out, g_aux, aux, stop, TS)
    before = SR.rasterize_surfels_bwd.launches
    rows = SR.rasterize_surfels_bwd(*bwd)
    torch.cuda.synchronize()
    assert SR.rasterize_surfels_bwd.launches == before + bwd_launches(
        n_channels, 60)
    rows_p = SR.rasterize_surfels_bwd_plain(*bwd)
    assert rows.shape == rows_p.shape == (gs.numel(), 13 + n_channels)
    assert bool(torch.isfinite(rows).all())
    shares = column_shares(rows, rows_p)
    assert min(shares) >= SURFEL_GRAD_SHARE, shares
    shares = column_shares(SR.rasterize_surfels_bwd(*bwd, group=8), rows_p)
    assert min(shares) >= SURFEL_GRAD_SHARE, shares
    assert torch.equal(rows, SR.rasterize_surfels_bwd(*bwd))  # no atomics


@pytest.mark.cuda
def test_sharded_step_on_card_stages_through_the_host(cuda):
    """gsl_tpu_torch.parallel on the card: 2 ranks (dp 1 x mp 2) share it
    over gloo, every collective staged through page-locked host buffers;
    the step's loss, radii and first moments agree with the same 2 ranks
    on the CPU (the plain versions of the kernels) at the kernels' shares,
    and the card ranks launch K1-K4 once each."""
    import torch_parallel_ranks as ranks
    from gsl_tpu_torch.parallel.launch import spawn
    from gsl_tpu_torch.tools.mp_scaling_table import synthetic_arrays
    n, cap, h, w = 3000, 4096, 64, 96
    state = synthetic_arrays(n, cap, sh_degree=1)
    state["params"]["means"][:n, 2] -= 1.5     # into the cameras' view
    cams = [{"R": np.eye(3), "T": np.array([0.3 * i - 0.15, 0.0, 0.0]),
             "fx": 90.0, "fy": 90.0, "cx": w / 2, "cy": h / 2, "width": w,
             "height": h} for i in range(2)]
    gts = np.random.RandomState(3).uniform(0, 1, (2, h, w, 3)).astype(
        np.float32)
    bg = np.zeros(3, np.float32)
    args = (1, 2, state, cams, gts, None, bg, h, w, 1)
    card = spawn(ranks.sharded_step, 2, "cuda", args=args + (None, "cuda"))
    cpu = spawn(ranks.sharded_step, 2, "cpu", args=args + (None, "cpu"))
    got, want = card[0], cpu[0]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)
    assert float(np.mean(got["radii"] == want["radii"])) >= SHARE
    for k in PARAM_FIELDS:
        g, r = torch.from_numpy(got["mu"][k]), torch.from_numpy(want["mu"][k])
        scale = float(r.abs().max()) + 1e-12
        assert close_share(g / scale, r / scale) >= SHARE, k
    ex = got["exchange"]
    assert ex["fwd_calls"] == ex["bwd_calls"] == 1
    assert ex["staged_copies"] > 0 and ex["staged_bytes"] > 0
    assert want["exchange"]["staged_copies"] == 0
    assert all(r["launches"] == dict.fromkeys(
        ("expand", "rasterize_fwd", "rasterize_bwd", "reduce_grads"), 1)
        for r in card)
    assert all(set(r["launches"].values()) == {0} for r in cpu)


def _sh_inputs(cuda, n, n_rest, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    means = torch.randn((n, 3), generator=gen) * 2.0
    dc = torch.randn((n, 1, 3), generator=gen) * 2.0
    rest = torch.randn((n, n_rest, 3), generator=gen) * 0.3
    grad = torch.randn((n, 11), generator=gen)[:, 8:]  # a row stride of 11
    return [t.to(cuda) for t in (means, torch.tensor([0.5, -1.0, 2.0]), dc,
                                 rest)] + [grad.to(cuda)]


SH_CARD_CASES = [pytest.param(d, r, 300, id=f"degree{d}-rest{r}")
                 for d in range(4) for r in (0, 3, 8, 15)
                 if (d + 1) ** 2 <= 1 + r] + [
    pytest.param(3, 15, 1_000_000, id="degree3-rest15-1M")]


@pytest.mark.cuda
@pytest.mark.parametrize("degree,n_rest,n", SH_CARD_CASES)
def test_sh_kernels_match_plain(cuda, degree, n_rest, n):
    means, centre, dc, rest, grad = _sh_inputs(cuda, n, n_rest, seed=degree)
    before = (SH.sh_colors_fwd.launches, SH.sh_colors_bwd.launches)
    rgb, mask = SH.sh_colors_fwd(means, centre, dc, rest, degree)
    g_dc, g_rest = SH.sh_colors_bwd(grad, means, centre, mask, degree,
                                    n_rest)
    torch.cuda.synchronize()
    assert (SH.sh_colors_fwd.launches, SH.sh_colors_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want_rgb, want_mask = SH.sh_colors_fwd_plain(means, centre, dc, rest,
                                                 degree)
    same = mask == want_mask
    assert float(same.float().mean()) >= 0.9999
    assert 0.05 < float((want_rgb == 0).float().mean()) < 0.6
    assert torch.allclose(rgb, want_rgb, rtol=2e-5, atol=2e-5)
    want_dc, want_rest = SH.sh_colors_bwd_plain(grad, means, centre, mask,
                                                degree, n_rest)
    assert torch.allclose(g_dc, want_dc, rtol=2e-5, atol=2e-5)
    assert torch.allclose(g_rest, want_rest, rtol=2e-5, atol=2e-5)
    assert bool((g_rest[:, (degree + 1) ** 2 - 1:] == 0).all())
    # the backward from the plain forward's mask: the rows that agree
    g_dc_p, g_rest_p = SH.sh_colors_bwd_plain(grad, means, centre, want_mask,
                                              degree, n_rest)
    assert torch.allclose(g_rest[same], g_rest_p[same], rtol=2e-5, atol=2e-5)
    print(f"SH degree {degree} K-1 {n_rest} n {n}: bit-equal colours "
          f"{float((rgb == want_rgb).float().mean()):.6f}, gradients "
          f"{float((g_rest == want_rest).float().mean()):.6f}, masks "
          f"{float(same.float().mean()):.6f}")


@pytest.mark.cuda
def test_sh_wrappers_reject_what_the_kernels_do_not_take(cuda):
    means, centre, dc, rest, grad = _sh_inputs(cuda, 200, 15)
    with pytest.raises(TypeError):
        SH.sh_colors_fwd(means, centre, dc, rest.double(), 3)
    with pytest.raises(ValueError):
        SH.sh_colors_fwd(means, centre.cpu(), dc, rest, 3)
    with pytest.raises(ValueError):
        SH.sh_colors_fwd(means, centre, dc,
                         rest.transpose(0, 1).contiguous().transpose(0, 1),
                         3)
    with pytest.raises(ValueError):
        SH.sh_colors_fwd(means, centre, dc, rest[:, :7].contiguous(), 3)
    with pytest.raises(ValueError):
        SH.sh_colors_fwd(means, centre, dc, rest, 4)
    _, mask = SH.sh_colors_fwd(means, centre, dc, rest, 3)
    with pytest.raises(TypeError):
        SH.sh_colors_bwd(grad.double(), means, centre, mask, 3, 15)
    with pytest.raises(TypeError):
        SH.sh_colors_bwd(grad, means, centre, mask.to(torch.int32), 3, 15)
    with pytest.raises(ValueError):
        SH.sh_colors_bwd(grad.t().contiguous().t(), means, centre, mask, 3,
                         15)
    with pytest.raises(ValueError):
        SH.sh_colors_bwd(grad, means, centre, mask, 3, 8)
    assert_attributes(SH.sh_colors_fwd_attributes(3, 15))
    assert_attributes(SH.sh_colors_bwd_attributes(3, 15))


@pytest.mark.cuda
def test_renderer_step_launches_each_sh_kernel_once(cuda):
    """One TileRenderer forward and backward on the card: one launch of
    each SH kernel, the SH gradients as the CPU's (the tolerance of
    test_parameter_gradients_on_card_match_cpu: they reach SH through the
    rasterizer's)."""
    arrays = scene(1500, seed=3)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        state = state_from_raw_arrays(arrays, device=dev)
        leaves = state.params.map(lambda _, x: x.requires_grad_(True))
        state.params = leaves
        before = (SH.sh_colors_fwd.launches, SH.sh_colors_bwd.launches)
        out = TileRendererConfig().instantiate().forward(
            state, camera(dev), H, W, torch.zeros(3, device=dev), 3)
        target = torch.rand((H, W, 3), generator=torch.Generator(
            device="cpu").manual_seed(2)).to(dev)
        ((out.render - target) ** 2).sum().backward()
        launched = (SH.sh_colors_fwd.launches - before[0],
                    SH.sh_colors_bwd.launches - before[1])
        assert launched == ((1, 1) if dev.type == "cuda" else (0, 0))
        grads.append({k: getattr(leaves, k).grad.cpu()
                      for k in ("shs_dc", "shs_rest")})
    for k, got in grads[0].items():
        want = grads[1][k]
        assert bool(torch.isfinite(got).all()), k
        scale = float(want.abs().max())
        assert scale > 0.0, k
        bad = (got - want).abs() > 1e-3 * scale + 1e-2 * want.abs()
        assert float(bad.float().mean()) <= 1e-3, k
