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
(hence a share of values, not all of them). K3 (backward) recomputes the
same alphas, so the same flips move single gradient rows: its rows, and
K4's per-Gaussian sums of them, are held to rtol 1e-3 / atol 1e-3 at
>= 99.9% of the values (the gradients of the test loss reach the
hundreds, and T / (1 - alpha) walked backwards rounds differently with
and without contraction). K4 on identical rows differs from `index_add_`
only in the order of its float32 additions.
"""
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from gsl_tpu_torch.data.cameras import make_camera
from gsl_tpu_torch.ops import rasterize as R
from gsl_tpu_torch.ops.projection import project_gaussians
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


def camera(device):
    return make_camera(R=np.eye(3), T=np.zeros(3), fx=110.0, fy=110.0,
                       cx=W / 2, cy=H / 2, width=W, height=H, device=device)


def close_share(got, want):
    bad = (got - want).abs() > ATOL + RTOL * want.abs()
    return 1.0 - float(bad.float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("n_channels", [3, 8, 11])
def test_kernels_match_plain(cuda, n_channels):
    """C = 11 takes two launches of channel groups (8 + 3)."""
    state = state_from_raw_arrays(scene(3000), device=cuda)
    cam = camera(cuda)
    proj = project_gaussians(state.get_means(), state.get_scales(),
                             state.get_rotations(), cam.world_to_camera,
                             cam.fx, cam.fy, cam.cx, cam.cy, W, H)
    op = state.get_opacities().contiguous()
    ch = torch.rand((3000, n_channels), generator=torch.Generator(
        device="cpu").manual_seed(0)).to(cuda)
    isects = R.isect_encode(proj, H, W, TS)
    args = (isects, proj.means2d, proj.conics, op, proj.depths, W // TS,
            H // TS, TS, True)
    before = R.expand.launches
    keys, gids = R.expand(*args)
    assert R.expand.launches == before + 1
    keys_p, gids_p = R.expand_plain(*args)
    assert torch.equal(keys, keys_p) and torch.equal(gids, gids_p)
    sk, gs, _ = R.sort_slots(keys, gids)
    bounds = R.tile_bounds(sk, (W // TS) * (H // TS))
    fwd = (proj.means2d, proj.conics, op, ch, gs, bounds, H, W, TS)
    before = R.rasterize_fwd.launches
    out, t_fin, stop = R.rasterize_fwd(*fwd)
    torch.cuda.synchronize()
    assert R.rasterize_fwd.launches == before + -(-n_channels // 8)
    out_p, t_p, stop_p = R.rasterize_fwd_plain(*fwd)
    assert float((stop == stop_p).float().mean()) >= SHARE
    assert bool((stop < R.NEVER_STOPPED).any())
    assert close_share(out, out_p) >= SHARE
    assert close_share(t_fin, t_p) >= SHARE


def _backward_inputs(cuda, n_channels, n=3000):
    state = state_from_raw_arrays(scene(n), device=cuda)
    cam = camera(cuda)
    proj = project_gaussians(state.get_means(), state.get_scales(),
                             state.get_rotations(), cam.world_to_camera,
                             cam.fx, cam.fy, cam.cx, cam.cy, W, H)
    op = state.get_opacities().contiguous()
    gen = torch.Generator(device="cpu").manual_seed(0)
    ch = torch.rand((n, n_channels), generator=gen).to(cuda)
    isects = R.isect_encode(proj, H, W, TS)
    keys, gids = R.expand(isects, proj.means2d, proj.conics, op,
                          proj.depths, W // TS, H // TS, TS, True)
    sk, gs, order = R.sort_slots(keys, gids)
    bounds = R.tile_bounds(sk, (W // TS) * (H // TS))
    out, t_fin, stop = R.rasterize_fwd(proj.means2d, proj.conics, op, ch,
                                       gs, bounds, H, W, TS)
    g_out = torch.randn((H, W, n_channels), generator=gen).to(cuda)
    g_alpha = torch.randn((H, W), generator=gen).to(cuda)
    bwd = (proj.means2d, proj.conics, op, ch, gs, bounds, g_out, g_alpha,
           t_fin, stop, TS)
    return bwd, isects, order, n


def close_share_grad(got, want):
    bad = (got - want).abs() > 1e-3 + RTOL * want.abs()
    return 1.0 - float(bad.float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("n_channels", [3, 8, 11])
def test_backward_kernels_match_plain(cuda, n_channels):
    """C = 11 takes K3's path with the cotangents in shared memory."""
    bwd, isects, order, n = _backward_inputs(cuda, n_channels)
    gs, bounds = bwd[4], bwd[5]
    before = R.rasterize_bwd.launches
    rows = R.rasterize_bwd(*bwd)
    torch.cuda.synchronize()
    assert R.rasterize_bwd.launches == before + 1
    rows_p = R.rasterize_bwd_plain(*bwd)
    assert rows.shape == rows_p.shape == (gs.numel(), 6 + n_channels)
    assert bool(torch.isfinite(rows).all())
    assert float(rows_p.abs().max()) > 1.0
    assert close_share_grad(rows, rows_p) >= SHARE
    # twice the same: no atomics
    assert torch.equal(rows, R.rasterize_bwd(*bwd))

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
    bwd, isects, order, n = _backward_inputs(cuda, 3, n=100)
    with pytest.raises(TypeError):
        R.rasterize_bwd(*bwd[:6], bwd[6].double(), *bwd[7:])
    with pytest.raises(ValueError):
        R.rasterize_bwd(*bwd[:10], 5)      # 25 threads: no whole warp
    rows = R.rasterize_bwd(*bwd)
    with pytest.raises(TypeError):
        R.reduce_grads(rows, bwd[4], isects.offsets, order, bwd[5][-1:], n)


@pytest.mark.cuda
def test_chip_smoke_passes(cuda):
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1].startswith('{"ok": true')
