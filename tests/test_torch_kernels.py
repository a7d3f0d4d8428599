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
(hence a share of values, not all of them).
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
    sk, gs = R.sort_slots(keys, gids)
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


@pytest.mark.cuda
def test_chip_smoke_passes(cuda):
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1].startswith('{"ok": true')
