"""gsl_tpu_torch's Mip-Splatting and MCMC modules against gsl_tpu's on the
same seeded numpy inputs: the relocation correction, a relocation and
growth round with gsl_tpu's own draws, the position noise with its own
normal draws, build_cov3d, the 3D filter, the Mip-Splatting renderer and
its gradients, `extra` through every row edit, the port's capacity growth
where gsl_tpu stops at the capacity, and the hooks' schedules."""
import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_tpu.data.cameras import make_camera as jax_make_camera
from gsl_tpu.data.cameras import stack_cameras as jax_stack_cameras
from gsl_tpu.models import mip_splatting as jmip
from gsl_tpu.models.gaussian import GaussianParams as JaxParams
from gsl_tpu.models.gaussian import GaussianState as JaxState
from gsl_tpu.models.gaussian import grow_capacity as jax_grow_capacity
from gsl_tpu.ops.transforms import build_cov3d as jax_build_cov3d
from gsl_tpu.renderers.mip_splatting_renderer import \
    MipSplattingRendererConfig as JaxMipRendererConfig
from gsl_tpu.training import density as jd
from gsl_tpu.training import hooks as jh
from gsl_tpu.training import mcmc as jm

from gsl_tpu_torch.data.cameras import make_camera, stack_cameras
from gsl_tpu_torch.models.gaussian import GaussianState, grow_capacity
from gsl_tpu_torch.models.mip_splatting import (MipSplattingConfig,
                                                apply_3d_filter,
                                                compute_3d_filter)
from gsl_tpu_torch.ops.transforms import build_cov3d
from gsl_tpu_torch.renderers.mip_splatting_renderer import \
    MipSplattingRendererConfig
from gsl_tpu_torch.training import density as td
from gsl_tpu_torch.training import hooks as th
from gsl_tpu_torch.training import mcmc as tm
from gsl_tpu_torch.training.fit import FitConfig
from gsl_tpu_torch.training.trainer import Trainer
from gsl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from gsl_tpu_torch.utils.convert import (train_state_from_jax_arrays,
                                         train_state_to_numpy)

from test_torch_training import (_assert_opt_equal, _density_arrays,
                                 _port_opt, _random_jax_state,
                                 _stepped_jax_optimizer, _to_port)
from torch_port_utils import (PARAM_FIELDS, jax_train_state_arrays,
                              small_port_state, to_torch)

W, H = 64, 48
ONE_ULP = float(np.spacing(np.float32(1.0)))   # 1.19e-7, of 1.0


# ---- the relocation correction -------------------------------------------

def _correction_f64(o_old, n):
    """The correction in float64 from the float32 inputs."""
    o = o_old.astype(np.float64)
    o_new = 1.0 - np.maximum(1.0 - o, 1e-12) ** (1.0 / n)
    denom = np.array([sum((-1) ** k / math.sqrt(k + 1) * math.comb(
        int(m), k + 1) * on ** (k + 1) for k in range(int(m)))
        for on, m in zip(o_new, n)])
    return o_new, o / denom


def test_relocation_correction_matches_jax():
    """N = 1..51 (400 rows each), o in [0.005, 0.999]: within rtol 1e-5 of
    gsl_tpu. Both compute o_new = 1 - (1 - o)^(1/N) in float32, and the
    two float32 pows differ by one rounding on a few rows; the subtraction
    hands that on as an absolute error of half an ulp of 1.0 (6e-8), which
    on a small o_new is more than 1e-5 of it and enters s_new as the same
    share. The tolerance adds that one rounding: |d o_new| <= 1e-5 o_new +
    ulp(1) / 2 and |d s_new| <= (1e-5 + ulp(1) / o_new) |s_new|. Where
    the two o_new are equal, s_new agrees within 2e-6."""
    rng = np.random.RandomState(0)
    n = np.repeat(np.arange(1, 52), 400).astype(np.int32)
    o = rng.uniform(0.005, 0.999, n.size).astype(np.float32)
    s = np.exp(rng.uniform(-6, 0, (n.size, 3))).astype(np.float32)
    jo, js = (np.asarray(a) for a in jm.relocation_correction(
        jnp.asarray(o), jnp.asarray(s), jnp.asarray(n)))
    to_, ts = (a.numpy() for a in tm.relocation_correction(
        to_torch(o), to_torch(s), to_torch(n)))
    assert np.all(np.abs(to_ - jo) <= 1e-5 * jo + ONE_ULP / 2)
    rel_s = np.abs(ts - js) / np.abs(js)
    assert np.all(rel_s <= 1e-5 + ONE_ULP / jo[:, None])
    same = to_ == jo
    assert same.mean() > 0.99 and rel_s[same].max() <= 2e-6
    # N is clamped to [1, 51] on both sides
    big = np.array([0, 60, 51], np.int32)
    for a, b in zip(tm.relocation_correction(to_torch(o[:3]),
                                             to_torch(s[:3]), to_torch(big)),
                    jm.relocation_correction(jnp.asarray(o[:3]),
                                             jnp.asarray(s[:3]),
                                             jnp.asarray(big))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


@pytest.mark.parametrize("o_old", [0.9999, 0.99999, 1 - 1e-6, 1 - 1e-7])
def test_relocation_correction_near_the_clip(o_old):
    """Up to the clip 1 - 1e-7, N = 1..51: the alternating sum cancels, so
    both packages are held to a float64 evaluation instead of each other:
    o_new within 1e-6, s_new within 5e-3, a bound the cancellation of
    the float32 sum reaches a few tenths of at the clip on both sides."""
    n = np.arange(1, 52).astype(np.int32)
    o = np.full(n.size, o_old, np.float32)
    s = np.ones((n.size, 3), np.float32)
    want_o, want_coeff = _correction_f64(o, n)
    for o_new, s_new in (
            [a.numpy() for a in tm.relocation_correction(
                to_torch(o), to_torch(s), to_torch(n))],
            [np.asarray(a) for a in jm.relocation_correction(
                jnp.asarray(o), jnp.asarray(s), jnp.asarray(n))]):
        np.testing.assert_allclose(o_new, want_o, rtol=1e-6)
        np.testing.assert_allclose(s_new[:, 0], want_coeff, rtol=5e-3)


# ---- a relocation and growth round ---------------------------------------

def _with_dead(jstate, n_dead, seed):
    """jstate with `n_dead` of its alive rows at opacity 0.001."""
    alive_rows = np.flatnonzero(np.asarray(jstate.alive))
    rows = np.random.RandomState(seed).choice(alive_rows, n_dead,
                                              replace=False)
    op = np.asarray(jstate.params.opacities).copy()
    op[rows, 0] = np.log(0.001 / 0.999)
    return JaxState(params=jstate.params.replace(opacities=jnp.asarray(op)),
                    alive=jstate.alive)


def _jax_draws(key, jstate, opt_state, cfg):
    """gsl_tpu's two categorical draws of mcmc_densify(key, ...), taken as
    it takes them (its phase 1 redone to get the opacities phase 2 draws
    from). Returns ([cap], [cap]) numpy."""
    cap = jstate.capacity
    k1, k2 = jax.random.split(key)
    p, alive = jstate.params, jstate.alive
    slot = jnp.arange(cap, dtype=jnp.int32)
    op_act = jax.nn.sigmoid(p.opacities[:, 0]) * alive
    dead = alive & (op_act <= cfg.min_opacity)
    draws = jm._sample_targets(k1, jnp.where(alive & ~dead, op_act, 0.0),
                               cap)
    n_dead = jnp.sum(dead.astype(jnp.int32))
    rank = jnp.cumsum(dead.astype(jnp.int32)) - 1
    counts1 = jax.ops.segment_sum((slot < n_dead).astype(jnp.int32), draws,
                                  num_segments=cap)
    params1, _ = jm._apply_relocation(
        p, dest_slots=slot, dest_valid=dead,
        targets_of_dest=draws[jnp.clip(rank, 0, cap - 1)], counts=counts1,
        cap=cap)
    op2 = jax.nn.sigmoid(params1.opacities[:, 0]) * alive
    draws2 = jm._sample_targets(k2, jnp.where(alive, op2, 0.0), cap)
    return np.asarray(draws), np.asarray(draws2)


# (capacity, alive, dead, cap_max): no dead rows and growth; dead rows
# only (cap_max at the alive count); dead rows and growth capped by
# cap_max; growth capped by the free slots
MCMC_CASES = {"no_dead": (160, 120, 0, 1_000_000),
              "dead_only": (160, 120, 9, 120),
              "capped_by_cap_max": (160, 120, 9, 123),
              "capped_by_free_slots": (124, 120, 4, 1_000_000)}


@pytest.mark.parametrize("case", sorted(MCMC_CASES))
def test_mcmc_densify_matches_jax(case):
    """The port fed gsl_tpu's draws (the first n_dead of phase 1's, the
    first n_new of phase 2's): the same alive mask and n_new, parameters
    within atol 1e-6 (rtol 1e-5 on the corrected opacities and scales,
    see the correction's test), and the Adam moments zeroed in the same
    rows."""
    cap, n_alive, n_dead, cap_max = MCMC_CASES[case]
    jstate = _with_dead(_random_jax_state(cap, n_alive, 3), n_dead, 4)
    _, opt_state, _, _ = _stepped_jax_optimizer(jstate, 2, seed=30)
    jcfg = jm.MCMCDensityControllerConfig(cap_max=cap_max)
    key = jax.random.PRNGKey(11)
    want, want_opt, want_new = jm.mcmc_densify(key, jstate, opt_state, jcfg)
    draws1, draws2 = _jax_draws(key, jstate, opt_state, jcfg)

    state0 = _to_port(jstate)
    cfg = tm.MCMCDensityControllerConfig(cap_max=cap_max)
    assert int(tm.dead_mask(state0, cfg).sum()) == n_dead
    want_new = int(want_new)
    got, got_opt, got_new = tm.mcmc_densify(
        (to_torch(draws1[:n_dead]), to_torch(draws2[:want_new])), state0,
        _port_opt(opt_state), cfg)
    assert got_new == want_new
    # float32 rounds 1.05 x 120 below 126, so 5 rows
    assert want_new == {"no_dead": 5, "dead_only": 0,
                        "capped_by_cap_max": 3,
                        "capped_by_free_slots": 4}[case]
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    for k in PARAM_FIELDS:
        np.testing.assert_allclose(
            getattr(got.params, k).numpy(),
            np.asarray(getattr(want.params, k)), rtol=1e-5, atol=1e-6,
            err_msg=k)
    _assert_opt_equal(got_opt, want_opt)
    if n_dead:
        # every dead row now holds a relocated copy above the cut
        dead_rows = np.asarray(jax.nn.sigmoid(
            jstate.params.opacities[:, 0])) <= 0.005
        assert float(torch.sigmoid(got.params.opacities[
            to_torch(dead_rows & np.asarray(jstate.alive)), 0]).min()) \
            >= 0.005 - 1e-6


def test_mcmc_densify_draws_from_a_generator():
    """With a generator: n_dead + n_new draws, the same state from the
    same generator state, and a different one from another."""
    jstate = _with_dead(_random_jax_state(160, 120, 3), 9, 4)
    state = _to_port(jstate)
    cfg = tm.MCMCDensityControllerConfig()
    opt = _port_opt(_stepped_jax_optimizer(jstate, 1, seed=30)[1])
    runs = [tm.mcmc_densify(torch.Generator().manual_seed(s), state, opt,
                            cfg) for s in (1, 1, 2)]
    for k in PARAM_FIELDS:
        assert torch.equal(getattr(runs[0][0].params, k),
                           getattr(runs[1][0].params, k))
    assert not torch.equal(runs[0][0].params.means, runs[2][0].params.means)
    assert runs[0][2] == 5 and int(runs[0][0].alive.sum()) == 125


def _gates(op):
    """(the port's gate, gsl_tpu's gate) of the noise at opacity op."""
    return (1.0 / (1.0 + np.exp(-100.0 * ((1.0 - op) - 0.995))),
            1.0 / (1.0 + np.exp(100.0 * (op - 0.995))))


def test_mcmc_noise_step_matches_jax_but_for_its_gate():
    """gsl_tpu's normal draws as eps: the port's noise is gsl_tpu's with
    its opacity gate sigmoid(-100 (op - 0.995)) replaced by the published
    3DGS-MCMC gate sigmoid(100 ((1 - op) - 0.995)), within 1e-5 of its
    largest component (Sigma's entries are sums of three products, added
    in another order). Alive rows move, dead ones do not. The difference:
    at opacity 0.1 gsl_tpu's gate is 1 and the port's 7.5e-5; a nearly
    transparent row (0.001) moves with both."""
    jstate = _random_jax_state(96, 70, 5)
    op = np.array(jax.nn.sigmoid(jstate.params.opacities[:, 0]))
    op[:4] = [0.001, 0.004, 0.1, 0.5]
    jstate = JaxState(params=jstate.params.replace(opacities=jnp.asarray(
        np.log(op / (1 - op))[:, None].astype(np.float32))),
        alive=jstate.alive.at[:4].set(True))
    key = jax.random.PRNGKey(4)
    lr = np.float32(1.6e-4 * 2.5)
    want = jm.mcmc_noise_step(key, jstate, jnp.asarray(lr), 5e5)
    eps = np.asarray(jax.random.normal(key, jstate.params.means.shape,
                                       jnp.float32))
    state = _to_port(jstate)
    got = tm.mcmc_noise_step(to_torch(eps), state, torch.tensor(lr), 5e5)
    noise = (got.params.means - state.params.means).numpy()
    want_noise = np.asarray(want.params.means) - state.params.means.numpy()
    port_gate, jax_gate = _gates(np.asarray(jax.nn.sigmoid(
        jstate.params.opacities[:, 0])).astype(np.float64))
    expect = want_noise / jax_gate[:, None] * port_gate[:, None]
    np.testing.assert_allclose(noise, expect, rtol=1e-5,
                               atol=1e-5 * np.abs(expect).max())
    np.testing.assert_allclose(port_gate[:4], [0.5987, 0.5250, 7.48e-5,
                                               0.0], atol=1e-4)
    np.testing.assert_allclose(jax_gate[:4], 1.0, atol=1e-6)
    moved = np.abs(noise).sum(-1)
    alive = state.alive.numpy()
    assert np.all(moved[alive & (op < 0.005)] > 0)
    assert np.all(moved[~alive] == 0)
    for k in PARAM_FIELDS[1:]:
        assert torch.equal(getattr(got.params, k), getattr(state.params, k))


def test_build_cov3d_matches_jax():
    """Within rtol 1e-5 and 1e-6 of the largest entry: an off-diagonal
    entry that cancels keeps only the roundings of its three products."""
    rng = np.random.RandomState(6)
    scales = np.exp(rng.uniform(-4, 0, (200, 3))).astype(np.float32)
    q = rng.normal(size=(200, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    want = np.asarray(jax_build_cov3d(jnp.asarray(scales), jnp.asarray(q)))
    np.testing.assert_allclose(
        build_cov3d(to_torch(scales), to_torch(q)).numpy(), want, rtol=1e-5,
        atol=1e-6 * np.abs(want).max())


# ---- Mip-Splatting ---------------------------------------------------------

CAMS = [dict(R=np.eye(3), T=np.zeros(3), fx=70.0, fy=75.0, cx=30.0,
             cy=20.0, width=W, height=H),
        dict(R=np.array([[0.0, 0.0, -1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]]),
             T=np.array([0.0, 0.0, 4.0]), fx=90.0, fy=90.0, cx=W / 2,
             cy=H / 2, width=W, height=H),
        dict(R=np.eye(3), T=np.array([0.3, 0.0, 1.0]), fx=50.0, fy=50.0,
             cx=40.0, cy=32.0, width=80, height=64)]


def _both_cameras():
    jcams = jax_stack_cameras([jax_make_camera(**c) for c in CAMS])
    tcams = stack_cameras([make_camera(device="cpu", **c) for c in CAMS])
    return jcams, tcams


def _filter_inputs():
    """Means of a random scene; row 0 behind every camera (invisible),
    row 1 dead and seen far away, the last 8 rows dead padding."""
    rng = np.random.RandomState(8)
    means = np.concatenate([rng.uniform(-1, 1, (64, 2)),
                            rng.uniform(1.5, 6, (64, 1))], 1)
    means[0] = [0.0, 0.0, -20.0]
    means[1] = [0.0, 0.0, 50.0]
    alive = np.ones(64, bool)
    alive[1] = False
    alive[56:] = False
    return means.astype(np.float32), alive


def test_compute_and_apply_3d_filter_match_jax():
    """rtol 1e-6. The invisible row takes the largest distance among the
    alive rows that are seen, which the dead far row does not set."""
    means, alive = _filter_inputs()
    jcams, tcams = _both_cameras()
    want = np.asarray(jmip.compute_3d_filter(jnp.asarray(means),
                                             jnp.asarray(alive), jcams))
    got = compute_3d_filter(to_torch(means), to_torch(alive), tcams).numpy()
    assert got.shape == want.shape == (64, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    seen = np.delete(np.arange(64), [0, 1])
    assert got[0, 0] == got[seen, 0].max() < got[1, 0]

    rng = np.random.RandomState(9)
    scales = np.exp(rng.uniform(-5, -1, (64, 3))).astype(np.float32)
    op = rng.uniform(0.01, 1, 64).astype(np.float32)
    for comp in (True, False):
        w_op, w_s = jmip.apply_3d_filter(jnp.asarray(scales),
                                         jnp.asarray(op), jnp.asarray(want),
                                         comp)
        g_op, g_s = apply_3d_filter(to_torch(scales), to_torch(op),
                                    to_torch(want), comp)
        np.testing.assert_allclose(g_op.numpy(), np.asarray(w_op),
                                   rtol=1e-6)
        np.testing.assert_allclose(g_s.numpy(), np.asarray(w_s), rtol=1e-6)


def _mip_scene(n=300, cap=320, seed=0):
    from test_torch_render import scene_params
    params, alive = scene_params(n, cap, seed)
    jcams, tcams = _both_cameras()
    f3d = np.asarray(jmip.compute_3d_filter(
        jnp.asarray(params["means"]), jnp.asarray(alive), jcams))
    return params, alive, f3d


def _jax_mip_render(params, alive, f3d, cam_kw, cot, comp=True):
    renderer = JaxMipRendererConfig(
        backend="xla", max_per_tile=4096, chunk=64,
        opacity_compensation=comp).instantiate()
    bg = jnp.asarray([0.1, 0.2, 0.3])

    def loss(p):
        state = JaxState(params=p, alive=jnp.asarray(alive),
                         extra={"filter_3d": jnp.asarray(f3d)})
        img = renderer.forward(state, jax_make_camera(**cam_kw), H, W, bg,
                               3).render
        return jnp.sum(img * cot), img

    p = JaxParams(**{k: jnp.asarray(v) for k, v in params.items()})
    (_, img), grads = jax.value_and_grad(loss, has_aux=True)(p)
    return np.asarray(img), {k: np.asarray(getattr(grads, k))
                             for k in PARAM_FIELDS}


def _port_mip_render(params, alive, f3d, cam_kw, cot, comp=True):
    from gsl_tpu_torch.utils.convert import state_from_jax_arrays
    renderer = MipSplattingRendererConfig(
        opacity_compensation=comp).instantiate()
    state = state_from_jax_arrays(params, alive, device="cpu")
    leaves = state.params.map(lambda _, x: x.requires_grad_(True))
    img = renderer.forward(
        GaussianState(params=leaves, alive=state.alive,
                      extra={"filter_3d": to_torch(f3d)}),
        make_camera(device="cpu", **cam_kw), H, W,
        torch.tensor([0.1, 0.2, 0.3]), 3).render
    grads = torch.autograd.grad((img * to_torch(cot)).sum(),
                                [getattr(leaves, k) for k in PARAM_FIELDS])
    return img.detach().numpy(), {k: g.numpy()
                                  for k, g in zip(PARAM_FIELDS, grads)}


@pytest.mark.parametrize("view", [0, 1])
def test_mip_renderer_and_gradients_match_jax(view):
    """MipSplattingRenderer against gsl_tpu's on backend="xla": images
    within 1e-4; gradients of a seeded linear loss for means, scales,
    rotations, opacities and SH within rtol 5e-3 / atol 1e-4. A scale's
    gradient takes two paths, through the covariance and through the
    compensated opacity: without the compensation it changes by far more
    than the tolerance."""
    params, alive, f3d = _mip_scene()
    cam_kw = CAMS[view]
    cot = np.random.RandomState(view).normal(size=(H, W, 3)).astype(
        np.float32)
    want_img, want = _jax_mip_render(params, alive, f3d, cam_kw, cot)
    got_img, got = _port_mip_render(params, alive, f3d, cam_kw, cot)
    assert float(np.abs(want_img).mean()) > 0.05
    np.testing.assert_allclose(got_img, want_img, atol=1e-4)
    for k in PARAM_FIELDS:
        assert np.abs(want[k]).max() > 0, k
        np.testing.assert_allclose(got[k], want[k], rtol=5e-3, atol=1e-4,
                                   err_msg=k)
    _, plain = _port_mip_render(params, alive, f3d, cam_kw, cot, comp=False)
    assert np.abs(plain["scales"] - got["scales"]).max() \
        > 0.02 * np.abs(got["scales"]).max()


# ---- extra through every row edit -----------------------------------------

def test_extra_through_grow_densify_convert_and_checkpoint(tmp_path):
    """A per-Gaussian `filter_3d` and a non-per-Gaussian entry: capacity
    growth pads the first with zeros and keeps the second (as gsl_tpu's
    grow_capacity); a densify that clones and splits copies the source
    rows into the new slots (as gsl_tpu's densify_and_prune, with its
    draws); the conversion from and to numpy and a checkpoint round trip
    keep both; the trainer's step and its grow_state carry them."""
    cap, n_alive = 96, 40
    jstate = _random_jax_state(cap, n_alive, cap)
    rng = np.random.RandomState(2)
    f3d = rng.uniform(0.001, 0.01, (cap, 1)).astype(np.float32)
    aux = rng.normal(size=(5,)).astype(np.float32)
    jstate = JaxState(params=jstate.params, alive=jstate.alive,
                      extra={"filter_3d": jnp.asarray(f3d),
                             "aux": jnp.asarray(aux)})
    state = dataclasses.replace(_to_port(jstate), extra={
        "filter_3d": to_torch(f3d), "aux": to_torch(aux)})

    grown, jgrown = grow_capacity(state, 160), jax_grow_capacity(jstate, 160)
    for k in ("filter_3d", "aux"):
        np.testing.assert_array_equal(grown.extra[k].numpy(),
                                      np.asarray(jgrown.extra[k]))
    assert grown.extra["filter_3d"].shape == (160, 1)

    _, opt_state, _, _ = _stepped_jax_optimizer(jstate, 1, seed=20)
    arrays = _density_arrays(cap, 5)
    cfg_kw = dict(densify_grad_threshold=2e-4, cull_opacity_threshold=0.3)
    key = jax.random.PRNGKey(7)
    want, _, _, _ = jd.densify_and_prune(
        key, jstate, opt_state,
        jd.DensityControlState(**{k: jnp.asarray(v)
                                  for k, v in arrays.items()}),
        jd.VanillaDensityControllerConfig(**cfg_kw), 10.0, 1.5,
        jnp.asarray(False))
    noise = tuple(to_torch(np.asarray(jax.random.normal(
        k, (cap, 3), jnp.float32))) for k in jax.random.split(key))
    got, _, _, _ = td.densify_and_prune(
        noise, state, _port_opt(opt_state),
        td.DensityControlState(**{k: to_torch(v)
                                  for k, v in arrays.items()}),
        td.VanillaDensityControllerConfig(**cfg_kw), 10.0, 1.5, False)
    born = np.asarray(want.alive & ~jstate.alive)
    assert born.sum() > 5
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    for k in ("filter_3d", "aux"):
        np.testing.assert_array_equal(got.extra[k].numpy(),
                                      np.asarray(want.extra[k]))
    assert not np.array_equal(got.extra["filter_3d"].numpy()[born],
                              f3d[born])

    trainer = Trainer()
    tstate = dataclasses.replace(trainer.setup(state, 1.3),
                                 extra=state.extra)
    arrays = train_state_to_numpy(tstate)
    back = train_state_from_jax_arrays(**arrays, device="cpu")
    for k in ("filter_3d", "aux"):
        assert torch.equal(back.extra[k], state.extra[k])
    jt = jax_train_state_arrays(jstate_as_train(jstate))
    assert set(jt["extra"]) == {"filter_3d", "aux"}

    path = save_checkpoint(str(tmp_path), tstate, step=3)
    loaded = load_checkpoint(path, dataclasses.replace(tstate, extra=None))
    for k in ("filter_3d", "aux"):
        assert torch.equal(loaded.extra[k], state.extra[k])
    plain = save_checkpoint(str(tmp_path / "plain"),
                            dataclasses.replace(tstate, extra=None), step=3)
    assert load_checkpoint(plain, tstate).extra is None

    assert torch.equal(trainer.grow_state(tstate, 128).extra["filter_3d"],
                       torch.cat([to_torch(f3d), torch.zeros(32, 1)]))


def jstate_as_train(jstate):
    """A gsl_tpu TrainState around a GaussianState, by its own setup."""
    from gsl_tpu.training.trainer import Trainer as JaxTrainer
    return JaxTrainer().setup(jstate, 1.3)


def test_train_step_carries_the_filter():
    trainer = Trainer(model=MipSplattingConfig(sh_degree=3),
                      renderer=MipSplattingRendererConfig())
    gstate = small_port_state(n=60)
    f3d = torch.full((60, 1), 0.01)
    state = trainer.setup(dataclasses.replace(gstate,
                                              extra={"filter_3d": f3d}), 1.3)
    cam = make_camera(np.eye(3), np.zeros(3), 70.0, 70.0, W / 2, H / 2, W,
                      H, device="cpu")
    state, scalars = trainer.train_step(state, cam, torch.zeros(H, W, 3), H,
                                        W, 3, torch.zeros(3))
    assert state.extra["filter_3d"] is f3d
    assert bool(torch.isfinite(scalars["loss"]))


# ---- MCMC and the capacity --------------------------------------------------

def _mcmc_hook(cap_max, max_steps=100, **density_kw):
    trainer = Trainer(density=tm.MCMCDensityControllerConfig(
        cap_max=cap_max, **density_kw))
    ctx = th.FitContext(trainer=trainer, outputs=None, dataset=None,
                        cfg=FitConfig(max_steps=max_steps), bg=None)
    return trainer, th.MCMCDensityHook(ctx)


@pytest.mark.parametrize("cap_max", [1_000_000, 1030])
def test_mcmc_growth_passes_the_capacity_where_gsl_tpu_stops(cap_max):
    """1000 alive rows at capacity 1002: gsl_tpu grows only into the two
    free slots, the port grows the capacity first and reaches
    min(cap_max, floor(1.05 n)) (1050: float32 rounds 1.05 x 1000 to
    1050, as gsl_tpu computes it)."""
    n, cap = 1000, 1002
    jstate = _random_jax_state(cap, n, 12)
    _, opt_state, _, _ = _stepped_jax_optimizer(jstate, 1, seed=3)
    want, _, want_new = jm.mcmc_densify(
        jax.random.PRNGKey(0), jstate, opt_state,
        jm.MCMCDensityControllerConfig(cap_max=cap_max))
    assert int(want_new) == 2 and int(want.n_alive) == cap

    trainer, hook = _mcmc_hook(cap_max)
    state = trainer.setup(_to_port(jstate), 1.0)
    target = min(cap_max, math.floor(1.05 * n))
    assert tm.grow_target(n, trainer.density_cfg) == target
    got = hook.density_round(state, torch.Generator().manual_seed(0))
    assert hook.n_new == target - n
    assert int(got.alive.sum()) == target
    assert got.params.capacity == 16384 > cap
    assert got.opt_state.exp_avg["means"].shape[0] == 16384
    assert got.density.denom.shape[0] == 16384


def test_mcmc_round_where_the_capacity_does_not_bind_equals_densify():
    """With free slots for the whole target the hook's round is
    mcmc_densify itself, from the same generator state."""
    jstate = _with_dead(_random_jax_state(160, 120, 3), 9, 4)
    trainer, hook = _mcmc_hook(1_000_000)
    state = trainer.setup(_to_port(jstate), 1.0)
    got = hook.density_round(state, torch.Generator().manual_seed(5))
    want, want_opt, n_new = tm.mcmc_densify(
        torch.Generator().manual_seed(5), state.gaussians, state.opt_state,
        trainer.density_cfg)
    assert got.params.capacity == 160 and hook.n_new == n_new == 5
    assert torch.equal(got.alive, want.alive)
    for k in PARAM_FIELDS:
        assert torch.equal(getattr(got.params, k), getattr(want.params, k))
        assert torch.equal(got.opt_state.exp_avg[k], want_opt.exp_avg[k])


# ---- the hooks' schedules ---------------------------------------------------

class _Stub:
    """A state that records nothing and replaces to itself."""
    params = types.SimpleNamespace(means=None)
    alive = None

    def replace(self, **_):
        return self


@dataclasses.dataclass
class _PortStub:
    params: object = dataclasses.field(
        default_factory=lambda: types.SimpleNamespace(means=None))
    alive: object = None
    extra: object = None


def test_hook_schedules_match_jax(monkeypatch):
    """Over steps 1-400 with shortened intervals (relocation every 30 in
    (20, 300), the filter every 70, 400 steps): gsl_tpu's hooks and the
    port's relocate, add noise and recompute the filter at the same steps,
    and the port's densify timer fires exactly at its relocations."""
    max_steps = 400
    density_kw = dict(densify_from_iter=20, densify_until_iter=300,
                      densification_interval=30)
    calls = {k: [] for k in ("j_density", "j_noise", "j_filter", "t_density",
                             "t_noise", "t_filter")}

    jtrainer = types.SimpleNamespace(
        density_cfg=jm.MCMCDensityControllerConfig(**density_kw),
        model=jmip.MipSplattingConfig(filter_3d_update_interval=70),
        cameras_extent=1.0)
    jctx = types.SimpleNamespace(
        trainer=jtrainer, cfg=types.SimpleNamespace(max_steps=max_steps),
        outputs=types.SimpleNamespace(train_set=types.SimpleNamespace(
            cameras=None)))
    jhook = jh.MCMCDensityHook(jctx)
    jhook._density = lambda s, k: (calls["j_density"].append(step) or s, 0)
    jhook._noise = lambda s, k, lr: calls["j_noise"].append(step) or s
    jfilter = jh.MipFilterHook(jctx)
    monkeypatch.setattr(jmip, "compute_3d_filter",
                        lambda *a: calls["j_filter"].append(step))

    trainer, thook = _mcmc_hook(1_000_000, max_steps, **density_kw)
    thook.density_round = lambda s, g: calls["t_density"].append(step) or s
    thook.noise = lambda s, g, st: calls["t_noise"].append(st) or s
    trainer.model = MipSplattingConfig(filter_3d_update_interval=70)
    tfilter = th.MipFilterHook(th.FitContext(
        trainer=trainer, outputs=types.SimpleNamespace(
            train_set=types.SimpleNamespace(cameras=None)),
        dataset=None, cfg=FitConfig(max_steps=max_steps), bg=None))
    monkeypatch.setattr(th, "compute_3d_filter",
                        lambda *a: calls["t_filter"].append(step))

    timed = []
    for step in range(1, max_steps + 1):
        jhook(_Stub(), None, None, step)
        jfilter.periodic(_Stub(), None, step)
        if thook.densifies_at(step):
            timed.append(step)
        thook(_PortStub(), None, step)
        tfilter.periodic(_PortStub(), None, step)
    assert calls["t_density"] == calls["j_density"] == timed \
        == list(range(30, 300, 30))
    assert calls["t_noise"] == calls["j_noise"] \
        == list(range(1, max_steps))
    assert calls["t_filter"] == calls["j_filter"] == [70, 140, 210, 280]
