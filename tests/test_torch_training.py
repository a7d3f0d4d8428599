"""gsl_tpu_torch's training modules against gsl_tpu's on the same numpy
inputs: loss, schedule, initialization, Adam and its surgery, density
control, and the training step as a whole."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_tpu.models.gaussian import GaussianParams as JaxParams
from gsl_tpu.models.gaussian import GaussianState as JaxState
from gsl_tpu.models.gaussian import OptimizationConfig as JaxOptConfig
from gsl_tpu.models.gaussian import VanillaGaussianConfig as JaxModelConfig
from gsl_tpu.models.gaussian import grow_capacity as jax_grow_capacity
from gsl_tpu.ops.knn import mean_sq_dist_to_knn as jax_knn
from gsl_tpu.ops.ssim import ssim as jax_ssim
from gsl_tpu.renderers.tile_renderer import \
    TileRendererConfig as JaxRendererConfig
from gsl_tpu.training import density as jd
from gsl_tpu.training import optimizers as jo
from gsl_tpu.training.metrics import psnr as jax_psnr
from gsl_tpu.training.metrics import train_loss as jax_train_loss
from gsl_tpu.training.schedulers import exponential_decay as jax_decay
from gsl_tpu.training.trainer import Trainer as JaxTrainer
from gsl_tpu.training.trainer import TrainerConfig as JaxTrainerConfig

from gsl_tpu_torch.data.cameras import make_camera
from gsl_tpu_torch.models.gaussian import (GaussianParams, GaussianState,
                                           OptimizationConfig,
                                           VanillaGaussianConfig,
                                           grow_capacity)
from gsl_tpu_torch.ops.knn import mean_sq_dist_to_knn
from gsl_tpu_torch.ops.ssim import ssim
from gsl_tpu_torch.renderers.tile_renderer import TileRendererConfig
from gsl_tpu_torch.training import density as td
from gsl_tpu_torch.training import optimizers as to
from gsl_tpu_torch.training.metrics import psnr, train_loss
from gsl_tpu_torch.training.schedulers import exponential_decay
from gsl_tpu_torch.training.trainer import Trainer, TrainerConfig
from gsl_tpu_torch.utils.convert import (state_from_jax_arrays,
                                         train_state_from_jax_arrays,
                                         train_state_to_numpy)

from scene_utils import random_scene, simple_camera
from torch_port_utils import (PARAM_FIELDS, jax_opt_arrays,
                              jax_train_state_arrays, to_torch)

W, H = 64, 48


def _images(seed):
    rng = np.random.RandomState(seed)
    base = rng.uniform(size=(H // 4, W // 4, 3))
    gt = np.kron(base, np.ones((4, 4, 1))).astype(np.float32)
    pred = np.clip(gt + 0.1 * rng.normal(size=gt.shape), 0, 1)
    return pred.astype(np.float32), gt


def test_ssim_and_psnr_match_jax():
    """The exact float32 SSIM on both sides: 1e-5."""
    pred, gt = _images(0)
    want = float(jax_ssim(jnp.asarray(pred).transpose(2, 0, 1),
                          jnp.asarray(gt).transpose(2, 0, 1), fast=False))
    got = float(ssim(to_torch(pred).permute(2, 0, 1),
                     to_torch(gt).permute(2, 0, 1)))
    assert 0.1 < want < 0.99
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        float(psnr(to_torch(pred), to_torch(gt))),
        float(jax_psnr(jnp.asarray(pred), jnp.asarray(gt))), rtol=1e-5)


@pytest.mark.parametrize("kind,masked", [("l1", False), ("l2", False),
                                         ("l1", True)])
def test_train_loss_matches_jax(kind, masked):
    """Against 0.8 L + 0.2 (1 - ssim(fast=False)) composed from the JAX
    pieces: 1e-5, value and gradient. Against the JAX train_loss itself,
    whose SSIM blurs are bf16-split matrix products (a 2^-9 relative
    rounding of each blur): 2e-3 absolute on a loss of ~0.1."""
    pred, gt = _images(1)
    mask = (np.random.RandomState(2).uniform(size=(H, W)) > 0.3
            ).astype(np.float32) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)

    def composed(p):
        g = jnp.asarray(gt)
        if jmask is not None:
            p, g = p * jmask[..., None], g * jmask[..., None]
        diff = jnp.mean((p - g) ** 2) if kind == "l2" \
            else jnp.mean(jnp.abs(p - g))
        return 0.8 * diff + 0.2 * (1.0 - jax_ssim(
            p.transpose(2, 0, 1), g.transpose(2, 0, 1), fast=False))

    want, want_grad = jax.value_and_grad(composed)(jnp.asarray(pred))
    leaf = to_torch(pred).requires_grad_(True)
    loss, scalars = train_loss(
        leaf, to_torch(gt), None if mask is None else to_torch(mask),
        rgb_diff_loss=kind)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-3, atol=1e-7)
    fast, fast_scalars = jax_train_loss(jnp.asarray(pred), jnp.asarray(gt),
                                        jmask, rgb_diff_loss=kind)
    np.testing.assert_allclose(float(loss.detach()), float(fast),
                               atol=2e-3)
    np.testing.assert_allclose(float(scalars["rgb_diff"].detach()),
                               float(fast_scalars["rgb_diff"]), rtol=1e-5)
    assert set(scalars) == set(fast_scalars)


@pytest.mark.parametrize("kw", [
    dict(lr_init=1.6e-4, lr_final=1.6e-6, max_steps=30_000),
    dict(lr_init=1e-2, lr_final=1e-4, max_steps=100, warmup_steps=10),
    dict(lr_init=1e-2, lr_final=1e-4, max_steps=100, warmup_steps=10,
         ramp="linear"),
])
def test_exponential_decay_matches_jax(kw):
    steps = [0, 1, 5, 10, 50, 100, 7000, 30_000, 40_000]
    want = [float(jax_decay(**kw)(s)) for s in steps]
    got = [float(exponential_decay(**kw)(s)) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    vec = exponential_decay(**kw)(torch.tensor(steps))
    np.testing.assert_allclose(vec.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("n", [1, 3, 700])
def test_knn_matches_jax(n):
    pts = np.random.RandomState(n).normal(size=(n, 3)).astype(np.float32)
    np.testing.assert_allclose(
        mean_sq_dist_to_knn(to_torch(pts)).numpy(),
        np.asarray(jax_knn(jnp.asarray(pts))), rtol=1e-4, atol=1e-6)


def _assert_states_equal(state: GaussianState, jstate: JaxState,
                         rtol=1e-6, atol=1e-6):
    assert np.array_equal(state.alive.numpy(), np.asarray(jstate.alive))
    for k in PARAM_FIELDS:
        np.testing.assert_allclose(
            getattr(state.params, k).numpy(),
            np.asarray(getattr(jstate.params, k)), rtol=rtol, atol=atol,
            err_msg=k)


def test_init_from_pcd_and_grow_capacity_match_jax():
    rng = np.random.RandomState(3)
    xyz = rng.normal(size=(150, 3)).astype(np.float32)
    rgb = rng.uniform(size=(150, 3)).astype(np.float32)
    jstate = JaxModelConfig(sh_degree=2).init_from_pcd(xyz, rgb, 256)
    state = VanillaGaussianConfig(sh_degree=2).init_from_pcd(
        xyz, rgb, 256, device="cpu")
    # the scales are a log of the knn distances: 1e-4 as for those
    _assert_states_equal(state, jstate, rtol=1e-4)
    assert state.n_alive == 150 and state.capacity == 256
    _assert_states_equal(grow_capacity(state, 300),
                         jax_grow_capacity(jstate, 300), rtol=1e-4)
    with pytest.raises(ValueError):
        VanillaGaussianConfig().init_from_pcd(xyz, rgb, 100, device="cpu")


def test_init_random_is_seeded():
    cfg = VanillaGaussianConfig(sh_degree=1)
    a = cfg.init_random(torch.Generator().manual_seed(5), 40, 64,
                        device="cpu")
    b = cfg.init_random(torch.Generator().manual_seed(5), 40, 64,
                        device="cpu")
    assert torch.equal(a.params.means, b.params.means)
    assert a.n_alive == 40 and a.params.shs_rest.shape == (64, 3, 3)
    assert float(a.params.means.abs().max()) <= 1.3
    np.testing.assert_allclose(a.get_opacities()[:40].numpy(), 0.1,
                               rtol=1e-5)
    assert float(a.get_opacities()[40:].max()) == 0.0


def _random_jax_state(cap, n_alive, seed, sh_degree=1):
    means, scales, quats, opac, colors = random_scene(cap, seed)
    rng = np.random.RandomState(seed + 100)
    k = (sh_degree + 1) ** 2
    params = JaxParams(
        means=means, scales=jnp.log(scales), rotations=quats,
        opacities=jnp.log(opac / (1 - opac))[:, None],
        shs_dc=jnp.asarray(rng.normal(size=(cap, 1, 3)), jnp.float32),
        shs_rest=jnp.asarray(rng.normal(size=(cap, k - 1, 3)), jnp.float32))
    alive = np.zeros(cap, bool)
    alive[rng.permutation(cap)[:n_alive]] = True
    return JaxState(params=params, alive=jnp.asarray(alive))


def _to_port(jstate: JaxState) -> GaussianState:
    return state_from_jax_arrays(
        {k: np.asarray(getattr(jstate.params, k)) for k in PARAM_FIELDS},
        np.asarray(jstate.alive), device="cpu")


def _port_opt(opt_state) -> to.AdamState:
    arrays = jax_opt_arrays(opt_state)
    return to.AdamState(
        exp_avg={k: to_torch(v["mu"]) for k, v in arrays.items()},
        exp_avg_sq={k: to_torch(v["nu"]) for k, v in arrays.items()},
        count=arrays["means"]["count"])


def _assert_opt_equal(state: to.AdamState, opt_state, rtol=1e-5,
                      atol=1e-12):
    arrays = jax_opt_arrays(opt_state)
    for k in PARAM_FIELDS:
        assert state.count == arrays[k]["count"]
        np.testing.assert_allclose(state.exp_avg[k].numpy(),
                                   arrays[k]["mu"], rtol=rtol, atol=atol)
        np.testing.assert_allclose(state.exp_avg_sq[k].numpy(),
                                   arrays[k]["nu"], rtol=rtol, atol=atol)


def _random_grads(jparams, seed):
    rng = np.random.RandomState(seed)
    out = {}
    for k in PARAM_FIELDS:
        g = rng.normal(size=getattr(jparams, k).shape) * 10.0 ** rng.randint(
            -6, 1)
        g[rng.uniform(size=g.shape[0]) < 0.2] = 0.0   # unseen rows
        out[k] = g.astype(np.float32)
    return out


def _stepped_jax_optimizer(jstate, n_steps, seed=0):
    tx = jo.build_gaussian_optimizer(JaxOptConfig(means_lr_max_steps=50),
                                     spatial_lr_scale=2.5)
    opt_state, params = tx.init(jstate.params), jstate.params
    grads_seq = [_random_grads(params, seed + i) for i in range(n_steps)]
    for grads in grads_seq:
        updates, opt_state = tx.update(
            JaxParams(**{k: jnp.asarray(v) for k, v in grads.items()}),
            opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
    return tx, opt_state, params, grads_seq


def test_adam_matches_optax_on_identical_gradients():
    """Six steps on the same gradient sequence, a fifth of the rows with
    gradient exactly 0 on both sides (at eps 1e-15 a row that sees 1e-20 on
    one side only would move by a full learning rate there, which is why
    the optimizer is compared on identical gradients): parameters to
    rtol 1e-5 / atol 1e-6 (a few float32 ulps of parameters of size 1 to
    3, summed over six updates of up to 0.05), moments to rtol 1e-5."""
    jstate = _random_jax_state(64, 64, 0)
    _, opt_state, jparams, grads_seq = _stepped_jax_optimizer(jstate, 6)
    tx = to.GaussianAdam(OptimizationConfig(means_lr_max_steps=50),
                         spatial_lr_scale=2.5)
    params = _to_port(jstate).params
    state = tx.init(params)
    for grads in grads_seq:
        updates, state = tx.update(
            GaussianParams(**{k: to_torch(v) for k, v in grads.items()}),
            state)
        params = params.map(lambda k, x: x + getattr(updates, k))
    for k in PARAM_FIELDS:
        np.testing.assert_allclose(
            getattr(params, k).numpy(), np.asarray(getattr(jparams, k)),
            rtol=1e-5, atol=1e-6, err_msg=k)
    _assert_opt_equal(state, opt_state)
    assert tx.learning_rate("means", 50) == pytest.approx(
        1.6e-4 * 0.01 * 2.5, rel=1e-5)


def test_optimizer_surgery_matches_jax():
    jstate = _random_jax_state(48, 48, 1)
    jtx, opt_state, _, _ = _stepped_jax_optimizer(jstate, 2, seed=10)
    state = _port_opt(opt_state)
    mask = np.random.RandomState(0).uniform(size=48) < 0.4
    _assert_opt_equal(to.zero_opt_state_rows(state, to_torch(mask)),
                      jo.zero_opt_state_rows(opt_state, jnp.asarray(mask),
                                             48))
    grown = jax_grow_capacity(jstate, 80)
    _assert_opt_equal(
        to.grow_opt_state(state, 80),
        jo.grow_opt_state(opt_state, jtx.init(grown.params), 48))
    _assert_opt_equal(
        to.zero_opacity_opt_state(state),
        jo.zero_opacity_opt_state(opt_state, (48, 1)))
    # the argument is left as it was
    _assert_opt_equal(state, opt_state)
    nan_state = dataclasses.replace(state, exp_avg={
        k: torch.full_like(v, float("nan"))
        for k, v in state.exp_avg.items()})
    cleared = to.zero_opt_state_rows(nan_state, torch.ones(48,
                                                           dtype=torch.bool))
    assert all(bool((v == 0).all()) for v in cleared.exp_avg.values())


def test_selective_adam_update_matches_jax():
    jstate = _random_jax_state(32, 32, 2)
    visible = np.random.RandomState(1).uniform(size=32) < 0.5
    want = jo.selective_adam_update(jstate.params, jnp.asarray(visible))
    got = to.selective_adam_update(_to_port(jstate).params,
                                   to_torch(visible))
    for k in PARAM_FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))


def _density_arrays(cap, seed):
    rng = np.random.RandomState(seed)
    denom = rng.randint(0, 5, cap).astype(np.float32)
    return dict(grad_accum=(rng.uniform(0, 1e-3, cap) * denom
                            ).astype(np.float32), denom=denom,
                max_radii=rng.uniform(0, 40, cap).astype(np.float32))


def test_update_stats_matches_jax():
    cap = 100
    rng = np.random.RandomState(4)
    arrays = _density_arrays(cap, 4)
    grad = rng.normal(size=(cap, 2)).astype(np.float32) * 1e-4
    radii = rng.randint(0, 30, cap).astype(np.int32) * (
        rng.uniform(size=cap) < 0.7)
    scale = np.array([0.5 * W, 0.5 * H], np.float32)
    want = jd.update_stats(
        jd.DensityControlState(**{k: jnp.asarray(v)
                                  for k, v in arrays.items()}),
        jnp.asarray(grad), jnp.asarray(radii), jnp.asarray(scale))
    got = td.update_stats(
        td.DensityControlState(**{k: to_torch(v)
                                  for k, v in arrays.items()}),
        to_torch(grad), to_torch(radii), to_torch(scale))
    for k in arrays:
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("cap,n_alive,size_prune", [
    (96, 40, False),    # free slots to spare
    (96, 40, True),     # with the screen / world size prune
    (64, 56, False),    # more children than free slots: truncated
])
def test_densify_and_prune_matches_jax(cap, n_alive, size_prune):
    """The same standard normal draws on both sides (jax.random.normal of
    the split key, as the JAX function draws them): identical alive mask
    and slots, n_truncated, parameters to 1e-6 (the rotated offsets sum
    three float32 products in a different order), moments zeroed in the
    same rows."""
    jstate = _random_jax_state(cap, n_alive, cap + int(size_prune))
    _, opt_state, _, _ = _stepped_jax_optimizer(jstate, 1, seed=20)
    arrays = _density_arrays(cap, 5)
    cfg_kw = dict(densify_grad_threshold=2e-4, cull_opacity_threshold=0.3)
    key = jax.random.PRNGKey(7)
    want_state, want_opt, want_d, want_trunc = jd.densify_and_prune(
        key, jstate, opt_state,
        jd.DensityControlState(**{k: jnp.asarray(v)
                                  for k, v in arrays.items()}),
        jd.VanillaDensityControllerConfig(**cfg_kw), 10.0, 1.5,
        jnp.asarray(size_prune))
    k1, k2 = jax.random.split(key)
    noise = tuple(to_torch(np.asarray(
        jax.random.normal(k, (cap, 3), jnp.float32))) for k in (k1, k2))
    state0 = _to_port(jstate)
    before = {k: getattr(state0.params, k).clone() for k in PARAM_FIELDS}
    got_state, got_opt, got_d, got_trunc = td.densify_and_prune(
        noise, state0, _port_opt(opt_state),
        td.DensityControlState(**{k: to_torch(v)
                                  for k, v in arrays.items()}),
        td.VanillaDensityControllerConfig(**cfg_kw), 10.0, 1.5, size_prune)
    assert int(got_trunc) == int(want_trunc)
    assert (int(got_trunc) > 0) == (cap == 64)
    n_new = int((want_state.alive & ~jstate.alive).sum())
    assert n_new > 5 and int((jstate.alive & ~want_state.alive).sum()) > 0
    _assert_states_equal(got_state, want_state)
    _assert_opt_equal(got_opt, want_opt)
    assert all(float(getattr(got_d, k).abs().max()) == 0.0
               for k in ("grad_accum", "denom", "max_radii"))
    # the argument is left as it was
    for k in PARAM_FIELDS:
        assert torch.equal(getattr(state0.params, k), before[k])


def test_densify_draws_from_a_generator():
    jstate = _random_jax_state(96, 40, 3)
    state = _to_port(jstate)
    tx = to.GaussianAdam(OptimizationConfig(), 1.0)
    d = td.DensityControlState(**{k: to_torch(v) for k, v in
                                  _density_arrays(96, 5).items()})
    cfg = td.VanillaDensityControllerConfig()
    runs = [td.densify_and_prune(
        torch.Generator().manual_seed(s), state, tx.init(state.params), d,
        cfg, 10.0, 1.5, False)[0] for s in (1, 1, 2)]
    assert torch.equal(runs[0].params.means, runs[1].params.means)
    assert not torch.equal(runs[0].params.means, runs[2].params.means)
    assert torch.equal(runs[0].alive, runs[2].alive)


def test_reset_opacities_matches_jax():
    jstate = _random_jax_state(40, 30, 6)
    _, opt_state, _, _ = _stepped_jax_optimizer(jstate, 1, seed=30)
    want_state, want_opt = jd.reset_opacities(jstate, opt_state, 0.01)
    got_state, got_opt = td.reset_opacities(_to_port(jstate),
                                            _port_opt(opt_state), 0.01)
    _assert_states_equal(got_state, want_state, rtol=1e-5)
    _assert_opt_equal(got_opt, want_opt)
    assert float(got_state.get_opacities().max()) <= 0.01 + 1e-6
    assert float(got_opt.exp_avg["opacities"].abs().max()) == 0.0
    assert float(got_opt.exp_avg["means"].abs().max()) > 0.0


# ---- the training step as a whole -------------------------------------

N_GT, CAPACITY, N_VIEWS = 150, 256, 3


def _jax_camera(i):
    cam = simple_camera(W, H)
    return cam.replace(T=cam.T + jnp.array([0.3 * i - 0.3, 0.0, 0.0]))


def _port_camera(i):
    return make_camera(R=np.eye(3), T=[0.3 * i - 0.3, 0.0, 0.0], fx=70.0,
                       fy=70.0, cx=W / 2, cy=H / 2, width=W, height=H,
                       device="cpu")


def _gt_state(sh_degree):
    means, scales, quats, opac, colors = random_scene(N_GT, 11)
    state = JaxModelConfig(sh_degree=sh_degree).init_from_pcd(
        np.asarray(means), np.asarray(colors), capacity=CAPACITY)
    params = state.params.replace(
        scales=state.params.scales.at[:N_GT].set(jnp.log(scales)),
        opacities=state.params.opacities.at[:N_GT, 0].set(
            jnp.log(opac / (1 - opac))),
        rotations=state.params.rotations.at[:N_GT].set(quats))
    return JaxState(params=params, alive=state.alive)


def _targets(gt_state, sh_degree):
    """Ground-truth views rendered by the port from the given scene."""
    renderer = TileRendererConfig().instantiate()
    state = _to_port(gt_state)
    with torch.no_grad():
        return [renderer.forward(state, _port_camera(i), H, W,
                                 torch.zeros(3), sh_degree).render
                for i in range(N_VIEWS)]


def test_train_steps_and_densify_match_jax():
    """The same TrainState stepped by gsl_tpu's Trainer (XLA rasterizer)
    and by the port: four steps, a densify, one more step.

    Loss per step within 3e-3 absolute: the JAX loss uses the bf16-split
    SSIM (2^-9 class, 2e-3 in test_train_loss_matches_jax) and from the
    second step on the parameters differ by what Adam at eps 1e-15 makes
    of gradient differences. Parameters after the first step are compared
    only on rows whose gradient is well above the rasterizer's gradient
    tolerance (|g| > 1e-5): there Adam's first step is -lr sign(g) on both
    sides. The densify threshold is put into the widest gap of the
    accumulated statistic, so that both sides select the same rows; masks,
    slots and n_truncated must then be equal."""
    sh_degree = 1
    gt_state = _gt_state(sh_degree)
    targets = _targets(gt_state, sh_degree)
    xyz = np.asarray(gt_state.params.means[:N_GT])
    rgb = np.full((N_GT, 3), 0.5, np.float32)
    density_kw = dict(densify_from_iter=2, densification_interval=4,
                      densify_until_iter=100, opacity_reset_interval=1000)
    jtrainer = JaxTrainer(
        model=JaxModelConfig(sh_degree=sh_degree),
        renderer=JaxRendererConfig(backend="xla", max_per_tile=256,
                                   chunk=32, min_isect_capacity=4096),
        density=jd.VanillaDensityControllerConfig(**density_kw),
        config=JaxTrainerConfig(sh_degree_interval=2))
    jstate = jtrainer.setup(
        JaxModelConfig(sh_degree=sh_degree).init_from_pcd(xyz, rgb,
                                                          CAPACITY), 1.5)
    trainer = Trainer(
        model=VanillaGaussianConfig(sh_degree=sh_degree),
        density=td.VanillaDensityControllerConfig(**density_kw),
        config=TrainerConfig(sh_degree_interval=2))
    trainer.setup(_to_port(jstate.gaussians), 1.5)
    state = train_state_from_jax_arrays(**jax_train_state_arrays(jstate),
                                        device="cpu")
    assert state.opt_state.count == 0 and state.step == 0
    bg_j, bg_t = jnp.zeros(3), torch.zeros(3)
    dead = ~state.alive

    def step_both(jstate, state, i):
        view = i % N_VIEWS
        degree = trainer.sh_degree_at(i)
        assert degree == jtrainer.sh_degree_at(i)
        jstate, jsc = jtrainer.train_step(
            jstate, _jax_camera(view), jnp.asarray(targets[view].numpy()),
            H, W, degree, bg_j)
        state, sc = trainer.train_step(state, _port_camera(view),
                                       targets[view], H, W, degree, bg_t)
        np.testing.assert_allclose(float(sc["loss"]), float(jsc["loss"]),
                                   atol=3e-3, err_msg=f"step {i}")
        return jstate, state

    first = state
    for i in range(4):
        jstate, state = step_both(jstate, state, i)
        if i == 0:
            moved = train_state_to_numpy(state)
            for k in PARAM_FIELDS:
                g = state.opt_state.exp_avg[k].numpy() / 0.1   # = gradient
                sure = np.abs(g) > 1e-5
                # isotropic initial scales give no rotation gradient and
                    # SH degree 0 none for the higher bands
                assert sure.sum() > 20 or k in ("rotations",
                                                    "shs_rest"), k
                np.testing.assert_allclose(
                    moved["params"][k][sure],
                    np.asarray(getattr(jstate.params, k))[sure], rtol=1e-5,
                    atol=1e-6, err_msg=k)
    assert state.step == 4 and state.opt_state.count == 4
    # padding slots see no gradient and stay exactly where they were
    for k in PARAM_FIELDS:
        assert bool(torch.isfinite(getattr(state.params, k)).all()), k
        assert torch.equal(getattr(state.params, k)[dead],
                           getattr(first.params, k)[dead]), k
    np.testing.assert_array_equal(state.density.denom.numpy(),
                                  np.asarray(jstate.density.denom))
    np.testing.assert_allclose(state.density.max_radii.numpy(),
                               np.asarray(jstate.density.max_radii))

    # densify, with the threshold in the widest gap of the statistic
    stat = np.asarray(jstate.density.grad_accum
                      / jnp.maximum(jstate.density.denom, 1.0))
    order = np.sort(stat[np.asarray(jstate.alive)])
    mid = order[len(order) // 4: 3 * len(order) // 4]
    at = int(np.argmax(mid[1:] / mid[:-1]))
    threshold = float(np.sqrt(mid[at] * mid[at + 1]))
    for t in (jtrainer, trainer):
        t.density_cfg = dataclasses.replace(
            t.density_cfg, densify_grad_threshold=threshold)
    key = jax.random.PRNGKey(3)
    jstate, jtrunc = jtrainer.density_step(jstate, key, jnp.asarray(False))
    noise = tuple(to_torch(np.asarray(jax.random.normal(
        k, (CAPACITY, 3), jnp.float32))) for k in jax.random.split(key))
    n_before = int(state.alive.sum())
    state, trunc = trainer.density_step(state, noise, False)
    assert int(trunc) == int(jtrunc) == 0
    assert np.array_equal(state.alive.numpy(), np.asarray(jstate.alive))
    assert int(state.alive.sum()) > n_before + 10
    assert float(state.density.denom.max()) == 0.0
    jstate, state = step_both(jstate, state, 4)
    assert all(bool(torch.isfinite(getattr(state.params, k)).all())
               for k in PARAM_FIELDS)


def test_training_improves_psnr():
    """Counterpart of tests/test_training.py::test_training_improves_psnr:
    gray init at the true positions, 60 steps over the views, densify and
    opacity reset on schedule."""
    gt_state = _gt_state(0)
    targets = _targets(gt_state, 0)
    xyz = np.asarray(gt_state.params.means[:N_GT])
    model = VanillaGaussianConfig(sh_degree=0)
    trainer = Trainer(
        model=model,
        density=td.VanillaDensityControllerConfig(
            densify_from_iter=10, densification_interval=20,
            densify_until_iter=50, opacity_reset_interval=1000),
        config=TrainerConfig(max_steps=60))
    state = trainer.setup(model.init_from_pcd(
        xyz, np.full((N_GT, 3), 0.5, np.float32), CAPACITY, device="cpu"),
        cameras_extent=1.5)
    bg = torch.zeros(3)

    def mean_psnr(state):
        return float(np.mean([float(trainer.eval_step(
            state, _port_camera(i), targets[i], H, W, 0, bg)[1]["psnr"])
            for i in range(N_VIEWS)]))

    psnr0 = mean_psnr(state)
    gen = torch.Generator().manual_seed(0)
    n0 = state.gaussians.n_alive
    for step in range(1, 61):
        view = step % N_VIEWS
        state, scalars = trainer.train_step(
            state, _port_camera(view), targets[view], H, W,
            trainer.sh_degree_at(step), bg)
        assert np.isfinite(float(scalars["loss"]))
        state = trainer.maybe_density_ops(state, gen, step)
    psnr1 = mean_psnr(state)
    assert psnr1 > psnr0 + 3.0, (psnr0, psnr1)
    assert state.gaussians.n_alive != n0
    assert state.step == 60


def test_absgrad_statistic_feeds_the_density_stats():
    gt_state = _gt_state(0)
    targets = _targets(gt_state, 0)
    model = VanillaGaussianConfig(sh_degree=0)
    stats = []
    for absgrad in (False, True):
        trainer = Trainer(model=model,
                          density=td.VanillaDensityControllerConfig(
                              absgrad=absgrad))
        state = trainer.setup(_to_port(gt_state), 1.5)
        state = dataclasses.replace(state, params=dataclasses.replace(
            state.params, shs_dc=state.params.shs_dc * 0.5))
        state, _ = trainer.train_step(state, _port_camera(0), targets[0],
                                      H, W, 0, torch.zeros(3))
        stats.append(state.density.grad_accum)
    # sum over tiles of |g| >= |sum over tiles of g|, strictly for some
    assert bool((stats[1] >= stats[0] * (1 - 1e-5)).all())
    assert bool((stats[1] > stats[0] * 1.01).any())


def test_maybe_density_ops_grows_the_capacity_and_resets_opacity():
    gt_state = _gt_state(0)
    model = VanillaGaussianConfig(sh_degree=0)
    trainer = Trainer(
        model=model, density=td.VanillaDensityControllerConfig(
            densify_from_iter=0, densification_interval=2,
            opacity_reset_interval=4, densify_grad_threshold=1e-9),
        config=TrainerConfig())
    port = _to_port(gt_state)
    tight = GaussianState(
        params=port.params.map(lambda _, x: x[:N_GT + 10].clone()),
        alive=port.alive[:N_GT + 10].clone())
    state = trainer.setup(tight, 1.5)
    targets = _targets(gt_state, 0)
    gen = torch.Generator().manual_seed(1)
    for step in (1, 2):
        state, _ = trainer.train_step(state, _port_camera(0), targets[0],
                                      H, W, 0, torch.zeros(3))
        state = trainer.maybe_density_ops(state, gen, step)
    # every seen Gaussian wanted a child and only 10 slots were free
    assert state.params.capacity == 2 * (N_GT + 10)
    assert state.opt_state.exp_avg["means"].shape[0] == 2 * (N_GT + 10)
    assert state.density.denom.shape[0] == 2 * (N_GT + 10)
    assert state.opt_state.count == 2
    assert state.gaussians.n_alive > N_GT + 10
    for step in (3, 4):
        state, _ = trainer.train_step(state, _port_camera(0), targets[0],
                                      H, W, 0, torch.zeros(3))
        state = trainer.maybe_density_ops(state, gen, step)
    assert float(state.gaussians.get_opacities().max()) <= 0.01 + 1e-6
    assert float(state.opt_state.exp_avg["opacities"].abs().max()) == 0.0
