"""gsl_tpu_torch's budgeted controllers (Taming, GNS) and LightGaussian
against gsl_tpu's on the same seeded numpy inputs, with gsl_tpu's own
draws passed in: the count and budget curves, the edge map, the
normalisation (and gsl_tpu's NaN median), the blend weights and Taming's
scores through both renderers, Taming's and GNS's densify, the prunes, the
GNS regulariser and step, and GNS's hooks after a resume."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_tpu.models.gaussian import GaussianParams as JaxParams
from gsl_tpu.models.gaussian import GaussianState as JaxState
from gsl_tpu.models.gaussian import VanillaGaussianConfig as JaxModelConfig
from gsl_tpu.renderers.tile_renderer import \
    TileRendererConfig as JaxRendererConfig
from gsl_tpu.training import density as jd
from gsl_tpu.training import gns as jg
from gsl_tpu.training import hooks as jh
from gsl_tpu.training import light_gaussian as jl
from gsl_tpu.training import taming as jt
from gsl_tpu.training.metrics import VanillaMetricsConfig as JaxMetrics
from gsl_tpu.training.trainer import Trainer as JaxTrainer

from gsl_tpu_torch.renderers.tile_renderer import TileRendererConfig
from gsl_tpu_torch.training import density as td
from gsl_tpu_torch.training import gns as tg
from gsl_tpu_torch.training import hooks as th
from gsl_tpu_torch.training import light_gaussian as tl
from gsl_tpu_torch.training import taming as tt
from gsl_tpu_torch.training.fit import FitConfig
from gsl_tpu_torch.training.metrics import VanillaMetricsConfig
from gsl_tpu_torch.training.trainer import Trainer
from gsl_tpu_torch.utils.convert import train_state_from_jax_arrays

from test_torch_training import (CAPACITY, N_GT, H, W, _assert_opt_equal,
                                 _assert_states_equal, _density_arrays,
                                 _gt_state, _jax_camera, _port_camera,
                                 _port_opt, _random_jax_state,
                                 _stepped_jax_optimizer, _targets, _to_port)
from torch_port_utils import (PARAM_FIELDS, jax_train_state_arrays,
                              to_torch)

GRAD_RTOL, GRAD_ATOL = 5e-3, 1e-4
JAX_RENDERER = dict(backend="xla", max_per_tile=256, chunk=32,
                    min_isect_capacity=4096)


# ---- curves, edges, normalisation ----------------------------------------

@pytest.mark.parametrize("args", [
    (100_000, 20, 15_000, 500, 500, "multiplier"),
    (400, 2.5, 30, 1, 3, "multiplier"),
    (1000, 1_000_000, 15_000, 500, 100, "final_count"),
    (5000, 0.5, 2000, 100, 100, "multiplier")])     # budget below start
def test_count_array_matches_jax(args):
    assert tt.get_count_array(*args) == jt.get_count_array(*args)


def test_gns_budget_curve_matches_jax():
    for kw in (dict(budget=1000), dict(budget=60_000, densify_from_iter=100,
                                       densify_until_iter=300)):
        jcfg = jg.GNSDensityControllerConfig(**kw)
        tcfg = tg.GNSDensityControllerConfig(**kw)
        for step in (0, 1, 100, 150, 200, 499, 500, 7000, 14_999, 20_000):
            assert tg.gns_budget_at(tcfg, step) == jg.gns_budget_at(jcfg,
                                                                    step)


def test_edges_match_jax():
    img = np.random.RandomState(2).uniform(size=(H, W, 3)).astype(
        np.float32)
    np.testing.assert_allclose(tt.get_edges(to_torch(img)).numpy(),
                               np.asarray(jt.get_edges(jnp.asarray(img))),
                               rtol=1e-5, atol=1e-6)


def test_normalize_matches_jax_where_every_entry_is_positive_and_alive():
    """An odd count of positive alive entries: jnp.median and torch.median
    take the same middle value."""
    v = np.random.RandomState(3).uniform(0.1, 5.0, 31).astype(np.float32)
    alive = np.ones(31, bool)
    np.testing.assert_allclose(
        tt.normalize(0.7, to_torch(v), to_torch(alive)).numpy(),
        np.asarray(jt._normalize(0.7, jnp.asarray(v), jnp.asarray(alive))),
        rtol=1e-6)


def test_gsl_tpu_normalize_takes_a_nan_median():
    """One zero (or dead) entry makes gsl_tpu's median NaN, which it turns
    into 1: [0, 1, 2, 4, 8] comes back unchanged. The port divides the
    positive entries by their median, 2 (the lower middle of four)."""
    v = np.array([0, 1, 2, 4, 8], np.float32)
    alive = np.ones(5, bool)
    np.testing.assert_array_equal(
        np.asarray(jt._normalize(1.0, jnp.asarray(v), jnp.asarray(alive))),
        v)
    np.testing.assert_array_equal(
        tt.normalize(1.0, to_torch(v), to_torch(alive)).numpy(),
        [0, 0.5, 1, 2, 4])
    # a dead row: gsl_tpu's median is NaN again; the port leaves it out
    v2, alive2 = np.array([3, 1, 2, 4, 8], np.float32), alive.copy()
    alive2[0] = False
    np.testing.assert_array_equal(
        np.asarray(jt._normalize(1.0, jnp.asarray(v2),
                                 jnp.asarray(alive2))), [0, 1, 2, 4, 8])
    np.testing.assert_array_equal(
        tt.normalize(1.0, to_torch(v2), to_torch(alive2)).numpy(),
        [0, 0.5, 1, 2, 4])
    assert float(tt.positive_median(torch.zeros(4),
                                    torch.ones(4, dtype=torch.bool))) == 1.0


# ---- blend weights and scores through both renderers ----------------------

def _visible_scene(n=31, seed=4):
    """n Gaussians all in view and large enough to reach pixels in every
    view of `_port_camera(0..1)`, every row alive (capacity n)."""
    rng = np.random.RandomState(seed)
    means = np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)),
                            rng.uniform(3.0, 4.0, (n, 1))], -1)
    params = dict(
        means=means.astype(np.float32),
        scales=np.log(rng.uniform(0.08, 0.15, (n, 3))).astype(np.float32),
        rotations=rng.normal(size=(n, 4)).astype(np.float32),
        opacities=rng.uniform(-1.0, 1.0, (n, 1)).astype(np.float32),
        shs_dc=rng.normal(scale=0.5, size=(n, 1, 3)).astype(np.float32),
        shs_rest=rng.normal(scale=0.1, size=(n, 3, 3)).astype(np.float32))
    jstate = JaxState(params=JaxParams(**{k: jnp.asarray(v)
                                          for k, v in params.items()}),
                      alive=jnp.ones(n, bool))
    return jstate, _to_port(jstate)


def _jax_bias_render(jr, sh_degree=1):
    def render_fn(gs, camera, bias):
        out = jr.forward(gs, camera, H, W, jnp.zeros(3), sh_degree,
                         rgbs_override=jr.get_rgbs(gs, camera, sh_degree)
                         + bias[:, None])
        return out.render
    return render_fn


def test_blend_weights_match_jax_and_sum_to_the_alpha():
    """Over two views: per Gaussian within rtol 5e-3 / atol 1e-4 of
    gsl_tpu's (its XLA rasterizer), and Sum_i blend_i / 3 = Sum_pixels
    alpha within 1e-5 relative (no colour is clamped)."""
    jstate, state = _visible_scene()
    jr = JaxRendererConfig(**JAX_RENDERER).instantiate()
    want = jl.accumulate_blend_weights(_jax_bias_render(jr), jstate,
                                       [_jax_camera(0), _jax_camera(1)])
    got = tl.accumulate_blend_weights(
        tl.bias_render(TileRendererConfig().instantiate(), 1,
                       torch.zeros(3)), state,
        [_port_camera(0), _port_camera(1)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    r = TileRendererConfig().instantiate()
    with torch.no_grad():
        alpha = sum(float(r.forward(state, _port_camera(i), H, W,
                                    torch.zeros(3), 1,
                                    render_types=frozenset({"rgb", "alpha"})
                                    ).alpha.double().sum())
                    for i in (0, 1))
    assert float(got.double().sum()) / 3.0 == pytest.approx(alpha, rel=1e-5)
    assert int((got > 0).sum()) == 31


def test_taming_scores_match_jax_on_a_scene_where_every_term_normalises():
    """Every row alive and seen in both views, the gradients positive:
    every term gsl_tpu normalises has positive alive entries only (31,
    an odd count), so its NaN median does not arise and the two scores
    agree within rtol 5e-3 / atol 1e-4 (the blend-weight sums are
    rasterizer gradients)."""
    jstate, state = _visible_scene()
    gt = _gt_state(1)
    targets = _targets(gt, 1)[:2]
    grads = np.random.RandomState(9).uniform(1e-5, 1e-3, 31).astype(
        np.float32)
    coeffs = dict(edge_importance=5.0)
    jr = JaxRendererConfig(**JAX_RENDERER).instantiate()
    want = jt.compute_gaussian_scores(
        jr, jstate, [_jax_camera(0), _jax_camera(1)],
        [t.numpy() for t in targets], jnp.asarray(grads), jnp.zeros(3), 1,
        jt.ScoreCoefficients(**coeffs))
    got = tt.compute_gaussian_scores(
        TileRendererConfig().instantiate(), state,
        [_port_camera(0), _port_camera(1)], targets, to_torch(grads),
        torch.zeros(3), 1, tt.ScoreCoefficients(**coeffs))
    assert bool((got > 0).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


# ---- densify and prune with gsl_tpu's draws ---------------------------------

def _jax_uniform(key, cap):
    return jax.random.uniform(key, (cap,), minval=1e-9, maxval=1.0)


@pytest.mark.parametrize("budget", [48, 60, 1000])
def test_taming_densify_matches_jax_with_its_draws(budget):
    """gsl_tpu's uniforms and split normals passed in: the same rows
    drawn, the same slots, parameters to 1e-6; the alive count ends at or
    under the budget where the budget binds."""
    cap, n_alive = 128, 40
    jstate = _random_jax_state(cap, n_alive, 8)
    _, opt_state, _, _ = _stepped_jax_optimizer(jstate, 1, seed=2)
    arrays = _density_arrays(cap, 8)
    scores = np.random.RandomState(1).uniform(0, 2, cap).astype(np.float32)
    scores[::7] = 0.0
    kw = dict(densify_grad_threshold=2e-4, cull_opacity_threshold=0.005)
    key = jax.random.PRNGKey(3)
    want = jt.taming_densify(
        key, jstate, opt_state,
        jd.DensityControlState(**{k: jnp.asarray(v)
                                  for k, v in arrays.items()}),
        jt.Taming3DGSDensityControllerConfig(**kw), jnp.asarray(scores),
        budget, 10.0, 1.5, jnp.asarray(False))
    k1, k2, k3 = jax.random.split(key, 3)
    n1, n2 = (to_torch(np.asarray(jax.random.normal(k, (cap, 3),
                                                      jnp.float32)))
              for k in jax.random.split(k3))
    noise = (to_torch(np.asarray(_jax_uniform(k1, cap))),
             to_torch(np.asarray(_jax_uniform(k2, cap))), (n1, n2))
    got = tt.taming_densify(
        noise, _to_port(jstate), _port_opt(opt_state),
        td.DensityControlState(**{k: to_torch(v)
                                  for k, v in arrays.items()}),
        tt.Taming3DGSDensityControllerConfig(**kw), to_torch(scores),
        budget, 10.0, 1.5, False)
    _assert_states_equal(got[0], want[0])
    _assert_opt_equal(got[1], want[1])
    assert int(got[3]) == int(want[3]) == 0
    n_after = int(got[0].alive.sum())
    assert n_after > n_alive
    if budget < 1000:
        assert n_after <= budget


def test_gns_densify_matches_jax_with_its_draws():
    cap, n_alive = 128, 50
    jstate = _random_jax_state(cap, n_alive, 12)
    _, opt_state, _, _ = _stepped_jax_optimizer(jstate, 1, seed=4)
    arrays = _density_arrays(cap, 12)
    imp = np.random.RandomState(5).uniform(0, 1, cap).astype(np.float32)
    imp[::5] = 0.0
    kw = dict(budget=200, densify_grad_threshold=2e-4,
              cull_opacity_threshold=0.05)
    key = jax.random.PRNGKey(6)
    want = jg.gns_densify(
        key, jstate, opt_state,
        jd.DensityControlState(**{k: jnp.asarray(v)
                                  for k, v in arrays.items()}),
        jg.GNSDensityControllerConfig(**kw), jnp.asarray(imp),
        jnp.asarray(62, jnp.int32))
    got = tg.gns_densify(
        to_torch(np.asarray(jax.random.uniform(key, (cap,), jnp.float32,
                                               1e-9, 1.0))),
        _to_port(jstate), _port_opt(opt_state),
        td.DensityControlState(**{k: to_torch(v)
                                  for k, v in arrays.items()}),
        tg.GNSDensityControllerConfig(**kw), to_torch(imp), 62)
    _assert_states_equal(got[0], want[0])
    _assert_opt_equal(got[1], want[1])
    born = np.asarray(want[0].alive & ~jstate.alive)
    assert 5 < born.sum() <= 12
    assert int(got[0].alive.sum()) <= 62


def test_the_prunes_match_jax():
    """prune_by_opacity, final_budget_prune (gsl_tpu's uniforms) and
    prune_by_importance, whose importances tie at 0 in a third of the
    rows (a stable sort decides which of them go): the same alive rows and
    zeroed moments."""
    cap = 96
    jstate = _random_jax_state(cap, 70, 14)
    _, opt_state, _, _ = _stepped_jax_optimizer(jstate, 1, seed=5)
    state, opt = _to_port(jstate), _port_opt(opt_state)

    w_s, w_o, w_n = jg.prune_by_opacity(jstate, opt_state, 0.4)
    g_s, g_o, g_n = tg.prune_by_opacity(state, opt, 0.4)
    assert int(g_n) == int(w_n) > 5
    _assert_states_equal(g_s, w_s)
    _assert_opt_equal(g_o, w_o)

    key = jax.random.PRNGKey(2)
    w_s, w_o = jg.final_budget_prune(key, jstate, opt_state, 45)
    g_s, g_o = tg.final_budget_prune(
        to_torch(np.asarray(jax.random.uniform(key, (cap,), jnp.float32,
                                               1e-9, 1.0))), state, opt, 45)
    assert int(g_s.alive.sum()) == 45
    _assert_states_equal(g_s, w_s)
    _assert_opt_equal(g_o, w_o)

    imp = np.random.RandomState(3).uniform(0, 1, cap).astype(np.float32)
    imp[np.random.RandomState(4).uniform(size=cap) < 0.33] = 0.0
    w_s, w_o, w_n = jl.prune_by_importance(jstate, opt_state,
                                           jnp.asarray(imp), 0.6)
    g_s, g_o, g_n = tl.prune_by_importance(state, opt, to_torch(imp), 0.6)
    assert int(g_n) == int(w_n) == int(70 * 0.6)
    _assert_states_equal(g_s, w_s)
    _assert_opt_equal(g_o, w_o)


# ---- the GNS regulariser, step and hooks ----------------------------------

@pytest.mark.parametrize("prior_phase", [True, False])
def test_gns_regulariser_matches_jax(prior_phase):
    jstate = _random_jax_state(64, 50, 7)
    jloss, jgrad = jax.value_and_grad(
        lambda p: jg.gns_opacity_reg_loss(p, jstate.alive, 3e-4,
                                          jnp.asarray(prior_phase)))(
        jstate.params)
    state = _to_port(jstate)
    op = state.params.opacities.clone().requires_grad_(True)
    loss = tg.gns_opacity_reg_loss(
        dataclasses.replace(state.params, opacities=op), state.alive, 3e-4,
        prior_phase)
    (g,) = torch.autograd.grad(loss, [op])
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jgrad.opacities),
                               rtol=1e-5, atol=1e-12)
    assert float(g[~state.alive].abs().max()) == 0.0


def _gns_trainers(**density_kw):
    gt = _gt_state(1)
    xyz = np.asarray(gt.params.means[:N_GT])
    rgb = np.full((N_GT, 3), 0.5, np.float32)
    cfg = dict(budget=100, **density_kw)
    jtrainer = JaxTrainer(model=JaxModelConfig(sh_degree=1),
                          renderer=JaxRendererConfig(**JAX_RENDERER),
                          density=jg.GNSDensityControllerConfig(**cfg),
                          metrics=JaxMetrics(lambda_dssim=0.0))
    jstate = jtrainer.setup(JaxModelConfig(sh_degree=1).init_from_pcd(
        xyz, rgb, CAPACITY), 1.5)
    trainer = Trainer(density=tg.GNSDensityControllerConfig(**cfg),
                      metrics=VanillaMetricsConfig(lambda_dssim=0.0))
    trainer.setup(_to_port(jstate.gaussians), 1.5)
    state = train_state_from_jax_arrays(**jax_train_state_arrays(jstate),
                                        device="cpu")
    return jtrainer, jstate, trainer, state, _targets(gt, 1)


@pytest.mark.parametrize("prior_phase", [True, False])
def test_gns_step_matches_jax(prior_phase):
    """One GNS step (the regulariser at weight 2e-3 in the loss, the
    opacities' update x4) from the same state, L1 loss: every property's
    gradient (its first moment / 0.1) within rtol 5e-3 / atol 1e-4, the
    parameters where that gradient is clear of it; the opacity moments are
    Adam's own (the same as with factor 1) and the opacity update is 4x
    the one with factor 1."""
    jtrainer, jstate, trainer, state, targets = _gns_trainers()
    step = jg.make_gns_step(jtrainer, jtrainer.density_cfg)
    jnew, _ = step(jstate, _jax_camera(1), jnp.asarray(targets[1].numpy()),
                   H, W, 1, jnp.zeros(3), jnp.asarray(2e-3, jnp.float32),
                   jnp.asarray(prior_phase), jnp.asarray(4.0, jnp.float32))

    def port_step(factor):
        return trainer.train_step(
            state, _port_camera(1), targets[1], H, W, 1, torch.zeros(3),
            extra_loss=lambda gs: tg.gns_opacity_reg_loss(
                gs.params, gs.alive, 2e-3, prior_phase),
            update_scale={"opacities": factor})[0]

    new, plain = port_step(4.0), port_step(1.0)
    for k in PARAM_FIELDS:
        inner = jnew.opt_state.inner_states[k].inner_state[0]
        jg_k = np.asarray(getattr(inner.mu, k)) / 0.1
        g = new.opt_state.exp_avg[k].numpy() / 0.1
        np.testing.assert_allclose(g, jg_k, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)
        assert torch.equal(new.opt_state.exp_avg[k],
                           plain.opt_state.exp_avg[k])
        sure = np.abs(g) > 1e-5
        np.testing.assert_allclose(
            getattr(new.params, k).numpy()[sure],
            np.asarray(getattr(jnew.params, k))[sure], rtol=1e-5, atol=1e-6,
            err_msg=k)
    # the regulariser reaches every alive row's opacity
    assert bool((new.opt_state.exp_avg["opacities"][state.alive] != 0).all())
    d4 = new.params.opacities - state.params.opacities
    d1 = plain.params.opacities - state.params.opacities
    np.testing.assert_allclose(d4.numpy(), 4.0 * d1.numpy(), rtol=1e-4,
                               atol=1e-7)
    assert float(d1.abs().max()) > 1e-3


def _gns_ctx(trainer):
    return th.FitContext(trainer=trainer, outputs=None, dataset=None,
                         cfg=FitConfig(), bg=torch.zeros(3))


def test_gns_hooks_after_a_resume_read_the_resumed_count():
    """A state resumed inside the regularisation phase with 150 alive rows
    against a budget of 100, from a point cloud of 90: gsl_tpu's hooks
    hold the point cloud's count, so its phase never starts and its final
    prune at opacity_reg_until never fires (150 stay); the port's read the
    count from the resumed state and prune to the budget, and the
    controller's values come from the state's extra (a checkpoint's)."""
    kw = dict(budget=100, densify_from_iter=1, densify_until_iter=5,
              densification_interval=2, opacity_reg_from=6,
              opacity_reg_until=10)
    jstate = _random_jax_state(CAPACITY, 150, 5)
    jtrainer = JaxTrainer(density=jg.GNSDensityControllerConfig(**kw))
    jtrain = jtrainer.setup(jstate, 1.5)
    jctx = types.SimpleNamespace(trainer=jtrainer, outputs=None,
                                 dataset=None, cfg=None, bg=None)
    jhooks = jh.GNSHooks(jctx, 90)
    out = jhooks.density(jtrain, jax.random.PRNGKey(0),
                         jax.random.PRNGKey(1), 10)
    assert int(out.gaussians.n_alive) == 150 and not jhooks.ctl.final_pruned

    trainer = Trainer(density=tg.GNSDensityControllerConfig(**kw))
    state = trainer.setup(_to_port(jstate), 1.5)
    hooks = th.GNSHooks(_gns_ctx(trainer))
    state = hooks.init_state(state, None)
    # the resumed checkpoint's controller: a weight the run had tuned
    state = dataclasses.replace(state, extra=dict(state.extra, __gns__=dict(
        state.extra["__gns__"], reg_weight=7e-4, opacity_min=0.05)))
    dhook = hooks.density_hook
    assert not dhook.densifies_at(10)
    g = torch.Generator().manual_seed(0)
    mid = dhook(state, g, 9)                 # in the phase, not yet at its end
    assert hooks.n_alive == 150 and mid.gaussians.n_alive == 150
    assert tg.GNSController.from_extra(
        trainer.density_cfg, mid.extra["__gns__"]).reg_weight == 7e-4
    out = dhook(mid, g, 10)
    assert out.gaussians.n_alive == 100 == hooks.n_alive
    assert out.extra["__gns__"]["final_pruned"] is True
    assert out.extra["__gns__"]["prune_step"] == 10
    assert out.extra["__gns__"]["reg_weight"] == 7e-4
