"""gsl_tpu_torch's Glossy Gaussians against gsl_tpu's on the same seeded
numpy inputs: the environment-map lookup, the normals, the glossy colours
with their gradients, one GlossyTrainer step, and the metalness through a
densify (where gsl_tpu copies the source row's Adam moments and the port
starts them at zero), a capacity growth, the state conversion and a
checkpoint."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_tpu.models import glossy as jgl
from gsl_tpu.models.gaussian import GaussianState as JaxState
from gsl_tpu.models.gaussian import VanillaGaussianConfig as JaxModelConfig
from gsl_tpu.renderers.tile_renderer import \
    TileRendererConfig as JaxRendererConfig
from gsl_tpu.training import density as jd
from gsl_tpu.training.glossy_trainer import GlossyTrainer as JaxGlossyTrainer
from gsl_tpu.training.metrics import VanillaMetricsConfig as JaxMetrics

from gsl_tpu_torch.models import glossy as tgl
from gsl_tpu_torch.models.gaussian import VanillaGaussianConfig
from gsl_tpu_torch.training import density as td
from gsl_tpu_torch.training.glossy_trainer import GlossyTrainer
from gsl_tpu_torch.training.metrics import VanillaMetricsConfig
from gsl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from gsl_tpu_torch.utils.convert import (train_state_from_jax_arrays,
                                         train_state_to_numpy)

from test_torch_training import (CAPACITY, N_GT, H, W, _density_arrays,
                                 _gt_state, _jax_camera, _port_camera,
                                 _targets)
from torch_port_utils import (PARAM_FIELDS, jax_train_state_arrays,
                              to_torch)

GRAD_RTOL, GRAD_ATOL = 5e-3, 1e-4
JAX_RENDERER = dict(backend="xla", max_per_tile=256, chunk=32,
                    min_isect_capacity=4096)


def _unit(n, seed):
    d = np.random.RandomState(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _envmap(seed=0, h=16, w=32):
    return np.random.RandomState(seed).uniform(0, 1, (h, w, 3)).astype(
        np.float32)


def test_sample_envmap_matches_jax_with_gradients():
    """A random map and directions (the azimuth's seam among them): the
    lookup within 1e-5 (arccos and atan2 round differently in the last
    bits), and the gradients of a weighted sum in the map and the
    directions within rtol 1e-4 / atol 1e-5. At the poles, where arccos
    has no finite gradient, the lookups agree."""
    env = _envmap()
    dirs = np.concatenate([_unit(60, 1), [[-1, 0, 1e-7], [-1, 0, -1e-7]]]
                          ).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    poles = np.array([[0, 1, 0], [0, -1, 0]], np.float32)
    np.testing.assert_allclose(
        tgl.sample_envmap(to_torch(env), to_torch(poles)).numpy(),
        np.asarray(jgl.sample_envmap(jnp.asarray(env), jnp.asarray(poles))),
        atol=1e-6)
    w = np.random.RandomState(2).normal(size=(len(dirs), 3)).astype(
        np.float32)
    (jv, (jge, jgd)) = jax.value_and_grad(
        lambda e, d: jnp.sum(jgl.sample_envmap(e, d) * w),
        argnums=(0, 1))(jnp.asarray(env), jnp.asarray(dirs))
    e, d = to_torch(env).requires_grad_(True), \
        to_torch(dirs).requires_grad_(True)
    out = tgl.sample_envmap(e, d)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jgl.sample_envmap(jnp.asarray(env), jnp.asarray(dirs))),
        atol=1e-5)
    ge, gd = torch.autograd.grad((out * to_torch(w)).sum(), [e, d])
    np.testing.assert_allclose(ge.numpy(), np.asarray(jge), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(gd.numpy(), np.asarray(jgd), rtol=1e-4,
                               atol=1e-5)
    # the constant map is constant
    const = tgl.sample_envmap(tgl.init_envmap(tgl.EnvLightConfig(
        init_value=0.25)), to_torch(dirs))
    np.testing.assert_allclose(const.numpy(), 0.25, atol=1e-6)


def test_a_lookup_at_a_pole_has_a_finite_gradient():
    """A reflection whose y rounds to -1 (one row in 1M of the bench
    scene at an orbit view does): gsl_tpu's gradient there is not finite
    (arccos's at -1, through its clip), and one Adam step then makes the
    row's mean NaN; the port's is finite and the value the same."""
    env = _envmap(6)
    dirs = np.array([[-3.8065016e-4, -1.0, -4.9233437e-05],
                     [0.3, 0.4, np.sqrt(0.75)]], np.float32)
    w = np.ones((2, 3), np.float32)
    jg = jax.grad(lambda d: jnp.sum(jgl.sample_envmap(jnp.asarray(env), d)
                                    * w))(jnp.asarray(dirs))
    assert not np.isfinite(np.asarray(jg)[0]).all()
    d = to_torch(dirs).requires_grad_(True)
    out = tgl.sample_envmap(to_torch(env), d)
    (g,) = torch.autograd.grad((out * to_torch(w)).sum(), [d])
    assert bool(torch.isfinite(g).all())
    np.testing.assert_allclose(g[1].numpy(), np.asarray(jg)[1], rtol=1e-4)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jgl.sample_envmap(jnp.asarray(env), jnp.asarray(dirs))),
        atol=1e-6)


def test_gaussian_normals_match_jax():
    rng = np.random.RandomState(3)
    scales = rng.normal(size=(50, 3)).astype(np.float32)
    scales[:5] = [0.1, 0.1, 0.1]               # a tie: the first axis
    quats = rng.normal(size=(50, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tgl.gaussian_normals(to_torch(scales), to_torch(quats)).numpy(),
        np.asarray(jgl.gaussian_normals(jnp.asarray(scales),
                                        jnp.asarray(quats))), atol=1e-6)


def test_glossy_rgbs_match_jax_with_gradients():
    """The colours within 1e-5 (the map lookup's arccos and atan2) and
    the gradients of a weighted sum in the base colours, metalness, map,
    means, raw scales and rotations within rtol 1e-4 / atol 1e-5 (the
    scales' is 0 on both sides: the axis choice has no gradient)."""
    rng = np.random.RandomState(4)
    n = 80
    args = dict(base=rng.uniform(0, 0.6, (n, 3)),
                metal=rng.uniform(0, 1, n), env=_envmap(5),
                means=rng.normal(size=(n, 3)) + [0, 0, 4],
                scales=rng.normal(size=(n, 3)),
                quats=rng.normal(size=(n, 4)))
    args = {k: np.asarray(v, np.float32) for k, v in args.items()}
    cc = np.array([0.1, -0.2, 0.3], np.float32)
    w = rng.normal(size=(n, 3)).astype(np.float32)

    def jloss(*xs):
        return jnp.sum(jgl.glossy_rgbs(*xs, jnp.asarray(cc)) * w)

    jgrads = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(v) for v in args.values()))
    leaves = [to_torch(v).requires_grad_(True) for v in args.values()]
    out = tgl.glossy_rgbs(*leaves, to_torch(cc))
    np.testing.assert_allclose(
        out.detach().numpy(), np.asarray(jgl.glossy_rgbs(
            *(jnp.asarray(v) for v in args.values()), jnp.asarray(cc))),
        atol=1e-5)
    clamped = (out.detach() <= 0) | (out.detach() >= 1)
    assert 0 < int(clamped.sum()) < n
    grads = torch.autograd.grad((out * to_torch(w)).sum(), leaves,
                                allow_unused=True)
    assert grads[4] is None                       # the raw scales
    assert float(np.abs(np.asarray(jgrads[4])).max()) == 0.0
    for name, g, jg in zip(args, grads, jgrads):
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(jg),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
    assert float(grads[3].abs().max()) > 1e-3     # through the reflection
    assert float(grads[5].abs().max()) > 1e-3


def test_the_lookup_over_the_alive_rows_equals_the_full_one():
    """glossy_rgbs(rows=alive) against the lookup over every row, the
    metalness times the alive mask (as the trainer passes it) and the
    dead rows' means on the camera centre: the same colours, and the
    same gradients in every input (0 in the dead rows)."""
    rng = np.random.RandomState(8)
    n = 60
    alive = rng.uniform(size=n) < 0.6
    means = (rng.normal(size=(n, 3)) + [0, 0, 4]).astype(np.float32)
    means[~alive] = 0.0
    args = [to_torch(a).requires_grad_(True) for a in (
        rng.uniform(0, 0.6, (n, 3)).astype(np.float32),
        rng.uniform(0, 1, n).astype(np.float32), _envmap(9),
        means, rng.normal(size=(n, 3)).astype(np.float32),
        rng.normal(size=(n, 4)).astype(np.float32))]
    w = to_torch(rng.normal(size=(n, 3)).astype(np.float32))
    outs, grads = [], []
    for rows in (None, torch.nonzero(to_torch(alive)).flatten()):
        masked = [args[0], args[1] * to_torch(alive)] + args[2:]
        out = tgl.glossy_rgbs(*masked, torch.zeros(3), rows=rows)
        outs.append(out.detach())
        grads.append(torch.autograd.grad((out * w).sum(), args,
                                         allow_unused=True))
    assert torch.equal(outs[0], outs[1])
    for g_full, g_rows in zip(*grads):
        if g_full is None:
            assert g_rows is None
            continue
        np.testing.assert_allclose(g_rows.numpy(), g_full.numpy(),
                                   rtol=1e-6, atol=1e-7)
    assert float(grads[1][3][~to_torch(alive)].abs().max()) == 0.0


# ---- the trainer -------------------------------------------------------------

def _jax_glossy(jstate):
    """gsl_tpu's ``extra["__glossy__"]`` in the layout
    `train_state_from_jax_arrays(glossy=)` takes."""
    g = jstate.extra["__glossy__"]
    inner = g.opt_state.inner_states
    env = inner["env"].inner_state[0]
    metal = inner["metal"].inner_state[0]
    return {"envmap": np.asarray(g.envmap),
            "metalness_raw": np.asarray(g.metalness_raw),
            "opt": {"envmap": {"mu": np.asarray(env.mu["envmap"]),
                               "nu": np.asarray(env.nu["envmap"]),
                               "count": int(env.count)},
                    "metalness_raw": {
                        "mu": np.asarray(metal.mu["metalness_raw"]),
                        "nu": np.asarray(metal.nu["metalness_raw"]),
                        "count": int(metal.count)}}}


def _port_of(jstate):
    arrays = jax_train_state_arrays(jstate.replace(extra=None))
    return train_state_from_jax_arrays(**arrays, device="cpu",
                                       glossy=_jax_glossy(jstate))


def _trainers():
    gt = _gt_state(1)
    xyz = np.asarray(gt.params.means[:N_GT])
    rgb = np.full((N_GT, 3), 0.5, np.float32)
    jtrainer = JaxGlossyTrainer(model=JaxModelConfig(sh_degree=1),
                                renderer=JaxRendererConfig(**JAX_RENDERER),
                                metrics=JaxMetrics(lambda_dssim=0.0))
    jstate = jtrainer.setup(JaxModelConfig(sh_degree=1).init_from_pcd(
        xyz, rgb, CAPACITY), 1.5)
    trainer = GlossyTrainer(model=VanillaGaussianConfig(sh_degree=1),
                            metrics=VanillaMetricsConfig(lambda_dssim=0.0))
    own = trainer.setup(VanillaGaussianConfig(sh_degree=1).init_from_pcd(
        xyz, rgb, CAPACITY, device="cpu"), 1.5)
    return jtrainer, jstate, trainer, own, _targets(gt, 1)


def test_setup_matches_jax():
    """The port's own setup gives what gsl_tpu's gives: metalness -3 in
    every row, the map at 0.5, zero moments."""
    _, jstate, _, own, _ = _trainers()
    conv = _port_of(jstate)
    assert torch.equal(own.params.metalness, conv.params.metalness)
    assert torch.equal(own.extra["__glossy__"]["envmap"],
                       conv.extra["__glossy__"]["envmap"])
    assert own.opt_state.exp_avg["metalness"].shape == (CAPACITY,)
    assert own.extra["__glossy__"]["opt"]["count"] == 0


def test_glossy_step_matches_jax():
    """Two steps from the same state, L1 loss (gsl_tpu's SSIM is its
    bf16-split one, ROADMAP §3): the loss within 1e-6 at the first step;
    every property's gradient (first moment / 0.1 after step 1), the
    metalness's and the map's among them, within rtol 5e-3 / atol 1e-4 on
    the alive rows, and the values after it where that gradient is clear
    of it (Adam's first step is -lr sign(g) there); after the second, a
    finite state, the map clipped at 0 and both Adam counts at 2.

    gsl_tpu's step gives the dead rows, which sit at the origin where
    this camera is, NaN mean and rotation gradients (atan2's at (0, 0) in
    the map lookup, times their zero metalness); the port's are 0, and
    its state stays finite."""
    jtrainer, jstate, trainer, _, targets = _trainers()
    state = _port_of(jstate)
    alive = state.alive.numpy()
    for view in (1, 2):
        jstate, jsc = jtrainer.train_step_glossy(
            jstate, _jax_camera(view), jnp.asarray(targets[view].numpy()),
            H, W, 1, jnp.zeros(3))
        state, sc = trainer.train_step_glossy(
            state, _port_camera(view), targets[view], H, W, 1,
            torch.zeros(3))
        if view == 1:
            assert float(sc["loss"]) == pytest.approx(float(jsc["loss"]),
                                                      abs=1e-6)
            assert float(sc["metal_mean"]) == pytest.approx(
                float(jsc["metal_mean"]), rel=1e-6)
            want = _port_of(jstate)
            for k in ("means", "rotations"):
                jmu = want.opt_state.exp_avg[k].numpy()
                assert np.isnan(jmu).any(-1).tolist() == (~alive).tolist()
                assert float(state.opt_state.exp_avg[k][~alive].abs().max()
                             ) == 0.0
            moments = [(state.opt_state.exp_avg[k][alive],
                        want.opt_state.exp_avg[k][alive], k)
                       for k in PARAM_FIELDS + ("metalness",)]
            moments.append((state.extra["__glossy__"]["opt"]["exp_avg"][
                "envmap"], want.extra["__glossy__"]["opt"]["exp_avg"][
                    "envmap"], "envmap"))
            for g, jg, k in moments:
                np.testing.assert_allclose(g.numpy() / 0.1,
                                           jg.numpy() / 0.1, rtol=GRAD_RTOL,
                                           atol=GRAD_ATOL, err_msg=k)
            assert float(moments[-1][0].abs().max()) > 1e-5
            assert float(moments[-2][0].abs().max()) > 1e-5
            names = PARAM_FIELDS + ("metalness",)
            got = {k: getattr(state.params, k)[alive] for k in names}
            wanted = {k: getattr(want.params, k)[alive] for k in names}
            got["envmap"] = state.extra["__glossy__"]["envmap"]
            wanted["envmap"] = want.extra["__glossy__"]["envmap"]
            for (g, _, _), k in zip(moments, got):
                sure = (g.abs() > 1e-5).numpy()
                np.testing.assert_allclose(got[k].numpy()[sure],
                                           wanted[k].numpy()[sure],
                                           rtol=1e-5, atol=1e-6, err_msg=k)
    assert all(bool(torch.isfinite(getattr(state.params, k)).all())
               for k in names)
    assert float(state.extra["__glossy__"]["envmap"].min()) >= 0.0
    assert state.extra["__glossy__"]["opt"]["count"] == 2
    assert state.opt_state.count_of("metalness") == 2


def test_glossy_validation_renders_without_the_specular_term():
    """eval_step renders SH colours, as gsl_tpu's: the same image as a
    plain render of the Gaussians, whatever the map and metalness."""
    _, _, trainer, own, targets = _trainers()
    state = dataclasses.replace(own, params=dataclasses.replace(
        own.params, metalness=torch.full_like(own.params.metalness, 5.0)))
    img, _ = trainer.eval_step(state, _port_camera(0), targets[0], H, W, 1,
                               torch.zeros(3))
    plain = trainer.renderer.forward(state.gaussians, _port_camera(0), H, W,
                                     torch.zeros(3), 1).render
    assert torch.equal(img, plain)


# ---- metalness row by row ----------------------------------------------------

def test_metalness_follows_densify_growth_convert_and_checkpoint(tmp_path):
    """A densify from the same state and draws: the metalness of every row
    equals gsl_tpu's (children copy their source's); the port's new rows
    start their metalness moments at zero, where gsl_tpu's row rule copies
    the source's; the map passes through. A growth pads metalness with 0;
    the state survives the conversion and a checkpoint bit for bit."""
    jtrainer, jstate, trainer, _, targets = _trainers()
    jstate, _ = jtrainer.train_step_glossy(
        jstate, _jax_camera(1), jnp.asarray(targets[1].numpy()), H, W, 1,
        jnp.zeros(3))
    # gsl_tpu's step left NaN in the dead rows (test_glossy_step_matches_jax)
    jstate = jstate.replace(
        params=jax.tree.map(jnp.nan_to_num, jstate.params),
        opt_state=jax.tree.map(jnp.nan_to_num, jstate.opt_state))
    g = jstate.extra["__glossy__"]
    rng = np.random.RandomState(7)
    jstate = jstate.replace(extra={"__glossy__": g.replace(
        metalness_raw=jnp.asarray(rng.normal(size=CAPACITY), jnp.float32))})
    state = _port_of(jstate)
    arrays = _density_arrays(CAPACITY, 3)
    arrays["grad_accum"][N_GT:] = 0.0
    cfg_kw = dict(densify_grad_threshold=2e-4)
    key = jax.random.PRNGKey(1)
    want = jd.densify_and_prune(
        key, JaxState(params=jstate.params, alive=jstate.alive,
                      extra=jstate.extra), jstate.opt_state,
        jd.DensityControlState(**{k: jnp.asarray(v)
                                  for k, v in arrays.items()}),
        jd.VanillaDensityControllerConfig(**cfg_kw), 1.5, 1.5,
        jnp.asarray(False))
    k1, k2 = jax.random.split(key)
    noise = tuple(to_torch(np.asarray(jax.random.normal(
        k, (CAPACITY, 3), jnp.float32))) for k in (k1, k2))
    got = td.densify_and_prune(
        noise, state.gaussians, state.opt_state,
        td.DensityControlState(**{k: to_torch(v)
                                  for k, v in arrays.items()}),
        td.VanillaDensityControllerConfig(**cfg_kw), 1.5, 1.5, False)
    wg = want[0].extra["__glossy__"]
    born = np.asarray(want[0].alive & ~jstate.alive)
    assert born.sum() > 10
    np.testing.assert_array_equal(got[0].params.metalness.numpy(),
                                  np.asarray(wg.metalness_raw))
    assert torch.equal(got[0].extra["__glossy__"]["envmap"],
                       state.extra["__glossy__"]["envmap"])
    jmu = np.asarray(wg.opt_state.inner_states["metal"].inner_state[0].mu[
        "metalness_raw"])
    mu = got[1].exp_avg["metalness"].numpy()
    # the port zeroes every property's moments in the rows the pass
    # touched (new rows, split originals, pruned rows); gsl_tpu's row rule
    # copies the metalness moments into new rows and leaves the rest
    touched = ~(got[1].exp_avg["means"] == state.opt_state.exp_avg[
        "means"]).all(-1).numpy() | born
    assert float(np.abs(mu[touched]).max()) == 0.0
    assert float(np.abs(jmu[born]).max()) > 0.0       # the source's moment
    np.testing.assert_array_equal(mu[~touched], jmu[~touched])

    trainer.setup(state.gaussians, 1.5)
    moved = dataclasses.replace(state, params=got[0].params,
                                alive=got[0].alive, opt_state=got[1])
    grown = trainer.grow_state(moved, 2 * CAPACITY)
    assert torch.equal(grown.params.metalness[:CAPACITY],
                       moved.params.metalness)
    assert float(grown.params.metalness[CAPACITY:].abs().max()) == 0.0
    assert grown.opt_state.exp_avg["metalness"].shape == (2 * CAPACITY,)

    back = train_state_from_jax_arrays(**{
        k: v for k, v in train_state_to_numpy(grown).items()}, device="cpu")
    assert torch.equal(back.params.metalness, grown.params.metalness)
    assert torch.equal(back.extra["__glossy__"]["envmap"],
                       grown.extra["__glossy__"]["envmap"])

    path = save_checkpoint(str(tmp_path), grown, 5)
    template = trainer.setup(VanillaGaussianConfig(
        sh_degree=1).init_from_pcd(np.zeros((4, 3), np.float32),
                                   np.zeros((4, 3), np.float32), 64,
                                   device="cpu"), 1.5)
    loaded = load_checkpoint(path, template)
    assert loaded.params.fields() == grown.params.fields()
    for k in grown.params.fields():
        assert torch.equal(getattr(loaded.params, k),
                           getattr(grown.params, k)), k
        assert torch.equal(loaded.opt_state.exp_avg[k],
                           grown.opt_state.exp_avg[k]), k
    for k in ("envmap",):
        assert torch.equal(loaded.extra["__glossy__"][k],
                           grown.extra["__glossy__"][k])
    assert loaded.extra["__glossy__"]["opt"]["count"] == 1
