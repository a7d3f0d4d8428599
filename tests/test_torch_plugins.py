"""gsl_tpu_torch's trainer plugins against gsl_tpu's on the same seeded
numpy inputs: the 3DGS form of depth_to_normal, each plugin's setup, its
loss term and that term's gradients, a training step with two plugins at
once, and the CLI's plugin list."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_tpu.models.gaussian import GaussianState as JaxState
from gsl_tpu.models.gaussian import VanillaGaussianConfig as JaxModelConfig
from gsl_tpu.ops.transforms import depth_to_normal as jax_depth_to_normal
from gsl_tpu.renderers.tile_renderer import \
    TileRendererConfig as JaxRendererConfig
from gsl_tpu.training import plugins as jp
from gsl_tpu.training.metrics import VanillaMetricsConfig as JaxMetrics
from gsl_tpu.training.trainer import Trainer as JaxTrainer
from gsl_tpu.training.trainer import TrainerConfig as JaxTrainerConfig

from gsl_tpu_torch import cli
from gsl_tpu_torch.models.gaussian import (GaussianState,
                                           VanillaGaussianConfig)
from gsl_tpu_torch.ops.transforms import depth_to_normal
from gsl_tpu_torch.renderers.tile_renderer import TileRendererConfig
from gsl_tpu_torch.training import plugins as tp
from gsl_tpu_torch.training.metrics import VanillaMetricsConfig
from gsl_tpu_torch.training.trainer import Trainer, TrainerConfig
from gsl_tpu_torch.utils.convert import train_state_from_jax_arrays

from test_torch_training import (CAPACITY, N_GT, H, W, _gt_state,
                                 _jax_camera, _port_camera, _targets,
                                 _to_port)
from torch_port_utils import PARAM_FIELDS, jax_train_state_arrays, to_torch

GRAD_RTOL, GRAD_ATOL = 5e-3, 1e-4
JAX_RENDERER = dict(backend="xla", max_per_tile=256, chunk=32,
                    min_isect_capacity=4096)


@pytest.mark.parametrize("view", [0, 2])
def test_depth_to_normal_matches_jax(view):
    """A smooth random depth map seen from a translated camera: the 3DGS
    form, within 1e-5."""
    rng = np.random.RandomState(view)
    base = rng.uniform(2.0, 4.0, size=(H // 8, W // 8))
    depth = np.kron(base, np.ones((8, 8))).astype(np.float32)
    depth += 0.05 * rng.normal(size=depth.shape).astype(np.float32)
    jcam, tcam = _jax_camera(view), _port_camera(view)
    want = np.asarray(jax_depth_to_normal(
        jnp.asarray(depth), jcam.world_to_camera, jcam.fx, jcam.fy,
        jcam.cx, jcam.cy))
    got = depth_to_normal(to_torch(depth), tcam.world_to_camera, tcam.fx,
                          tcam.fy, tcam.cx, tcam.cy).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(got[0]).max() == 0.0 and np.abs(got[:, -1]).max() == 0.0


def _states(seed=0, below=0):
    """gsl_tpu's TrainState at setup and the port's copy of it; with
    `below`, that many of the alive means sit under z = 0 (the scene lies
    at z in [2, 6])."""
    gt = _gt_state(1)
    xyz = np.asarray(gt.params.means[:N_GT]).copy()
    xyz[:below, 2] = -np.random.RandomState(seed).uniform(0.1, 1.0, below)
    rgb = np.random.RandomState(seed + 1).uniform(size=(N_GT, 3)).astype(
        np.float32)
    jtrainer = JaxTrainer(model=JaxModelConfig(sh_degree=1))
    jstate = jtrainer.setup(
        JaxModelConfig(sh_degree=1).init_from_pcd(xyz, rgb, CAPACITY), 1.5)
    return jstate, train_state_from_jax_arrays(
        **jax_train_state_arrays(jstate), device="cpu")


def _assert_params_close(got, want, atol=1e-6):
    for k in PARAM_FIELDS:
        np.testing.assert_allclose(getattr(got.params, k).numpy(),
                                   np.asarray(getattr(want.params, k)),
                                   rtol=1e-6, atol=atol, err_msg=k)


def test_normal_reg_setup_matches_jax_with_its_rotations():
    jstate, state = _states()
    jplugin = jp.NormalRegPluginConfig().instantiate()
    want = jplugin.on_setup(jstate)
    rots = jax.random.uniform(jax.random.PRNGKey(7),
                              jstate.params.rotations.shape)
    got = tp.NormalRegPluginConfig().instantiate().on_setup(
        state, rotations=to_torch(rots))
    _assert_params_close(got, want)
    assert not np.array_equal(got.params.scales.numpy(),
                              state.params.scales.numpy())
    # without draws, a generator seeded 7 on the state's device
    a = tp.NormalRegPluginConfig().instantiate().on_setup(state)
    b = tp.NormalRegPluginConfig().instantiate().on_setup(state)
    assert torch.equal(a.params.rotations, b.params.rotations)
    assert float(a.params.rotations.min()) >= 0.0
    assert float(a.params.rotations.max()) < 1.0
    assert torch.equal(a.params.scales, got.params.scales)


def test_ground_reg_setup_matches_jax():
    jstate, state = _states(below=20)
    cfg = dict(up_direction=(0.0, 0.1, 1.0), ground_alt=0.0)
    want = jp.GroundRegPluginConfig(**cfg).instantiate().on_setup(jstate)
    got = tp.GroundRegPluginConfig(**cfg).instantiate().on_setup(state)
    _assert_params_close(got, want)
    moved = (got.params.means != state.params.means).any(-1)
    assert int(moved.sum()) >= 20
    assert float(got.params.opacities[moved].max()) == -15.0


def _jax_term(plugin, jstate, view, mask, step, render_types):
    """gsl_tpu's extra_loss of the plugin at `view` and its gradients."""
    renderer = JaxRendererConfig(**JAX_RENDERER).instantiate()
    cam = _jax_camera(view)

    def term(params):
        g = JaxState(params=params, alive=jstate.alive)
        out = renderer.forward(g, cam, H, W, jnp.zeros(3), 1,
                               render_types=render_types)
        t, sc = plugin.extra_loss(out, None, mask, g, jnp.asarray(step),
                                  camera=cam)
        return t, sc

    (t, sc), grads = jax.value_and_grad(term, has_aux=True)(jstate.params)
    return float(t), {k: float(v) for k, v in sc.items()}, grads


def _port_term(plugin, state, view, mask, step, render_types):
    renderer = TileRendererConfig().instantiate()
    leaves = state.params.map(lambda _, x: x.detach().requires_grad_(True))
    g = GaussianState(params=leaves, alive=state.alive)
    out = renderer.forward(g, _port_camera(view), H, W, torch.zeros(3), 1,
                           render_types=render_types)
    t, sc = plugin.extra_loss(out, None, mask, g, step,
                              camera=_port_camera(view))
    if not isinstance(t, torch.Tensor):
        return t, sc, None
    wrt = [getattr(leaves, k) for k in PARAM_FIELDS]
    # a term switched off by its schedule is a constant
    grads = (torch.autograd.grad(t, wrt, allow_unused=True)
             if t.requires_grad else [None] * len(wrt))
    return (float(t.detach()), {k: float(v.detach()) for k, v in sc.items()},
            dict(zip(PARAM_FIELDS, grads)))


def _assert_terms_equal(got, want):
    (t, sc, grads), (jt, jsc, jgrads) = got, want
    assert t == pytest.approx(jt, rel=1e-5, abs=1e-7)
    assert sc.keys() == jsc.keys()
    for k in sc:
        assert sc[k] == pytest.approx(jsc[k], rel=1e-5, abs=1e-7), k
    for k in PARAM_FIELDS:
        g = grads[k]
        g = np.zeros(np.shape(getattr(jgrads, k))) if g is None else \
            g.numpy()
        np.testing.assert_allclose(g, np.asarray(getattr(jgrads, k)),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)


PLUGIN_CASES = {
    # case: (plugin, config kwargs, step, with a mask)
    "normal_reg": ("normal_reg", {}, 3, False),
    "ground_reg_on_its_step": ("ground_reg", dict(ground_reg_lambda=2.0),
                               20, False),
    "ground_reg_between_its_steps": (
        "ground_reg", dict(ground_reg_lambda=2.0), 21, False),
    "background_removal_masked": (
        "background_removal", dict(background_removal_from=5), 5, True),
    "background_removal_before_its_start": (
        "background_removal", dict(background_removal_from=5), 4, True),
    "background_removal_without_a_mask": ("background_removal", {}, 9000,
                                          False),
}


@pytest.mark.parametrize("case", sorted(PLUGIN_CASES))
def test_extra_loss_and_its_gradients_match_jax(case):
    """The term, its scalars (rtol 1e-5) and its gradients in every
    parameter (rtol 5e-3, atol 1e-4, as the rasterizer's gradient tests)
    on a scene with some means under the ground plane."""
    name, kwargs, step, masked = PLUGIN_CASES[case]
    jstate, state = _states(below=15)
    jplugin = jp.PLUGIN_REGISTRY[name](**kwargs).instantiate()
    plugin = tp.PLUGIN_REGISTRY[name](**kwargs).instantiate()
    assert plugin.required_render_types == jplugin.required_render_types
    render_types = frozenset({"rgb"}) | plugin.required_render_types
    mask = None
    if masked:
        mask = (np.random.RandomState(4).uniform(size=(H, W)) > 0.3).astype(
            np.float32)
    want = _jax_term(jplugin, jstate, 1, None if mask is None
                     else jnp.asarray(mask), step, render_types)
    got = _port_term(plugin, state, 1, None if mask is None
                     else to_torch(mask), step, render_types)
    if case == "background_removal_without_a_mask":
        assert got[:2] == (0.0, {}) and want[:2] == (0.0, {})
        return
    _assert_terms_equal(got, want)
    if case in ("ground_reg_between_its_steps",
                "background_removal_before_its_start"):
        assert got[0] == 0.0
    else:
        assert got[0] != 0.0


def test_train_step_with_two_plugins_matches_jax():
    """Trainer(plugins=(normal_reg, ground_reg)) set up from the same
    Gaussians (NormalReg given gsl_tpu's rotations), ten means sunk under
    the plane, and stepped once on the same view at a ground-reg step: the loss within 3e-3 (gsl_tpu's SSIM is
    its bf16-split one), the plugins' scalars within rtol 1e-4, gradients
    (Adam's first moment / 0.1) within rtol 5e-3 / atol 1e-4, and the
    parameters after the step where the gradient is clear of that
    tolerance (|g| > 1e-5: there Adam's first step is -lr sign(g))."""
    gt = _gt_state(1)
    targets = _targets(gt, 1)
    xyz = np.asarray(gt.params.means[:N_GT]).copy()
    xyz[:12, 2] = -0.5
    rgb = np.full((N_GT, 3), 0.5, np.float32)
    ground = dict(up_direction=(0.0, 0.0, 1.0), ground_alt=0.0,
                  ground_reg_interval=1)
    jtrainer = JaxTrainer(
        model=JaxModelConfig(sh_degree=1),
        renderer=JaxRendererConfig(**JAX_RENDERER),
        metrics=JaxMetrics(), config=JaxTrainerConfig(),
        plugins=(jp.NormalRegPluginConfig().instantiate(),
                 jp.GroundRegPluginConfig(**ground).instantiate()))
    jinit = JaxModelConfig(sh_degree=1).init_from_pcd(xyz, rgb, CAPACITY)
    jstate = jtrainer.setup(jinit, 1.5)
    normal = tp.NormalRegPluginConfig().instantiate()
    rots = to_torch(jax.random.uniform(jax.random.PRNGKey(7),
                                       (CAPACITY, 4)))
    normal.on_setup = (lambda st, f=normal.on_setup: f(st, rotations=rots))
    trainer = Trainer(
        model=VanillaGaussianConfig(sh_degree=1), metrics=VanillaMetricsConfig(),
        config=TrainerConfig(),
        plugins=(normal, tp.GroundRegPluginConfig(**ground).instantiate()))
    state = trainer.setup(_to_port(jinit), 1.5)
    _assert_params_close(state, jstate)
    # setup lifted the sunken means onto the plane: sink a few again, as
    # training may
    means = np.asarray(jstate.params.means).copy()
    means[20:30, 2] = -0.3
    jstate = jstate.replace(params=jstate.params.replace(
        means=jnp.asarray(means)))
    state = dataclasses.replace(state, params=dataclasses.replace(
        state.params, means=to_torch(means)))

    jnew, jsc = jtrainer.train_step(
        jstate, _jax_camera(1), jnp.asarray(targets[1].numpy()), H, W, 1,
        jnp.zeros(3))
    new, sc = trainer.train_step(state, _port_camera(1), targets[1], H, W,
                                 1, torch.zeros(3))
    assert float(sc["loss"]) == pytest.approx(float(jsc["loss"]), abs=3e-3)
    for k in ("normal_loss", "flatten_loss", "ground"):
        assert float(sc[k]) == pytest.approx(float(jsc[k]), rel=1e-4), k
    assert float(sc["ground"]) > 0.0
    got = jax_train_state_arrays(jnew)
    for k in PARAM_FIELDS:
        g = new.opt_state.exp_avg[k].numpy() / 0.1
        jg = got["opt"][k]["mu"] / 0.1
        np.testing.assert_allclose(g, jg, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)
        sure = np.abs(jg) > 1e-5
        np.testing.assert_allclose(getattr(new.params, k).numpy()[sure],
                                   got["params"][k][sure], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_registry_and_the_cli_plugin_list():
    assert sorted(tp.PLUGIN_REGISTRY) == sorted(jp.PLUGIN_REGISTRY)
    for name, cls in tp.PLUGIN_REGISTRY.items():
        jfields = {f.name: f.default for f in dataclasses.fields(
            jp.PLUGIN_REGISTRY[name])}
        assert {f.name: f.default for f in dataclasses.fields(cls)} \
            == jfields, name
    plugins = cli.build_plugins([
        "normal_reg",
        {"class_path": "ground_reg", "init_args": {"ground_alt": -1.5}},
        {"class_path": "gsl_tpu_torch.training.plugins."
                       "BackgroundRemovalPluginConfig"}])
    assert [type(p).__name__ for p in plugins] == [
        "NormalRegPlugin", "GroundRegPlugin", "BackgroundRemovalPlugin"]
    assert plugins[1].config.ground_alt == -1.5
    trainer, _, _ = cli.build_components({"plugins": ["ground_reg"]})
    assert type(trainer.plugins[0]).__name__ == "GroundRegPlugin"
    (freeze,) = cli.build_plugins(["freeze_bilagrid"])
    assert type(freeze).__name__ == "FreezeBilagridPlugin"
    assert freeze.config.freeze_from == 15_000
    bilagrid = cli._PROCESSORS["bilagrid"]()
    assert Trainer(output_processor=bilagrid).output_processor is bilagrid
