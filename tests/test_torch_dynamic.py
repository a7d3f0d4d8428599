"""gsl_tpu_torch's dynamic-scene modules against gsl_tpu's on the same
seeded numpy inputs: the deformation MLP with its positional encoding,
deform_gaussians and the AST noise (given gsl_tpu's draw), the HexPlane
lookup, field and deformation, PVG's init, modulation, render and step,
DeformTrainer's step for both fields in and after the warm-up, a densify
with PVG rows, and the differences on gsl_tpu's side that the port
mirrors or refuses.

The capacities here stay outside {16, 32, 64, 72, 104, 256, 328}:
gsl_tpu's densify and growth row-edit every leaf of `extra` whose leading
dimension is the capacity, and the fields' weights lead with those
(`test_the_row_rule_reaches_the_field_at_small_capacities`)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_tpu.models import deform as jdf
from gsl_tpu.models import hexplane as jhx
from gsl_tpu.models import pvg as jpvg
from gsl_tpu.models.appearance import positional_encoding as jax_pe
from gsl_tpu.models.gaussian import GaussianState as JaxState
from gsl_tpu.models.gaussian import VanillaGaussianConfig as JaxModelConfig
from gsl_tpu.renderers.tile_renderer import \
    TileRendererConfig as JaxRendererConfig
from gsl_tpu.training import density as jd
from gsl_tpu.training.deform_trainer import DeformNetState
from gsl_tpu.training.deform_trainer import DeformTrainer as JaxDeformTrainer
from gsl_tpu.training.metrics import VanillaMetricsConfig as JaxMetrics
from gsl_tpu.training.trainer import Trainer as JaxTrainer
from gsl_tpu.utils.ply import save_state_ply as jax_save_ply

from gsl_tpu_torch import cli
from gsl_tpu_torch.models import deform as tdf
from gsl_tpu_torch.models import hexplane as thx
from gsl_tpu_torch.models import pvg as tpvg
from gsl_tpu_torch.models.appearance import positional_encoding
from gsl_tpu_torch.models.gaussian import VanillaGaussianConfig
from gsl_tpu_torch.renderers.tile_renderer import TileRendererConfig
from gsl_tpu_torch.training import density as td
from gsl_tpu_torch.training.deform_trainer import DeformTrainer
from gsl_tpu_torch.training.metrics import VanillaMetricsConfig
from gsl_tpu_torch.training.trainer import Trainer
from gsl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from gsl_tpu_torch.utils.convert import (state_dict_from_flax,
                                         state_from_jax_arrays,
                                         train_state_from_jax_arrays,
                                         train_state_to_numpy)
from gsl_tpu_torch.utils.ply import load_gaussian_ply, save_state_ply

from test_torch_training import (N_GT, H, W, _density_arrays, _jax_camera,
                                 _port_camera)
from torch_port_utils import PARAM_FIELDS, jax_train_state_arrays, to_torch
from scene_utils import random_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_RTOL, GRAD_ATOL = 5e-3, 1e-4
NET_ATOL = 1e-5
JAX_RENDERER = dict(backend="xla", max_per_tile=256, chunk=32,
                    min_isect_capacity=4096)
CAP = 200                 # outside the fields' leading dimensions
PVG_FIELDS = ("t_centers", "t_scales", "velocities")
SMALL_MLP = dict(n_neurons=32, n_layers=4, skip_layers=(2,))
SMALL_HEX = dict(resolutions=(4, 8), n_features=4)


def _tree(tree):
    return jax.tree.map(np.asarray, tree)


def _module(m, flax_params):
    """`m` carrying gsl_tpu's parameters."""
    m.load_state_dict(state_dict_from_flax(_tree(flax_params), "cpu"))
    return m


def _randomise(params, seed, scale=0.05, only=None):
    """The flax tree with every leaf whose path holds one of `only` (every
    leaf when None) replaced by seeded normal values times `scale`."""
    rng = np.random.RandomState(seed)

    def fix(path, x):
        names = "/".join(str(getattr(k, "key", k)) for k in path)
        if only is not None and not any(o in names for o in only):
            return x
        return jnp.asarray(rng.normal(size=x.shape) * scale, jnp.float32)

    return jax.tree_util.tree_map_with_path(fix, params)


def _xyz(n=90, seed=0, spread=1.2):
    return np.random.RandomState(seed).uniform(
        -spread, spread, (n, 3)).astype(np.float32)


def _assert_close_tree(got: dict, want: dict, rtol, atol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   want[k].detach().numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


# ---- the deformation MLP -----------------------------------------------------

def test_positional_encoding_as_the_field_uses_it_matches_jax():
    """The means at 10 frequencies and the time column at 6: the
    encodings within 1e-5 (the angles are the same float32 products)."""
    xyz = _xyz(120, 1)
    tt = np.full((120, 1), 0.37, np.float32)
    for x, f in ((xyz, 10), (tt, 6)):
        np.testing.assert_allclose(
            positional_encoding(to_torch(x), f).numpy(),
            np.asarray(jax_pe(jnp.asarray(x), f)), atol=NET_ATOL)


def _mlp_pair(seed=0, heads=True):
    cfg = jdf.DeformModelConfig(**SMALL_MLP)
    net = jdf.DeformNetwork(cfg)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((8, 3)),
                      jnp.zeros(()))
    if heads:       # non-zero heads, so every layer has a gradient
        params = _randomise(params, seed + 1, only=("Dense_4", "Dense_5",
                                                    "Dense_6"))
    port = _module(tdf.DeformNetwork(tdf.DeformModelConfig(**SMALL_MLP)),
                   params)
    return net, params, port


def test_deform_network_matches_jax_with_gradients():
    """A 4 x 32 MLP with a skip at layer 2 and gsl_tpu's weights (random
    heads): the three outputs within 1e-5, and the gradients of a weighted
    sum of them in every weight within rtol 5e-3 / atol 1e-4."""
    net, params, port = _mlp_pair()
    xyz, t = _xyz(), np.float32(0.61)
    rng = np.random.RandomState(3)
    ws = [rng.normal(size=(len(xyz), k)).astype(np.float32)
          for k in (3, 4, 3)]

    def jloss(p):
        return sum(jnp.sum(o * w) for o, w in zip(
            net.apply(p, jnp.asarray(xyz), jnp.asarray(t)), ws))

    jgrads = state_dict_from_flax(_tree(jax.grad(jloss)(params)), "cpu")
    outs = port(to_torch(xyz), torch.tensor(t))
    for o, jo in zip(outs, net.apply(params, jnp.asarray(xyz),
                                     jnp.asarray(t))):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                                   atol=NET_ATOL)
    loss = sum((o * to_torch(w)).sum() for o, w in zip(outs, ws))
    names = [k for k, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, list(port.parameters()))
    _assert_close_tree(dict(zip(names, grads)), jgrads, GRAD_RTOL,
                       GRAD_ATOL)
    assert float(grads[0].abs().max()) > 1e-4      # reached the first layer


def test_a_new_network_is_the_identity():
    """The port's own init: hidden layers drawn, heads at zero, so the
    deformed state equals the canonical one at any time; its layer shapes
    are gsl_tpu's."""
    state = VanillaGaussianConfig(sh_degree=0).init_from_pcd(
        _xyz(30), np.full((30, 3), 0.5, np.float32), 40, device="cpu")
    cfg = tdf.DeformModelConfig()
    net = tdf.DeformNetwork(cfg, torch.Generator().manual_seed(0))
    m, r, s = tdf.deform_gaussians(net, None, state, torch.tensor(0.7))
    assert torch.equal(m, state.params.means)
    assert torch.equal(r, state.params.rotations)
    assert torch.equal(s, state.params.scales)
    jparams = jdf.DeformNetwork(jdf.DeformModelConfig()).init(
        jax.random.PRNGKey(0), jnp.zeros((4, 3)), jnp.zeros(()))
    want = {k: tuple(v.shape) for k, v in state_dict_from_flax(
        _tree(jparams), "cpu").items()}
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == want
    assert want["layers.0.weight"] == (256, 72)      # 60 + 12 inputs
    assert want["layers.4.weight"] == (256, 328)     # the skip


def test_deform_gaussians_and_ast_noise_match_jax():
    """deform_gaussians on a state with dead rows (which stay where they
    are) within 1e-5, in the warm-up the canonical tensors themselves;
    the AST noise given gsl_tpu's draw at steps 0, 1234 and past
    max_steps within 1e-7."""
    net, params, port = _mlp_pair(4)
    n = 60
    js = JaxModelConfig(sh_degree=0).init_from_pcd(
        _xyz(n, 5), np.full((n, 3), 0.5, np.float32), CAP)
    alive = np.asarray(js.alive).copy()
    alive[::7] = False
    js = JaxState(params=js.params, alive=jnp.asarray(alive))
    ts = state_from_jax_arrays(
        {k: np.asarray(getattr(js.params, k)) for k in PARAM_FIELDS},
        alive, device="cpu")
    t = np.float32(0.25)
    want = jdf.deform_gaussians(net, params, js, jnp.asarray(t))
    got = tdf.deform_gaussians(
        port, None, ts, torch.tensor(t))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=NET_ATOL)
    moved = (got[0] - ts.params.means).abs().sum(-1).detach()
    assert float(moved[~ts.alive].max()) == 0.0
    assert float(moved[ts.alive].min()) > 0.0
    warm = tdf.deform_gaussians(port, None, ts, torch.tensor(t),
                                warm_up_active=True)
    assert warm[0] is ts.params.means and warm[2] is ts.params.scales
    key = jax.random.PRNGKey(11)
    draw = torch.tensor(np.asarray(jax.random.normal(key, ())))
    for step in (0, 1234, 50_000):
        np.testing.assert_allclose(
            float(tdf.ast_noise(draw, torch.tensor(t), step, 40_000, 0.1)),
            float(jdf.ast_noise(key, jnp.asarray(t), jnp.asarray(
                step, jnp.int32), 40_000, 0.1)), atol=1e-7)


# ---- HexPlane ----------------------------------------------------------------

def test_bilinear_matches_jax_with_gradients():
    """A random [5, 7, 4] grid at points inside and outside [0, 1]^2
    (clamped to the border) and on the first and last row and column: the
    values within 1e-6, the gradients in the grid and the points within
    rtol 5e-3 / atol 1e-4 (at a border the clip's gradient is split in
    half, as jnp.clip splits it)."""
    rng = np.random.RandomState(6)
    grid = rng.normal(size=(5, 7, 4)).astype(np.float32)
    uv = np.concatenate([rng.uniform(-0.3, 1.3, (50, 2)),
                         [[1.0, 1.0], [0.0, 1.0], [1.0, 0.5]]]).astype(
        np.float32)
    w = rng.normal(size=(len(uv), 4)).astype(np.float32)
    jg, juv = jax.grad(lambda g, u: jnp.sum(jhx._bilinear(g, u) * w),
                       argnums=(0, 1))(jnp.asarray(grid), jnp.asarray(uv))
    g, u = (to_torch(grid).requires_grad_(True),
            to_torch(uv).requires_grad_(True))
    out = thx._bilinear(g, u)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jhx._bilinear(jnp.asarray(grid), jnp.asarray(uv))),
        atol=1e-6)
    gg, gu = torch.autograd.grad((out * to_torch(w)).sum(), [g, u])
    np.testing.assert_allclose(gg.numpy(), np.asarray(jg), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(gu.numpy(), np.asarray(juv), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def _hex_params(seed=0, n_neurons=16):
    """gsl_tpu's HexPlaneDeformation at resolutions (4, 8) with 4
    features, its time planes and heads made random (at init they are one
    and zero)."""
    net = jhx.HexPlaneDeformation(**SMALL_HEX, n_neurons=n_neurons)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((8, 3)),
                      jnp.zeros(()))
    rng = np.random.RandomState(seed + 1)

    def fix(path, x):
        names = "/".join(str(getattr(k, "key", k)) for k in path)
        if any(f"_p{pi}" in names for pi in (2, 4, 5)):   # (., t) planes
            return x + jnp.asarray(rng.normal(size=x.shape) * 0.3,
                                   jnp.float32)
        if any(h in names for h in ("Dense_2", "Dense_3", "Dense_4")):
            return jnp.asarray(rng.normal(size=x.shape) * 0.05, jnp.float32)
        return x

    return net, jax.tree_util.tree_map_with_path(fix, params)


def test_hexplane_field_and_deformation_match_jax_with_gradients():
    """The field alone and the deformation at two times, on points inside
    and outside the bounds: the field's features within 1e-5 and the plane
    names and shapes gsl_tpu's; the deformation's outputs within 1e-5 and
    the gradients of a weighted sum in every plane and layer within rtol
    5e-3 / atol 1e-4."""
    net, params = _hex_params()
    port = _module(thx.HexPlaneDeformation(**SMALL_HEX, n_neurons=16),
                   params)
    xyz = _xyz(80, 7, spread=1.8)
    for t in (np.float32(0.0), np.float32(0.73)):
        field = jhx.HexPlaneField(**SMALL_HEX)
        fparams = {"params": params["params"]["HexPlaneField_0"]}
        np.testing.assert_allclose(
            port.field(to_torch(xyz), torch.tensor(t)).detach().numpy(),
            np.asarray(field.apply(fparams, jnp.asarray(xyz),
                                   jnp.asarray(t))), atol=NET_ATOL)
        rng = np.random.RandomState(9)
        ws = [rng.normal(size=(len(xyz), k)).astype(np.float32)
              for k in (3, 4, 3)]

        def jloss(p):
            return sum(jnp.sum(o * w) for o, w in zip(
                net.apply(p, jnp.asarray(xyz), jnp.asarray(t)), ws))

        jgrads = state_dict_from_flax(_tree(jax.grad(jloss)(params)), "cpu")
        outs = port(to_torch(xyz), torch.tensor(t))
        for o, jo in zip(outs, net.apply(params, jnp.asarray(xyz),
                                         jnp.asarray(t))):
            np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                                       atol=NET_ATOL)
        loss = sum((o * to_torch(w)).sum() for o, w in zip(outs, ws))
        names = [k for k, _ in port.named_parameters()]
        grads = dict(zip(names, torch.autograd.grad(
            loss, list(port.parameters()))))
        _assert_close_tree(grads, jgrads, GRAD_RTOL, GRAD_ATOL)
        assert float(grads["field.plane_r8_p0"].abs().max()) > 1e-4
    assert sorted(k for k in port.state_dict() if "plane" in k) == sorted(
        f"field.plane_r{r}_p{p}" for r in (4, 8) for p in range(6))
    assert tuple(port.field.plane_r8_p2.shape) == (16, 8, 4)   # (x, t)


def test_a_new_hexplane_field_is_static_and_its_deformation_zero():
    """The port's own init: time planes at one (features the same at
    every time), spatial planes in [0, 0.2), heads at zero."""
    net = thx.HexPlaneDeformation(generator=torch.Generator().manual_seed(1))
    xyz = to_torch(_xyz(50, 8))
    f0 = net.field(xyz, torch.tensor(0.0))
    assert torch.equal(f0, net.field(xyz, torch.tensor(0.9)))
    assert f0.shape == (50, 32)
    p = net.field.plane_r32_p0
    assert p.shape == (32, 32, 16) and 0.0 <= float(p.min()) \
        and float(p.max()) < 0.2
    assert all(float(o.abs().max()) == 0.0
               for o in net(xyz, torch.tensor(0.4)))


def test_hexplane_clips_coordinates_outside_its_fixed_bounds():
    """gsl_tpu's bounds are 1.5 whatever the scene: every point beyond
    them on one axis samples the border, so two points that differ only
    beyond x = 1.5 get the same features, in both packages."""
    net, params = _hex_params(3)
    port = _module(thx.HexPlaneDeformation(**SMALL_HEX, n_neurons=16),
                   params)
    xyz = np.array([[1.6, 0.2, -0.3], [4.0, 0.2, -0.3], [1.4, 0.2, -0.3]],
                   np.float32)
    got = port.field(to_torch(xyz), torch.tensor(0.5))
    want = jhx.HexPlaneField(**SMALL_HEX).apply(
        {"params": params["params"]["HexPlaneField_0"]}, jnp.asarray(xyz),
        jnp.asarray(0.5))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=NET_ATOL)
    assert torch.equal(got[0], got[1]) and not torch.equal(got[0], got[2])


# ---- PVG ---------------------------------------------------------------------

def _pvg_jax_state(seed=7, n=80, cap=CAP):
    """gsl_tpu's PVG init of a random scene, with velocities, life peaks
    and lifespans made random (at init they are 0, uniform and log 1)."""
    means, scales, quats, opac, colors = random_scene(n, seed)
    cfg = jpvg.PVGConfig(sh_degree=0)
    st = cfg.init_from_pcd(np.asarray(means), np.asarray(colors), cap)
    rng = np.random.RandomState(seed)
    p = st.params.replace(
        velocities=jnp.asarray(rng.normal(size=(cap, 3)) * 2.0,
                               jnp.float32),
        t_scales=jnp.asarray(rng.uniform(-2.5, 0.5, (cap, 1)), jnp.float32),
        scales=st.params.scales.at[:n].set(jnp.log(scales)),
        opacities=st.params.opacities.at[:n, 0].set(
            jnp.log(opac / (1 - opac))),
        rotations=st.params.rotations.at[:n].set(quats))
    return JaxState(params=p, alive=st.alive)


def _pvg_arrays(js):
    return {k: np.asarray(getattr(js.params, k))
            for k in PARAM_FIELDS + PVG_FIELDS}


def _pvg_port_state(js):
    return state_from_jax_arrays(_pvg_arrays(js), np.asarray(js.alive),
                                 device="cpu")


def test_pvg_init_from_pcd_is_bit_for_bit():
    """gsl_tpu's RandomState(3) life peaks, log(initial_t_scale) and zero
    velocities: every field of the port's init equal to gsl_tpu's."""
    means, _, _, _, colors = random_scene(70, 2)
    want = jpvg.PVGConfig(sh_degree=1, initial_t_scale=0.7).init_from_pcd(
        np.asarray(means), np.asarray(colors), CAP)
    got = tpvg.PVGConfig(sh_degree=1, initial_t_scale=0.7).init_from_pcd(
        np.asarray(means), np.asarray(colors), CAP, device="cpu")
    assert got.params.fields() == PARAM_FIELDS + PVG_FIELDS
    for k in PVG_FIELDS + ("means", "shs_dc", "opacities", "rotations"):
        np.testing.assert_array_equal(getattr(got.params, k).numpy(),
                                      np.asarray(getattr(want.params, k)),
                                      err_msg=k)
    assert float(got.params.t_centers[70:].abs().max()) == 0.0


def test_pvg_modulate_matches_jax():
    """The means and the temporal opacity at four times within 1e-6."""
    js = _pvg_jax_state()
    ts = _pvg_port_state(js)
    for t in (0.0, 0.3, 0.55, 1.0):
        jm, jr = jpvg.pvg_modulate(js, jnp.float32(t), 0.2)
        m, r = tpvg.pvg_modulate(ts, torch.tensor(t), 0.2)
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-6)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-6)


@pytest.mark.parametrize("anti_aliased", [True, False])
def test_pvg_render_matches_jax_at_three_times(anti_aliased):
    """PVGRenderer's image at three times within 1e-4 of gsl_tpu's (XLA
    rasterizer), and the three differ (the scene moves and fades)."""
    js = _pvg_jax_state(8)
    ts = _pvg_port_state(js)
    jr = jpvg.PVGRendererConfig(anti_aliased=anti_aliased,
                                **JAX_RENDERER).instantiate()
    tr = tpvg.PVGRendererConfig(anti_aliased=anti_aliased).instantiate()
    imgs = []
    for t in (0.1, 0.45, 0.8):
        want = jr.forward(js, _jax_camera(1).replace(time=jnp.float32(t)),
                          H, W, jnp.zeros(3), 0).render
        got = tr.forward(ts, dataclasses.replace(
            _port_camera(1), time=torch.tensor(t)), H, W, torch.zeros(3),
            0).render
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        imgs.append(got)
    assert float((imgs[0] - imgs[1]).abs().max()) > 0.05
    assert float((imgs[1] - imgs[2]).abs().max()) > 0.05


def _jax_pvg_opt(opt_state):
    """The PVG group's Adam of gsl_tpu's optimizer as {field: {mu, nu,
    count}}."""
    adam = opt_state.inner_states["pvg"].inner_state[0]
    return {k: {"mu": np.asarray(getattr(adam.mu, k)),
                "nu": np.asarray(getattr(adam.nu, k)),
                "count": int(adam.count)} for k in PVG_FIELDS}


def _pvg_train_port(jstate):
    arrays = jax_train_state_arrays(jstate)
    arrays["params"].update({k: np.asarray(getattr(jstate.params, k))
                             for k in PVG_FIELDS})
    arrays["opt"].update(_jax_pvg_opt(jstate.opt_state))
    return train_state_from_jax_arrays(**arrays, device="cpu")


def _pvg_trainers(pvg_lr=1e-3, cycle_length=0.2):
    js = _pvg_jax_state(9)
    jtrainer = JaxTrainer(
        model=jpvg.PVGConfig(sh_degree=0, pvg_lr=pvg_lr,
                             cycle_length=cycle_length),
        renderer=jpvg.PVGRendererConfig(**JAX_RENDERER),
        metrics=JaxMetrics(lambda_dssim=0.0))
    trainer = Trainer(
        model=tpvg.PVGConfig(sh_degree=0, pvg_lr=pvg_lr,
                             cycle_length=cycle_length),
        renderer=tpvg.PVGRendererConfig(),
        metrics=VanillaMetricsConfig(lambda_dssim=0.0))
    jstate = jtrainer.setup(js, 1.5)
    trainer.setup(_pvg_port_state(js), 1.5)
    truth = _pvg_port_state(_pvg_jax_state(10))
    with torch.no_grad():
        targets = [trainer.renderer.forward(truth, dataclasses.replace(
            _port_camera(i), time=torch.tensor(0.2 + 0.3 * i)), H, W,
            torch.zeros(3), 0).render for i in range(3)]
    return jtrainer, jstate, trainer, targets


def _pvg_step(jtrainer, jstate, trainer, state, targets, view):
    t = 0.2 + 0.3 * view
    jstate, jsc = jtrainer.train_step(
        jstate, _jax_camera(view).replace(time=jnp.float32(t)),
        jnp.asarray(targets[view].numpy()), H, W, 0, jnp.zeros(3))
    state, sc = trainer.train_step(
        state, dataclasses.replace(_port_camera(view), time=torch.tensor(t)),
        targets[view], H, W, 0, torch.zeros(3))
    return jstate, jsc, state, sc


def test_pvg_training_step_matches_jax():
    """Two Trainer steps with the PVG model and renderer at two times: the
    loss within 1e-6 at the first; every property's gradient (first
    moment / 0.1) within rtol 5e-3 / atol 1e-4, PVG's three among them
    and non-zero; after the second, the values where the gradients are
    clear of zero within 1e-5, and the three in one Adam of 1e-3 counted
    with the rest."""
    jtrainer, jstate, trainer, targets = _pvg_trainers()
    state = _pvg_train_port(jstate)
    assert trainer.tx.learning_rate("velocities", 0) == 1e-3
    jstate, jsc, state, sc = _pvg_step(jtrainer, jstate, trainer, state,
                                       targets, 1)
    assert float(sc["loss"]) == pytest.approx(float(jsc["loss"]), abs=1e-6)
    want = _pvg_train_port(jstate)
    alive = state.alive
    for k in PARAM_FIELDS + PVG_FIELDS:
        np.testing.assert_allclose(
            state.opt_state.exp_avg[k][alive].numpy() / 0.1,
            want.opt_state.exp_avg[k][alive].numpy() / 0.1, rtol=GRAD_RTOL,
            atol=GRAD_ATOL, err_msg=k)
    for k in PVG_FIELDS:
        assert float(state.opt_state.exp_avg[k].abs().max()) > 1e-6, k
    jstate, _, state, _ = _pvg_step(jtrainer, jstate, trainer, state,
                                    targets, 2)
    want = _pvg_train_port(jstate)
    for k in PARAM_FIELDS + PVG_FIELDS:
        sure = (want.opt_state.exp_avg[k].abs() > 1e-5) \
            & alive.reshape((-1,) + (1,) * (want.opt_state.exp_avg[k].ndim
                                            - 1))
        np.testing.assert_allclose(getattr(state.params, k)[sure].numpy(),
                                   getattr(want.params, k)[sure].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert state.opt_state.count_of("t_centers") == 2
    assert _jax_pvg_opt(jstate.opt_state)["t_centers"]["count"] == 2


def test_pvg_lr_and_cycle_length_are_not_read():
    """gsl_tpu reads neither `PVGConfig.pvg_lr` (the group's rate is
    build_gaussian_optimizer's default, 1e-3) nor
    `PVGConfig.cycle_length` (the renderer keeps its own): a step with
    other values of both equals the default one, in both packages."""
    runs = []
    for lr, cycle in ((1e-3, 0.2), (0.5, 3.0)):
        jtrainer, jstate, trainer, targets = _pvg_trainers(lr, cycle)
        state = _pvg_train_port(jstate)
        jstate, _, state, _ = _pvg_step(jtrainer, jstate, trainer, state,
                                        targets, 0)
        runs.append((_pvg_train_port(jstate), state))
    for k in PARAM_FIELDS + PVG_FIELDS:
        assert torch.equal(getattr(runs[0][0].params, k),
                           getattr(runs[1][0].params, k)), k
        assert torch.equal(getattr(runs[0][1].params, k),
                           getattr(runs[1][1].params, k)), k


def test_densify_with_pvg_rows_matches_jax():
    """A densify from the same state, statistics and draws: every row of
    every property, PVG's three among them, equal to gsl_tpu's (children
    copy their source's; a split's children move only their means and
    scales), the same moments and alive rows."""
    js = _pvg_jax_state(12)
    jtrainer = JaxTrainer(model=jpvg.PVGConfig(sh_degree=0))
    jstate = jtrainer.setup(js, 1.5)
    rng = np.random.RandomState(13)
    jstate = jstate.replace(opt_state=jax.tree.map(
        lambda x: (jnp.asarray(rng.normal(size=x.shape), x.dtype)
                   if getattr(x, "ndim", 0) >= 1 else x), jstate.opt_state))
    state = _pvg_train_port(jstate)
    arrays = _density_arrays(CAP, 3)
    arrays["grad_accum"][80:] = 0.0
    cfg_kw = dict(densify_grad_threshold=2e-4)
    key = jax.random.PRNGKey(2)
    want = jd.densify_and_prune(
        key, JaxState(params=jstate.params, alive=jstate.alive),
        jstate.opt_state,
        jd.DensityControlState(**{k: jnp.asarray(v)
                                  for k, v in arrays.items()}),
        jd.VanillaDensityControllerConfig(**cfg_kw), 1.5, 1.5,
        jnp.asarray(True))
    k1, k2 = jax.random.split(key)
    noise = tuple(to_torch(np.asarray(jax.random.normal(
        k, (CAP, 3), jnp.float32))) for k in (k1, k2))
    got = td.densify_and_prune(
        noise, state.gaussians, state.opt_state,
        td.DensityControlState(**{k: to_torch(v)
                                  for k, v in arrays.items()}),
        td.VanillaDensityControllerConfig(**cfg_kw), 1.5, 1.5, True)
    born = np.asarray(want[0].alive & ~jstate.alive)
    assert born.sum() > 10
    np.testing.assert_array_equal(got[0].alive.numpy(),
                                  np.asarray(want[0].alive))
    wopt = _pvg_train_port(jstate.replace(
        params=want[0].params, alive=want[0].alive, opt_state=want[1]))
    for k in PARAM_FIELDS + PVG_FIELDS:
        np.testing.assert_allclose(getattr(got[0].params, k).numpy(),
                                   np.asarray(getattr(want[0].params, k)),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_array_equal(got[1].exp_avg[k].numpy(),
                                      wopt.opt_state.exp_avg[k].numpy(),
                                      err_msg=k)
    assert float(np.abs(got[0].params.velocities.numpy()[born]).max()) > 0


def test_opacity_reset_zeroes_only_the_opacity_moments():
    """PVG's t_centers and t_scales share the opacities' [CAP, 1] shape;
    the reset zeroes the opacities' moments alone, in both packages."""
    js = _pvg_jax_state(14)
    jstate = JaxTrainer(model=jpvg.PVGConfig(sh_degree=0)).setup(js, 1.5)
    rng = np.random.RandomState(15)
    jstate = jstate.replace(opt_state=jax.tree.map(
        lambda x: (jnp.asarray(rng.normal(size=x.shape), x.dtype)
                   if getattr(x, "ndim", 0) >= 1 else x), jstate.opt_state))
    state = _pvg_train_port(jstate)
    _, jopt = jd.reset_opacities(jstate.gaussians, jstate.opt_state, 0.01)
    _, opt = td.reset_opacities(state.gaussians, state.opt_state, 0.01)
    want = _pvg_train_port(jstate.replace(opt_state=jopt)).opt_state
    for k in PARAM_FIELDS + PVG_FIELDS:
        assert torch.equal(opt.exp_avg[k], want.exp_avg[k]), k
        m = opt.exp_avg[k].abs()
        if k == "opacities":
            assert float(m.max()) == 0.0
        elif m.numel():
            assert float(m.max()) > 0.0, k


def test_pvg_rows_follow_growth_convert_and_checkpoint(tmp_path):
    """A growth pads PVG's three with zeros, with zero moments; the state
    survives the conversion and a checkpoint bit for bit."""
    jtrainer, jstate, trainer, targets = _pvg_trainers()
    state = _pvg_train_port(jstate)
    _, _, state, _ = _pvg_step(jtrainer, jstate, trainer, state, targets, 0)
    grown = trainer.grow_state(state, 2 * CAP)
    for k in PVG_FIELDS:
        x = getattr(grown.params, k)
        assert torch.equal(x[:CAP], getattr(state.params, k))
        assert float(x[CAP:].abs().max()) == 0.0
        assert grown.opt_state.exp_avg[k].shape[0] == 2 * CAP
    back = train_state_from_jax_arrays(**train_state_to_numpy(grown),
                                       device="cpu")
    path = save_checkpoint(str(tmp_path), grown, 5)
    template = trainer.setup(tpvg.PVGConfig(sh_degree=0).init_from_pcd(
        np.zeros((4, 3), np.float32), np.zeros((4, 3), np.float32), 20,
        device="cpu"), 1.5)
    loaded = load_checkpoint(path, template)
    for other in (back, loaded):
        assert other.params.fields() == PARAM_FIELDS + PVG_FIELDS
        for k in other.params.fields():
            assert torch.equal(getattr(other.params, k),
                               getattr(grown.params, k)), k
            assert torch.equal(other.opt_state.exp_avg_sq[k],
                               grown.opt_state.exp_avg_sq[k]), k


def test_a_pvg_ply_is_static(tmp_path):
    """Neither package writes t_centers, t_scales or velocities to a PLY:
    the two files of one PVG state are equal byte for byte, and load as a
    static scene."""
    js = _pvg_jax_state(16)
    ts = _pvg_port_state(js)
    a, b = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    save_state_ply(a, ts)
    jax_save_ply(b, js)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert sorted(load_gaussian_ply(a)) == sorted(PARAM_FIELDS)


# ---- DeformTrainer -----------------------------------------------------------

def _jax_deform(jstate):
    """gsl_tpu's ``extra["__deform__"]`` in the layout
    `train_state_from_jax_arrays(deform=)` takes."""
    net = jstate.extra["__deform__"]
    adam = net.opt_state[0]
    return {"params": _tree(net.params),
            "opt": {"mu": _tree(adam.mu), "nu": _tree(adam.nu),
                    "count": int(adam.count)}}


def _deform_port_of(jstate):
    return train_state_from_jax_arrays(
        **jax_train_state_arrays(jstate.replace(extra=None)), device="cpu",
        deform=_jax_deform(jstate))


def _deform_trainers(field):
    """gsl_tpu's DeformTrainer and the port's at small widths (gsl_tpu
    builds its HexPlane at the defaults: both get the small one here), set
    up on the same cloud at capacity 200, the network's heads made random
    (at init they are zero), and three target views at three times."""
    from test_torch_training import _gt_state, _targets
    gt = _gt_state(1)
    xyz = np.asarray(gt.params.means[:N_GT])
    rgb = np.full((N_GT, 3), 0.5, np.float32)
    kw = dict(field=field, deform_cfg=jdf.DeformModelConfig(
        **SMALL_MLP, max_steps=100))
    jtrainer = JaxDeformTrainer(model=JaxModelConfig(sh_degree=1),
                                renderer=JaxRendererConfig(**JAX_RENDERER),
                                metrics=JaxMetrics(lambda_dssim=0.0), **kw)
    trainer = DeformTrainer(model=VanillaGaussianConfig(sh_degree=1),
                            metrics=VanillaMetricsConfig(lambda_dssim=0.0),
                            field=field, deform_cfg=tdf.DeformModelConfig(
                                **SMALL_MLP, max_steps=100))
    if field == "hexplane":
        jtrainer.deform_net = jhx.HexPlaneDeformation(**SMALL_HEX,
                                                      n_neurons=16)
        trainer.deform_net = thx.HexPlaneDeformation(**SMALL_HEX,
                                                     n_neurons=16)
        heads = ("Dense_2", "Dense_3", "Dense_4")
    else:
        heads = ("Dense_4", "Dense_5", "Dense_6")
    jstate = jtrainer.setup(JaxModelConfig(sh_degree=1).init_from_pcd(
        xyz, rgb, CAP), 1.5)
    net = jstate.extra["__deform__"]
    jstate = jstate.replace(extra={"__deform__": DeformNetState(
        params=_randomise(net.params, 21, 0.02, only=heads),
        opt_state=net.opt_state)})
    trainer.setup(VanillaGaussianConfig(sh_degree=1).init_from_pcd(
        xyz, rgb, CAP, device="cpu"), 1.5)
    return jtrainer, jstate, trainer, _targets(gt, 1)


def _times(view):
    return np.float32(0.15 + 0.35 * view)


@pytest.mark.parametrize("field", ["mlp", "hexplane"])
@pytest.mark.parametrize("warm_up", [True, False])
def test_deform_step_matches_jax(field, warm_up):
    """Two train_step_deform calls from the same state, the view's time
    moved by gsl_tpu's AST draw (the MLP field after the warm-up): the
    loss within 1e-6; the Gaussians' gradients (first moment / 0.1) within
    rtol 5e-3 / atol 1e-4; in the warm-up the network and its Adam as they
    were, after it the network's gradients within rtol 5e-3 / atol 1e-4
    and its weights after the Adam step within 1e-5 where the gradient is
    clear of zero, its count 2 after the second step."""
    jtrainer, jstate, trainer, targets = _deform_trainers(field)
    state = _deform_port_of(jstate)
    first = state.extra["__deform__"]
    for view in (1, 2):
        key = jax.random.PRNGKey(30 + view)
        draw = torch.tensor(np.asarray(jax.random.normal(key, ())))
        t = _times(view)
        jstate, jsc = jtrainer.train_step_deform(
            jstate, _jax_camera(view).replace(time=jnp.asarray(t)),
            jnp.asarray(targets[view].numpy()), H, W, 1, jnp.zeros(3),
            warm_up, key)
        state, sc = trainer.train_step_deform(
            state, dataclasses.replace(_port_camera(view),
                                       time=torch.tensor(t)),
            targets[view], H, W, 1, torch.zeros(3), warm_up,
            ast_draw=draw)
        want = _deform_port_of(jstate)
        if view == 1:
            assert float(sc["loss"]) == pytest.approx(float(jsc["loss"]),
                                                      abs=1e-6)
            alive = state.alive
            for k in PARAM_FIELDS:
                np.testing.assert_allclose(
                    state.opt_state.exp_avg[k][alive].numpy() / 0.1,
                    want.opt_state.exp_avg[k][alive].numpy() / 0.1,
                    rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)
            got_net, want_net = (state.extra["__deform__"],
                                 want.extra["__deform__"])
            if warm_up:
                for k, v in first["params"].items():
                    assert torch.equal(got_net["params"][k], v), k
                assert got_net["opt"]["count"] == 0
                assert want_net["opt"]["count"] == 0
                continue
            mu = {k: v / 0.1 for k, v in got_net["opt"]["exp_avg"].items()}
            jmu = {k: v / 0.1
                   for k, v in want_net["opt"]["exp_avg"].items()}
            _assert_close_tree(mu, jmu, GRAD_RTOL, GRAD_ATOL)
            assert max(float(v.abs().max()) for v in mu.values()) > 1e-3
            for k, v in got_net["params"].items():
                sure = got_net["opt"]["exp_avg"][k].abs() > 1e-6
                np.testing.assert_allclose(
                    v[sure].numpy(), want_net["params"][k][sure].numpy(),
                    rtol=1e-5, atol=NET_ATOL, err_msg=k)
    assert state.extra["__deform__"]["opt"]["count"] == (0 if warm_up
                                                         else 2)
    assert all(bool(torch.isfinite(getattr(state.params, k)).all())
               for k in PARAM_FIELDS)


def test_the_ast_noise_reaches_only_the_mlp_after_the_warm_up():
    """The field's time: the camera's in the warm-up and for HexPlane;
    for the MLP after it, the camera's plus the generator's draw, scaled
    and annealed."""
    for field in ("mlp", "hexplane"):
        trainer = DeformTrainer(field=field, deform_cfg=tdf.DeformModelConfig(
            **SMALL_MLP, max_steps=100))
        state = trainer.setup(VanillaGaussianConfig(sh_degree=0)
                              .init_from_pcd(_xyz(20), np.full(
                                  (20, 3), 0.5, np.float32), 30,
                                  device="cpu"), 1.0)
        state = dataclasses.replace(state, step=40)
        cam = dataclasses.replace(_port_camera(0), time=torch.tensor(0.5))
        assert float(trainer.step_time(state, cam, True)) == 0.5
        gen = torch.Generator().manual_seed(5)
        t = trainer.step_time(state, cam, False, gen)
        if field == "hexplane":
            assert float(t) == 0.5
            continue
        draw = torch.randn((), generator=torch.Generator().manual_seed(5))
        assert float(t) == pytest.approx(0.5 + float(draw) * 0.1 * 0.6,
                                         abs=1e-7)


# ---- pairs gsl_tpu drops, and its side ---------------------------------------

@pytest.mark.parametrize("configs,overrides,pair", [
    (("deformable.yaml", "bilagrid.yaml"), {}, r"with an output processor"),
    (("deformable.yaml", "exposure.yaml"), {}, r"with an output processor"),
    (("deformable.yaml", "normal_reg.yaml"), {}, r"deform \(mlp\) with "
     r"plugins"),
    (("gs4d.yaml", "depth_regularization.yaml"), {},
     r"deform with DepthTrainer"),
    (("gs4d.yaml", "gs2d.yaml"), {}, r"deform with GS2DTrainer"),
    (("deformable.yaml", "appearance_embedding.yaml"), {},
     r"deform with AppearanceTrainer"),
    (("deformable.yaml", "absgrad.yaml"), {}, r"deform \(mlp\) with absgrad"),
    (("gs4d.yaml", "mcmc.yaml"), {}, r"deform \(hexplane\) with the MCMC "
     r"opacity or scale regulariser"),
    (("deformable.yaml", "glossy.yaml"), {}, r"deform with GlossyTrainer"),
    (("deformable.yaml",), {"model": {"density": {
        "class_path": "AccurateVisibilityFilterDensityController"}}},
     r"deform \(mlp\) with the accurate-visibility statistic")])
def test_pairs_gsl_tpu_drops_raise_naming_both(configs, overrides, pair):
    """gsl_tpu's deform step calls train_loss alone, with the plain tap:
    an output processor, plugins' terms, the depth or 2DGS losses,
    appearance, Glossy, MCMC's regularisers and the AbsGS or
    accurate-visibility statistic would be dropped silently. The port
    raises naming both."""
    cfg = cli.load_config([os.path.join(REPO, "gsl_tpu_torch", "configs", c)
                           for c in configs], overrides)
    with pytest.raises(ValueError, match=pair):
        cli.build_components(cfg)


def test_deform_validation_renders_the_canonical_set():
    """Neither DeformTrainer has an eval_step of its own: validation
    renders the Gaussians undeformed, whatever the camera's time and the
    field, as a plain render of them does."""
    assert JaxDeformTrainer.eval_step is JaxTrainer.eval_step
    assert DeformTrainer.eval_step is Trainer.eval_step
    _, jstate, trainer, targets = _deform_trainers("mlp")
    state = _deform_port_of(jstate)
    cam = dataclasses.replace(_port_camera(0), time=torch.tensor(0.9))
    img, _ = trainer.eval_step(state, cam, targets[0], H, W, 1,
                               torch.zeros(3))
    plain = TileRendererConfig().instantiate().forward(
        state.gaussians, cam, H, W, torch.zeros(3), 1).render
    assert torch.equal(img, plain)
    deformed = trainer.renderer.forward(
        trainer.deform(state.extra["__deform__"]["params"], state.gaussians,
                       cam.time), cam, H, W, torch.zeros(3), 1).render
    assert float((deformed - img).abs().max()) > 1e-3


def test_the_row_rule_reaches_the_field_at_small_capacities():
    """gsl_tpu's densify row-copies every leaf of `extra` whose leading
    dimension is the capacity, and hands it the field's state: at capacity
    32 a 4 x 32 network's [32, 32] kernels get rows written over (and its
    Adam moments with them). The port passes ``__deform__`` through by
    name."""
    cap = 32
    js = JaxModelConfig(sh_degree=0).init_from_pcd(
        _xyz(20, 17, 0.3), np.full((20, 3), 0.5, np.float32), cap)
    jtrainer = JaxDeformTrainer(model=JaxModelConfig(sh_degree=0),
                                deform_cfg=jdf.DeformModelConfig(**SMALL_MLP))
    jstate = jtrainer.setup(js, 1.0)
    arrays = _density_arrays(cap, 18)
    arrays["grad_accum"][20:] = 0.0
    key = jax.random.PRNGKey(4)
    jout = jd.densify_and_prune(
        key, JaxState(params=jstate.params, alive=jstate.alive,
                      extra=jstate.extra), jstate.opt_state,
        jd.DensityControlState(**{k: jnp.asarray(v)
                                  for k, v in arrays.items()}),
        jd.VanillaDensityControllerConfig(densify_grad_threshold=2e-4),
        1.0, 1.0, jnp.asarray(False))
    before = state_dict_from_flax(_tree(jstate.extra["__deform__"].params),
                                  "cpu")
    after = state_dict_from_flax(_tree(jout[0].extra["__deform__"].params),
                                 "cpu")
    assert int(np.asarray(jout[0].alive).sum()) > 20
    assert not torch.equal(before["layers.1.weight"],
                           after["layers.1.weight"])     # [32, 32]
    assert torch.equal(before["layers.0.weight"], after["layers.0.weight"])

    state = _deform_port_of(jstate)
    k1, k2 = jax.random.split(key)
    noise = tuple(to_torch(np.asarray(jax.random.normal(
        k, (cap, 3), jnp.float32))) for k in (k1, k2))
    got = td.densify_and_prune(
        noise, state.gaussians, state.opt_state,
        td.DensityControlState(**{k: to_torch(v)
                                  for k, v in arrays.items()}),
        td.VanillaDensityControllerConfig(densify_grad_threshold=2e-4),
        1.0, 1.0, False)
    assert got[0].extra["__deform__"] is state.extra["__deform__"]
    np.testing.assert_array_equal(got[0].alive.numpy(),
                                  np.asarray(jout[0].alive))


@pytest.mark.parametrize("base,anti_aliased", [
    ({"model": {"renderer": {"init_args": {"anti_aliased": False}}}},
     False),
    ({"model": {"renderer": {"anti_aliased": False}}}, True)])
def test_pvg_renderer_merges_with_the_base_renderer_as_gsl_tpu_merges(
        tmp_path, base, anti_aliased):
    """pvg.yaml's ``renderer: {class_path: PVGRenderer}`` over a base
    config's renderer: the config merge keeps the base's ``init_args``
    (so gsl_tpu's preset test need not supply them again), but a base
    that sets the fields flat loses them, since a ``class_path`` spec
    reads ``init_args`` alone. Both packages build the same renderer."""
    from gsl_tpu import cli as jcli
    import yaml
    path = tmp_path / "base.yaml"
    path.write_text(yaml.safe_dump(base))
    configs = [str(path), os.path.join(REPO, "gsl_tpu_torch", "configs",
                                       "pvg.yaml")]
    got = cli.build_components(cli.load_config(configs, {}))[0]
    want = jcli.build_components(jcli.load_config(configs, {}))[0]
    for trainer in (got, want):
        assert type(trainer.renderer_cfg).__name__ == "PVGRendererConfig"
        assert trainer.renderer_cfg.anti_aliased is anti_aliased
