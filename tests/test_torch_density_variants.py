"""gsl_tpu_torch's variant density controllers against gsl_tpu's on the
same seeded numpy inputs and the same normal draws: one densify of each
of the six (static, Revising, no-culling-big-scale, H3DGS, accurate
visibility, background removal), the accurate-visibility statistics, the
background-removal step, Revising's copy rows where gsl_tpu's keep the
old opacity, the hooks `build_hooks` picks for each controller, and the
CLI's refusal to import gsl_tpu through a ``class_path``."""
import dataclasses
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_tpu.models.gaussian import GaussianParams as JaxParams
from gsl_tpu.models.gaussian import GaussianState as JaxState
from gsl_tpu.training import density as jd
from gsl_tpu.training import optimizers as jo
from gsl_tpu.models.gaussian import OptimizationConfig as JaxOptConfig

from gsl_tpu_torch import cli
from gsl_tpu_torch.data.cameras import make_camera, stack_cameras
from gsl_tpu_torch.models.gaussian import OptimizationConfig
from gsl_tpu_torch.training import density as td
from gsl_tpu_torch.training import hooks as th
from gsl_tpu_torch.training.fit import FitConfig
from gsl_tpu_torch.training.optimizers import GaussianAdam
from gsl_tpu_torch.training.trainer import Trainer

from test_torch_training import (_assert_opt_equal, _assert_states_equal,
                                 _density_arrays, _port_opt,
                                 _random_jax_state, _stepped_jax_optimizer,
                                 _to_port)
from torch_port_utils import PARAM_FIELDS, to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 64, 48
VARIANTS = ("Static", "Revising", "NoCullingBigScale", "H3DGS",
            "AccurateVisibilityFilter", "BackgroundRemoval")


def _cfgs(name, **kw):
    cls = f"{name}DensityControllerConfig"
    return getattr(jd, cls)(**kw), getattr(td, cls)(**kw)


def _densify_both(name, cap, n_alive, size_prune, seed, **cfg_kw):
    """One densify of the controller `name` in both packages on the same
    state, statistics and draws: (gsl_tpu's result, the port's, the
    gsl_tpu input state)."""
    jstate = _random_jax_state(cap, n_alive, seed)
    _, opt_state, _, _ = _stepped_jax_optimizer(jstate, 1, seed=20)
    arrays = _density_arrays(cap, seed + 1)
    jcfg, tcfg = _cfgs(name, **cfg_kw)
    key = jax.random.PRNGKey(seed)
    want = jd.densify_and_prune(
        key, jstate, opt_state,
        jd.DensityControlState(**{k: jnp.asarray(v)
                                  for k, v in arrays.items()}),
        jcfg, 10.0, 1.5, jnp.asarray(size_prune))
    k1, k2 = jax.random.split(key)
    noise = tuple(to_torch(np.asarray(
        jax.random.normal(k, (cap, 3), jnp.float32))) for k in (k1, k2))
    got = td.densify_and_prune(
        noise, _to_port(jstate), _port_opt(opt_state),
        td.DensityControlState(**{k: to_torch(v)
                                  for k, v in arrays.items()}),
        tcfg, 10.0, 1.5, size_prune)
    return want, got, jstate


@pytest.mark.parametrize("name", [v for v in VARIANTS if v != "Revising"])
@pytest.mark.parametrize("size_prune", [False, True])
def test_variant_densify_matches_jax(name, size_prune):
    """The same alive mask and slots, n_truncated and zeroed moments;
    parameters to 1e-6 (the rotated split offsets sum three float32
    products in another order, the one reduction that reorders). H3DGS
    selects by its own score (a lower threshold than its default, so the
    small scene has candidates), and with the size prune prunes by world
    scale only; no-culling-big-scale never by world scale."""
    kw = dict(densify_grad_threshold=2e-4, cull_opacity_threshold=0.3)
    if name == "H3DGS":
        kw.update(densify_grad_threshold=0.005, clone_min_opacity=0.3)
    (ws, wo, wd, wt), (gs, go, gd, gt), jstate = _densify_both(
        name, 96, 40, size_prune, 30 + len(name), **kw)
    assert int(gt) == int(wt)
    n_new = int((ws.alive & ~jstate.alive).sum())
    assert n_new > 8 and int((jstate.alive & ~ws.alive).sum()) > 2
    _assert_states_equal(gs, ws)
    _assert_opt_equal(go, wo)
    assert all(float(getattr(gd, k).abs().max()) == 0.0
               for k in ("grad_accum", "denom", "max_radii"))


def test_the_variants_prune_and_select_as_they_should():
    """On one state: with the size prune the vanilla pass prunes more than
    no-culling-big-scale (its world-scale prune), and H3DGS selects other
    rows than the vanilla gradient gate does."""
    kw = dict(densify_grad_threshold=2e-4, cull_opacity_threshold=0.3,
              cull_scale_factor=0.05)
    jstate = _random_jax_state(96, 40, 3)
    state = _to_port(jstate)
    d = td.DensityControlState(**{k: to_torch(v) for k, v in
                                  _density_arrays(96, 4).items()})
    alive = {}
    for name in ("Vanilla", "NoCullingBigScale"):
        cfg = getattr(td, f"{name}DensityControllerConfig")(**kw)
        out = td.densify_and_prune(
            torch.Generator().manual_seed(0), state,
            _port_opt(_stepped_jax_optimizer(jstate, 1)[1]), d, cfg, 10.0,
            1.5, True)[0]
        alive[name] = int(out.alive.sum())
    assert alive["Vanilla"] < alive["NoCullingBigScale"]
    vanilla = td.densify_masks(state, d, td.VanillaDensityControllerConfig(
        densify_grad_threshold=2e-4), 10.0)
    h3dgs = td.densify_masks(state, d, td.H3DGSDensityControllerConfig(
        densify_grad_threshold=0.005, clone_min_opacity=0.3), 10.0)
    assert int((vanilla[0] | vanilla[1]).sum()) > 0
    assert int((h3dgs[0] | h3dgs[1]).sum()) > 0
    assert not torch.equal(vanilla[0] | vanilla[1], h3dgs[0] | h3dgs[1])


def test_revising_densify_matches_jax_but_for_the_copies():
    """Revising in both packages on the same inputs: every row equal to
    1e-6 but the opacity of the clones' copies. The port gives the copy
    the original's alpha_hat = 1 - sqrt(1 - alpha); gsl_tpu's copy keeps
    the old opacity (its original alone gets alpha_hat)."""
    (ws, wo, _, wt), (gs, go, _, gt), jstate = _densify_both(
        "Revising", 96, 40, False, 11, densify_grad_threshold=2e-4,
        cull_opacity_threshold=0.001)
    assert int(gt) == int(wt) == 0
    assert np.array_equal(gs.alive.numpy(), np.asarray(ws.alive))
    born = np.asarray(ws.alive & ~jstate.alive)
    old_op = np.asarray(jstate.params.opacities)
    for k in PARAM_FIELDS:
        got, want = getattr(gs.params, k).numpy(), np.asarray(
            getattr(ws.params, k))
        if k == "opacities":
            got, want = got[~born], want[~born]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    _assert_opt_equal(go, wo)
    # a clone's copy has its original's mean exactly; a split child not
    wm = np.asarray(ws.params.means)
    pairs = [(r, b) for b in np.flatnonzero(born)
             for r in np.flatnonzero(np.asarray(jstate.alive))
             if np.array_equal(wm[r], wm[b])]
    assert len(pairs) > 2
    orig, copy = (np.array(x) for x in zip(*pairs))
    got_op = gs.params.opacities.numpy()[:, 0]
    want_op = np.asarray(ws.params.opacities)[:, 0]
    np.testing.assert_allclose(got_op[orig], want_op[orig], rtol=1e-6)
    assert bool((want_op[orig] != old_op[orig, 0]).all())
    # the port's copy takes the corrected opacity, gsl_tpu's the old one
    np.testing.assert_array_equal(got_op[copy], got_op[orig])
    np.testing.assert_array_equal(want_op[copy], old_op[orig, 0])


def _one_row_state(jax_side):
    """4 slots, one alive row at opacity 0.5 that clones."""
    means = np.zeros((4, 3), np.float32)
    means[0] = [0.1, 0.2, 3.0]
    params = dict(means=means, scales=np.full((4, 3), -5.0, np.float32),
                  rotations=np.tile([1.0, 0, 0, 0], (4, 1)).astype(
                      np.float32),
                  opacities=np.zeros((4, 1), np.float32),
                  shs_dc=np.zeros((4, 1, 3), np.float32),
                  shs_rest=np.zeros((4, 3, 3), np.float32))
    alive = np.array([True, False, False, False])
    d = dict(grad_accum=np.array([1.0, 0, 0, 0], np.float32),
             denom=np.ones(4, np.float32), max_radii=np.zeros(4, np.float32))
    if jax_side:
        return (JaxState(params=JaxParams(**{k: jnp.asarray(v) for k, v in
                                             params.items()}),
                         alive=jnp.asarray(alive)),
                jd.DensityControlState(**{k: jnp.asarray(v)
                                          for k, v in d.items()}))
    return (_to_port(JaxState(params=JaxParams(**params), alive=alive)),
            td.DensityControlState(**{k: to_torch(v) for k, v in d.items()}))


def test_revising_gives_both_copies_alpha_hat_where_gsl_tpu_does_not():
    """One alive row at opacity 0.5 clones: the port's original and copy
    are both at 1 - sqrt(0.5) = 0.2929; gsl_tpu's original is at 0.2929
    and its copy at 0.5000."""
    alpha_hat = 1.0 - np.sqrt(0.5)
    jstate, jd_state = _one_row_state(True)
    jtx = jo.build_gaussian_optimizer(JaxOptConfig(), 1.0)
    want = jd.densify_and_prune(
        jax.random.PRNGKey(0), jstate, jtx.init(jstate.params), jd_state,
        jd.RevisingDensityControllerConfig(), 10.0, 10.0,
        jnp.asarray(False))[0]
    assert list(np.asarray(want.alive)) == [True, True, False, False]
    jop = np.asarray(jax.nn.sigmoid(want.params.opacities[:2, 0]))
    np.testing.assert_allclose(jop, [alpha_hat, 0.5], rtol=1e-5)

    state, d = _one_row_state(False)
    opt = GaussianAdam(OptimizationConfig(), 1.0).init(state.params)
    got = td.densify_and_prune(
        torch.Generator().manual_seed(0), state, opt, d,
        td.RevisingDensityControllerConfig(), 10.0, 10.0, False)[0]
    assert got.alive.tolist() == [True, True, False, False]
    np.testing.assert_allclose(
        torch.sigmoid(got.params.opacities[:2, 0]).numpy(),
        [alpha_hat, alpha_hat], rtol=1e-5)


def test_accurate_visibility_statistics_match_jax():
    """Rows with a screen radius but a zero tap gradient count in the
    vanilla statistics and not in the accurate-visibility ones; both
    packages agree on both."""
    cap = 100
    rng = np.random.RandomState(4)
    arrays = _density_arrays(cap, 4)
    grad = rng.normal(size=(cap, 2)).astype(np.float32) * 1e-4
    grad[rng.uniform(size=cap) < 0.3] = 0.0
    radii = (rng.randint(1, 30, cap) * (rng.uniform(size=cap) < 0.8)
             ).astype(np.int32)
    scale = np.array([0.5 * W, 0.5 * H], np.float32)
    out = {}
    for acc in (False, True):
        want = jd.update_stats(
            jd.DensityControlState(**{k: jnp.asarray(v)
                                      for k, v in arrays.items()}),
            jnp.asarray(grad), jnp.asarray(radii), jnp.asarray(scale),
            accurate_visibility=acc)
        got = td.update_stats(
            td.DensityControlState(**{k: to_torch(v)
                                      for k, v in arrays.items()}),
            to_torch(grad), to_torch(radii), to_torch(scale),
            accurate_visibility=acc)
        for k in arrays:
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       np.asarray(getattr(want, k)),
                                       rtol=1e-6, err_msg=k)
        out[acc] = got.denom - to_torch(arrays["denom"])
    hidden = (radii > 0) & ~np.any(grad != 0, axis=-1)
    assert hidden.sum() > 5
    assert bool((out[False][hidden] == 1).all())
    assert bool((out[True][hidden] == 0).all())


def test_background_removal_step_matches_jax():
    jstate = _random_jax_state(80, 60, 9)
    center, radius = np.array([0.1, -0.2, 4.0], np.float32), 1.2
    want = jd.background_removal_step(jstate, center, radius)
    got = td.background_removal_step(_to_port(jstate), center, radius)
    np.testing.assert_array_equal(got.params.opacities.numpy(),
                                  np.asarray(want.params.opacities))
    outside = (np.linalg.norm(np.asarray(jstate.params.means) - center,
                              axis=-1) > radius) & np.asarray(jstate.alive)
    assert 5 < outside.sum() < 55
    assert bool((got.params.opacities.numpy()[outside] == -15.0).all())


# ---- the hooks -------------------------------------------------------------

class _Train(types.SimpleNamespace):
    def __len__(self):
        return len(self.cameras)


def _outputs(n_views=4):
    """DataParserOutputs-like: train cameras on a circle of radius 2
    around (0, 0, 5), looking along +z."""
    cams = []
    for a in np.linspace(0, 2 * np.pi, n_views, endpoint=False):
        c = np.array([2 * np.cos(a), 0.0, 5 + 2 * np.sin(a)])
        cams.append(make_camera(np.eye(3), -c, 50.0, 50.0, W / 2, H / 2, W,
                                H, device="cpu"))
    return types.SimpleNamespace(train_set=_Train(
        cameras=stack_cameras(cams)))


@pytest.mark.parametrize("class_path,density_hook", [
    ("VanillaDensityController", "DensityHook"),
    ("StaticDensityController", "StaticDensityHook"),
    ("RevisingDensityController", "DensityHook"),
    ("NoCullingBigScaleDC", "DensityHook"),
    ("H3DGSDensityController", "DensityHook"),
    ("AccurateVisibilityFilterDensityController", "DensityHook"),
    ("BackgroundRemoval", "DensityHook"),
    ("MCMCDensityController", "MCMCDensityHook"),
    ("gsl_tpu.training.taming.Taming3DGSDensityControllerConfig",
     "TamingDensityHook"),
    ("GNS", "_GNSDensity")])
def test_build_hooks_dispatch(class_path, density_hook):
    """Each controller of the registry gets its density hook (GNS its
    step hook too); the LightGaussian prune hook follows the density hook
    when the fit has prune steps; gsl_tpu's build_hooks picks the same
    classes but for its GNS adapter's name."""
    spec = {"model": {"density": {"class_path": class_path}}}
    if class_path == "GNS":
        spec["model"]["density"]["init_args"] = {"budget": 1000}
    trainer, _, _ = cli.build_components(spec)
    ctx = th.FitContext(trainer=trainer, outputs=_outputs(), dataset=None,
                        cfg=FitConfig(lg_prune_steps=(10,)),
                        bg=torch.zeros(3))
    step_hook, dhook, pre, post = th.build_hooks(ctx, 100)
    assert type(dhook).__name__ == density_hook
    assert type(step_hook).__name__ == ("GNSHooks" if class_path == "GNS"
                                        else "StepHook")
    assert [type(h).__name__ for h in post] == ["LightGaussianPruneHook"]
    assert pre == [step_hook]
    if class_path == "BackgroundRemoval":
        np.testing.assert_allclose(dhook.br_center, [0, 0, 5], atol=1e-6)
        assert dhook.br_radius == pytest.approx(2.0, rel=1e-6)
    if density_hook == "TamingDensityHook":
        assert dhook.budgets[0] == 100


def test_static_hook_leaves_the_state_unchanged():
    trainer = Trainer(density=td.StaticDensityControllerConfig(
        densify_from_iter=0, densification_interval=1,
        opacity_reset_interval=1))
    state = trainer.setup(_to_port(_random_jax_state(64, 40, 2)), 1.0)
    hook = th.StaticDensityHook(th.FitContext(
        trainer=trainer, outputs=None, dataset=None, cfg=FitConfig(),
        bg=None))
    for step in range(1, 5):
        assert hook(state, torch.Generator(), step) is state
        assert not hook.densifies_at(step)


def test_background_removal_hook_runs_before_the_densify():
    """At a densify step after background_removal_from the rows outside
    the cameras' sphere lose their opacity first, so the densify's prune
    removes them; before it, they stay."""
    trainer = Trainer(density=td.BackgroundRemovalDensityControllerConfig(
        densify_from_iter=1, densification_interval=5,
        background_removal_from=7, foreground_radius_scaling=1.0,
        densify_grad_threshold=1e9))
    jstate = _random_jax_state(64, 64, 5)
    gs = _to_port(jstate)
    means = gs.params.means.clone()
    means[:10] = torch.tensor([0.0, 0.0, 20.0])      # far outside
    gs = dataclasses.replace(gs, params=dataclasses.replace(
        gs.params, means=means))
    state = trainer.setup(gs, 1.0)
    hook = th.DensityHook(th.FitContext(trainer=trainer, outputs=_outputs(),
                                        dataset=None, cfg=FitConfig(),
                                        bg=None))
    g = torch.Generator().manual_seed(0)
    assert bool(hook(state, g, 5).alive[:10].all())
    out = hook(state, g, 10)
    assert not bool(out.alive[:10].any())


# ---- the CLI never imports gsl_tpu ----------------------------------------

def test_a_gsl_tpu_class_path_is_never_imported():
    """In a fresh interpreter: taming.yaml's gsl_tpu path resolves to the
    port's class through the registry, another gsl_tpu path raises
    NotImplementedError naming it, and neither imports gsl_tpu (or jax)."""
    code = (
        "import sys\n"
        "from gsl_tpu_torch import cli\n"
        "c = cli._resolve_class("
        "'gsl_tpu.training.taming.Taming3DGSDensityControllerConfig')\n"
        "assert c.__module__ == 'gsl_tpu_torch.training.taming', c\n"
        "try:\n"
        "    cli._resolve_class('gsl_tpu.training.density."
        "VanillaDensityControllerConfig')\n"
        "    raise SystemExit('resolved')\n"
        "except NotImplementedError as e:\n"
        "    assert 'gsl_tpu.training.density' in str(e), e\n"
        "bad = [m for m in sys.modules if m == 'jax' or m == 'gsl_tpu' "
        "or m.startswith(('gsl_tpu.', 'jax.'))]\n"
        "assert not bad, bad\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert run.returncode == 0, run.stderr
