"""gsl_tpu_torch's 2DGS (surfel) path against gsl_tpu's on the same numpy
inputs: projection, rasterizer forward and gradients, renderer, trainer
step and the 2-column densify.

On the CPU the port's kernel wrappers run their plain versions
(surfel_expand_plain, rasterize_surfels_fwd_plain,
rasterize_surfels_bwd_plain, reduce_grads_plain). The reference is run
twice: through its XLA oracle (`rasterize_surfels` on `isect_encode`'s
lists, with `max_per_tile` above the longest list, since the port never
cuts a list) and through the Pallas kernels in interpret mode. The Pallas
key keeps 32 - tile_bits depth bits where the port's keeps all 32, so two
surfels of one tile whose depths share those top bits could be ordered
differently; the scenes here are the ones on which gsl_tpu's own tests
hold Pallas to the oracle, so no such tie decides a pixel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_tpu.data.cameras import make_camera as jax_make_camera
from gsl_tpu.models.gaussian import GaussianState as JaxState
from gsl_tpu.models.gaussian_2d import Gaussian2DConfig as JaxModel2D
from gsl_tpu.ops.projection import Projections as JaxProjections
from gsl_tpu.ops.rasterize_pallas import isect_encode_padded
from gsl_tpu.ops.surfel import project_surfels as jax_project_surfels
from gsl_tpu.ops.surfel import rasterize_surfels as jax_rasterize_surfels
from gsl_tpu.ops.surfel_pallas import rasterize_surfels_pallas
from gsl_tpu.ops.tiling import isect_encode as jax_isect_encode
from gsl_tpu.renderers import surfel_renderer as jsr
from gsl_tpu.training import density as jd
from gsl_tpu.training.gs2d import GS2DMetricsConfig as JaxGS2DMetrics
from gsl_tpu.training.gs2d import GS2DTrainer as JaxGS2DTrainer

from gsl_tpu_torch.data.cameras import make_camera
from gsl_tpu_torch.models.gaussian import grow_capacity
from gsl_tpu_torch.models.gaussian_2d import Gaussian2DConfig
from gsl_tpu_torch.ops import surfel_rasterize as SR
from gsl_tpu_torch.ops.surfel import SurfelProjections, project_surfels
from gsl_tpu_torch.renderers.surfel_renderer import (SurfelRendererConfig,
                                                     depth_to_normal)
from gsl_tpu_torch.training import density as td
from gsl_tpu_torch.training import optimizers as to
from gsl_tpu_torch.training.gs2d import GS2DMetricsConfig, GS2DTrainer
from gsl_tpu_torch.utils.convert import train_state_from_jax_arrays
from gsl_tpu_torch.viewer.renderer import ViewerRenderer

import test_torch_training as tt
from torch_port_utils import PARAM_FIELDS, jax_train_state_arrays, to_torch

H = W = 48
TS = 16
FOCAL = 60.0
NAMES = ("Tu", "Tv", "Tw", "zcoef", "opacities", "channels")


def _scene(n, seed):
    """The scene of gsl_tpu's tests/test_surfel_pallas.py, as numpy."""
    rng = np.random.RandomState(seed)
    means = (rng.randn(n, 3) * 0.7).astype(np.float32)
    scales = (rng.rand(n, 2) * 0.3 + 0.05).astype(np.float32)
    quats = rng.randn(n, 4).astype(np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 4.0
    op = (rng.rand(n) * 0.7 + 0.2).astype(np.float32)
    ch = rng.rand(n, 6).astype(np.float32)
    return means, scales, quats, w2c, op, ch


def _project_both(means, scales, quats, w2c):
    pj = jax_project_surfels(
        jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats),
        jnp.asarray(w2c), FOCAL, FOCAL, W / 2, H / 2, W, H)
    pt = project_surfels(
        to_torch(means), to_torch(scales), to_torch(quats), to_torch(w2c),
        FOCAL, FOCAL, W / 2, H / 2, W, H)
    return pj, pt


def _shim(proj):
    r2 = jnp.maximum(proj.radii.astype(jnp.float32), 1.0) ** 2
    iso = 9.0 / r2
    return JaxProjections(
        means2d=proj.means2d, depths=proj.depths, radii=proj.radii,
        conics=jnp.stack([iso, jnp.zeros_like(iso), iso], axis=-1),
        compensations=jnp.ones_like(iso), mask=proj.mask)


def _jax_raster(backend, proj, op, ch):
    """-> (channels, alpha, exp_depth, median_depth, distortion)."""
    if backend == "xla":
        isects = jax_isect_encode(_shim(proj), H, W, TS, 8192)
        return tuple(jax_rasterize_surfels(
            proj, op, ch, isects, H, W, tile_size=TS, max_per_tile=512,
            chunk=64))
    isects = isect_encode_padded(_shim(proj), H, W, TS, capacity=8192)
    return rasterize_surfels_pallas(
        proj.Tu, proj.Tv, proj.Tw, proj.zcoef, op, ch, isects, H, W, TS,
        128, True, 8192)


@pytest.mark.parametrize("seed,n", [(0, 60), (5, 40), (9, 80)])
def test_project_surfels_matches_jax(seed, n):
    means, scales, quats, w2c, _, _ = _scene(n, seed)
    means[0, 2] = -3.9     # 0.1 in front of the camera: nearer than 0.2
    means[1, 0] = 40.0     # far off screen
    pj, pt = _project_both(means, scales, quats, w2c)
    assert np.array_equal(pt.mask.numpy(), np.asarray(pj.mask))
    assert not bool(pt.mask[0]) and not bool(pt.mask[1])
    assert int(pt.mask.sum()) > n // 2
    assert np.array_equal(pt.radii.numpy(), np.asarray(pj.radii))
    for k in SurfelProjections._fields[:7]:
        want = np.asarray(getattr(pj, k))
        np.testing.assert_allclose(getattr(pt, k).numpy(), want, rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_tile_lists_match_jax():
    """The same (tile, depth) lists as the reference's isect_encode: counts
    per tile and surfel ids in order."""
    means, scales, quats, w2c, _, _ = _scene(60, 0)
    pj, pt = _project_both(means, scales, quats, w2c)
    isects_j = jax_isect_encode(_shim(pj), H, W, TS, 8192)
    isects = SR.surfel_isect_encode(pt.means2d, pt.depths, pt.radii, H, W,
                                    TS)
    keys, gids = SR.surfel_expand(isects, pt.depths, W // TS, H // TS)
    sorted_keys, gids_sorted, _ = SR.sort_slots(keys, gids)
    bounds = SR.tile_bounds(sorted_keys, (W // TS) * (H // TS))
    assert isects.n_isects == int(isects_j.n_isects) > 60
    counts = (bounds[1:] - bounds[:-1]).numpy()
    assert np.array_equal(counts, np.asarray(isects_j.tile_counts))
    n_valid = int(bounds[-1])
    assert np.array_equal(gids_sorted[:n_valid].numpy(),
                          np.asarray(isects_j.gaussian_ids)[:n_valid])
    # a surfel culled by projection keeps one dummy slot with the invalid
    # key, sorted behind every real one
    assert isects.total == isects.n_isects + int((pt.radii == 0).sum())
    assert bool((sorted_keys[n_valid:]
                 == torch.iinfo(torch.int64).max).all())


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_rasterize_surfels_forward_matches_jax(backend):
    """The tolerances gsl_tpu holds its Pallas kernel to against its
    oracle (tests/test_surfel_pallas.py)."""
    means, scales, quats, w2c, op, ch = _scene(60, 0)
    pj, pt = _project_both(means, scales, quats, w2c)
    want = _jax_raster(backend, pj, jnp.asarray(op), jnp.asarray(ch))
    with torch.no_grad():
        got, aux = SR.rasterize_surfels(pt, to_torch(op), to_torch(ch), H,
                                        W, TS)
    tol = dict(channels=(1e-4, 2e-5), alpha=(1e-4, 2e-5),
               exp_depth=(1e-4, 1e-4), median_depth=(1e-4, 1e-4),
               distortion=(2e-4, 2e-5))
    for k, w in zip(got._fields, want):
        rtol, atol = tol[k]
        assert float(np.abs(np.asarray(w)).max()) > 0.0, k
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(w),
                                   rtol=rtol, atol=atol, err_msg=k)
    assert aux.n_isects > 60 and aux.i_stop.shape == (H, W)


def _cotangents(n_channels=6):
    rng = np.random.RandomState(1)
    return (rng.rand(H, W, n_channels).astype(np.float32),
            rng.rand(H, W).astype(np.float32),
            (rng.rand(H, W) * 0.1).astype(np.float32),
            (rng.rand(H, W) * 0.1).astype(np.float32))


def _port_grads(pt, op, ch, cots):
    leaves = [getattr(pt, k).clone().requires_grad_(True)
              for k in NAMES[:4]]
    leaves += [to_torch(op).requires_grad_(True),
               to_torch(ch).requires_grad_(True)]
    proj = pt._replace(Tu=leaves[0], Tv=leaves[1], Tw=leaves[2],
                       zcoef=leaves[3])
    res, _ = SR.rasterize_surfels(proj, leaves[4], leaves[5], H, W, TS)
    w_img, w_a, w_d, w_dist = (to_torch(c) for c in cots)
    loss = ((res.channels * w_img).sum() + (res.alpha * w_a).sum()
            + (res.exp_depth * w_d).sum() + (res.distortion * w_dist).sum())
    return res, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_rasterize_surfels_gradients_match_jax(backend):
    """All six inputs, with random cotangents on the channels, alpha, the
    depth and the distortion; each gradient normalised by its largest
    entry and held to 3e-3, as gsl_tpu holds its hand-derived backward to
    autodiff through the oracle."""
    means, scales, quats, w2c, op, ch = _scene(40, 5)
    pj, pt = _project_both(means, scales, quats, w2c)
    cots = _cotangents()
    w_img, w_a, w_d, w_dist = (jnp.asarray(c) for c in cots)

    def loss(Tu, Tv, Tw, zc, o, c):
        p = pj._replace(Tu=Tu, Tv=Tv, Tw=Tw, zcoef=zc)
        img, alpha, expd, _, dist = _jax_raster(backend, p, o, c)
        return (jnp.sum(img * w_img) + jnp.sum(alpha * w_a)
                + jnp.sum(expd * w_d) + jnp.sum(dist * w_dist))

    want = jax.grad(loss, argnums=tuple(range(6)))(
        pj.Tu, pj.Tv, pj.Tw, pj.zcoef, jnp.asarray(op), jnp.asarray(ch))
    _, got = _port_grads(pt, op, ch, cots)
    for name, w, g in zip(NAMES, want, got):
        w = np.asarray(w)
        denom = np.abs(w).max() + 1e-6
        assert denom > 1e-2, name
        np.testing.assert_allclose(g.numpy() / denom, w / denom, atol=3e-3,
                                   err_msg=f"gradient mismatch for {name}")


def test_median_depth_carries_no_gradient():
    means, scales, quats, w2c, op, ch = _scene(40, 5)
    _, pt = _project_both(means, scales, quats, w2c)
    leaf = to_torch(op).requires_grad_(True)
    res, _ = SR.rasterize_surfels(pt, leaf, to_torch(ch), H, W, TS)
    assert float(res.median_depth.max()) > 1.0
    assert not res.median_depth.requires_grad
    assert res.exp_depth.requires_grad and res.distortion.requires_grad


def test_channel_count_is_not_capped():
    """C = 9 (the reference asserts C <= 6): the first six channels and
    the geometry gradients are those of a C = 6 pass whose cotangents they
    share."""
    means, scales, quats, w2c, op, ch = _scene(40, 5)
    _, pt = _project_both(means, scales, quats, w2c)
    extra = np.random.RandomState(2).rand(40, 3).astype(np.float32)
    cots6 = _cotangents(6)
    cots9 = (np.concatenate([cots6[0], np.zeros((H, W, 3), np.float32)],
                            -1),) + cots6[1:]
    res6, g6 = _port_grads(pt, op, ch, cots6)
    res9, g9 = _port_grads(pt, op, np.concatenate([ch, extra], 1), cots9)
    assert res9.channels.shape == (H, W, 9)
    assert torch.equal(res9.channels[..., :6], res6.channels)
    assert float(res9.channels[..., 6:].abs().max()) > 0.1
    for a, b in zip(g6[:5], g9[:5]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
    assert float(g9[5][:, 6:].abs().max()) == 0.0


def test_edge_on_surfel_gives_finite_gradients():
    """A surfel seen exactly edge-on (its normal perpendicular to the view
    axis, |sz| ~ 0 along its line) among ordinary ones: only the low-pass
    branch keeps it alive there, with the center depth, and every gradient
    stays finite."""
    means, scales, quats, w2c, op, ch = _scene(40, 5)
    means[0] = [0.0, 0.0, 0.0]
    scales[0] = [0.4, 0.4]
    th = np.pi / 2                        # rotate 90 degrees about y
    quats[0] = [np.cos(th / 2), 0.0, np.sin(th / 2), 0.0]
    op[0] = 0.9
    _, pt = _project_both(means, scales, quats, w2c)
    assert bool(pt.mask[0])
    res, grads = _port_grads(pt, op, ch, _cotangents())
    for k in res._fields:
        assert bool(torch.isfinite(getattr(res, k)).all()), k
    for name, g in zip(NAMES, grads):
        assert bool(torch.isfinite(g).all()), name
    assert float(grads[4][0].abs()) > 0.0     # it was composited somewhere


def test_empty_scene_renders_nothing():
    means, scales, quats, w2c, op, ch = _scene(8, 2)
    _, pt = _project_both(means, scales, quats, w2c)
    pt = pt._replace(radii=torch.zeros_like(pt.radii),
                     mask=torch.zeros_like(pt.mask))
    res, aux = SR.rasterize_surfels(pt, to_torch(op), to_torch(ch), H, W, TS)
    assert aux.n_isects == 0 and aux.n_slots == 8
    assert float(res.channels.abs().max()) == 0.0
    assert float(res.alpha.abs().max()) == 0.0
    assert bool((aux.i_stop == SR.NEVER_STOPPED).all())


# ---- model, renderer, trainer -----------------------------------------

SH_DEGREE = 1
N_PTS, CAPACITY = 80, 128


def _init_both(sh_degree=SH_DEGREE):
    rng = np.random.RandomState(3)
    xyz = rng.rand(N_PTS, 3).astype(np.float32) * 2 - 1
    rgb = rng.rand(N_PTS, 3).astype(np.float32)
    jstate = JaxModel2D(sh_degree=sh_degree).init_from_pcd(xyz, rgb,
                                                           CAPACITY)
    state = Gaussian2DConfig(sh_degree=sh_degree).init_from_pcd(
        xyz, rgb, CAPACITY, device="cpu")
    return jstate, state


def _cameras(width=W, height=H):
    kw = dict(R=np.eye(3), T=np.array([0., 0., 3.]), fx=50., fy=50.,
              cx=width / 2, cy=height / 2, width=width, height=height)
    return jax_make_camera(**kw), make_camera(device="cpu", **kw)


def test_gaussian_2d_model_matches_jax():
    """2-column scales, the reference's seeded random rotations, and the
    state surgery on such a state: capacity growth and the Adam moments."""
    jstate, state = _init_both()
    assert state.params.scales.shape == (CAPACITY, 2)
    tt._assert_states_equal(state, jstate, rtol=1e-4)
    assert float(state.params.rotations[:N_PTS].min()) >= 0.0
    assert torch.equal(state.params.rotations[N_PTS:, 0],
                       torch.ones(CAPACITY - N_PTS))
    grown = grow_capacity(state, 200)
    assert grown.params.scales.shape == (200, 2)
    assert float(grown.params.scales[CAPACITY:].max()) == -10.0
    tx = to.GaussianAdam(Gaussian2DConfig().optimization, 1.0)
    opt = tx.init(state.params)
    grads = state.params.map(lambda _, x: torch.ones_like(x))
    updates, opt = tx.update(grads, opt)
    assert updates.scales.shape == (CAPACITY, 2)
    assert to.grow_opt_state(opt, 200).exp_avg["scales"].shape == (200, 2)


@pytest.mark.parametrize("depth_ratio,w,h", [(0.0, W, H), (1.0, W, H),
                                             (0.5, 52, 40)])
def test_surfel_renderer_matches_jax(depth_ratio, w, h):
    """Every output against the reference's XLA backend at rtol 1e-3 /
    atol 1e-4, the tolerance gsl_tpu holds its own Pallas backend to.
    52x40 leaves the last row and column of tiles partly outside."""
    jstate, state = _init_both()
    jcam, cam = _cameras(w, h)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    want = jsr.SurfelRendererConfig(
        backend="xla", depth_ratio=depth_ratio, max_per_tile=512,
        min_isect_capacity=8192).instantiate().forward(
        jstate, jcam, h, w, jnp.asarray(bg), SH_DEGREE)
    renderer = SurfelRendererConfig(depth_ratio=depth_ratio).instantiate()
    with torch.no_grad():
        got = renderer.forward(state, cam, h, w, to_torch(bg), SH_DEGREE)
    for k in ("render", "alpha", "rend_normal", "view_normal", "rend_dist",
              "surf_depth", "surf_normal"):
        w = np.asarray(getattr(want, k))
        assert float(np.abs(w).max()) > 0.0, k
        np.testing.assert_allclose(getattr(got, k).numpy(), w, rtol=1e-3,
                                   atol=1e-4, err_msg=k)
    assert np.array_equal(got.radii.numpy(), np.asarray(want.radii))
    assert got.n_dropped == 0 and int(want.n_dropped) == 0
    assert set(renderer.get_available_outputs()) == set(
        jsr.SurfelRendererConfig().instantiate().get_available_outputs())


def test_viewer_renderer_drives_every_surfel_output():
    _, state = _init_both()
    renderer = SurfelRendererConfig().instantiate()
    vr = ViewerRenderer(state, renderer, SH_DEGREE)
    c2w = np.eye(4)
    c2w[2, 3] = -3.0
    seen = {}
    for name in renderer.get_available_outputs():
        vr.output_type = name
        img = vr.get_outputs(c2w, W, H, fov_y=50.0)
        assert img.shape == (H, W, 3) and img.dtype == np.uint8, name
        assert int(img.max()) > 0, name
        seen[name] = img
    assert len(seen) == 7
    assert not np.array_equal(seen["rend_normal"], seen["surf_normal"])


@pytest.mark.parametrize("base", [0.0, 3.0])
def test_depth_to_normal_gradient_is_finite_on_flat_depth(base):
    """cross(dx, dy) is 0 where the depth is empty (0) and the normalize
    must keep a finite gradient there."""
    jcam, cam = _cameras()
    depth = torch.full((H, W), base, requires_grad=True)
    normal = depth_to_normal(cam, depth)
    (normal ** 2).sum().backward()
    assert bool(torch.isfinite(depth.grad).all())
    want = jsr.depth_to_normal(jcam, jnp.full((H, W), base, jnp.float32))
    np.testing.assert_allclose(normal.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    assert float(normal[0].abs().max()) == 0.0      # border rows stay zero


def _trainers(density_kw=None):
    metrics_kw = dict(lambda_dist=100.0, normal_from_iter=-1,
                      dist_from_iter=-1)
    density_kw = density_kw or {}
    jtrainer = JaxGS2DTrainer(
        model=JaxModel2D(sh_degree=SH_DEGREE),
        density=jd.VanillaDensityControllerConfig(**density_kw),
        metrics=JaxGS2DMetrics(**metrics_kw))
    jtrainer.renderer_cfg = jsr.SurfelRendererConfig(
        backend="xla", max_per_tile=512, chunk=64, min_isect_capacity=8192)
    jtrainer.renderer = jtrainer.renderer_cfg.instantiate()
    trainer = GS2DTrainer(
        model=Gaussian2DConfig(sh_degree=SH_DEGREE),
        density=td.VanillaDensityControllerConfig(**density_kw),
        metrics=GS2DMetricsConfig(**metrics_kw))
    return jtrainer, trainer


def test_gs2d_train_step_matches_jax():
    """One step from the same state with the normal-consistency and the
    distortion loss on (from_iter = -1 turns them on at step 0; the
    distortion weight is large enough to show in the gradients). The loss
    within 3e-3 (gsl_tpu's training loss uses its bf16-split SSIM), the two
    extra terms within 1e-4 relative, and the parameters after the step on
    every row whose gradient is well above the rasterizer's gradient
    tolerance: there Adam's first step is -lr sign(g) on both sides."""
    jstate0, _ = _init_both()
    jtrainer, trainer = _trainers()
    jstate = jtrainer.setup(jstate0, 1.0)
    trainer.setup(tt._to_port(jstate.gaussians), 1.0)
    state = train_state_from_jax_arrays(**jax_train_state_arrays(jstate),
                                        device="cpu")
    jcam, cam = _cameras()
    gt = np.random.RandomState(4).rand(H, W, 3).astype(np.float32)
    jnew, jsc = jtrainer.train_step(jstate, jcam, jnp.asarray(gt), H, W,
                                    SH_DEGREE, jnp.zeros(3))
    new, sc = trainer.train_step(state, cam, to_torch(gt), H, W, SH_DEGREE,
                                 torch.zeros(3))
    assert set(sc) == set(jsc)
    np.testing.assert_allclose(float(sc["loss"]), float(jsc["loss"]),
                               atol=3e-3)
    for k in ("normal_loss", "dist_loss"):
        assert float(jsc[k]) > 1e-4, k
        np.testing.assert_allclose(float(sc[k]), float(jsc[k]), rtol=1e-3,
                                   err_msg=k)
    assert new.step == 1 and new.params.scales.shape == (CAPACITY, 2)
    for k in PARAM_FIELDS:
        g = new.opt_state.exp_avg[k].numpy() / 0.1      # = the gradient
        sure = np.abs(g) > 1e-5
        assert sure.sum() > 20, k
        np.testing.assert_allclose(
            getattr(new.params, k).numpy()[sure],
            np.asarray(getattr(jnew.params, k))[sure], rtol=1e-5, atol=1e-6,
            err_msg=k)
        assert bool(torch.isfinite(getattr(new.params, k)).all()), k
    np.testing.assert_array_equal(new.density.denom.numpy(),
                                  np.asarray(jnew.density.denom))
    np.testing.assert_allclose(new.density.grad_accum.numpy(),
                               np.asarray(jnew.density.grad_accum),
                               rtol=2e-2, atol=1e-7)


def test_gs2d_losses_start_at_their_iterations():
    """With the reference's defaults (normal loss from step 7000, no
    distortion weight) a first step has neither term."""
    _, state0 = _init_both()
    trainer = GS2DTrainer(model=Gaussian2DConfig(sh_degree=SH_DEGREE))
    state = trainer.setup(state0, 1.0)
    _, cam = _cameras()
    _, sc = trainer.train_step(state, cam, torch.zeros(H, W, 3), H, W,
                               SH_DEGREE, torch.zeros(3))
    assert float(sc["normal_loss"]) == 0.0 and float(sc["dist_loss"]) == 0.0
    state.step = 7001
    _, sc = trainer.train_step(state, cam, torch.zeros(H, W, 3), H, W,
                               SH_DEGREE, torch.zeros(3))
    assert float(sc["normal_loss"]) > 0.0 and float(sc["dist_loss"]) == 0.0


def test_absgrad_with_the_surfel_renderer_takes_the_plain_tap():
    """The surfel rasterizer has no AbsGS statistic. gsl_tpu's trainer
    falls back to the plain means2d tap when its renderer cannot produce
    one; so does the port: the statistics equal those without absgrad."""
    _, state0 = _init_both()
    _, cam = _cameras()
    gt = to_torch(np.random.RandomState(4).rand(H, W, 3).astype(np.float32))
    stats = []
    for absgrad in (False, True):
        trainer = GS2DTrainer(
            model=Gaussian2DConfig(sh_degree=SH_DEGREE),
            density=td.VanillaDensityControllerConfig(absgrad=absgrad))
        assert not trainer.renderer.supports_absgrad()
        new, _ = trainer.train_step(trainer.setup(state0, 1.0), cam, gt, H,
                                    W, SH_DEGREE, torch.zeros(3))
        stats.append(new.density.grad_accum)
    assert float(stats[0].max()) > 0.0
    assert torch.equal(stats[0], stats[1])


@pytest.mark.parametrize("cap,n_alive", [(96, 40), (64, 56)])
def test_densify_with_two_column_scales_matches_jax(cap, n_alive):
    """The split offsets lie in the surfel's tangent plane: [CAP, 2] noise
    through the first two rotation columns, the same draws on both sides
    (jax.random.normal of the split key). Identical alive mask, slots and
    n_truncated; parameters to 1e-6; moments zeroed in the same rows."""
    jstate = tt._random_jax_state(cap, n_alive, cap)
    jstate = JaxState(
        params=jstate.params.replace(scales=jstate.params.scales[:, :2]),
        alive=jstate.alive)
    _, opt_state, _, _ = tt._stepped_jax_optimizer(jstate, 1, seed=20)
    arrays = tt._density_arrays(cap, 5)
    cfg_kw = dict(densify_grad_threshold=2e-4, cull_opacity_threshold=0.3)
    key = jax.random.PRNGKey(7)
    want_state, want_opt, _, want_trunc = jd.densify_and_prune(
        key, jstate, opt_state,
        jd.DensityControlState(**{k: jnp.asarray(v)
                                  for k, v in arrays.items()}),
        jd.VanillaDensityControllerConfig(**cfg_kw), 10.0, 1.5,
        jnp.asarray(False))
    noise = tuple(to_torch(np.asarray(
        jax.random.normal(k, (cap, 2), jnp.float32)))
        for k in jax.random.split(key))
    got_state, got_opt, _, got_trunc = td.densify_and_prune(
        noise, tt._to_port(jstate), tt._port_opt(opt_state),
        td.DensityControlState(**{k: to_torch(v)
                                  for k, v in arrays.items()}),
        td.VanillaDensityControllerConfig(**cfg_kw), 10.0, 1.5, False)
    assert int(got_trunc) == int(want_trunc)
    assert (int(got_trunc) > 0) == (cap == 64)
    assert got_state.params.scales.shape == (cap, 2)
    split = ((np.asarray(want_state.params.scales)
              != np.asarray(jstate.params.scales)).any(-1)
             & np.asarray(jstate.alive))
    assert split.sum() > 3
    tt._assert_states_equal(got_state, want_state)
    tt._assert_opt_equal(got_opt, want_opt)
    # a generator draws [CAP, 2] too
    drawn = td.densify_and_prune(
        torch.Generator().manual_seed(0), tt._to_port(jstate),
        tt._port_opt(opt_state),
        td.DensityControlState(**{k: to_torch(v)
                                  for k, v in arrays.items()}),
        td.VanillaDensityControllerConfig(**cfg_kw), 10.0, 1.5, False)[0]
    assert np.array_equal(drawn.alive.numpy(), np.asarray(want_state.alive))


def test_gs2d_training_lowers_the_loss_and_densifies():
    """Sixteen steps toward a black target with both extra losses on, then
    a densify that splits: the rgb loss falls, every parameter stays
    finite (the normal-consistency term once produced NaN parameters under
    a finite loss in gsl_tpu), the scales keep two columns."""
    rng = np.random.RandomState(3)
    xyz = np.concatenate([rng.uniform(-0.8, 0.8, (100, 2)),
                          rng.uniform(2.5, 5, (100, 1))], 1
                         ).astype(np.float32)
    rgb = rng.uniform(0, 1, (100, 3)).astype(np.float32)
    trainer = GS2DTrainer(
        model=Gaussian2DConfig(sh_degree=0),
        density=td.VanillaDensityControllerConfig(
            densify_grad_threshold=1e-7, percent_dense=1e-4),
        metrics=GS2DMetricsConfig(lambda_dist=100.0, normal_from_iter=0,
                                  dist_from_iter=0))
    state = trainer.setup(
        trainer.model.init_from_pcd(xyz, rgb, 256, device="cpu"), 1.0)
    cam = make_camera(R=np.eye(3), T=np.zeros(3), fx=70.0, fy=70.0,
                      cx=32.0, cy=24.0, width=64, height=48, device="cpu")
    gt, bg = torch.zeros(48, 64, 3), torch.zeros(3)
    rgb_diff = []
    for _ in range(16):
        state, sc = trainer.train_step(state, cam, gt, 48, 64, 0, bg)
        assert bool(torch.isfinite(sc["loss"]))
        rgb_diff.append(float(sc["rgb_diff"]))
    assert rgb_diff[0] > 1e-4 and rgb_diff[-1] < rgb_diff[0]
    assert float(sc["dist_loss"]) > 0.0 and float(sc["normal_loss"]) > 0.0
    n_before = state.gaussians.n_alive
    state, trunc = trainer.density_step(
        state, torch.Generator().manual_seed(0), False)
    assert int(trunc) == 0 and state.gaussians.n_alive > n_before
    assert state.params.scales.shape == (256, 2)
    state, _ = trainer.train_step(state, cam, gt, 48, 64, 0, bg)
    for k in PARAM_FIELDS:
        assert bool(torch.isfinite(getattr(state.params, k)).all()), k
