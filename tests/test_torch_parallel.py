"""gsl_tpu_torch.parallel against gsl_tpu.parallel: the sharded training
step of 4 gloo ranks spawned on the CPU (dp 2 x mp 2) against gsl_tpu's
shard_map step on the conftest's virtual devices, on the inputs of
tests/test_parallel.py (32x32, CAP 512, N 150, SH 0); the compaction, the
exchange's autograd, the rebalance permutation and the densify of the
sharded state."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gsl_tpu.models.gaussian import GaussianState as JGaussianState
from gsl_tpu.models.gaussian import OptimizationConfig as JOptimizationConfig
from gsl_tpu.models.gaussian import VanillaGaussianConfig as JVanillaConfig
from gsl_tpu.ops.rasterize_pallas import (_resolve_capacity,
                                          isect_encode_padded,
                                          rasterize_pallas)
from gsl_tpu.ops.ssim import ssim as jax_ssim
from gsl_tpu.parallel import gaussian_sharded as jgs
from gsl_tpu.training.density import (VanillaDensityControllerConfig as
                                      JDensityCfg)
from gsl_tpu.training.density import densify_and_prune as jdensify
from gsl_tpu.training.density import init_density_state as jinit_density
from gsl_tpu.training.optimizers import build_gaussian_optimizer

from gsl_tpu_torch.parallel import gaussian_sharded as gs
from gsl_tpu_torch.parallel.launch import spawn
from gsl_tpu_torch.training.density import (VanillaDensityControllerConfig,
                                            densify_and_prune)
from gsl_tpu_torch.training.optimizers import B1, B2
from gsl_tpu_torch.training.trainer import Trainer

import torch_parallel_ranks as ranks
from test_parallel import CAP, H, W, _setup
from torch_port_utils import PARAM_FIELDS, jax_opt_arrays

DP, MP = 2, 2
N_DEV = DP * MP
ISECT_CAPACITY = 4096
LOSS_RTOL = 1e-5
# gsl_tpu's own step on its Pallas path (interpret) against its XLA path
# (test_parallel.py::test_mp_pallas_backend_matches_xla): its jitted loss
# over the interpreted kernels moves by ~2e-5 relative, where the same
# kernels' images, and their loss computed op by op, agree with the XLA
# path to ~1e-6
PALLAS_LOSS_RTOL = 1e-4
# ROADMAP's gradient tolerance, its atol taken of each leaf's own scale
# (max |ref|, where below 1): here the leaves but the means have gradients
# far below 1e-4, which an absolute atol would not hold
GRAD_RTOL, GRAD_ATOL = 5e-3, 1e-4
UPDATE_RTOL, UPDATE_ATOL = 2e-3, 5e-6    # tests/test_parallel.py's
needs_devices = pytest.mark.skipif(len(jax.devices()) < N_DEV,
                                   reason="needs 4 virtual devices")


def _assert_grads_close(got, want, what):
    """`got` within GRAD_RTOL and GRAD_ATOL of `want`'s own scale. A leaf
    the loss does not reach (the rotations of isotropic Gaussians; no
    shs_rest at SH 0) is held exactly."""
    assert np.shape(got) == np.shape(want), what
    scale = float(np.abs(want).max()) if np.size(want) else 0.0
    if scale == 0.0:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * min(1.0, scale),
                               err_msg=what)


def _grad_of_moments(mu, nu):
    """The first step's gradient g from its Adam moments, and |g| again
    from the second: mu = (1 - b1) g, nu = (1 - b2) g^2."""
    return mu / (1.0 - B1), np.sqrt(nu / (1.0 - B2))


def _cam_np(cam):
    return {k: np.asarray(getattr(cam, k)) for k in
            ("R", "T", "fx", "fy", "cx", "cy", "width", "height")}


def _state_np(params, alive, opt_state):
    return {"params": {k: np.asarray(getattr(params, k))
                       for k in PARAM_FIELDS},
            "alive": np.asarray(alive), "opt": jax_opt_arrays(opt_state)}


def _permuted(state):
    """50 alive rows moved from shard 0 (rows 0-255) into shard 1, so no
    shard holds more than 100 alive (test_parallel.py:169-177's layout for
    2 shards)."""
    idx = np.concatenate([np.arange(0, 100), np.arange(256, 306),
                          np.arange(150, 256), np.arange(100, 150),
                          np.arange(306, 512)])

    def mv(a):
        return a[idx] if a.ndim >= 1 and a.shape[0] == CAP else a

    params = jax.tree.map(mv, state.params)
    return JGaussianState(params=params, alive=state.alive[idx])


@pytest.fixture(scope="module")
def scene():
    state, cam_batch, cams, gts, bg = _setup()
    cam4 = jax.tree.map(lambda x: x[:N_DEV], cam_batch)
    gts4 = jnp.clip(gts[:N_DEV] + 0.05, 0.0, 1.0)
    tx = build_gaussian_optimizer(JOptimizationConfig(), 1.0)
    return dict(state=state, cam_batch=cam4, cams=cams[:N_DEV], gts=gts4,
                bg=bg, tx=tx,
                cams_np=[_cam_np(c) for c in cams[:N_DEV]],
                gts_np=np.asarray(gts4), bg_np=np.asarray(bg))


def _exact_train_loss(pred_hwc, gt_hwc, mask_hw=None, lambda_dssim=0.2):
    """gsl_tpu's train_loss with its exact SSIM (``fast=False``) in place of
    the bf16-split blurs of its training term: the reference's exact mode,
    which the port's loss computes."""
    if mask_hw is not None:
        pred_hwc = pred_hwc * mask_hw[..., None]
        gt_hwc = gt_hwc * mask_hw[..., None]
    rgb_loss = jnp.mean(jnp.abs(pred_hwc - gt_hwc))
    ssim_val = jax_ssim(pred_hwc.transpose(2, 0, 1),
                        gt_hwc.transpose(2, 0, 1), fast=False)
    loss = (1.0 - lambda_dssim) * rgb_loss + lambda_dssim * (1.0 - ssim_val)
    return loss, {}


def _exact_rasterize_pallas(*args):
    """gsl_tpu's sharded step calls rasterize_pallas with the packed depth
    key and without the tile cull (gaussian_sharded.py:191-197); the exact
    mode sorts by the float32 depth and culls, as the port does."""
    return rasterize_pallas(*args[:12], tile_based_culling=True,
                            fast=args[13], exact_sort=True)


def _jax_step(sc, state, compact_k=None, backend="pallas"):
    """gsl_tpu's step in the exact mode of the port's parity tests."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgs, "train_loss", _exact_train_loss)
        mp.setattr(jgs, "rasterize_pallas", _exact_rasterize_pallas)
        return _jax_step_exact(sc, state, compact_k, backend)


def _jax_step_exact(sc, state, compact_k, backend):
    mesh = jgs.make_mesh(N_DEV, dp=DP, mp=MP)
    tx = sc["tx"]
    opt = tx.init(state.params)
    step = jgs.make_mp_train_step(
        mesh, tx, H, W, sh_degree=0, isect_capacity=ISECT_CAPACITY,
        max_per_tile=256, chunk=32, backend=backend, fast_math=False,
        compact_k=compact_k)
    args = jgs.shard_params(mesh, state.params, state.alive, opt)
    p, o, loss, tap, radii, ovf = step(*args, sc["cam_batch"], sc["gts"],
                                       sc["bg"])
    return {"params": jax.device_get(p), "opt": jax_opt_arrays(
        jax.device_get(o)), "loss": float(loss),
        "tap": np.asarray(jax.device_get(tap)),
        "radii": np.asarray(jax.device_get(radii)), "n_overflow": int(ovf)}


def _port_step(sc, state, compact_k=None):
    opt = sc["tx"].init(state.params)
    return spawn(ranks.sharded_step, N_DEV, "cpu", args=(
        DP, MP, _state_np(state.params, state.alive, opt), sc["cams_np"],
        sc["gts_np"], None, sc["bg_np"], H, W, 0, compact_k))


@pytest.fixture(scope="module")
def steps(scene):
    return {"jax": _jax_step(scene, scene["state"]),
            "jax_xla": _jax_step(scene, scene["state"], backend="xla"),
            "port": _port_step(scene, scene["state"]),
            "scene": scene["state"], "cams": scene["cams"]}


@needs_devices
def test_sharded_step_matches_jax(steps):
    want, got = steps["jax"], steps["port"][0]
    np.testing.assert_allclose(got["loss"], steps["jax_xla"]["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["loss"], want["loss"],
                               rtol=PALLAS_LOSS_RTOL)
    assert got["tap"].shape == (CAP, 2)
    _assert_grads_close(got["tap"], want["tap"], "tap_grad_sum")
    for k in PARAM_FIELDS:
        g, abs_g = _grad_of_moments(got["mu"][k], got["nu"][k])
        want_g, want_abs = _grad_of_moments(want["opt"][k]["mu"],
                                            want["opt"][k]["nu"])
        _assert_grads_close(g, want_g, f"first moment of {k}")
        _assert_grads_close(abs_g, want_abs, f"second moment of {k}")
        np.testing.assert_allclose(
            got["params"][k], np.asarray(getattr(want["params"], k)),
            rtol=UPDATE_RTOL, atol=UPDATE_ATOL, err_msg=f"updated {k}")
    np.testing.assert_array_equal(got["radii"], want["radii"])
    # radii_max is dp row 0's: the max over ITS mp cameras (0 and 1)
    st = steps["scene"]
    dp0 = np.max([np.asarray(jgs._project_and_color(
        st.params, st.alive, c, H, W, 0, True, 0.3)[1])
        for c in steps["cams"][:MP]], axis=0)
    np.testing.assert_array_equal(got["radii"], dp0)
    assert got["n_overflow"] == want["n_overflow"] == 0
    # every rank of the world ends with the same gathered state
    for other in steps["port"][1:]:
        for k in PARAM_FIELDS:
            np.testing.assert_array_equal(other["params"][k],
                                          got["params"][k])
    # gloo on the CPU stages nothing; one exchange forward and backward
    ex = got["exchange"]
    assert (ex["fwd_calls"], ex["bwd_calls"], ex["staged_copies"]) == \
        (1, 1, 0)


@needs_devices
def test_applied_gradient_is_n_dev_times_the_mean_loss_gradient(scene,
                                                                 steps):
    """The first moment is (1 - b1) g: g is the gradient of the SUM of the
    four ranks' losses (gsl_tpu's pmean-then-psum), 4x the port Trainer's
    mean-loss gradient over the same cameras; the reported loss is the
    mean."""
    ts = ranks.train_state(_state_np(scene["state"].params,
                                     scene["state"].alive,
                                     scene["tx"].init(scene["state"].params)))
    trainer = Trainer()
    trainer.setup(ts.gaussians, 1.0)
    bg = torch.from_numpy(scene["bg_np"])
    total, losses = None, []
    for c, g in zip(scene["cams_np"], scene["gts_np"]):
        cam, gt = ranks.port_camera(c), torch.from_numpy(g)

        def loss_of(gstate, tap, abstap, cam=cam, gt=gt):
            return trainer.render_losses(gstate, cam, H, W, bg, 0, gt, None,
                                         tap, abstap, 0)

        pgrads, _, _, loss, _ = trainer.gradients(ts, loss_of)
        losses.append(float(loss.detach()))
        total = pgrads if total is None else total.map(
            lambda k, x: x + getattr(pgrads, k))
    got = steps["port"][0]
    np.testing.assert_allclose(got["loss"], np.mean(losses), rtol=LOSS_RTOL)
    for k in PARAM_FIELDS:
        mean_grad = getattr(total, k).numpy() / N_DEV
        g, abs_g = _grad_of_moments(got["mu"][k], got["nu"][k])
        _assert_grads_close(g, N_DEV * mean_grad,
                            f"{k}: not {N_DEV}x the mean gradient")
        _assert_grads_close(abs_g, N_DEV * np.abs(mean_grad),
                            f"{k}: second moment not of {N_DEV}x the mean "
                            "gradient")
    g = got["mu"]["means"] / (1.0 - B1)
    mean_g = total.means.numpy() / N_DEV
    np.testing.assert_allclose(np.linalg.norm(g) / np.linalg.norm(mean_g),
                               N_DEV, rtol=2.5e-4)


@needs_devices
def test_jax_drops_no_intersection_at_these_sizes(scene):
    """Each camera's whole projection (a superset of any rank's exchanged
    splats) fits gsl_tpu's slot capacity: its step renders all of them."""
    st = scene["state"]
    cap = _resolve_capacity(0, ISECT_CAPACITY)
    for cam in scene["cams"]:
        payload, radii = jgs._project_and_color(
            st.params, st.alive, cam, H, W, 0, True, 0.3)
        from gsl_tpu.ops.projection import Projections
        proj = Projections(means2d=payload[:, 0:2], depths=payload[:, 9],
                           radii=radii, conics=payload[:, 2:5],
                           compensations=jnp.ones(CAP), mask=radii > 0)
        isects = isect_encode_padded(proj, H, W, 16, cap)
        assert int(isects.n_dropped) == 0


@needs_devices
def test_compaction_equals_the_full_exchange(scene):
    state = _permuted(scene["state"])
    full = _port_step(scene, state)[0]
    cmp = _port_step(scene, state, compact_k=100)[0]
    assert full["n_overflow"] == cmp["n_overflow"] == 0
    np.testing.assert_allclose(cmp["loss"], full["loss"], rtol=1e-6)
    np.testing.assert_allclose(cmp["params"]["means"],
                               full["params"]["means"], rtol=1e-5, atol=1e-8)
    np.testing.assert_array_equal(cmp["radii"], full["radii"])


@needs_devices
def test_compaction_overflow_equals_jax(scene):
    want = _jax_step(scene, scene["state"], compact_k=8)["n_overflow"]
    got = _port_step(scene, scene["state"], compact_k=8)
    assert want > 0
    assert [r["n_overflow"] for r in got] == [want] * N_DEV


def test_exchange_gradient_is_the_reverse_all_to_all():
    """Rank r's loss sum(w_r * y_r), y_r[i] = x_i[r]: the gradient that
    reaches x_i through the exchange equals that of the same computation
    in one process with the blocks permuted."""
    mp = 4
    rng = np.random.RandomState(7)
    blocks = rng.normal(size=(mp, mp, 5, 3)).astype(np.float32)
    weights = rng.normal(size=(mp, mp, 5, 3)).astype(np.float32)
    got = spawn(ranks.exchange_grad, mp, "cpu", args=(mp, blocks, weights))
    x = torch.from_numpy(blocks).requires_grad_(True)
    y = x.transpose(0, 1)                 # y[r][i] = x[i][r]
    (y * torch.from_numpy(weights)).sum().backward()
    for r, (y_r, g_r) in enumerate(got):
        np.testing.assert_array_equal(y_r, y[r].detach().numpy())
        np.testing.assert_allclose(g_r, x.grad[r].numpy(), rtol=1e-6)


def test_spawn_names_the_rank_that_failed_first():
    """The other ranks fail after rank 2 and exit before it: the error
    names rank 2 and carries its traceback."""
    with pytest.raises(Exception) as err:
        spawn(ranks.fail_first_on_rank_two, 4, "cpu")
    assert "Process 2 terminated" in str(err.value)
    assert "rank two could not read its image" in str(err.value)


@pytest.mark.parametrize("seed,layout", [
    (0, "skewed"), (1, "skewed"), (2, "random"), (3, "random"),
    (4, "one_shard"), (5, "empty")])
def test_rebalance_permutation_equals_jax(seed, layout):
    cap, n_mp = 256, 4
    rng = np.random.RandomState(seed)
    alive = np.zeros(cap, bool)
    if layout == "skewed":
        alive[:rng.randint(20, 90)] = True
        alive[rng.choice(cap, 10, replace=False)] = True
    elif layout == "random":
        alive = rng.rand(cap) < rng.uniform(0.1, 0.9)
    elif layout == "one_shard":
        alive[128:128 + rng.randint(1, 64)] = True
    want = np.asarray(jgs.rebalance_permutation(jnp.asarray(alive), n_mp))
    got = gs.rebalance_permutation(torch.from_numpy(alive), n_mp).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        gs.shard_alive_counts(torch.from_numpy(alive[got]), n_mp),
        jgs.shard_alive_counts(jnp.asarray(alive[want]), n_mp))
    counts = alive[got].reshape(n_mp, -1).sum(1)
    assert counts.max() - counts.min() <= 1


def test_apply_permutation_carries_rows_and_moments():
    from gsl_tpu_torch.training.density import init_density_state
    from gsl_tpu_torch.models.gaussian import OptimizationConfig
    from gsl_tpu_torch.training.optimizers import GaussianAdam
    from torch_port_utils import small_port_state
    st = small_port_state(n=64)
    rng = np.random.RandomState(2)
    alive = torch.from_numpy(rng.rand(64) < 0.4)
    tx = GaussianAdam(OptimizationConfig(), 1.0)
    opt = tx.init(st.params)
    opt.exp_avg["means"] = torch.from_numpy(
        rng.normal(size=(64, 3)).astype(np.float32))
    dens = init_density_state(64)
    dens.grad_accum = torch.arange(64, dtype=torch.float32)
    perm = gs.rebalance_permutation(alive, 4)
    p2, a2, o2, d2 = gs.apply_permutation(perm, st.params, alive, opt, dens)
    for k in st.params.fields():
        assert torch.equal(getattr(p2, k), getattr(st.params, k)[perm])
    assert torch.equal(a2, alive[perm])
    assert torch.equal(o2.exp_avg["means"], opt.exp_avg["means"][perm])
    assert torch.equal(d2.grad_accum, dens.grad_accum[perm])
    assert o2.count == opt.count
    # the alive rows and their moments travel together
    old = {tuple(r) for r in torch.cat(
        [st.params.means, opt.exp_avg["means"]], 1)[alive].tolist()}
    new = {tuple(r) for r in torch.cat(
        [p2.means, o2.exp_avg["means"]], 1)[a2].tolist()}
    assert old == new


@pytest.mark.parametrize("n_dev,n_mp,k", [(8, 4, 512), (4, 2, 100),
                                          (1, 1, 4096), (6, 3, 1536)])
def test_exchange_bytes_equal_jax(n_dev, n_mp, k):
    assert gs.exchange_bytes_per_step(n_dev, n_mp, k) == \
        jgs.exchange_bytes_per_step(n_dev, n_mp, k)


@needs_devices
def test_sharded_densify_matches_single_process_and_jax():
    """tests/test_parallel.py:97-147's state: the densify of the state
    gathered from 4 ranks equals the single-process densify with the same
    draws on every rank, and its alive count gsl_tpu's sharded densify."""
    rng = np.random.RandomState(0)
    xyz = rng.normal(size=(100, 3)).astype(np.float32) + [0, 0, 4]
    rgb = rng.uniform(0, 1, (100, 3)).astype(np.float32)
    jstate = JVanillaConfig(sh_degree=1).init_from_pcd(xyz, rgb,
                                                       capacity=256)
    p = jstate.params.replace(
        scales=jstate.params.scales.at[0].set(jnp.log(0.001))
        .at[1].set(jnp.log(0.5)))
    jstate = JGaussianState(params=p, alive=jstate.alive)
    tx = build_gaussian_optimizer(JOptimizationConfig(), 1.0)
    opt = tx.init(jstate.params)
    grad_accum = np.zeros(256, np.float32)
    grad_accum[:2] = 1.0
    denom = np.ones(256, np.float32)

    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = jgs.make_mesh(N_DEV, dp=DP, mp=MP)
    shard = NamedSharding(mesh, P("mp"))

    def put(x):
        if isinstance(x, jnp.ndarray) and x.ndim >= 1 and x.shape[0] == 256:
            return jax.device_put(x, shard)
        return x

    dstate = jinit_density(256).replace(grad_accum=jnp.asarray(grad_accum),
                                        denom=jnp.asarray(denom))
    fn = jax.jit(lambda k, st, o, d: jdensify(
        k, st, o, d, JDensityCfg(), 1.0, 100.0, jnp.asarray(False)))
    jout, _, _, _ = fn(jax.random.PRNGKey(0), jax.tree.map(put, jstate),
                       jax.tree.map(put, opt), jax.tree.map(put, dstate))

    state_np = _state_np(jstate.params, jstate.alive, opt)
    got = spawn(ranks.sharded_densify, N_DEV, "cpu",
                args=(DP, MP, state_np, grad_accum, denom, 11))
    ts = ranks.train_state(state_np)
    dens = type(ts.density)(grad_accum=torch.from_numpy(grad_accum),
                            denom=torch.from_numpy(denom),
                            max_radii=torch.zeros(256))
    want, _, _, _ = densify_and_prune(
        torch.Generator().manual_seed(11), ts.gaussians, ts.opt_state, dens,
        VanillaDensityControllerConfig(), 1.0, 100.0, False)
    for r in got:
        np.testing.assert_array_equal(r["alive"], want.alive.numpy())
        np.testing.assert_array_equal(r["means"], want.params.means.numpy())
        np.testing.assert_array_equal(r["scales"],
                                      want.params.scales.numpy())
    assert int(got[0]["alive"].sum()) == int(np.asarray(jout.alive).sum())
    assert int(got[0]["alive"].sum()) > 100
