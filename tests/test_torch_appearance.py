"""gsl_tpu_torch's appearance slice against gsl_tpu's on the same seeded
numpy inputs, with the flax weights carried across: the renderer's
`rgbs_override` / `opacity_offset`, the encodings (a hashed level among
them), the appearance network and its initialisation, the appearance
train step in its warm-up, after it and with the opacity head, the
network's learning rate across the warm-up, the densify of the feature
rows, and the similarity regulariser with its step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_tpu.models import encodings as je
from gsl_tpu.models.appearance import \
    AppearanceFeatureGaussianConfig as JaxAppearanceModel
from gsl_tpu.models.appearance import AppearanceNetwork as JaxNetwork
from gsl_tpu.models.appearance import network_lr_schedule as jax_lr
from gsl_tpu.models.gaussian import GaussianState as JaxState
from gsl_tpu.ops.knn import knn_indices as jax_knn_indices
from gsl_tpu.renderers.tile_renderer import \
    TileRendererConfig as JaxRendererConfig
from gsl_tpu.training import density as jd
from gsl_tpu.training import similarity_reg as jsr
from gsl_tpu.training.appearance_trainer import \
    AppearanceOptimizationConfig as JaxAppearanceOpt
from gsl_tpu.training.appearance_trainer import \
    AppearanceTrainer as JaxAppearanceTrainer
from gsl_tpu.training.metrics import VanillaMetricsConfig as JaxMetrics

from gsl_tpu_torch.models import encodings as te
from gsl_tpu_torch.models.appearance import (AppearanceFeatureGaussianConfig,
                                             AppearanceNetwork,
                                             network_lr_schedule)
from gsl_tpu_torch.models.gaussian import GaussianState
from gsl_tpu_torch.ops.knn import knn_indices
from gsl_tpu_torch.renderers.tile_renderer import TileRendererConfig
from gsl_tpu_torch.training import density as td
from gsl_tpu_torch.training import similarity_reg as tsr
from gsl_tpu_torch.training.appearance_trainer import (
    AppearanceOptimizationConfig, AppearanceTrainer)
from gsl_tpu_torch.training.metrics import VanillaMetricsConfig
from gsl_tpu_torch.utils.convert import (state_dict_from_flax,
                                         state_from_jax_arrays)

from test_torch_training import (CAPACITY, N_GT, H, W, _gt_state,
                                 _jax_camera, _port_camera, _targets)
from torch_port_utils import PARAM_FIELDS, to_torch

GRAD_RTOL, GRAD_ATOL = 5e-3, 1e-4
JAX_RENDERER = dict(backend="xla", max_per_tile=256, chunk=32,
                    min_isect_capacity=4096)
ALL_FIELDS = PARAM_FIELDS + ("appearance_features",)
N_APPEARANCES, APPEARANCE_ID = 4, 2


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _module(cls, flax_params, *args, **kwargs):
    """The port's module built with `args`, carrying gsl_tpu's weights."""
    m = cls(*args, **kwargs)
    m.load_state_dict(state_dict_from_flax(_numpy_tree(flax_params),
                                           "cpu"))
    return m


# ---- the renderer's seams ------------------------------------------------

@pytest.mark.parametrize("anti_aliased", [True, False])
def test_rgbs_override_and_opacity_offset_match_jax(anti_aliased):
    """A random scene rendered with given colours and opacity offsets (some
    pushing an opacity past 1, and dead rows with offsets): the image
    within 1e-4, and the gradients of a weighted sum of it in every
    parameter, the colours and the offsets within rtol 5e-3 / atol
    1e-4."""
    gt = _gt_state(1)
    rng = np.random.RandomState(5)
    rgbs = rng.uniform(0, 1, (CAPACITY, 3)).astype(np.float32)
    offset = rng.uniform(-0.3, 0.6, CAPACITY).astype(np.float32)
    weights = rng.normal(size=(H, W, 3)).astype(np.float32)
    jr = JaxRendererConfig(anti_aliased=anti_aliased,
                           **JAX_RENDERER).instantiate()
    cam = _jax_camera(1)

    def jloss(params, c, o):
        out = jr.forward(JaxState(params=params, alive=gt.alive), cam, H, W,
                         jnp.zeros(3), 1, rgbs_override=c, opacity_offset=o)
        return jnp.sum(out.render * weights), out.render

    (_, jimg), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        gt.params, jnp.asarray(rgbs), jnp.asarray(offset))

    state = state_from_jax_arrays(
        {k: np.asarray(getattr(gt.params, k)) for k in PARAM_FIELDS},
        np.asarray(gt.alive), "cpu")
    leaves = state.params.map(lambda _, x: x.detach().requires_grad_(True))
    c, o = to_torch(rgbs).requires_grad_(True), \
        to_torch(offset).requires_grad_(True)
    out = TileRendererConfig(anti_aliased=anti_aliased).instantiate(
    ).forward(GaussianState(params=leaves, alive=state.alive),
              _port_camera(1), H, W, torch.zeros(3), 1, rgbs_override=c,
              opacity_offset=o)
    grads = torch.autograd.grad(
        torch.sum(out.render * to_torch(weights)),
        [getattr(leaves, k) for k in PARAM_FIELDS] + [c, o],
        allow_unused=True)
    np.testing.assert_allclose(out.render.detach().numpy(),
                               np.asarray(jimg), atol=1e-4)
    want = [np.asarray(getattr(jgrads[0], k)) for k in PARAM_FIELDS] \
        + [np.asarray(jgrads[1]), np.asarray(jgrads[2])]
    for name, g, w in zip(PARAM_FIELDS + ("rgbs", "offset"), grads, want):
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    assert np.abs(want[-1]).max() > 1e-3      # the offsets are in play
    # an opacity pushed past 1 is held at 1
    assert float((torch.sigmoid(state.params.opacities[:, 0])
                  + o.detach())[state.alive].max()) > 1.0


# ---- encodings and the network -------------------------------------------

def _uv(n, d=2, seed=0):
    # a few points outside [0, 1] test the clamps
    return np.random.RandomState(seed).uniform(-0.05, 1.05, (n, d)).astype(
        np.float32)


ENCODINGS = {
    # name: (flax module, its input [N, d], port module builder, call args)
    "dense_grid": (
        je.DenseGrid2DEncoding(n_levels=3, base_resolution=8,
                               n_instances=3),
        2, lambda: te.DenseGrid2DEncoding(n_levels=3, base_resolution=8,
                                          n_instances=3), (2,)),
    # the visibility network's hash grid: level 0 (17^3 rows) is dense,
    # levels 1-3 (80, 406, 2048) are hashed into 2^19 rows
    "hash_grid_3d": (
        je.HashGridEncoding(n_input_dims=3, n_levels=4),
        3, lambda: te.HashGridEncoding(n_input_dims=3, n_levels=4), ()),
    # two dimensions into a small table: levels of 16 and 45 are dense,
    # 128 is hashed into 2^12 rows
    "hash_grid_2d_small_table": (
        je.HashGridEncoding(n_input_dims=2, n_levels=3,
                            log2_hashmap_size=12, max_resolution=128),
        2, lambda: te.HashGridEncoding(n_input_dims=2, n_levels=3,
                                       log2_hashmap_size=12,
                                       max_resolution=128), ()),
    "skip_mlp": (
        je.SkipMLP(n_output_dims=2, n_layers=4, skips=[1]), 5,
        lambda: te.SkipMLP(5, 2, n_layers=4, skips=[1]), ()),
}


@pytest.mark.parametrize("name", sorted(ENCODINGS))
def test_encodings_match_jax(name):
    """flax's initialised weights carried into the port's module: outputs
    within 1e-5 on points in and a little outside [0, 1]."""
    flax_mod, d, build, args = ENCODINGS[name]
    x = _uv(600, d, seed=len(name))
    if name == "skip_mlp":
        x = x * 4.0 - 2.0
    jargs = tuple(jnp.asarray(a, jnp.int32) for a in args)
    params = flax_mod.init(jax.random.PRNGKey(3), jnp.asarray(x), *jargs)
    # tables and grids start at 1e-4: spread them, so the lookups differ
    params = jax.tree.map(lambda p: p * 1e3 if p.ndim >= 2 and name
                          != "skip_mlp" else p, params)
    want = np.asarray(flax_mod.apply(params, jnp.asarray(x), *jargs))
    got = _module(lambda: build(), params)(
        to_torch(x), *[torch.tensor(a) for a in args])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    if name.startswith("hash"):
        m = build()
        dense = [(r + 1) ** d <= s for r, s in zip(m.resolutions, m.sizes)]
        assert dense[0] and not dense[-1], (m.resolutions, m.sizes)


def test_hash_of_large_coordinates_wraps_as_jax():
    """The hashed corner rows at resolution 2048 in 3D, where the int32
    products wrap and XOR to negative values: the same rows, as the
    lookup of a one-hot table column shows."""
    x = _uv(2000, 3, seed=9)
    table = np.zeros((1 << 19, 1), np.float32)
    table[np.random.RandomState(1).choice(1 << 19, 3000), 0] = 1.0
    want = np.asarray(je.hash_grid_lookup(jnp.asarray(table), jnp.asarray(x),
                                          2048, 1 << 19))
    got = te.hash_grid_lookup(to_torch(table), to_torch(x), 2048, 1 << 19)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert want.max() > 0.5


NETWORKS = {
    "default": {},
    "opacity_view_dependent_skip": dict(with_opacity=True,
                                        is_view_dependent=True,
                                        skip_layers=[1]),
}


@pytest.mark.parametrize("case", sorted(NETWORKS))
def test_appearance_network_matches_jax(case):
    kw = NETWORKS[case]
    rng = np.random.RandomState(7)
    feats = rng.normal(size=(300, 16)).astype(np.float32)
    dirs = rng.normal(size=(300, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    jnet = JaxNetwork(n_appearances=5, **kw)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                       jnp.asarray(3, jnp.int32), jnp.asarray(dirs))
    want = np.asarray(jnet.apply(params, jnp.asarray(feats),
                                 jnp.asarray(3, jnp.int32),
                                 jnp.asarray(dirs)))
    net = _module(lambda: AppearanceNetwork(5, 16, **kw), params)
    got = net(to_torch(feats), torch.tensor(3, dtype=torch.int32),
              to_torch(dirs))
    assert got.shape == want.shape == (300, 4 if kw else 3)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_initialisation_follows_flax():
    """The port's own initial weights are drawn as flax draws them (not
    torch's defaults): per tensor, the spread within 10% of flax's, zero
    biases, and tables in [0, 1e-4). A seed fixes them."""
    jnet = JaxNetwork(n_appearances=512, n_neurons=256)
    params = _numpy_tree(jnet.init(jax.random.PRNGKey(0),
                                   jnp.zeros((4, 64)),
                                   jnp.zeros((), jnp.int32),
                                   jnp.zeros((4, 3))))
    want = state_dict_from_flax(params, "cpu")
    net = AppearanceNetwork(512, 64, n_neurons=256,
                            generator=torch.Generator().manual_seed(0))
    got = dict(net.named_parameters())
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k].detach()
        assert g.shape == w.shape, k
        if k.endswith("bias"):
            assert float(g.abs().max()) == 0.0 == float(w.abs().max()), k
            continue
        assert float(g.std()) == pytest.approx(float(w.std()), rel=0.1), k
        assert float(g.abs().max()) <= 2.0 * float(w.std()) / 0.8796 * 1.01 \
            or k == "embedding.weight", k
    again = AppearanceNetwork(512, 64, n_neurons=256,
                              generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(net.parameters(),
                                                 again.parameters()))
    enc = te.HashGridEncoding(n_levels=2,
                              generator=torch.Generator().manual_seed(1))
    t = enc.table_1.detach()
    assert 0.0 <= float(t.min()) and float(t.max()) < 1e-4


# ---- the train step --------------------------------------------------------

def _trainers(warm_up, with_opacity, max_steps=30_000, lambda_dssim=0.2):
    """gsl_tpu's and the port's AppearanceTrainer set up from the same
    Gaussians (features N(0, 0.02)), the port carrying gsl_tpu's network
    weights."""
    gt = _gt_state(1)
    xyz = np.asarray(gt.params.means[:N_GT])
    rgb = np.full((N_GT, 3), 0.5, np.float32)
    opt = dict(warm_up=warm_up, max_steps=max_steps)
    model = dict(sh_degree=1, appearance_feature_init="normal",
                 appearance_feature_dims=16)
    jtrainer = JaxAppearanceTrainer(
        model=JaxAppearanceModel(**model),
        renderer=JaxRendererConfig(**JAX_RENDERER),
        metrics=JaxMetrics(lambda_dssim=lambda_dssim),
        n_appearances=N_APPEARANCES, with_opacity=with_opacity,
        appearance_opt=JaxAppearanceOpt(**opt))
    jstate = jtrainer.setup(JaxAppearanceModel(**model).init_from_pcd(
        xyz, rgb, CAPACITY), 1.5)
    trainer = AppearanceTrainer(
        model=AppearanceFeatureGaussianConfig(**model),
        metrics=VanillaMetricsConfig(lambda_dssim=lambda_dssim),
        n_appearances=N_APPEARANCES, with_opacity=with_opacity,
        appearance_opt=AppearanceOptimizationConfig(**opt))
    state = trainer.setup(state_from_jax_arrays(
        {k: np.asarray(getattr(jstate.params, k)) for k in ALL_FIELDS},
        np.asarray(jstate.alive), "cpu"), 1.5)
    assert torch.equal(state.params.appearance_features,
                       to_torch(jstate.params.appearance_features))
    net = state.extra["__net__"]
    net["params"] = state_dict_from_flax(
        _numpy_tree(jstate.extra["__net__"].params), "cpu")
    net["opt"] = trainer.net_tx.init(net["params"])
    return jtrainer, jstate, trainer, state, _targets(gt, 1)


def _jax_moment(jstate, k):
    """gsl_tpu's first Adam moment of property k."""
    inner = jstate.opt_state.inner_states[k].inner_state[0]
    return np.asarray(getattr(inner.mu, k))


def _step_both(jtrainer, jstate, trainer, state, targets, view, warm_up,
               loss_atol=3e-3):
    jcam = _jax_camera(view).replace(
        appearance_id=jnp.asarray(APPEARANCE_ID, jnp.int32))
    pcam = dataclasses.replace(_port_camera(view),
                               appearance_id=torch.tensor(
                                   APPEARANCE_ID, dtype=torch.int32))
    jnew, jsc = jtrainer.train_step_appearance(
        jstate, jcam, jnp.asarray(targets[view].numpy()), H, W, 1,
        jnp.zeros(3), warm_up)
    new, sc = trainer.train_step_appearance(state, pcam, targets[view], H,
                                            W, 1, torch.zeros(3), warm_up)
    # with SSIM, gsl_tpu's loss takes its bf16-split SSIM
    assert float(sc["loss"]) == pytest.approx(float(jsc["loss"]),
                                              abs=loss_atol)
    return jnew, new


STEP_CASES = {"warm_up": (True, False), "after_warm_up": (False, False),
              "opacity_head": (False, True)}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_appearance_matches_jax(case):
    """One step from the same state, the loss L1 alone: gsl_tpu's train
    loss takes a bf16-split SSIM (ROADMAP §3), whose gradient moves some
    colour gradients by ~10% (the loss with SSIM is held within 3e-3 in
    test_network_lr_follows_its_own_update_count, and the port's exact
    SSIM in test_torch_training.py). The loss within 1e-6, every
    property's gradient (its first Adam moment / 0.1) within rtol 5e-3 /
    atol 1e-4 and its value after the step where that gradient is clear
    of the tolerance (Adam's first step is -lr sign(g) there); the
    network unchanged in the warm-up, and after it its gradients and its
    stepped weights likewise."""
    warm_up, with_opacity = STEP_CASES[case]
    jtrainer, jstate, trainer, state, targets = _trainers(
        0 if not warm_up else 100, with_opacity, lambda_dssim=0.0)
    net0 = {k: v.clone() for k, v in state.extra["__net__"]["params"].items()}
    jnew, new = _step_both(jtrainer, jstate, trainer, state, targets, 1,
                           warm_up, loss_atol=1e-6)
    for k in ALL_FIELDS:
        g = new.opt_state.exp_avg[k].numpy() / 0.1
        jg = _jax_moment(jnew, k) / 0.1
        np.testing.assert_allclose(g, jg, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)
        sure = np.abs(g) > 1e-5
        np.testing.assert_allclose(
            getattr(new.params, k).numpy()[sure],
            np.asarray(getattr(jnew.params, k))[sure], rtol=1e-5, atol=1e-6,
            err_msg=k)
    feats_moved = int((np.abs(new.opt_state.exp_avg[
        "appearance_features"].numpy()) > 0).any(-1).sum())
    net = new.extra["__net__"]
    jnet = state_dict_from_flax(_numpy_tree(jnew.extra["__net__"].params),
                                "cpu")
    if warm_up:
        assert feats_moved == 0 and net["opt"]["count"] == 0
        assert all(torch.equal(net["params"][k], net0[k]) for k in net0)
        assert all(torch.equal(jnet[k], net0[k]) for k in net0)
        return
    assert feats_moved > 50 and net["opt"]["count"] == 1
    jmu = state_dict_from_flax(_numpy_tree(_net_moments(jnew)), "cpu")
    for k in net0:
        g = net["opt"]["exp_avg"][k].numpy() / 0.1
        np.testing.assert_allclose(g, jmu[k].numpy() / 0.1, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
        sure = np.abs(g) > 1e-4
        np.testing.assert_allclose(net["params"][k].numpy()[sure],
                                   jnet[k].numpy()[sure], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    # the step moved the embedding of the view's appearance id only
    emb = net["params"]["embedding.weight"] - net0["embedding.weight"]
    assert float(emb[APPEARANCE_ID].abs().max()) > 1e-4
    others = [i for i in range(N_APPEARANCES) if i != APPEARANCE_ID]
    assert float(emb[others].abs().max()) == 0.0


def _net_moments(jstate):
    """gsl_tpu's network first moments as one flax tree: the embedding's
    from its Adam, the layers' from theirs (multi_transform masks the
    other group's leaves)."""
    import optax
    st = jstate.extra["__net__"].opt_state.inner_states
    return jax.tree.map(
        lambda a, b: b if isinstance(a, optax.MaskedNode) else a,
        st["embedding"].inner_state[0].mu, st["network"].inner_state[0].mu,
        is_leaf=lambda x: isinstance(x, optax.MaskedNode))


def test_network_lr_follows_its_own_update_count():
    """warm_up 2, max_steps 4: four steps through gsl_tpu and the port
    (two in the warm-up); both networks have taken 2 updates, and the
    rate of each group, read at that count, is the reference schedule's:
    lr_init until `warm_up` updates after the first, then decayed."""
    jtrainer, jstate, trainer, state, targets = _trainers(2, False,
                                                          max_steps=4)
    for step in range(4):
        warm_up = step < 2
        jstate, state = _step_both(jtrainer, jstate, trainer, state,
                                   targets, step % 3, warm_up)
    st = jstate.extra["__net__"].opt_state.inner_states
    for group in ("embedding", "network"):
        assert int(st[group].inner_state[0].count) == 2, group
    assert state.extra["__net__"]["opt"]["count"] == 2
    for name, init in (("embedding.weight", 2e-3),
                       ("layers.0.weight", 1e-3)):
        jsched = jax_lr(init, 0.1, 4, 2)
        got = [trainer.net_tx.lr(name, n) for n in range(6)]
        want = [float(jsched(n)) for n in range(6)]
        np.testing.assert_allclose(got, want, rtol=1e-7)
        assert got[:3] == [pytest.approx(init)] * 3 and got[3] < init
        assert got == [network_lr_schedule(init, 0.1, 4, 2)(n)
                       for n in range(6)]


# ---- density control and the similarity regulariser ----------------------

def test_densify_copies_the_feature_rows_as_jax():
    """A clone / split / prune pass on a state with appearance features:
    the same alive rows and parameters as gsl_tpu's, every new row's
    features its source's; the features' Adam moments zeroed in the new,
    split and pruned rows and kept elsewhere."""
    jtrainer, jstate, trainer, state, _ = _trainers(0, False)
    rng = np.random.RandomState(2)
    grads = rng.uniform(0, 4e-4, CAPACITY).astype(np.float32)
    denom = np.where(np.asarray(jstate.alive), 2.0, 0.0).astype(np.float32)
    radii = rng.uniform(0, 30, CAPACITY).astype(np.float32)
    jd_state = jd.DensityControlState(
        grad_accum=jnp.asarray(grads * denom), denom=jnp.asarray(denom),
        max_radii=jnp.asarray(radii))
    cfg = dict(densify_grad_threshold=2e-4, percent_dense=0.05)
    key = jax.random.PRNGKey(4)
    jg, _, _, jtrunc = jd.densify_and_prune(
        key, jstate.gaussians, jstate.opt_state, jd_state,
        jd.VanillaDensityControllerConfig(**cfg), 1.5, 1.5,
        jnp.asarray(False))
    noise = tuple(to_torch(np.asarray(jax.random.normal(
        k, (CAPACITY, 3), jnp.float32))) for k in jax.random.split(key))
    moments = {k: torch.randn(v.shape, generator=torch.Generator()
                              .manual_seed(3)) for k, v in
               state.opt_state.exp_avg.items()}
    opt = dataclasses.replace(state.opt_state, exp_avg=moments)
    g, opt2, _, trunc = td.densify_and_prune(
        noise, state.gaussians, opt, td.DensityControlState(
            grad_accum=to_torch(grads * denom), denom=to_torch(denom),
            max_radii=to_torch(radii)),
        td.VanillaDensityControllerConfig(**cfg), 1.5, 1.5, False)
    assert int(trunc) == int(jtrunc) == 0
    assert np.array_equal(g.alive.numpy(), np.asarray(jg.alive))
    born = g.alive & ~state.alive
    assert int(born.sum()) > 10
    for k in ALL_FIELDS:
        np.testing.assert_allclose(getattr(g.params, k).numpy(),
                                   np.asarray(getattr(jg.params, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    f = g.params.appearance_features
    sources = {tuple(r) for r in state.params.appearance_features[
        state.alive].numpy()}
    assert all(tuple(r) in sources for r in f[born].numpy())
    mu = opt2.exp_avg["appearance_features"]
    assert float(mu[born].abs().max()) == 0.0
    kept = g.alive & state.alive & ~((mu == 0).all(-1))
    assert torch.equal(mu[kept], moments["appearance_features"][kept])


def test_knn_indices_match_jax():
    pts = np.random.RandomState(3).normal(size=(700, 3)).astype(np.float32)
    q = pts[::7]
    jidx, jd2 = jax_knn_indices(jnp.asarray(q), jnp.asarray(pts), 8)
    idx, d2 = knn_indices(to_torch(q), to_torch(pts), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), atol=1e-5)


def _full_states():
    """gsl_tpu's and the port's states with every row a distinct alive
    point. (gsl_tpu samples dead rows too, and moves them 1e6 + i away;
    between two of them the distance's float32 expansion cancels, so a
    dead query's neighbours and weights follow the rounding of the matrix
    product, on both sides. Those terms touch dead rows only.)"""
    xyz = np.random.RandomState(8).uniform(-1, 1, (CAPACITY, 3)).astype(
        np.float32)
    model = dict(sh_degree=1, appearance_feature_init="normal",
                 appearance_feature_dims=16)
    jtrainer = JaxAppearanceTrainer(model=JaxAppearanceModel(**model),
                                    n_appearances=N_APPEARANCES)
    jstate = jtrainer.setup(JaxAppearanceModel(**model).init_from_pcd(
        xyz, np.full_like(xyz, 0.5), CAPACITY), 1.5)
    trainer = AppearanceTrainer(
        model=AppearanceFeatureGaussianConfig(**model),
        n_appearances=N_APPEARANCES)
    state = trainer.setup(state_from_jax_arrays(
        {k: np.asarray(getattr(jstate.params, k)) for k in ALL_FIELDS},
        np.asarray(jstate.alive), "cpu"), 1.5)
    assert bool(state.alive.all())
    return jtrainer, jstate, trainer, state


@pytest.mark.parametrize("kind", ["cosine", "euclidean"])
def test_similarity_loss_and_step_match_jax(kind):
    """gsl_tpu's sample (jax.random.choice of its key) handed to the port:
    the loss within rtol 1e-4 (a float32 sum of 64 x 15 terms, taken in
    another order); one regulariser step moves the appearance
    features as gsl_tpu's (-lr sign(g) where g is clear of zero), leaves
    every other property and moment as it was, and advances only the
    features' Adam count."""
    jtrainer, jstate, trainer, state = _full_states()
    cfg = dict(n_appearance_samples=64, n_appearance_nn=6,
               distance_weight_decay=2.0, similarity_type=kind)
    jcfg, cfg_t = jsr.SimilarityRegConfig(**cfg), tsr.SimilarityRegConfig(
        **cfg)
    key = jax.random.PRNGKey(11)
    sample = to_torch(np.asarray(jax.random.choice(
        key, CAPACITY, (64,), replace=False)), np.int64)
    jloss = jsr.similarity_loss(jcfg, jstate.params.means,
                                jstate.params.appearance_features,
                                jstate.alive, key)
    loss = tsr.similarity_loss(cfg_t, state.params.means,
                               state.params.appearance_features,
                               state.alive, sample)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    assert float(loss) != 0.0

    jnew, _ = jsr.make_similarity_reg_step(jcfg, jtrainer.tx)(jstate, key)
    new, loss2 = tsr.similarity_reg_step(cfg_t, trainer.tx, state, sample)
    assert float(loss2) == float(loss)
    g = new.opt_state.exp_avg["appearance_features"].numpy() / 0.1
    assert (np.abs(g) > 1e-7).sum() > 100
    np.testing.assert_allclose(g, _jax_moment(jnew, "appearance_features")
                               / 0.1, rtol=1e-4, atol=1e-9)
    sure = np.abs(g) > 1e-7
    np.testing.assert_allclose(
        new.params.appearance_features.numpy()[sure],
        np.asarray(jnew.params.appearance_features)[sure], rtol=1e-5,
        atol=1e-7)
    for k in PARAM_FIELDS:
        assert torch.equal(getattr(new.params, k), getattr(state.params, k))
        assert torch.equal(new.opt_state.exp_avg[k],
                           state.opt_state.exp_avg[k])
    assert new.opt_state.count == 0
    assert new.opt_state.count_of("appearance_features") == 1
    counts = {k: int(s.inner_state[0].count) for k, s in
              jnew.opt_state.inner_states.items()}
    assert counts["appearance_features"] == 1 and counts["means"] == 0
