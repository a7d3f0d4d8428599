"""gsl_tpu_torch's visibility-map appearance training against gsl_tpu's on
the same seeded numpy inputs, with the flax weights carried across: the
dense and hash visibility networks, one train step of each, the networks
sized from the data, and the row rule: a densify and a growth at a
capacity equal to the hash tables' rows leave every network tensor and
its Adam state as it was."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_tpu.models.appearance import \
    AppearanceFeatureGaussianConfig as JaxAppearanceModel
from gsl_tpu.models.gaussian import GaussianState as JaxState
from gsl_tpu.models.gaussian import grow_capacity as jax_grow_capacity
from gsl_tpu.renderers.tile_renderer import \
    TileRendererConfig as JaxRendererConfig
from gsl_tpu.training.appearance_trainer import \
    AppearanceOptimizationConfig as JaxAppearanceOpt
from gsl_tpu.training.metrics import VanillaMetricsConfig as JaxMetrics
from gsl_tpu.training.visibility_map_trainer import \
    VisibilityMapAppearanceTrainer as JaxVisibilityTrainer
from gsl_tpu.training.visibility_map_trainer import \
    VisibilityNetwork as JaxVisibilityNetwork

from gsl_tpu_torch.models.appearance import AppearanceFeatureGaussianConfig
from gsl_tpu_torch.training import density as td
from gsl_tpu_torch.training.appearance_trainer import \
    AppearanceOptimizationConfig
from gsl_tpu_torch.training.metrics import VanillaMetricsConfig
from gsl_tpu_torch.training.visibility_map_trainer import (
    VisibilityMapAppearanceTrainer, VisibilityNetwork, pixel_uv)
from gsl_tpu_torch.utils.convert import (state_dict_from_flax,
                                         state_from_jax_arrays)

from test_torch_training import (CAPACITY, N_GT, H, W, _gt_state,
                                 _jax_camera, _port_camera, _targets)
from torch_port_utils import PARAM_FIELDS, to_torch

GRAD_RTOL, GRAD_ATOL = 5e-3, 1e-4
JAX_RENDERER = dict(backend="xla", max_per_tile=256, chunk=32,
                    min_isect_capacity=4096)
ALL_FIELDS = PARAM_FIELDS + ("appearance_features",)
N_IMAGES, IMAGE_ID = 4, 3


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("grid_type", ["dense", "hash"])
def test_visibility_network_matches_jax(grid_type):
    """flax's weights (the grids and tables spread from 1e-4 to 0.1, so
    the lookups count) carried into the port's network: the visibility of
    every pixel of a 48 x 64 image within 1e-5. The hash network is the
    presets': 4 levels from 16, three of them hashed into 2^19 rows."""
    jnet = JaxVisibilityNetwork(n_images=N_IMAGES, grid_type=grid_type)
    uv = pixel_uv(H, W, "cpu").reshape(-1, 2).numpy()
    params = jnet.init(jax.random.PRNGKey(1), jnp.asarray(uv),
                       jnp.asarray(IMAGE_ID, jnp.int32))
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: p * 1e3 if any(
            str(getattr(k, "key", "")).startswith(("grid_", "table_"))
            for k in path) else p, params)
    want = np.asarray(jnet.apply(params, jnp.asarray(uv),
                                 jnp.asarray(IMAGE_ID, jnp.int32)))
    net = VisibilityNetwork(N_IMAGES, grid_type=grid_type)
    net.load_state_dict(state_dict_from_flax(_numpy_tree(params), "cpu"))
    got = net(to_torch(uv), torch.tensor(IMAGE_ID, dtype=torch.int32))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    assert want.std() > 1e-3
    if grid_type == "hash":
        assert net.encoding.resolutions == [16, 80, 406, 2048]
        assert net.encoding.sizes == [17 ** 3] + [1 << 19] * 3


def _trainers(grid_type):
    """gsl_tpu's and the port's trainers, past the warm-up, L1 loss (see
    test_torch_appearance.py: gsl_tpu's SSIM is a bf16-split one), set up
    from the same Gaussians; the port carries both of gsl_tpu's networks."""
    gt = _gt_state(1)
    xyz = np.asarray(gt.params.means[:N_GT])
    rgb = np.full((N_GT, 3), 0.5, np.float32)
    model = dict(sh_degree=1, appearance_feature_init="normal",
                 appearance_feature_dims=16)
    common = dict(n_appearances=N_IMAGES, n_images=N_IMAGES,
                  grid_type=grid_type)
    jtrainer = JaxVisibilityTrainer(
        model=JaxAppearanceModel(**model),
        renderer=JaxRendererConfig(**JAX_RENDERER),
        metrics=JaxMetrics(lambda_dssim=0.0),
        appearance_opt=JaxAppearanceOpt(warm_up=0), **common)
    jstate = jtrainer.setup(JaxAppearanceModel(**model).init_from_pcd(
        xyz, rgb, CAPACITY), 1.5)
    trainer = VisibilityMapAppearanceTrainer(
        model=AppearanceFeatureGaussianConfig(**model),
        metrics=VanillaMetricsConfig(lambda_dssim=0.0),
        appearance_opt=AppearanceOptimizationConfig(warm_up=0), **common)
    state = trainer.setup(state_from_jax_arrays(
        {k: np.asarray(getattr(jstate.params, k)) for k in ALL_FIELDS},
        np.asarray(jstate.alive), "cpu"), 1.5)
    for name, tx in (("__net__", trainer.net_tx), ("__vis__",
                                                    trainer.vis_tx)):
        params = state_dict_from_flax(
            _numpy_tree(jstate.extra[name].params), "cpu")
        state.extra[name] = {"params": params, "opt": tx.init(params)}
    return jtrainer, jstate, trainer, state, _targets(gt, 1)


@pytest.mark.parametrize("grid_type", ["dense", "hash"])
def test_visibility_step_matches_jax(grid_type):
    """One step with a mask: the loss within 1e-6, vis_reg and vis_mean
    within rtol 1e-5, the Gaussians' and the visibility network's
    gradients (first Adam moments / 0.1) within rtol 5e-3 / atol 1e-4,
    and the visibility weights after the step where their gradient is
    clear of the tolerance."""
    jtrainer, jstate, trainer, state, targets = _trainers(grid_type)
    mask = (np.random.RandomState(3).uniform(size=(H, W)) > 0.2).astype(
        np.float32)
    jcam = _jax_camera(2).replace(
        appearance_id=jnp.asarray(IMAGE_ID, jnp.int32))
    pcam = dataclasses.replace(_port_camera(2), appearance_id=torch.tensor(
        IMAGE_ID, dtype=torch.int32))
    jnew, jsc = jtrainer.train_step_appearance(
        jstate, jcam, jnp.asarray(targets[2].numpy()), H, W, 1,
        jnp.zeros(3), False, mask=jnp.asarray(mask))
    new, sc = trainer.train_step_appearance(
        state, pcam, targets[2], H, W, 1, torch.zeros(3), False,
        mask=to_torch(mask))
    assert float(sc["loss"]) == pytest.approx(float(jsc["loss"]), abs=1e-6)
    for k in ("vis_reg", "vis_mean"):
        assert float(sc[k]) == pytest.approx(float(jsc[k]), rel=1e-5), k
    for k in ALL_FIELDS:
        inner = jnew.opt_state.inner_states[k].inner_state[0]
        np.testing.assert_allclose(
            new.opt_state.exp_avg[k].numpy() / 0.1,
            np.asarray(getattr(inner.mu, k)) / 0.1, rtol=GRAD_RTOL,
            atol=GRAD_ATOL, err_msg=k)
    vis = new.extra["__vis__"]
    jmu = state_dict_from_flax(_numpy_tree(
        jnew.extra["__vis__"].opt_state[0].mu), "cpu")
    jparams = state_dict_from_flax(_numpy_tree(
        jnew.extra["__vis__"].params), "cpu")
    assert vis["opt"]["count"] == 1
    for k, v in vis["params"].items():
        g = vis["opt"]["exp_avg"][k].numpy() / 0.1
        np.testing.assert_allclose(g, jmu[k].numpy() / 0.1, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
        sure = np.abs(g) > 1e-4
        np.testing.assert_allclose(v.numpy()[sure],
                                   jparams[k].numpy()[sure], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    moved = vis["params"]["encoding.table_3" if grid_type == "hash"
                          else "encoding.grid_3"] \
        - state.extra["__vis__"]["params"][
            "encoding.table_3" if grid_type == "hash" else "encoding.grid_3"]
    assert float(moved.abs().max()) > 1e-4
    if grid_type == "dense":
        # only the view's own grids moved
        others = [i for i in range(N_IMAGES) if i != IMAGE_ID]
        assert float(moved[others].abs().max()) == 0.0


def test_networks_are_sized_from_the_data():
    """Without counts, the embedding and the visibility network take the
    largest appearance id of any split + 1 (gsl_tpu's CLI builds the
    appearance network with None, which flax cannot initialise, and fixes
    the visibility network at 1024 images)."""
    class Split(list):
        cameras = None

    def split(ids):
        s = Split(ids)
        s.cameras = types.SimpleNamespace(
            appearance_id=torch.tensor(ids, dtype=torch.int32))
        return s

    outputs = types.SimpleNamespace(train_set=split([0, 2, 5]),
                                    val_set=split([6]), test_set=split([]))
    trainer = VisibilityMapAppearanceTrainer(
        model=AppearanceFeatureGaussianConfig())
    with pytest.raises(ValueError, match="n_images is not set"):
        trainer.setup(None, 1.0)
    trainer.size_from_data(outputs)
    assert trainer.n_appearances == trainer.n_images == 7
    given = VisibilityMapAppearanceTrainer(n_appearances=9, n_images=3)
    given.size_from_data(outputs)
    assert (given.n_appearances, given.n_images) == (9, 3)


ROWS = 1 << 19          # the hash tables' rows, and the capacity


def test_densify_and_growth_leave_the_networks_alone_at_table_capacity():
    """A hash-visibility state whose capacity is 2^19, the row count of
    the three finer hash tables: a densify that clones and splits, then a
    growth to 2^20, leave every tensor of both networks and of their Adam
    states (given non-zero moments) as it was, while the per-Gaussian
    rows follow. gsl_tpu's growth, by its shape rule, pads those tables
    to 2^20 rows."""
    n = 2000
    rng = np.random.RandomState(0)
    xyz = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    trainer = VisibilityMapAppearanceTrainer(
        model=AppearanceFeatureGaussianConfig(sh_degree=0,
                                              appearance_feature_dims=4),
        n_appearances=3, n_images=3, grid_type="hash")
    state = trainer.setup(trainer.model.init_from_pcd(
        xyz, np.full_like(xyz, 0.5), ROWS, "cpu"), 1.0)
    assert state.params.capacity == ROWS
    gen = torch.Generator().manual_seed(2)
    for name in ("__net__", "__vis__"):
        opt = state.extra[name]["opt"]
        for m in ("exp_avg", "exp_avg_sq"):
            opt[m] = {k: torch.rand(v.shape, generator=gen)
                      for k, v in opt[m].items()}
    tables = [k for k, v in state.extra["__vis__"]["params"].items()
              if v.shape[0] == ROWS]
    assert len(tables) == 3
    before = {name: _flat(state.extra[name])
              for name in ("__net__", "__vis__")}
    denom = state.alive.to(torch.float32)
    state = dataclasses.replace(state, density=td.DensityControlState(
        grad_accum=denom * 1e-3, denom=denom,
        max_radii=torch.zeros(ROWS)))
    state, n_trunc = trainer.density_step(state, gen, False)
    born = int(state.alive.sum()) - n
    assert int(n_trunc) == 0 and born > 1000
    grown = trainer.grow_state(state, 2 * ROWS)
    assert grown.params.capacity == 2 * ROWS
    assert grown.params.appearance_features.shape == (2 * ROWS, 4)
    for s in (state, grown):
        for name, flat in before.items():
            after = _flat(s.extra[name])
            assert after.keys() == flat.keys()
            for k, v in flat.items():
                assert (torch.equal(after[k], v)
                        if isinstance(v, torch.Tensor)
                        else after[k] == v), (name, k)
    # gsl_tpu's growth pads any extra leaf of capacity rows
    jtables = {"__vis__": {k: jnp.zeros((ROWS, 4)) for k in tables}}
    jgrown = jax_grow_capacity(JaxState(
        params=JaxAppearanceModel(sh_degree=0, appearance_feature_dims=4)
        .init_from_pcd(xyz, np.full_like(xyz, 0.5), ROWS).params,
        alive=jnp.zeros(ROWS, bool), extra=jtables), 2 * ROWS)
    assert jgrown.extra["__vis__"][tables[0]].shape == (2 * ROWS, 4)


def _flat(x, prefix=""):
    if isinstance(x, dict):
        return {k2: v2 for k, v in x.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix: x}
