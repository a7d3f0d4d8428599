"""gsl_tpu_torch's output processors, gradient accumulation and the
PhotoTourism split against gsl_tpu's on the same seeded numpy inputs: the
bilateral-grid slice and its TV loss, exposure, a Trainer step with each
processor, the bilateral-grid freeze, k steps of gradient accumulation,
the split of a written ``.tsv``, the components the presets build, and the
variant pairs that gsl_tpu drops silently, which the port refuses."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_tpu import cli as jcli
from gsl_tpu.data.dataparsers.phototourism import \
    PhotoTourismDataParserConfig as JaxPhotoTourism
from gsl_tpu.models.gaussian import VanillaGaussianConfig as JaxModelConfig
from gsl_tpu.renderers.tile_renderer import \
    TileRendererConfig as JaxRendererConfig
from gsl_tpu.training import output_processors as jop
from gsl_tpu.training import plugins as jp
from gsl_tpu.training.metrics import VanillaMetricsConfig as JaxMetrics
from gsl_tpu.training.opt_strategies import GradAccConfig as JaxGradAccConfig
from gsl_tpu.training.opt_strategies import \
    GradAccTrainer as JaxGradAccTrainer
from gsl_tpu.training.trainer import Trainer as JaxTrainer

from gsl_tpu_torch import cli
from gsl_tpu_torch.data.dataparsers.colmap import ColmapDataParserConfig
from gsl_tpu_torch.data.dataparsers.phototourism import \
    PhotoTourismDataParserConfig
from gsl_tpu_torch.models.gaussian import VanillaGaussianConfig
from gsl_tpu_torch.training import output_processors as top
from gsl_tpu_torch.training import plugins as tp
from gsl_tpu_torch.training.appearance_trainer import AppearanceTrainer
from gsl_tpu_torch.training.depth_trainer import DepthTrainer
from gsl_tpu_torch.training.gs2d import GS2DTrainer
from gsl_tpu_torch.training.metrics import VanillaMetricsConfig
from gsl_tpu_torch.training.opt_strategies import (GradAccConfig,
                                                   GradAccTrainer)
from gsl_tpu_torch.training.trainer import Trainer
from gsl_tpu_torch.utils.convert import train_state_from_jax_arrays

from test_torch_fit_e2e import make_colmap_dataset
from test_torch_training import (CAPACITY, N_GT, H, W, _gt_state,
                                 _jax_camera, _port_camera, _targets)
from torch_port_utils import PARAM_FIELDS, jax_train_state_arrays, to_torch

GRAD_RTOL, GRAD_ATOL = 5e-3, 1e-4
JAX_RENDERER = dict(backend="xla", max_per_tile=256, chunk=32,
                    min_isect_capacity=4096)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_IMAGES, IMAGE_IDX = 3, 1


def _grid(seed, n=1):
    """Bilateral grids near identity: [n, 16, 16, 8, 12]."""
    g = np.asarray(jop.init_bilateral_grids(jop.BilateralGridConfig(
        n_images=n)))
    return (g + 0.2 * np.random.RandomState(seed).normal(
        size=g.shape)).astype(np.float32)


def test_bilateral_slice_and_tv_loss_match_jax():
    """One image's grid applied to colours in and a little outside [0, 1]:
    the output within 1e-5, its gradients in the grid and the colours
    within rtol 5e-3 / atol 1e-4, the TV loss (three float32 means over
    24,576 differences) within rtol 1e-5."""
    grids = _grid(0, 2)
    rgb = np.random.RandomState(1).uniform(-0.1, 1.1, (H, W, 3)).astype(
        np.float32)
    w = np.random.RandomState(2).normal(size=(H, W, 3)).astype(np.float32)

    def jloss(g, c):
        return jnp.sum(jop.slice_bilateral_grid(g, c) * w)

    want = np.asarray(jop.slice_bilateral_grid(jnp.asarray(grids[1]),
                                               jnp.asarray(rgb)))
    jgg, jgc = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(grids[1]),
                                               jnp.asarray(rgb))
    g, c = to_torch(grids[1]).requires_grad_(True), \
        to_torch(rgb).requires_grad_(True)
    got = top.slice_bilateral_grid(g, c)
    gg, gc = torch.autograd.grad(torch.sum(got * to_torch(w)), [g, c])
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    np.testing.assert_allclose(gg.numpy(), np.asarray(jgg), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(gc.numpy(), np.asarray(jgc), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    tv = float(top.bilateral_grid_tv_loss(to_torch(grids)))
    assert tv == pytest.approx(float(jop.bilateral_grid_tv_loss(
        jnp.asarray(grids))), rel=1e-5)
    ident = top.init_bilateral_grids(top.BilateralGridConfig(n_images=2))
    np.testing.assert_array_equal(ident.numpy(), np.asarray(
        jop.init_bilateral_grids(jop.BilateralGridConfig(n_images=2))))
    assert torch.allclose(top.slice_bilateral_grid(ident[0], c.detach()),
                          c.detach(), atol=1e-6)


def test_exposure_matches_jax():
    e = np.asarray(jop.init_exposures(jop.ExposureConfig(n_images=3)))
    np.testing.assert_array_equal(
        top.init_exposures(top.ExposureConfig(n_images=3)).numpy(), e)
    e = e + 0.1 * np.random.RandomState(4).normal(size=e.shape).astype(
        np.float32)
    rgb = np.random.RandomState(5).uniform(size=(H, W, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        top.apply_exposure(to_torch(e[2]), to_torch(rgb)).numpy(),
        np.asarray(jop.apply_exposure(jnp.asarray(e[2]), jnp.asarray(rgb))),
        atol=1e-6)


def _processor_trainers(kind, plugins=((), ())):
    """gsl_tpu's and the port's Trainer with the same processor (its
    parameters spread from the identity), L1 loss (gsl_tpu's SSIM is a
    bf16-split one, see test_torch_appearance.py), from the same state."""
    gt = _gt_state(1)
    xyz = np.asarray(gt.params.means[:N_GT])
    rgb = np.full((N_GT, 3), 0.5, np.float32)
    jcfg = (jop.BilateralGridConfig() if kind == "bilagrid"
            else jop.ExposureConfig())
    cfg = (top.BilateralGridConfig() if kind == "bilagrid"
           else top.ExposureConfig())
    jtrainer = JaxTrainer(model=JaxModelConfig(sh_degree=1),
                          renderer=JaxRendererConfig(**JAX_RENDERER),
                          metrics=JaxMetrics(lambda_dssim=0.0),
                          output_processor=jcfg, plugins=plugins[0])
    jstate = jtrainer.init_output_processor(jtrainer.setup(
        JaxModelConfig(sh_degree=1).init_from_pcd(xyz, rgb, CAPACITY), 1.5),
        N_IMAGES)
    spread = np.asarray(jstate.extra["__outproc__"])
    spread = spread + 0.05 * np.random.RandomState(6).normal(
        size=spread.shape).astype(np.float32)
    jstate = jstate.replace(extra=dict(jstate.extra,
                                       __outproc__=jnp.asarray(spread)))
    trainer = Trainer(model=VanillaGaussianConfig(sh_degree=1),
                      metrics=VanillaMetricsConfig(lambda_dssim=0.0),
                      output_processor=cfg, plugins=plugins[1])
    arrays = jax_train_state_arrays(jstate.replace(extra=None))
    state = train_state_from_jax_arrays(**arrays, device="cpu")
    trainer.setup(state.gaussians, 1.5)
    state = trainer.init_output_processor(state, N_IMAGES)
    state.extra["__outproc__"] = to_torch(spread)
    return jtrainer, jstate, trainer, state, _targets(gt, 1)


def _jax_op_moment(jstate):
    return np.asarray(jstate.extra["__outproc_opt__"][0].mu)


def _step_both(jtrainer, jstate, trainer, state, targets, view):
    jnew, jsc = jtrainer.train_step(
        jstate, _jax_camera(view), jnp.asarray(targets[view].numpy()), H, W,
        1, jnp.zeros(3), image_idx=jnp.asarray(IMAGE_IDX, jnp.int32))
    new, sc = trainer.train_step(state, _port_camera(view), targets[view],
                                 H, W, 1, torch.zeros(3),
                                 image_idx=IMAGE_IDX)
    assert float(sc["loss"]) == pytest.approx(float(jsc["loss"]), abs=1e-6)
    return jnew, new


@pytest.mark.parametrize("kind", ["bilagrid", "exposure"])
def test_trainer_step_with_a_processor_matches_jax(kind):
    """One step on image 1 of 3: the loss (with the grid's TV term) within
    1e-6; the Gaussians' and the processor's gradients (first Adam moments
    / 0.1) within rtol 5e-3 / atol 1e-4; the processor stepped by its own
    Adam (eps 1e-8, its lr) as gsl_tpu's where its gradient is clear of
    the tolerance; the other images' parameters untouched."""
    jtrainer, jstate, trainer, state, targets = _processor_trainers(kind)
    jnew, new = _step_both(jtrainer, jstate, trainer, state, targets, 2)
    for k in PARAM_FIELDS:
        inner = jnew.opt_state.inner_states[k].inner_state[0]
        np.testing.assert_allclose(
            new.opt_state.exp_avg[k].numpy() / 0.1,
            np.asarray(getattr(inner.mu, k)) / 0.1, rtol=GRAD_RTOL,
            atol=GRAD_ATOL, err_msg=k)
    opt = new.extra["__outproc_opt__"]
    g = opt["exp_avg"]["__outproc__"].numpy() / 0.1
    np.testing.assert_allclose(g, _jax_op_moment(jnew) / 0.1,
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    sure = np.abs(g) > 1e-4
    assert sure[IMAGE_IDX].mean() > 0.5
    got = new.extra["__outproc__"].numpy()
    np.testing.assert_allclose(got[sure], np.asarray(
        jnew.extra["__outproc__"])[sure], rtol=1e-5, atol=1e-6)
    assert opt["count"] == 1
    before = state.extra["__outproc__"].numpy()
    others = [i for i in range(N_IMAGES) if i != IMAGE_IDX]
    np.testing.assert_array_equal(got[others], before[others])
    assert np.abs(got[IMAGE_IDX] - before[IMAGE_IDX]).max() > 1e-4


def test_freeze_bilagrid_matches_jax():
    """freeze_from 2: four steps with the plugin's after_step, as gsl_tpu's
    fit calls it. The grids follow gsl_tpu's and from step 2 on stay at
    their value after step 2, while the processor's Adam state goes on."""
    pj = (jp.FreezeBilagridPluginConfig(freeze_from=2).instantiate(),)
    pt = (tp.FreezeBilagridPluginConfig(freeze_from=2).instantiate(),)
    jtrainer, jstate, trainer, state, targets = _processor_trainers(
        "bilagrid", (pj, pt))
    grids, moments = [], []
    for step in range(1, 5):
        jstate, state = _step_both(jtrainer, jstate, trainer, state,
                                   targets, step % 3)
        jstate = pj[0].after_step(jstate, step)
        state = pt[0].after_step(state, step)
        got = state.extra["__outproc__"].numpy()
        sure = np.abs(state.extra["__outproc_opt__"]["exp_avg"][
            "__outproc__"].numpy()) > 1e-4
        np.testing.assert_allclose(got[sure], np.asarray(
            jstate.extra["__outproc__"])[sure], rtol=1e-4, atol=1e-5,
            err_msg=f"step {step}")
        grids.append(got)
        moments.append(state.extra["__outproc_opt__"]["exp_avg"][
            "__outproc__"].clone())
    assert not np.array_equal(grids[0], grids[1])
    assert np.array_equal(grids[1], grids[2]) \
        and np.array_equal(grids[1], grids[3])
    assert not torch.equal(moments[2], moments[3])
    assert state.extra["__outproc_opt__"]["count"] == 4


def test_grad_acc_matches_jax():
    """k = 3 from step 0 (stages ((0, 3),)): six steps, the mean of each
    three applied on steps 3 and 6. Losses within 1e-6, the density
    statistics every step, the buffer's sums within rtol 5e-3 / atol
    1e-4, the parameters unchanged between applies and after each apply
    as gsl_tpu's where the first moment is clear of zero; two Adam
    updates in all."""
    gt = _gt_state(1)
    xyz = np.asarray(gt.params.means[:N_GT])
    rgb = np.full((N_GT, 3), 0.5, np.float32)
    targets = _targets(gt, 1)
    jtrainer = JaxGradAccTrainer(
        model=JaxModelConfig(sh_degree=1),
        renderer=JaxRendererConfig(**JAX_RENDERER),
        metrics=JaxMetrics(lambda_dssim=0.0),
        grad_acc=JaxGradAccConfig(stages=((0, 3),)))
    jstate = jtrainer.setup(JaxModelConfig(sh_degree=1).init_from_pcd(
        xyz, rgb, CAPACITY), 1.5)
    trainer = GradAccTrainer(model=VanillaGaussianConfig(sh_degree=1),
                             metrics=VanillaMetricsConfig(lambda_dssim=0.0),
                             grad_acc=GradAccConfig(stages=((0, 3),)))
    state = train_state_from_jax_arrays(**jax_train_state_arrays(jstate),
                                        device="cpu")
    trainer.setup(state.gaussians, 1.5)
    jbuf, buf = jtrainer.init_grad_buffer(jstate), \
        trainer.init_grad_buffer(state)
    for step in range(1, 7):
        k = trainer.grad_acc.accumulation_at(step)
        assert k == jtrainer.grad_acc.accumulation_at(step) == 3
        apply, view = step % k == 0, step % 3
        prev = state
        jstate, jbuf, jsc = jtrainer.train_step_accumulate(
            jstate, jbuf, _jax_camera(view),
            jnp.asarray(targets[view].numpy()), H, W, 1, jnp.zeros(3),
            apply=apply, inv_k=1.0 / k)
        state, buf, sc = trainer.train_step_accumulate(
            state, buf, _port_camera(view), targets[view], H, W, 1,
            torch.zeros(3), apply=apply, inv_k=1.0 / k)
        assert float(sc["loss"]) == pytest.approx(float(jsc["loss"]),
                                                  abs=1e-6), step
        np.testing.assert_array_equal(state.density.denom.numpy(),
                                      np.asarray(jstate.density.denom))
        np.testing.assert_allclose(state.density.grad_accum.numpy(),
                                   np.asarray(jstate.density.grad_accum),
                                   rtol=1e-4, atol=1e-8)
        for f in PARAM_FIELDS:
            np.testing.assert_allclose(
                getattr(buf, f).numpy(), np.asarray(getattr(jbuf, f)),
                rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=f"{f} {step}")
            if not apply:
                assert torch.equal(getattr(state.params, f),
                                   getattr(prev.params, f))
                continue
            want = np.asarray(getattr(jstate.params, f))
            got = getattr(state.params, f).numpy()
            sure = np.abs(state.opt_state.exp_avg[f].numpy()) > 1e-6
            np.testing.assert_allclose(got[sure], want[sure], rtol=1e-5,
                                       atol=2e-6, err_msg=f"{f} {step}")
        if apply:
            assert all(float(getattr(buf, f).abs().max()) == 0.0
                       for f in PARAM_FIELDS)
    assert state.opt_state.count == 2
    assert int(jstate.opt_state.inner_states["means"].inner_state[0]
               .count) == 2


def _write_tsv(root, rows):
    with open(os.path.join(root, "scene.tsv"), "w") as f:
        f.write("filename\tid\tsplit\tdataset\n")
        for name, split in rows:
            f.write(f"{name}\t0\t{split}\tscene\n")


def test_phototourism_split_matches_jax(tmp_path):
    """A six-view COLMAP scene with a ``.tsv``: views 1 and 4 test, view 5
    unlisted (so it trains). The train split as gsl_tpu's (names, paths,
    cameras, appearance ids in COLMAP order: 0, 2, 3, 5); the test views
    keep ids 1 and 4. gsl_tpu cuts its test split out of the train split
    it has just cut: here that raises IndexError, and with views 0 and 3
    to test it serves two train views (ROADMAP §3)."""
    root = str(tmp_path / "scene")
    make_colmap_dataset(root)
    _write_tsv(root, [("view_0.png", "train"), ("view_1.png", "test"),
                      ("view_2.png", "train"), ("view_3.png", "train"),
                      ("view_4.png", "test")])
    out = PhotoTourismDataParserConfig(path=root).instantiate().get_outputs()
    with pytest.raises(IndexError):
        JaxPhotoTourism(path=root).instantiate().get_outputs()
    colmap = ColmapDataParserConfig(path=root).instantiate().get_outputs()
    sets = {"train_set": [0, 2, 3, 5], "val_set": [1, 4], "test_set": [1, 4]}
    for split, rows in sets.items():
        a = getattr(out, split)
        assert a.image_names == [f"view_{i}.png" for i in rows], split
        assert a.image_paths == [colmap.train_set.image_paths[i]
                                 for i in rows]
        assert a.cameras.appearance_id.tolist() == rows
        for k in ("R", "T", "fx", "fy", "cx", "cy"):
            assert torch.equal(getattr(a.cameras, k),
                               getattr(colmap.train_set.cameras, k)[rows])
        assert len(a.extra_data["distortion"]) == len(a)
    # gsl_tpu's train split, where its parser gets that far
    _write_tsv(root, [("view_0.png", "test"), ("view_1.png", "train"),
                      ("view_3.png", "test")])
    out = PhotoTourismDataParserConfig(path=root).instantiate().get_outputs()
    jout = JaxPhotoTourism(path=root).instantiate().get_outputs()
    a, b = out.train_set, jout.train_set
    assert a.image_names == b.image_names == [
        f"view_{i}.png" for i in (1, 2, 4, 5)]
    assert a.image_paths == b.image_paths
    np.testing.assert_array_equal(a.cameras.appearance_id.numpy(),
                                  np.asarray(b.cameras.appearance_id))
    for k in ("R", "T", "fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(getattr(a.cameras, k).numpy(),
                                   np.asarray(getattr(b.cameras, k)),
                                   atol=1e-6)
    assert out.val_set.image_names == ["view_0.png", "view_3.png"]
    assert jout.val_set.image_names == ["view_1.png", "view_5.png"]
    # through the CLI's registry, sized from every split; without a .tsv
    # the COLMAP split
    trainer, dp, _ = cli.build_components({"data": {
        "path": root, "parser": "PhotoTourism"},
        "model": {"gaussian": {"class_path": "AppearanceFeatureGaussian"}}})
    assert type(dp).__name__ == "PhotoTourismDataParserConfig"
    trainer.size_from_data(dp.instantiate().get_outputs())
    assert trainer.n_appearances == 6
    os.remove(os.path.join(root, "scene.tsv"))
    plain = PhotoTourismDataParserConfig(path=root).instantiate(
    ).get_outputs()
    assert len(plain.train_set) == 6


SLICE_PRESETS = ("appearance_embedding.yaml", "appearance_visibility_map.yaml",
                 "appearance_visibility_map_hash.yaml", "swag.yaml",
                 "bilagrid.yaml", "exposure.yaml", "grad_acc.yaml")


@pytest.mark.parametrize("preset", SLICE_PRESETS)
def test_slice_presets_build_as_jax(preset):
    """The components gsl_tpu's CLI builds from each preset, in the port:
    the trainer's class, the processor's config, the accumulation stages,
    the opacity head, the grid type and the appearance count (None: from
    the data)."""
    path = [os.path.join(REPO, "gsl_tpu_torch", "configs", preset)]
    trainer, _, _ = cli.build_components(cli.load_config(path, {}))
    jtrainer, _, _ = jcli.build_components(jcli.load_config(path, {}))
    assert type(trainer).__name__ == type(jtrainer).__name__
    op, jop_cfg = trainer.output_processor, jtrainer.output_processor
    assert type(op).__name__ == type(jop_cfg).__name__
    if op is not None:
        assert dataclasses.asdict(op) == dataclasses.asdict(jop_cfg)
    if hasattr(jtrainer, "grad_acc"):
        assert tuple(trainer.grad_acc.stages) == tuple(
            jtrainer.grad_acc.stages)
    if hasattr(jtrainer, "with_opacity"):
        assert trainer.with_opacity == jtrainer.with_opacity
        assert trainer.n_appearances is None
        assert dataclasses.asdict(trainer.appearance_opt) == \
            dataclasses.asdict(jtrainer.appearance_opt)
    if hasattr(jtrainer, "vis_net"):
        assert trainer.grid_type == jtrainer.vis_net.grid_type
        assert trainer.vis_reg_factor == jtrainer.vis_reg_factor


@pytest.mark.parametrize("configs,pair", [
    (("appearance_embedding.yaml", "bilagrid.yaml"),
     r"AppearanceTrainer with an output processor \(BilateralGridConfig"),
    (("swag.yaml", "grad_acc.yaml"),
     "appearance .* with opt_strategy grad_acc"),
    (("grad_acc.yaml", "exposure.yaml"),
     r"GradAccTrainer with an output processor \(ExposureConfig"),
    (("appearance_embedding.yaml", "depth_regularization.yaml"),
     "appearance .* with metrics DepthMetricsConfig"),
    (("appearance_embedding.yaml", "normal_reg.yaml"),
     "appearance .* with plugins")])
def test_pairs_gsl_tpu_drops_raise_naming_both(configs, pair):
    cfg = cli.load_config([os.path.join(REPO, "gsl_tpu_torch", "configs", c)
                           for c in configs], {})
    with pytest.raises(ValueError, match=pair):
        cli.build_components(cfg)


def test_trainers_that_drop_a_processor_refuse_it():
    for cls in (AppearanceTrainer, GradAccTrainer, DepthTrainer,
                GS2DTrainer):
        with pytest.raises(ValueError, match=rf"{cls.__name__} with an "
                           "output processor \\(ExposureConfig\\)"):
            cls(output_processor=top.ExposureConfig())
    assert Trainer(output_processor=top.ExposureConfig()).op_tx.eps == 1e-8
