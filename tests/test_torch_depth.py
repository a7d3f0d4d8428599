"""gsl_tpu_torch's depth-regularised training against gsl_tpu's on the same
seeded numpy inputs: DepthTrainer's step for each loss and output key at
an early and a late step, the estimated-depth parser and load_depth, the
depth-scale solve of tools/get_depth_scales.py; then the port's own fit,
which feeds each image's map to the loss (gsl_tpu's fit never does) and
resumes bit for bit."""
import dataclasses
import importlib.util
import json
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_tpu.data.dataparsers.estimated_depth_colmap import (
    EstimatedDepthColmapDataParserConfig as JaxParserConfig)
from gsl_tpu.data.dataparsers.estimated_depth_colmap import \
    load_depth as jax_load_depth
from gsl_tpu.models.gaussian import VanillaGaussianConfig as JaxModelConfig
from gsl_tpu.renderers.tile_renderer import \
    TileRendererConfig as JaxRendererConfig
from gsl_tpu.training.depth_trainer import DepthMetricsConfig as JaxMetrics
from gsl_tpu.training.depth_trainer import DepthTrainer as JaxDepthTrainer

from gsl_tpu_torch import cli
from gsl_tpu_torch.data.cameras import make_camera
from gsl_tpu_torch.data.colmap_io import (ColmapCamera, ColmapImage,
                                          ColmapModel, rotmat_to_qvec,
                                          write_model_bin)
from gsl_tpu_torch.data.dataparsers.estimated_depth_colmap import (
    EstimatedDepthColmapDataParserConfig, load_depth)
from gsl_tpu_torch.data.dataset import CachedDataset
from gsl_tpu_torch.models.gaussian import VanillaGaussianConfig
from gsl_tpu_torch.renderers.tile_renderer import TileRendererConfig
from gsl_tpu_torch.tools import get_depth_scales
from gsl_tpu_torch.training import hooks
from gsl_tpu_torch.training.depth_trainer import (DepthMetricsConfig,
                                                  DepthTrainer)
from gsl_tpu_torch.utils.convert import (state_from_raw_arrays,
                                         train_state_from_jax_arrays)

from test_dataparsers import _write_synthetic_colmap
from test_torch_fit_e2e import (_render_views, _scene_arrays,
                                make_colmap_dataset)
from test_torch_training import (CAPACITY, N_GT, H, W, _gt_state,
                                 _jax_camera, _port_camera, _targets,
                                 _to_port)
from torch_port_utils import PARAM_FIELDS, jax_train_state_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "gsl_tpu_torch", "configs")
GRAD_RTOL, GRAD_ATOL = 5e-3, 1e-4
LATE_STEP = 20_000


# ---- DepthTrainer.train_step ---------------------------------------------

def _depth_target(view):
    """The inverse depth of the ground-truth scene at `view`, blended, as
    the port renders it, mapped through an affine as an estimator's map
    would be."""
    renderer = TileRendererConfig().instantiate()
    state = _to_port(_gt_state(1))
    with torch.no_grad():
        out = renderer.forward(state, _port_camera(view), H, W,
                               torch.zeros(3), 1,
                               render_types=frozenset({"rgb",
                                                       "inverse_depth"}))
    return (0.9 * out.inverse_depth + 0.02).numpy()


def _both_trainers(loss_type, key):
    """gsl_tpu's DepthTrainer (XLA rasterizer) set up from the initial
    cloud, and the port's set up from the same TrainState. The rgb loss is
    L1 alone (lambda_dssim 0): gsl_tpu's training SSIM is its bf16-split
    one, and the step is held here to the depth term."""
    gt = _gt_state(1)
    xyz = np.asarray(gt.params.means[:N_GT])
    rgb = np.full((N_GT, 3), 0.5, np.float32)
    kw = dict(depth_loss_type=loss_type, depth_output_key=key,
              lambda_dssim=0.0)
    jtrainer = JaxDepthTrainer(
        model=JaxModelConfig(sh_degree=1),
        renderer=JaxRendererConfig(backend="xla", max_per_tile=256,
                                   chunk=32, min_isect_capacity=4096),
        metrics=JaxMetrics(**kw))
    jstate = jtrainer.setup(
        JaxModelConfig(sh_degree=1).init_from_pcd(xyz, rgb, CAPACITY), 1.5)
    trainer = DepthTrainer(model=VanillaGaussianConfig(sh_degree=1),
                           metrics=DepthMetricsConfig(**kw))
    trainer.setup(_to_port(jstate.gaussians), 1.5)
    state = train_state_from_jax_arrays(**jax_train_state_arrays(jstate),
                                        device="cpu")
    return jtrainer, jstate, trainer, state, gt


def _step_both(jtrainer, jstate, trainer, state, target, aux, view=1):
    jnew, jsc = jtrainer.train_step(
        jstate, _jax_camera(view), jnp.asarray(target.numpy()), H, W, 1,
        jnp.zeros(3), aux_inputs=None if aux is None else jnp.asarray(aux))
    new, sc = trainer.train_step(
        state, _port_camera(view), target, H, W, 1, torch.zeros(3),
        aux_inputs=None if aux is None else torch.from_numpy(aux))
    return jnew, {k: float(v) for k, v in jsc.items()}, new, \
        {k: float(v) for k, v in sc.items()}


@pytest.mark.parametrize("key", ["inverse_depth", "hard_inverse_depth"])
@pytest.mark.parametrize("loss_type", ["l1", "l2", "l1+ssim"])
def test_depth_train_step_matches_jax(loss_type, key):
    """One step of both packages from the same state with the same map, at
    step 0 and at step 20,000 (the weight decayed to 0.01^(2/3)): the
    loss and every scalar within rtol 1e-5, the gradients (Adam's first
    moment / 0.1) within rtol 5e-3 / atol 1e-4, and the parameters after
    the step where the gradient is clear of that tolerance (|g| > 1e-5:
    there Adam's first step is -lr sign(g))."""
    jtrainer, jstate0, trainer, state0, gt = _both_trainers(loss_type, key)
    target = _targets(gt, 1)[1]
    aux = _depth_target(1)
    for step in (0, LATE_STEP):
        jstate = jstate0.replace(step=jnp.asarray(step, jnp.int32))
        state = dataclasses.replace(state0, step=step)
        jnew, jsc, new, sc = _step_both(jtrainer, jstate, trainer, state,
                                        target, aux)
        assert sc.keys() == jsc.keys()
        for k in sc:
            # the rgb SSIM is reported, not trained on: gsl_tpu's is its
            # bf16-split one (2e-3 in test_torch_training.py)
            tol = dict(abs=2e-3) if k == "ssim" else dict(rel=1e-5,
                                                          abs=1e-7)
            assert sc[k] == pytest.approx(jsc[k], **tol), (step, k)
        assert sc["depth_loss"] > 0.0
        # the weighted depth term is what the loss adds to the rgb loss
        w = 0.01 ** (step / 30_000)
        assert sc["loss"] == pytest.approx(
            sc["rgb_diff"] + w * sc["depth_loss"], rel=1e-5)
        got = jax_train_state_arrays(jnew)
        for k in PARAM_FIELDS:
            g = new.opt_state.exp_avg[k].numpy() / 0.1
            jg = got["opt"][k]["mu"] / 0.1
            np.testing.assert_allclose(g, jg, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=(step, k))
            sure = np.abs(jg) > 1e-5
            np.testing.assert_allclose(
                getattr(new.params, k).numpy()[sure],
                got["params"][k][sure], rtol=1e-5, atol=1e-6,
                err_msg=(step, k))


def test_depth_train_step_without_a_map_matches_jax():
    """aux_inputs=None: no depth term on either side, and the step is the
    plain one."""
    jtrainer, jstate, trainer, state, gt = _both_trainers(
        "l1", "hard_inverse_depth")
    target = _targets(gt, 1)[1]
    jnew, jsc, new, sc = _step_both(jtrainer, jstate, trainer, state,
                                    target, None)
    assert "depth_loss" not in sc and "depth_loss" not in jsc
    assert sc["loss"] == pytest.approx(jsc["loss"], rel=1e-5)
    assert sc["loss"] == pytest.approx(sc["rgb_diff"], rel=1e-6)
    got = jax_train_state_arrays(jnew)
    for k in PARAM_FIELDS:
        np.testing.assert_allclose(new.opt_state.exp_avg[k].numpy() / 0.1,
                                   got["opt"][k]["mu"] / 0.1,
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)


# ---- the parser ----------------------------------------------------------

def _write_depth_scene(root):
    """tests/test_dataparsers.py's 10-image COLMAP scene with maps: half
    named <stem>.npy, half <name>.npy; scales keyed by name or by stem;
    img_008 and img_009 at 100x the others' scale, img_007 without one."""
    _write_synthetic_colmap(root)
    ddir = os.path.join(root, "estimated_depths")
    os.makedirs(ddir)
    rng = np.random.RandomState(5)
    scales = {}
    for i in range(10):
        stem = f"img_{i:03d}"
        fname = f"{stem}.npy" if i % 2 else f"{stem}.png.npy"
        np.save(os.path.join(ddir, fname),
                rng.uniform(0.1, 1.0, (48, 64)).astype(np.float32))
        if i == 7:
            continue
        scales[stem if i % 3 else stem + ".png"] = {
            "scale": (100.0 if i >= 8 else 1.5 + 0.1 * i),
            "offset": 0.01 * i}
    with open(os.path.join(root, "estimated_depth_scales.json"), "w") as f:
        json.dump(scales, f)


@pytest.mark.parametrize("rescaling", [True, False])
def test_estimated_depth_parser_matches_jax(tmp_path, rescaling):
    root = str(tmp_path)
    _write_depth_scene(root)
    kw = dict(path=root, eval_step=4, depth_rescaling=rescaling)
    got = EstimatedDepthColmapDataParserConfig(**kw).instantiate() \
        .get_outputs()
    want = JaxParserConfig(**kw).instantiate().get_outputs()
    for split in ("train_set", "val_set"):
        g, w = getattr(got, split), getattr(want, split)
        assert g.image_names == w.image_names
        assert g.extra_data["depth"] == w.extra_data["depth"], split
        for entry in g.extra_data["depth"]:
            if entry is not None:
                np.testing.assert_array_equal(load_depth(entry),
                                              jax_load_depth(entry))
    entries = got.train_set.extra_data["depth"]
    if rescaling:
        # the two outliers and the image without a scale are dropped
        assert [e is None for e in entries] == [False] * 7 + [True] * 3
    else:
        assert all(e is not None for e in entries)
    assert load_depth(None) is None


def test_a_map_of_another_size_raises_naming_its_file(tmp_path):
    root = str(tmp_path)
    _write_depth_scene(root)
    outputs = EstimatedDepthColmapDataParserConfig(path=root).instantiate() \
        .get_outputs()
    dataset = CachedDataset(outputs.train_set)
    name = outputs.train_set.image_names[1]
    d = dataset.get_depth(name, (48, 64))
    assert d.dtype == torch.float32 and d.shape == (48, 64)
    assert dataset.get_depth(name, (48, 64)) is d          # cached
    assert dataset.get_depth(outputs.train_set.image_names[9],
                             (48, 64)) is None
    path = outputs.train_set.extra_data["depth"][3]["path"]
    np.save(path, np.zeros((24, 32), np.float32))
    with pytest.raises(ValueError, match=path):
        dataset.get_depth(outputs.train_set.image_names[3], (48, 64))


# ---- get_depth_scales ----------------------------------------------------

AFFINES = [(1.5, 0.05), (0.8, -0.1), (2.5, 0.2), (1.2, 0.0)]


def _yaw(deg):
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])


def _write_scale_scene(root):
    """Views from the origin at yaws 0, 90, 180 and 270 degrees (80x60,
    fx 100), each with 60 SfM points of its own at distinct pixel centres
    of its map, which holds (1/z - b)/a there (views' `AFFINES`) and noise
    elsewhere; 3 of each view's 60 samples are outliers. A fifth view at
    45 degrees sees only 5 points and is skipped. No view sees another's
    points: their bearings lie outside its field of view."""
    Wd, Hd, f = 80, 60, 100.0
    rng = np.random.RandomState(0)
    ddir = os.path.join(root, "estimated_depths")
    os.makedirs(ddir)
    images, points = {}, []
    for k, yaw in enumerate((0, 90, 180, 270, 45)):
        R = _yaw(yaw)
        n = 60 if k < 4 else 5
        pix = rng.choice(Wd * Hd, n, replace=False)
        u, v = pix % Wd, pix // Wd
        z = rng.uniform(2.0, 6.0, n)
        p_cam = np.stack([(u - Wd / 2) / f * z, (v - Hd / 2) / f * z, z], 1)
        points.append(p_cam @ R)           # R^T p_cam: t = 0
        dmap = rng.uniform(0.1, 1.0, (Hd, Wd))
        a, b = AFFINES[k] if k < 4 else (1.0, 0.0)
        dmap[v, u] = (1.0 / z - b) / a
        bad = rng.choice(n, 3, replace=False)
        dmap[v[bad], u[bad]] += rng.uniform(0.05, 0.1, 3)
        np.save(os.path.join(ddir, f"view_{k}.npy"), dmap.astype(np.float32))
        images[k + 1] = ColmapImage(k + 1, rotmat_to_qvec(R), np.zeros(3),
                                    1, f"view_{k}.png")
    xyz = np.concatenate(points)
    write_model_bin(ColmapModel(
        cameras={1: ColmapCamera(1, "PINHOLE", Wd, Hd,
                                 np.array([f, f, Wd / 2, Hd / 2]))},
        images=images, points_xyz=xyz,
        points_rgb=np.zeros((len(xyz), 3), np.uint8),
        points_err=np.zeros(len(xyz))), os.path.join(root, "sparse", "0"))


def _jax_tool(root, monkeypatch):
    """tools/get_depth_scales.py run on `root`; returns its JSON."""
    spec = importlib.util.spec_from_file_location(
        "jax_get_depth_scales", os.path.join(REPO, "tools",
                                             "get_depth_scales.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(sys, "argv", ["get_depth_scales.py", root])
    tool.main()
    with open(os.path.join(root, "estimated_depth_scales.json")) as f:
        return json.load(f)


def test_get_depth_scales_recovers_the_affine_and_writes_the_jax_json(
        tmp_path, monkeypatch, capsys):
    root = str(tmp_path)
    _write_scale_scene(root)
    want = _jax_tool(root, monkeypatch)
    got = get_depth_scales.main([root, "--device", "cpu"])
    assert "wrote" in capsys.readouterr().out
    with open(os.path.join(root, "estimated_depth_scales.json")) as f:
        written = json.load(f)
    assert written == got
    assert list(got) == list(want) == [f"view_{k}.png" for k in range(4)]
    for name, (a, b) in zip(got, AFFINES):
        assert got[name]["scale"] == pytest.approx(a, abs=1e-4)
        assert got[name]["offset"] == pytest.approx(b, abs=1e-4)
        for k in ("scale", "offset"):
            assert got[name][k] == pytest.approx(want[name][k], rel=1e-9,
                                                 abs=1e-12)


# ---- the fit through the CLI ---------------------------------------------

A_KNOWN, B_KNOWN = 2.0, -0.1


def _colmap_depth_scene(root):
    """The port's COLMAP test scene with estimated_depths/view_i.npy: the
    port's rendered inverse depth mapped through d = (inv - b) / a, and the
    scales file holding that affine, but view_4 at 100x the others' scale,
    so the parser drops its map. (The scene's 200 SfM points are splat
    centres mostly hidden behind other splats, so the scale solve has too
    few visible samples here; tests of it use a scene built for it.)"""
    make_colmap_dataset(root)
    views, f = _render_views(6)
    state = state_from_raw_arrays(_scene_arrays(), device="cpu")
    renderer = TileRendererConfig().instantiate()
    os.makedirs(os.path.join(root, "estimated_depths"))
    side = views[0][0].shape[0]
    scales = {}
    for i, (_, T) in enumerate(views):
        cam = make_camera(np.eye(3), T, f, f, side / 2, side / 2, side,
                          side, device="cpu")
        with torch.no_grad():
            inv = renderer.forward(
                state, cam, side, side, torch.zeros(3), 0,
                render_types=frozenset({"rgb", "inverse_depth"})
            ).inverse_depth
        np.save(os.path.join(root, "estimated_depths", f"view_{i}.npy"),
                ((inv - B_KNOWN) / A_KNOWN).numpy())
        scales[f"view_{i}.png"] = {
            "scale": A_KNOWN * (100.0 if i == 4 else 1.0),
            "offset": B_KNOWN}
    with open(os.path.join(root, "estimated_depth_scales.json"), "w") as fh:
        json.dump(scales, fh)


@pytest.fixture(scope="module")
def depth_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("depth_scene"))
    _colmap_depth_scene(root)
    return root


def _fit_argv(root, out, name, steps, extra=()):
    return ["fit", "--config", os.path.join(CONFIGS, "colmap.yaml"),
            "--config", os.path.join(CONFIGS, "depth_regularization.yaml"),
            "--data.path", root, "--output", out, "-n", name,
            "--max_steps", str(steps), "--device", "cpu",
            "fit.min_capacity=1024", "model.gaussian.sh_degree=1",
            "fit.log_interval=1", *extra]


def test_the_fit_feeds_each_image_its_map(depth_scene, tmp_path,
                                          monkeypatch):
    """A 4-step fit of colmap.yaml + depth_regularization.yaml: every
    train_step gets the map of its image (None for view_4, whose scale is
    an outlier), and the fitted parameters differ from those of the same
    fit with the maps' directory removed."""
    seen = []
    step_of = DepthTrainer.train_step
    call_of = hooks.DepthStepHook.__call__

    def spy_step(self, *args, aux_inputs=None, **kw):
        seen[-1].append(aux_inputs)
        return step_of(self, *args, aux_inputs=aux_inputs, **kw)

    def spy_call(self, state, generator, step, sh_degree, cam, name, *a):
        seen.append([name])
        return call_of(self, state, generator, step, sh_degree, cam, name,
                       *a)

    monkeypatch.setattr(DepthTrainer, "train_step", spy_step)
    monkeypatch.setattr(hooks.DepthStepHook, "__call__", spy_call)
    out = str(tmp_path)
    with_maps, _ = cli.main(_fit_argv(depth_scene, out, "maps", 4))
    assert len(seen) == 4
    outputs = EstimatedDepthColmapDataParserConfig(
        path=depth_scene).instantiate().get_outputs()
    entries = dict(zip(outputs.train_set.image_names,
                       outputs.train_set.extra_data["depth"]))
    assert entries["view_4.png"] is None
    assert sum(e is not None for e in entries.values()) == 5
    for name, aux in seen:
        want = load_depth(entries[name])
        if want is None:
            assert aux is None, name
        else:
            assert torch.equal(aux, torch.from_numpy(want)), name

    moved = os.path.join(str(tmp_path), "moved_depths")
    shutil.move(os.path.join(depth_scene, "estimated_depths"), moved)
    try:
        seen.clear()
        without, _ = cli.main(_fit_argv(depth_scene, out, "none", 4))
    finally:
        shutil.move(moved, os.path.join(depth_scene, "estimated_depths"))
    assert [aux for _, aux in seen] == [None] * 4
    differs = [k for k in PARAM_FIELDS
               if not torch.equal(getattr(with_maps.params, k),
                                  getattr(without.params, k))]
    assert "means" in differs and "opacities" in differs


def test_the_depth_fit_resumes_bit_for_bit(depth_scene, tmp_path, capsys):
    """16 steps, and 16 steps resumed from the first run's checkpoint at
    step 8, with densifies every 4 steps: the same parameters, moments and
    alive rows."""
    out = str(tmp_path)
    extra = ("fit.log_interval=2", "fit.save_iterations=[8]",
             "fit.save_ply=false",
             "model.density.init_args.densify_from_iter=1",
             "model.density.init_args.densification_interval=4")
    ref, _ = cli.main(_fit_argv(depth_scene, out, "ref", 16,
                                extra + ("fit.resume=never",)))
    step_8 = os.path.join(out, "ref", "checkpoints", "step_8")
    capsys.readouterr()
    res, _ = cli.main(_fit_argv(depth_scene, out, "res", 16,
                                extra + (f"fit.resume={step_8}",)))
    assert "-> continuing at 9" in capsys.readouterr().out
    for k in PARAM_FIELDS:
        assert torch.equal(getattr(res.params, k), getattr(ref.params, k)), k
        assert torch.equal(res.opt_state.exp_avg[k],
                           ref.opt_state.exp_avg[k]), k
        assert torch.equal(res.opt_state.exp_avg_sq[k],
                           ref.opt_state.exp_avg_sq[k]), k
    assert torch.equal(res.alive, ref.alive)
    assert ref.gaussians.n_alive != 200            # the densifies ran
