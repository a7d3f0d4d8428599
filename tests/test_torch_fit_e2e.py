"""End to end through gsl_tpu_torch's CLI on the CPU, the port alone: a
small Blender-style scene rendered by the port is fitted with one densify,
validated and resumed; the 2DGS, StopThePop, AbsGS, Mip-Splatting, MCMC,
depth, normal, ground and scale regulariser presets, the seven
appearance-slice presets, the density variants, Glossy and the dynamic
presets take a few steps, and Mip-Splatting, MCMC, GNS, an appearance run
and a bilateral-grid run resume bit for bit."""
import csv
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gsl_tpu_torch import cli
from gsl_tpu_torch.data.cameras import make_camera
from gsl_tpu_torch.data.colmap_io import (ColmapCamera, ColmapImage,
                                          ColmapModel, rotmat_to_qvec,
                                          write_model_bin)
from gsl_tpu_torch.renderers.tile_renderer import TileRendererConfig
from gsl_tpu_torch.training.fit import _init_gaussians, validate
from gsl_tpu_torch.utils.convert import state_from_raw_arrays
from gsl_tpu_torch.utils.gaussian_model_loader import GaussianModelLoader

# the port's tests work on small tensors in long Python loops, where
# several intra-op threads per test worker gain nothing
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 64
N_VIEWS = 6


def _scene_arrays(n=200, seed=9, spread=0.8, z_range=(2.0, 6.0)):
    rng = np.random.RandomState(seed)
    means = np.concatenate([rng.uniform(-spread, spread, size=(n, 2)),
                            rng.uniform(*z_range, size=(n, 1))],
                           axis=-1).astype(np.float32)
    scales = rng.uniform(-3.5, -1.5, size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.2, 0.95, size=(n,)).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    return dict(means=means, scales=scales, rotations=quats,
                opacities=np.log(opac / (1 - opac))[:, None],
                shs_dc=((colors - 0.5) / 0.28209479177387814)[:, None, :],
                shs_rest=np.zeros((n, 0, 3), np.float32))


def _render_views(n_views):
    """The known scene rendered by the port from `n_views` cameras along x,
    looking +z, as tests/test_fit_e2e.py places them: [(uint8 image, T of
    the world-to-camera transform)], and the focal length."""
    state = state_from_raw_arrays(_scene_arrays(), device="cpu")
    renderer = TileRendererConfig().instantiate()
    f = 0.5 * W / np.tan(0.5 * FOV_X)
    views = []
    for i in range(n_views):
        T = np.array([0.25 * i - 0.6, 0.0, 0.0], np.float32)
        cam = make_camera(np.eye(3), T, f, f, W / 2, H / 2, W, H,
                          device="cpu")
        with torch.no_grad():
            out = renderer.forward(state, cam, H, W, torch.zeros(3), 0)
        views.append(((np.clip(out.render.numpy(), 0, 1) * 255).astype(
            np.uint8), T))
    return views, f


FOV_X = 0.8


def make_dataset(root, n_views=N_VIEWS):
    """Render a known scene with the port to PNGs + transforms_train.json
    (cameras along x, looking +z, as tests/test_fit_e2e.py places them)."""
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    frames = []
    for i, (img, T) in enumerate(_render_views(n_views)[0]):
        name = f"train/r_{i}"
        Image.fromarray(img).save(os.path.join(root, name + ".png"))
        c2w = np.eye(4)
        c2w[:3, 3] = -T
        c2w[:3, 1:3] *= -1          # OpenCV -> OpenGL; the parser flips back
        frames.append({"file_path": name, "transform_matrix": c2w.tolist()})
    with open(os.path.join(root, "transforms_train.json"), "w") as fjs:
        json.dump({"camera_angle_x": FOV_X, "frames": frames}, fjs)


def make_colmap_dataset(root, n_views=N_VIEWS):
    """The same views as a COLMAP scene: images/*.png and
    sparse/0/*.bin (PINHOLE), with the scene's means and colours as the
    SfM points."""
    views, f = _render_views(n_views)
    os.makedirs(os.path.join(root, "images"))
    images = {}
    for i, (img, T) in enumerate(views):
        name = f"view_{i}.png"
        Image.fromarray(img).save(os.path.join(root, "images", name))
        images[i + 1] = ColmapImage(i + 1, rotmat_to_qvec(np.eye(3)), T, 1,
                                    name)
    arrays = _scene_arrays()
    rgb = np.clip(0.5 + 0.28209479177387814 * arrays["shs_dc"][:, 0], 0, 1)
    write_model_bin(ColmapModel(
        cameras={1: ColmapCamera(1, "PINHOLE", W, H,
                                 np.array([f, f, W / 2, H / 2]))},
        images=images, points_xyz=arrays["means"].astype(np.float64),
        points_rgb=(rgb * 255 + 0.5).astype(np.uint8),
        points_err=np.zeros(len(rgb))), os.path.join(root, "sparse", "0"))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    make_dataset(root)
    return root


def _argv(sub, scene, out, name, steps, preset="blender.yaml", extra=()):
    return [sub, "--config", os.path.join(REPO, "gsl_tpu_torch", "configs",
                                          preset),
            "--data.path", scene, "--output", out, "-n", name,
            "--max_steps", str(steps), "--device", "cpu",
            "data.parser.class_path=Blender",
            "data.parser.init_args.random_point_count=400",
            "data.parser.init_args.white_background=false",
            "trainer.background_color=[0.0, 0.0, 0.0]",
            "fit.min_capacity=1024", *extra]


def _log(run_dir):
    with open(os.path.join(run_dir, "train_log.csv")) as f:
        return list(csv.reader(f))


FIT_STEPS = 60
PARAM_FIELDS_3DGS = ("means", "scales", "rotations", "opacities", "shs_dc",
                     "shs_rest")
# measured on this scene (the port on the CPU): the initial cloud
# validates at 10.575 dB, and 60 steps with the densify at step 40 reach
# 15.727 dB, a rise of 5.15 dB; the test asks for half of that rise
PSNR_RISE = 2.5


def test_cli_fit_raises_psnr_and_writes_its_artifacts(scene, tmp_path):
    out = str(tmp_path)
    extra = ("model.gaussian.sh_degree=0",
             "model.density.init_args.densify_from_iter=30",
             "model.density.init_args.densification_interval=10",
             "model.density.init_args.densify_until_iter=45",
             "fit.log_interval=10", "fit.save_iterations=[30]")
    state, results = cli.main(_argv("fit", scene, out, "run", FIT_STEPS,
                                    extra=extra))
    run = os.path.join(out, "run")

    cfg = cli.load_config([os.path.join(run, "config.yaml")], {})
    trainer, dp, fit_cfg = cli.build_components(cfg)
    outputs = dp.instantiate().get_outputs()
    initial = trainer.setup(_init_gaussians(trainer, outputs, fit_cfg, "cpu"),
                            outputs.camera_extent)
    fit_cfg.output_dir = str(tmp_path / "initial")
    before = validate(trainer, initial, outputs, fit_cfg)["psnr"]
    print(f"val PSNR: initial cloud {before:.3f} dB, after {FIT_STEPS} "
          f"steps {results['psnr']:.3f} dB")
    assert results["psnr"] > before + PSNR_RISE, (before, results)

    log = _log(run)
    assert [int(r[0]) for r in log[1:]] == list(range(10, FIT_STEPS + 1, 10))
    counts = [int(r[2]) for r in log[1:]]
    assert counts[0] == 400 and counts[-1] != 400      # one densify ran
    assert all(np.isfinite(float(r[1])) for r in log[1:])
    with open(os.path.join(run, "fit_timing.json")) as f:
        timing = json.load(f)
    assert len(timing["densify_ms"]) == 1 and timing["start_step"] == 1
    for step in (30, FIT_STEPS):
        assert os.path.isfile(os.path.join(
            run, "point_cloud", f"iteration_{step}", "point_cloud.ply"))
        assert os.path.isfile(os.path.join(run, "checkpoints",
                                           f"step_{step}", "state.pt"))
        with open(os.path.join(run, "checkpoints", f"step_{step}",
                               "fit_meta.json")) as f:
            meta = json.load(f)
        assert meta["step"] == step and meta["capacity"] == 16384
    with open(os.path.join(run, "metrics", "val.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["name", "psnr", "ssim", "lpips(unavailable)"]
    assert rows[-1][0] == "MEAN" and len(rows) == N_VIEWS + 2
    assert float(rows[-1][1]) == pytest.approx(results["psnr"])

    # validate through the CLI: the snapshot, then the newest checkpoint
    vstate, vres = cli.main(["validate", "--output", out, "-n", "run",
                             "--device", "cpu"])
    assert vstate.step == FIT_STEPS
    assert vres["psnr"] == pytest.approx(results["psnr"], abs=1e-6)
    assert len(os.listdir(os.path.join(run, "val"))) == N_VIEWS

    # the loader picks the newest checkpoint and renders it
    loaded, renderer, sh_degree = GaussianModelLoader.load(run, "cpu")
    assert loaded.capacity == state.gaussians.n_alive and sh_degree == 0
    cam = outputs.val_set.cameras[0]
    with torch.no_grad():
        img = renderer.forward(loaded, cam, H, W, torch.zeros(3),
                               sh_degree).render
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.01


def _resume_argv(scene, out, name, steps, resume):
    return _argv("fit", scene, out, name, steps, extra=(
        "model.gaussian.sh_degree=1", "fit.log_interval=2",
        "fit.save_iterations=[]", "fit.save_ply=false",
        f"fit.resume={resume}",
        # densify every 4 steps so the generator is drawn from and its
        # restored state matters
        "model.density.init_args.densify_from_iter=1",
        "model.density.init_args.densification_interval=4",
        "model.density.init_args.opacity_reset_interval=10000"))


def test_resume_is_bit_exact(scene, tmp_path, capsys):
    out = str(tmp_path)
    ref, _ = cli.main(_resume_argv(scene, out, "ref", 16, "never"))
    cli.main(_resume_argv(scene, out, "res", 8, "never"))
    capsys.readouterr()
    res, _ = cli.main(_resume_argv(scene, out, "res", 16, "auto"))
    assert "-> continuing at 9" in capsys.readouterr().out

    assert res.step == ref.step == 16
    assert res.params.capacity == ref.params.capacity
    for k in ("means", "scales", "rotations", "opacities", "shs_dc",
              "shs_rest"):
        assert torch.equal(getattr(res.params, k), getattr(ref.params, k)), k
        assert torch.equal(res.opt_state.exp_avg[k],
                           ref.opt_state.exp_avg[k]), k
        assert torch.equal(res.opt_state.exp_avg_sq[k],
                           ref.opt_state.exp_avg_sq[k]), k
    assert res.opt_state.count == ref.opt_state.count == 16
    assert torch.equal(res.alive, ref.alive)
    assert ref.gaussians.n_alive != 400            # the densifies ran
    # the resumed log appends to the first run's, and both logs agree
    got, want = _log(os.path.join(out, "res")), _log(os.path.join(out, "ref"))
    assert [r[:3] for r in got] == [r[:3] for r in want]
    assert len(got) == 9


def test_resume_from_a_missing_path_fails_fast(scene, tmp_path):
    with pytest.raises(FileNotFoundError, match="fit.resume"):
        cli.main(_argv("fit", scene, str(tmp_path), "run", 4,
                       extra=(f"fit.resume={tmp_path / 'nowhere'}",)))


# overrides that put a 3D-filter recompute into the 4 steps (the densify,
# or the MCMC relocation round, at step 3 comes from the common ones)
VARIANT_EXTRA = {"mip_splatting.yaml": (
    "model.gaussian.init_args.filter_3d_update_interval=2",)}
APPEARANCE_PRESETS = ("appearance_embedding.yaml",
                      "appearance_visibility_map.yaml",
                      "appearance_visibility_map_hash.yaml", "swag.yaml")
for _p in APPEARANCE_PRESETS:
    # the preset names the model's class, so its fields go in init_args
    VARIANT_EXTRA[_p] = ("model.gaussian.init_args.sh_degree=1",)
# GNS's budget per scene, and its curve past the 400 points at step 3;
# Taming's round at 3 its second (the first is the initial count); a
# LightGaussian prune inside the 4 steps
VARIANT_EXTRA["gns.yaml"] = ("model.density.init_args.budget=1000",
                             "model.density.init_args.densify_until_iter=10")
VARIANT_EXTRA["taming.yaml"] = (
    "model.density.init_args.densify_from_iter=0",
    "model.density.init_args.densify_until_iter=10")
VARIANT_EXTRA["light_gaussian.yaml"] = ("fit.lg_prune_steps=[2]",)
# the deformation field trains from step 2 (the MLP at 4 x 32 for the
# CPU); PVG's preset names the model's class
for _p in ("deformable.yaml", "gs4d.yaml"):
    VARIANT_EXTRA[_p] = ("model.deform.init_args.warm_up=2",
                         "model.deform.init_args.n_neurons=32",
                         "model.deform.init_args.n_layers=4",
                         "model.deform.init_args.skip_layers=[2]")
VARIANT_EXTRA["pvg.yaml"] = ("model.gaussian.init_args.sh_degree=1",)


# the renderer is the one the loader serves the run with: gsl_tpu's
# loader, and so the port's, serves every 3DGS checkpoint through a plain
# TileRenderer
@pytest.mark.parametrize("preset,renderer", [
    ("gs2d.yaml", "SurfelRenderer"), ("stp.yaml", "TileRenderer"),
    ("absgrad.yaml", "TileRenderer"), ("mip_splatting.yaml", "TileRenderer"),
    ("mcmc.yaml", "TileRenderer"),
    # the Blender scene has no depth maps: the depth trainer's term is
    # absent (tests/test_torch_depth.py fits a scene with them)
    ("depth_regularization.yaml", "TileRenderer"),
    ("normal_reg.yaml", "TileRenderer"), ("ground_reg.yaml", "TileRenderer"),
    ("scale_reg.yaml", "TileRenderer"),
    # validation and the loader render SH colours, without the appearance
    # network or the output processor, as gsl_tpu's do
    ("appearance_embedding.yaml", "TileRenderer"),
    ("appearance_visibility_map.yaml", "TileRenderer"),
    ("appearance_visibility_map_hash.yaml", "TileRenderer"),
    ("swag.yaml", "TileRenderer"), ("bilagrid.yaml", "TileRenderer"),
    ("exposure.yaml", "TileRenderer"), ("grad_acc.yaml", "TileRenderer"),
    ("revising.yaml", "TileRenderer"), ("taming.yaml", "TileRenderer"),
    ("gns.yaml", "TileRenderer"), ("light_gaussian.yaml", "TileRenderer"),
    # validation renders SH colours without the specular term, as
    # gsl_tpu's does
    ("glossy.yaml", "TileRenderer"),
    # validation renders the canonical set for the deform presets, and
    # the loader serves PVG through a plain TileRenderer (a PVG PLY is
    # static)
    ("deformable.yaml", "TileRenderer"), ("gs4d.yaml", "TileRenderer"),
    ("pvg.yaml", "TileRenderer")])
def test_variant_presets_fit_through_the_cli(scene, tmp_path, capsys,
                                             preset, renderer):
    extra = VARIANT_EXTRA.get(preset, ())
    state, results = cli.main(_argv(
        "fit", scene, str(tmp_path), "run", 4, preset=preset, extra=(
            "model.gaussian.sh_degree=1", "fit.log_interval=1",
            "model.density.init_args.densify_from_iter=1",
            "model.density.init_args.densification_interval=3", *extra)))
    log = _log(os.path.join(str(tmp_path), "run"))
    assert len(log) == 5 and all(np.isfinite(float(r[1])) for r in log[1:])
    assert int(log[-1][2]) != 400                   # the densify at 3 ran
    assert np.isfinite(results["psnr"])
    _, got_renderer, _ = GaussianModelLoader.load(
        os.path.join(str(tmp_path), "run"), "cpu")
    assert type(got_renderer).__name__ == renderer
    assert state.params.scales.shape[1] == (2 if preset == "gs2d.yaml"
                                            else 3)
    if preset == "stp.yaml":
        assert got_renderer.config.stp_resort is False   # a loader default
    with open(os.path.join(str(tmp_path), "run", "fit_timing.json")) as f:
        (d,) = json.load(f)["densify"]
    if preset == "mcmc.yaml":
        # 5% more (float32 rounds 1.05 x 400 to 419), no dead row
        assert int(log[2][2]) == 400 and int(log[3][2]) == 419
        assert d == {"step": 3, "before": 400, "dead": 0, "added": 19,
                     "after": 419}
        assert type(cli.build_components(cli.load_config(
            [os.path.join(REPO, "gsl_tpu_torch", "configs", preset)], {}))[
                0].metrics_cfg).__name__ == "MCMCMetricsConfig"
    elif preset == "gns.yaml":
        # the budget curve's point at step 3 holds every candidate
        assert d["budget"] > d["after"] == d["before"] + d["net"] > 400
    else:
        assert d["after"] == d["before"] + d["clone"] + d["split"] \
            - d["pruned"]
    if preset == "mip_splatting.yaml":
        # recomputed at step 2 over the rows alive then; the densify at 3
        # copied it into the new rows
        f3d = state.extra["filter_3d"]
        assert f3d.shape == (state.params.capacity, 1)
        assert bool((f3d[state.alive] > 0).all())
    elif preset in APPEARANCE_PRESETS:
        # the networks sized from the data: the Blender parser gives every
        # image appearance id 0; the features followed the densify
        n_vis = "visibility" in preset
        assert sorted(state.extra) == ["__net__"] + ["__vis__"] * n_vis
        emb = state.extra["__net__"]["params"]["embedding.weight"]
        assert emb.shape == (1, 32)
        assert state.params.appearance_features.shape == (
            state.params.capacity, 64)
        assert state.opt_state.exp_avg["appearance_features"].shape == (
            state.params.capacity, 64)
    elif preset in ("bilagrid.yaml", "exposure.yaml"):
        assert sorted(state.extra) == ["__outproc__", "__outproc_opt__"]
        assert state.extra["__outproc__"].shape[0] == N_VIEWS
        assert state.extra["__outproc_opt__"]["count"] == 4
    elif preset == "glossy.yaml":
        # the map and its Adam; the metalness is a property of the rows
        assert sorted(state.extra) == ["__glossy__"]
        assert state.extra["__glossy__"]["opt"]["count"] == 4
        assert state.params.metalness.shape == (state.params.capacity,)
        assert float(state.params.metalness[state.alive].std()) > 0
    elif preset == "gns.yaml":
        assert sorted(state.extra) == ["__gns__"]
    elif preset in ("deformable.yaml", "gs4d.yaml"):
        # three field updates (steps 2-4); the field's widths
        assert sorted(state.extra) == ["__deform__"]
        net = state.extra["__deform__"]
        assert net["opt"]["count"] == 3
        assert net["params"]["layers.0.weight"].shape == (
            (32, 72) if preset == "deformable.yaml" else (64, 32))
    else:
        assert state.extra is None
    if preset == "pvg.yaml":
        assert state.params.t_centers.shape == (state.params.capacity, 1)
        assert float(state.params.velocities[state.alive].abs().max()) > 0
    said = capsys.readouterr().out
    if preset == "light_gaussian.yaml":
        # 60% of the 400 alive at step 2
        assert "[fit] LightGaussian pruned 240 at 2" in said
        assert int(log[2][2]) == 160
    if preset == "taming.yaml":
        # the curve from the initial count to 20 x 400 over 4 rounds
        from gsl_tpu_torch.training.taming import get_count_array
        assert d["budget"] == get_count_array(400, 20, 10, 0, 3)[1]
        assert 400 < d["after"] <= d["budget"]


def _variant_resume_argv(scene, out, name, resume, preset):
    return _argv("fit", scene, out, name, 16, preset=preset, extra=(
        "model.gaussian.sh_degree=1", "fit.log_interval=2",
        "fit.save_iterations=[8]", "fit.save_ply=false",
        f"fit.resume={resume}",
        "model.density.init_args.densify_from_iter=1",
        "model.density.init_args.densification_interval=4",
        "model.gaussian.init_args.filter_3d_update_interval=3"
        if preset == "mip_splatting.yaml"
        else "model.density.init_args.cap_max=1000000"))


@pytest.mark.parametrize("preset", ["mip_splatting.yaml", "mcmc.yaml"])
def test_variant_resume_is_bit_exact(scene, tmp_path, capsys, preset):
    """A 16-step run, and a second run of 16 steps resumed from the
    first's checkpoint at step 8: the same parameters, moments and alive
    rows, and for Mip-Splatting the same filter_3d (recomputed at 3, 6, 9
    and 12; the one of step 6 comes from the checkpoint); the MCMC noise
    and relocation draw from the checkpoint's generator. Both runs end at
    16: the filter recompute (while step + interval <= max_steps) and the
    noise (step < max_steps) follow the run's last step, as gsl_tpu's
    do, so a run that stops at 8 skips what a run to 16 does at 6 and 8."""
    out = str(tmp_path)
    ref, _ = cli.main(_variant_resume_argv(scene, out, "ref", "never",
                                           preset))
    step_8 = os.path.join(out, "ref", "checkpoints", "step_8")
    saved = torch.load(os.path.join(step_8, "state.pt"), weights_only=True)
    capsys.readouterr()
    res, _ = cli.main(_variant_resume_argv(scene, out, "res", step_8,
                                           preset))
    assert "-> continuing at 9" in capsys.readouterr().out
    for k in ("means", "scales", "rotations", "opacities", "shs_dc",
              "shs_rest"):
        assert torch.equal(getattr(res.params, k), getattr(ref.params, k)), k
        assert torch.equal(res.opt_state.exp_avg[k],
                           ref.opt_state.exp_avg[k]), k
    assert torch.equal(res.alive, ref.alive)
    if preset == "mip_splatting.yaml":
        assert torch.equal(res.extra["filter_3d"], ref.extra["filter_3d"])
        assert saved["extra"]["filter_3d"].shape == (16384, 1)
    else:
        assert saved["extra"] is None and res.extra is None
        assert ref.gaussians.n_alive > 400      # the rounds grew it


def _gns_argv(scene, out, name, resume):
    return _argv("fit", scene, out, name, 16, preset="gns.yaml", extra=(
        "model.gaussian.sh_degree=1", "fit.log_interval=2",
        "fit.save_iterations=[10]", "fit.save_ply=false",
        f"fit.resume={resume}", "model.density.init_args.budget=500",
        "model.density.init_args.densify_from_iter=1",
        "model.density.init_args.densification_interval=3",
        "model.density.init_args.densify_until_iter=8",
        "model.density.init_args.opacity_reg_from=8",
        "model.density.init_args.opacity_reg_until=14"))


def test_gns_resume_across_its_regularisation_phase_is_bit_exact(
        scene, tmp_path, capsys):
    """GNS on 400 points with a budget of 500: densifies at 3 and 6 grow
    it past the budget, the regularisation phase runs from 8 to 14 with
    its opacity term and x4 opacity updates, and the final prune at 14
    keeps 500. A second run resumed at step 10, inside the phase, from the
    first's checkpoint ends bit for bit where the first did: its hooks
    read the resumed count (past the budget, where the point cloud's 400
    is under it) and the controller's state from the checkpoint."""
    out = str(tmp_path)
    ref, _ = cli.main(_gns_argv(scene, out, "ref", "never"))
    step_10 = os.path.join(out, "ref", "checkpoints", "step_10")
    saved = torch.load(os.path.join(step_10, "state.pt"), weights_only=True)
    assert saved["extra"]["__gns__"]["final_pruned"] is False
    assert int(saved["alive"].sum()) > 500
    capsys.readouterr()
    res, _ = cli.main(_gns_argv(scene, out, "res", step_10))
    said = capsys.readouterr().out
    assert "-> continuing at 11" in said
    assert "[fit] GNS final prune at 14 -> 500" in said
    assert res.gaussians.n_alive == ref.gaussians.n_alive == 500
    for k in PARAM_FIELDS_3DGS:
        assert torch.equal(getattr(res.params, k), getattr(ref.params, k)), k
        assert torch.equal(res.opt_state.exp_avg[k],
                           ref.opt_state.exp_avg[k]), k
        assert torch.equal(res.opt_state.exp_avg_sq[k],
                           ref.opt_state.exp_avg_sq[k]), k
    assert torch.equal(res.alive, ref.alive)
    assert res.extra["__gns__"] == ref.extra["__gns__"] == {
        "reg_weight": 2e-4, "opacity_min": None, "final_pruned": True,
        "prune_step": 14}


@pytest.mark.parametrize("preset", ["appearance_embedding.yaml",
                                    "bilagrid.yaml"])
def test_appearance_and_processor_resume_is_bit_exact(scene, tmp_path,
                                                      capsys, monkeypatch,
                                                      preset):
    """As above for an appearance run (its warm-up cut to 3 steps, so the
    network trains from step 3; the similarity step every 5 steps) and a
    bilateral-grid run: the Gaussians with their appearance features, the
    network's weights and Adam state, the grids and their Adam state,
    and the features' own Adam count all come back from step 8."""
    build = cli.build_components

    def build_short_warm_up(cfg):
        trainer, dp, fit_cfg = build(cfg)
        if hasattr(trainer, "appearance_opt"):
            trainer.appearance_opt.warm_up = 3
        return trainer, dp, fit_cfg

    monkeypatch.setattr(cli, "build_components", build_short_warm_up)
    sim = ("model.similarity_reg.similarity_reg_interval=5",
           "model.similarity_reg.n_appearance_samples=64",
           "model.gaussian.init_args.sh_degree=1") \
        if preset == "appearance_embedding.yaml" else ()

    def argv(name, resume):
        return _argv("fit", scene, out, name, 16, preset=preset, extra=(
            "model.gaussian.sh_degree=1", "fit.log_interval=2",
            "fit.save_iterations=[8]", "fit.save_ply=false",
            f"fit.resume={resume}",
            "model.density.init_args.densify_from_iter=1",
            "model.density.init_args.densification_interval=4", *sim))

    out = str(tmp_path)
    ref, _ = cli.main(argv("ref", "never"))
    step_8 = os.path.join(out, "ref", "checkpoints", "step_8")
    capsys.readouterr()
    res, _ = cli.main(argv("res", step_8))
    assert "-> continuing at 9" in capsys.readouterr().out
    assert res.params.fields() == ref.params.fields()
    for k in ref.params.fields():
        assert torch.equal(getattr(res.params, k), getattr(ref.params, k)), k
        assert torch.equal(res.opt_state.exp_avg[k],
                           ref.opt_state.exp_avg[k]), k
        assert torch.equal(res.opt_state.exp_avg_sq[k],
                           ref.opt_state.exp_avg_sq[k]), k
        assert res.opt_state.count_of(k) == ref.opt_state.count_of(k), k
    assert torch.equal(res.alive, ref.alive)
    assert ref.gaussians.n_alive != 400               # the densifies ran

    def flat(x, prefix=""):
        if isinstance(x, dict):
            return {k2: v2 for k, v in x.items()
                    for k2, v2 in flat(v, f"{prefix}{k}/").items()}
        return {prefix: x}

    got, want = flat(res.extra), flat(ref.extra)
    assert got.keys() == want.keys()
    for k in want:
        assert (torch.equal(got[k], want[k])
                if isinstance(want[k], torch.Tensor)
                else got[k] == want[k]), k
    if preset == "appearance_embedding.yaml":
        # 14 network updates (steps 3-16) and 3 similarity steps (5, 10,
        # 15) of the features alone
        assert want["__net__/opt/count/"] == 14
        assert ref.opt_state.solo_counts == {"appearance_features": 3}
    else:
        assert want["__outproc_opt__/count/"] == 16
        assert not torch.equal(want["__outproc__/"],
                               _identity_grids(N_VIEWS))


def _identity_grids(n):
    from gsl_tpu_torch.training.output_processors import (
        BilateralGridConfig, init_bilateral_grids)
    return init_bilateral_grids(BilateralGridConfig(n_images=n))


@pytest.mark.parametrize("preset,extra", [
    ("mip_splatting.yaml",
     ("model.gaussian.init_args.filter_3d_update_interval=2",)),
    ("mcmc.yaml", ("model.density.init_args.densify_from_iter=1",
                   "model.density.init_args.densification_interval=3"))])
def test_colmap_variant_fit_and_validate_through_the_cli(tmp_path, preset,
                                                         extra):
    """`cli fit --config colmap.yaml --config <variant>` on a COLMAP scene
    for 4 steps (a filter recompute at 2, or a relocation round at 3),
    then `cli validate` of the run: its snapshot builds the variant's
    model again, and the checkpoint brings its state back."""
    root = str(tmp_path / "colmap")
    make_colmap_dataset(root)
    configs = [os.path.join(REPO, "gsl_tpu_torch", "configs", p)
               for p in ("colmap.yaml", preset)]
    out = str(tmp_path / "runs")
    state, results = cli.main([
        "fit", "--config", configs[0], "--config", configs[1],
        "--data.path", root, "--output", out, "-n", "run", "--max_steps",
        "4", "--device", "cpu", "fit.min_capacity=1024",
        "fit.log_interval=1", "model.gaussian.sh_degree=1", *extra])
    log = _log(os.path.join(out, "run"))
    assert len(log) == 5 and all(np.isfinite(float(r[1])) for r in log[1:])
    assert np.isfinite(results["psnr"])
    vstate, vres = cli.main(["validate", "--output", out, "-n", "run",
                             "--device", "cpu"])
    assert vres["psnr"] == pytest.approx(results["psnr"], abs=1e-6)
    assert torch.equal(vstate.alive, state.alive)
    if preset == "mcmc.yaml":
        # 5% more: float32 rounds 1.05 x 200 to 209
        assert int(log[-1][2]) == 209 > int(log[2][2]) == 200
        assert vstate.extra is None
    else:
        assert torch.equal(vstate.extra["filter_3d"],
                           state.extra["filter_3d"])
