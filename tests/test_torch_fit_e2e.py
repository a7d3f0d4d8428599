"""End to end through gsl_tpu_torch's CLI on the CPU, the port alone: a
small Blender-style scene rendered by the port is fitted with one densify,
validated and resumed; the 2DGS and StopThePop presets take a few steps."""
import csv
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gsl_tpu_torch import cli
from gsl_tpu_torch.data.cameras import make_camera
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


def make_dataset(root, n_views=N_VIEWS):
    """Render a known scene with the port to PNGs + transforms_train.json
    (cameras along x, looking +z, as tests/test_fit_e2e.py places them)."""
    state = state_from_raw_arrays(_scene_arrays(), device="cpu")
    renderer = TileRendererConfig().instantiate()
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    fov_x = 0.8
    f = 0.5 * W / np.tan(0.5 * fov_x)
    frames = []
    for i in range(n_views):
        T = np.array([0.25 * i - 0.6, 0.0, 0.0], np.float32)
        cam = make_camera(np.eye(3), T, f, f, W / 2, H / 2, W, H,
                          device="cpu")
        with torch.no_grad():
            out = renderer.forward(state, cam, H, W, torch.zeros(3), 0)
        img = (np.clip(out.render.numpy(), 0, 1) * 255).astype(np.uint8)
        name = f"train/r_{i}"
        Image.fromarray(img).save(os.path.join(root, name + ".png"))
        c2w = np.eye(4)
        c2w[:3, 3] = -T
        c2w[:3, 1:3] *= -1          # OpenCV -> OpenGL; the parser flips back
        frames.append({"file_path": name, "transform_matrix": c2w.tolist()})
    with open(os.path.join(root, "transforms_train.json"), "w") as fjs:
        json.dump({"camera_angle_x": fov_x, "frames": frames}, fjs)


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


@pytest.mark.parametrize("preset,renderer", [
    ("gs2d.yaml", "SurfelRenderer"), ("stp.yaml", "TileRenderer")])
def test_variant_presets_fit_through_the_cli(scene, tmp_path, preset,
                                             renderer):
    state, results = cli.main(_argv(
        "fit", scene, str(tmp_path), "run", 4, preset=preset, extra=(
            "model.gaussian.sh_degree=1", "fit.log_interval=1",
            "model.density.init_args.densify_from_iter=1",
            "model.density.init_args.densification_interval=3")))
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
