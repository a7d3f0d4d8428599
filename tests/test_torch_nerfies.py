"""gsl_tpu_torch's Nerfies parser against gsl_tpu's on a synthesised
scene, and the dynamic presets fitted through the port's CLI on it.

The scene: a PVG ground truth (a static cloud and a part that vibrates
and fades with time) rendered by the port's PVGRenderer from cameras
along x with small yaws, each at its own time, written as Nerfies writes
a capture (``dataset.json``, ``scene.json`` with a scale and a centre,
``camera/<id>.json``, ``rgb/1x/<id>.png``, ``metadata.json`` time ids and
``points.npy``). gsl_tpu has no test of this parser; these hold the
port's to it, and check its camera convention against a render: the
cameras it parses are the ones that rendered the images."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gsl_tpu.data.dataparsers.nerfies import \
    NerfiesDataParserConfig as JaxNerfiesConfig

from gsl_tpu_torch import cli
from gsl_tpu_torch.data.cameras import make_camera
from gsl_tpu_torch.data.dataparsers.nerfies import NerfiesDataParserConfig
from gsl_tpu_torch.data.dataset import CachedDataset, DataLoader
from gsl_tpu_torch.models.pvg import PVGRendererConfig
from gsl_tpu_torch.training.deform_trainer import DeformTrainer
from gsl_tpu_torch.training.fit import _init_gaussians, validate
from gsl_tpu_torch.utils.convert import state_from_jax_arrays

# the port's tests work on small tensors in long Python loops, where
# several intra-op threads per test worker gain nothing
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 48, 64
FOCAL = 60.0
N_VIEWS = 8
N_STATIC, N_MOVING = 220, 60
SCENE_SCALE, SCENE_CENTER = 2.0, np.array([0.3, -0.2, 0.5])
PVG_FIELDS = ("t_centers", "t_scales", "velocities")


def truth_arrays(seed=4):
    """The ground truth in the parser's (normalised) coordinates: a
    static cloud (life span e^3, no velocity) and a moving part (velocities
    of 6 a unit time, life peaks spread over [0, 1], spans 0.3-0.6)."""
    rng = np.random.RandomState(seed)
    n = N_STATIC + N_MOVING
    means = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)),
                            rng.uniform(2.0, 5.0, (n, 1))], -1)
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.3, 0.9, n)
    colors = rng.uniform(0.0, 1.0, (n, 3))
    moving = np.arange(n) >= N_STATIC
    out = dict(
        means=means, scales=rng.uniform(-3.3, -2.0, (n, 3)),
        rotations=quats, opacities=np.log(opac / (1 - opac))[:, None],
        shs_dc=((colors - 0.5) / 0.28209479177387814)[:, None, :],
        shs_rest=np.zeros((n, 0, 3)),
        t_centers=np.where(moving, rng.uniform(0, 1, n), 0.5)[:, None],
        t_scales=np.where(moving, np.log(rng.uniform(0.3, 0.6, n)),
                          3.0)[:, None],
        velocities=rng.normal(size=(n, 3)) * 6.0 * moving[:, None])
    return {k: v.astype(np.float32) for k, v in out.items()}


def view_pose(i, n_views=N_VIEWS):
    """(world-to-camera R, camera centre) of view i: along x, a yaw of up
    to 8 degrees about y."""
    yaw = np.deg2rad(-8.0 + 16.0 * i / max(n_views - 1, 1))
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])
    return R, np.array([0.2 * i - 0.7, 0.05 * i, -0.1])


def make_nerfies_dataset(root, n_views=N_VIEWS, points=True, val=True,
                         metadata=True, images=True):
    """Write the scene as a Nerfies capture; every third view goes to
    val. Returns the ground truth's arrays and the views' times."""
    arrays = truth_arrays()
    state = state_from_jax_arrays(arrays, np.ones(len(arrays["means"]),
                                                  bool), device="cpu")
    renderer = PVGRendererConfig().instantiate()
    ids = [f"frame_{i:03d}" for i in range(n_views)]
    times = [i / (n_views - 1) for i in range(n_views)]
    os.makedirs(os.path.join(root, "camera"), exist_ok=True)
    os.makedirs(os.path.join(root, "rgb", "1x"), exist_ok=True)
    for i, iid in enumerate(ids):
        R, centre = view_pose(i, n_views)
        cam = {"orientation": R.tolist(),
               "position": (centre / SCENE_SCALE + SCENE_CENTER).tolist(),
               "focal_length": FOCAL, "pixel_aspect_ratio": 1.0,
               "principal_point": [W / 2.0, H / 2.0],
               "image_size": [W, H],
               "radial_distortion": [0.05, -0.01, 0.0],
               "tangential_distortion": [0.001, -0.002], "skew": 0.0}
        with open(os.path.join(root, "camera", f"{iid}.json"), "w") as f:
            json.dump(cam, f)
        if images:
            view = make_camera(R, -R @ centre, FOCAL, FOCAL, W / 2.0,
                               H / 2.0, W, H, time=times[i], device="cpu")
            with torch.no_grad():
                img = renderer.forward(state, view, H, W, torch.zeros(3),
                                       0).render
            Image.fromarray((np.clip(img.numpy(), 0, 1) * 255 + 0.5).astype(
                np.uint8)).save(os.path.join(root, "rgb", "1x",
                                             f"{iid}.png"))
    val_ids = ids[1::3] if val else []
    train_ids = [i for i in ids if i not in val_ids]
    with open(os.path.join(root, "dataset.json"), "w") as f:
        json.dump({"count": n_views, "num_exemplars": len(train_ids),
                   "ids": ids, "train_ids": train_ids,
                   "val_ids": val_ids}, f)
    with open(os.path.join(root, "scene.json"), "w") as f:
        json.dump({"scale": SCENE_SCALE, "center": SCENE_CENTER.tolist(),
                   "near": 0.5, "far": 8.0}, f)
    if metadata:
        with open(os.path.join(root, "metadata.json"), "w") as f:
            json.dump({iid: {"time_id": i, "warp_id": i, "appearance_id": i,
                             "camera_id": 0} for i, iid in enumerate(ids)},
                      f)
    if points:
        np.save(os.path.join(root, "points.npy"),
                (arrays["means"].astype(np.float64) / SCENE_SCALE
                 + SCENE_CENTER).astype(np.float32))
    return arrays, times


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nerfies"))
    make_nerfies_dataset(root)
    return root


# ---- the parser -----------------------------------------------------------------

def _cameras_equal(got, want):
    for k in ("R", "T", "fx", "fy", "cx", "cy", "time"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    for k in ("width", "height", "appearance_id"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)


@pytest.mark.parametrize("variant", ["full", "bare", "downsampled"])
def test_nerfies_parser_matches_jax(tmp_path, variant):
    """The port's outputs against gsl_tpu's: names, paths, every camera
    field (times among them), the cloud, the extent and the splits, on
    the full scene; without points.npy (gsl_tpu's RandomState(42) cloud),
    val ids (the first train id validates) or metadata (every time 0);
    and at downsample 2 without the images (their size from the camera's
    image_size)."""
    root = str(tmp_path)
    full = variant == "full"
    make_nerfies_dataset(root, points=full, val=full, metadata=full,
                         images=variant != "downsampled")
    kw = dict(path=root, random_point_count=500)
    if variant == "downsampled":
        kw["downsample"] = 2
    got = NerfiesDataParserConfig(**kw).instantiate().get_outputs()
    want = JaxNerfiesConfig(**kw).instantiate().get_outputs()
    for split in ("train_set", "val_set", "test_set"):
        g, w = getattr(got, split), getattr(want, split)
        assert g.image_names == w.image_names
        assert g.image_paths == w.image_paths
        _cameras_equal(g.cameras, w.cameras)
    np.testing.assert_array_equal(got.point_cloud.xyz, want.point_cloud.xyz)
    np.testing.assert_array_equal(got.point_cloud.rgb, want.point_cloud.rgb)
    assert got.camera_extent == pytest.approx(want.camera_extent, rel=1e-6)
    assert got.test_set.image_names == got.val_set.image_names
    times = np.concatenate([got.train_set.cameras.time.numpy(),
                            got.val_set.cameras.time.numpy()])
    if full:
        assert len(got.point_cloud.xyz) == N_STATIC + N_MOVING
        assert got.val_set.image_names == [
            f"frame_{i:03d}.png" for i in range(1, N_VIEWS, 3)]
        assert times.min() == 0.0 and times.max() == 1.0
    else:
        assert len(got.point_cloud.xyz) == 500
        assert got.val_set.image_names == got.train_set.image_names[:1]
        assert float(np.abs(times).max()) == 0.0
    if variant == "downsampled":
        assert int(got.train_set.cameras.width[0]) == W // 2
        assert float(got.train_set.cameras.fx[0]) == FOCAL / 2


def test_the_parsed_cameras_rendered_the_images(scene):
    """The camera convention against a render: the parser's cameras are
    the world-to-camera poses that rendered each image (the orientation's
    rows as R, the position through the scene's scale and centre), its
    cloud the ground truth's means, and the ground truth rendered from
    them at their times gives each image back (within its 8-bit
    rounding)."""
    outputs = NerfiesDataParserConfig(path=scene).instantiate().get_outputs()
    arrays = truth_arrays()
    np.testing.assert_allclose(outputs.point_cloud.xyz, arrays["means"],
                               atol=1e-5)
    state = state_from_jax_arrays(arrays, np.ones(len(arrays["means"]),
                                                  bool), device="cpu")
    renderer = PVGRendererConfig().instantiate()
    for split in (outputs.train_set, outputs.val_set):
        for i, name in enumerate(split.image_names):
            k = int(name[6:9])
            R, centre = view_pose(k)
            cam = split.cameras[i]
            np.testing.assert_allclose(cam.R.numpy(), R, atol=1e-6)
            np.testing.assert_allclose(cam.camera_center.numpy(), centre,
                                       atol=1e-5)
            assert float(cam.time) == pytest.approx(k / (N_VIEWS - 1))
            with torch.no_grad():
                img = renderer.forward(state, cam, H, W, torch.zeros(3),
                                       0).render.numpy()
            saved = np.asarray(Image.open(split.image_paths[i]),
                               np.float32) / 255.0
            assert float(np.abs(img - saved).max()) <= 0.5 / 255 + 1e-5


def test_each_view_reaches_the_step_at_its_time(scene, tmp_path,
                                                monkeypatch):
    """The loader hands out each train view with its camera's time, and
    the fit's deform step receives that time."""
    outputs = NerfiesDataParserConfig(path=scene).instantiate().get_outputs()
    by_name = dict(zip(outputs.train_set.image_names,
                       outputs.train_set.cameras.time.tolist()))
    loader = iter(DataLoader(CachedDataset(outputs.train_set), seed=1))
    for _ in range(len(by_name)):
        cam, name, _, _ = next(loader)
        assert float(cam.time) == by_name[name]
    loader.close()
    seen = []
    step = DeformTrainer.train_step_deform

    def spy(self, state, camera, *args, **kwargs):
        seen.append(float(camera.time))
        return step(self, state, camera, *args, **kwargs)

    monkeypatch.setattr(DeformTrainer, "train_step_deform", spy)
    cli.main(_argv(scene, str(tmp_path), "spy", 6, "gs4d.yaml",
                   ("fit.save_iterations=[]", "fit.save_ply=false")))
    assert len(seen) == 6 and set(seen) <= set(by_name.values())
    assert len(set(seen)) > 1


# ---- the presets through the CLI ------------------------------------------------

# the MLP at 4 x 32 with its skip at 2 for the CPU; the presets' own
# schedule otherwise, the warm-up cut
SMALL_MLP = ("model.deform.init_args.n_neurons=32",
             "model.deform.init_args.n_layers=4",
             "model.deform.init_args.skip_layers=[2]")


def _preset(preset):
    return os.path.join(REPO, "gsl_tpu_torch", "configs", preset)


def _overrides(preset, extra=(), interval=4):
    return ["data.parser.class_path=Nerfies",
            "trainer.background_color=[0.0, 0.0, 0.0]",
            "fit.min_capacity=1024", "fit.log_interval=2",
            "model.density.init_args.densify_from_iter=1",
            f"model.density.init_args.densification_interval={interval}",
            *(SMALL_MLP if preset == "deformable.yaml" else ()),
            *(("model.deform.init_args.warm_up=5",)
              if preset != "pvg.yaml" else
              ("model.gaussian.init_args.sh_degree=0",)), *extra]


def _argv(scene, out, name, steps, preset, extra=(), interval=4):
    return ["fit", "--config", _preset(preset), "--data.path", scene,
            "--output", out, "-n", name, "--max_steps", str(steps),
            "--device", "cpu", *_overrides(preset, extra, interval)]


# the splats are large against this scene's camera extent, so every
# densify splits nearly every row: two densifies keep the fit small
FIT_STEPS, FIT_INTERVAL = 30, 10


@pytest.mark.parametrize("preset", ["deformable.yaml", "gs4d.yaml",
                                    "pvg.yaml"])
def test_dynamic_presets_fit_a_nerfies_scene(scene, tmp_path, preset):
    """Each preset fitted for 30 steps with densifies at 10 and 20 and the
    warm-up at 5: losses finite, the field or PVG's properties trained,
    and the validation PSNR above the initial cloud's (for the deform
    presets that is the canonical set's: validation renders it
    undeformed, as gsl_tpu's does)."""
    trainer, dp_cfg, fit_cfg = cli.build_components(cli.load_config(
        [_preset(preset)], cli.parse_overrides(_overrides(
            preset, interval=FIT_INTERVAL) + [f"data.path={scene}"])))
    outputs = dp_cfg.instantiate().get_outputs()
    fit_cfg.output_dir = str(tmp_path / "initial")
    gaussians = _init_gaussians(trainer, outputs, fit_cfg, "cpu")
    psnr0 = validate(trainer, trainer.setup(gaussians,
                                            outputs.camera_extent),
                     outputs, fit_cfg)["psnr"]
    state, results = cli.main(_argv(scene, str(tmp_path), "run", FIT_STEPS,
                                    preset, interval=FIT_INTERVAL))
    assert state.step == FIT_STEPS
    assert results["psnr"] > psnr0, (results["psnr"], psnr0)
    print(f"{preset}: val PSNR {psnr0:.3f} -> {results['psnr']:.3f} dB")
    if preset == "pvg.yaml":
        assert state.params.fields()[-3:] == PVG_FIELDS
        assert float(state.params.velocities[state.alive].abs().max()) > 0
        assert state.extra is None
    else:
        net = state.extra["__deform__"]
        assert sorted(state.extra) == ["__deform__"]
        assert net["opt"]["count"] == FIT_STEPS - 4       # steps 5-30
        assert max(float(v.abs().max())
                   for k, v in net["params"].items()
                   if k.startswith("layers.4" if preset == "deformable.yaml"
                                   else "layers.2")) > 0


def _resume_argv(scene, out, name, preset, resume):
    return _argv(scene, out, name, 12, preset, (
        "fit.save_iterations=[3]", "fit.save_ply=false",
        f"fit.resume={resume}"))


@pytest.mark.parametrize("preset", ["deformable.yaml", "gs4d.yaml",
                                    "pvg.yaml"])
def test_dynamic_resume_is_bit_exact(scene, tmp_path, capsys, preset):
    """A 12-step run, and a second resumed from the first's checkpoint at
    step 3, before the deform warm-up ends at 5 (so the field first
    trains after the resume, its AST noise drawn from the checkpoint's
    generator): the same Gaussians, moments and alive rows, the same
    field and its Adam state, bit for bit."""
    out = str(tmp_path)
    ref, _ = cli.main(_resume_argv(scene, out, "ref", preset, "never"))
    step_3 = os.path.join(out, "ref", "checkpoints", "step_3")
    saved = torch.load(os.path.join(step_3, "state.pt"), weights_only=True)
    capsys.readouterr()
    res, _ = cli.main(_resume_argv(scene, out, "res", preset, step_3))
    assert "-> continuing at 4" in capsys.readouterr().out
    assert res.params.fields() == ref.params.fields()
    for k in ref.params.fields():
        assert torch.equal(getattr(res.params, k), getattr(ref.params, k)), k
        assert torch.equal(res.opt_state.exp_avg[k],
                           ref.opt_state.exp_avg[k]), k
        assert torch.equal(res.opt_state.exp_avg_sq[k],
                           ref.opt_state.exp_avg_sq[k]), k
    assert torch.equal(res.alive, ref.alive)
    if preset == "pvg.yaml":
        assert saved["extra"] is None and res.extra is None
        assert set(PVG_FIELDS) <= set(saved["params"])
        return
    assert saved["extra"]["__deform__"]["opt"]["count"] == 0
    net, want = res.extra["__deform__"], ref.extra["__deform__"]
    assert net["opt"]["count"] == want["opt"]["count"] == 8     # 5-12
    for part in ("params",):
        for k, v in want[part].items():
            assert torch.equal(net[part][k], v), k
    for m in ("exp_avg", "exp_avg_sq"):
        for k, v in want["opt"][m].items():
            assert torch.equal(net["opt"][m][k], v), k
