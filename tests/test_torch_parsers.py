"""The NSVF, instant-ngp, MatrixCity and SiLVR parsers of gsl_tpu_torch
against gsl_tpu's on scenes written here (the fit tests' views of a known
scene, rendered by the port), and each one fitted through the port's CLI
on the CPU."""
import csv
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gsl_tpu.data.dataparsers.matrix_city import \
    MatrixCityDataParserConfig as JaxMatrixCity
from gsl_tpu.data.dataparsers.ngp import NGPDataParserConfig as JaxNGP
from gsl_tpu.data.dataparsers.nsvf import NSVFDataParserConfig as JaxNSVF
from gsl_tpu.data.dataparsers.silvr import SILVRDataParserConfig as JaxSILVR

from gsl_tpu_torch import cli
from gsl_tpu_torch.data.cameras import make_camera
from gsl_tpu_torch.data.dataparsers.matrix_city import \
    MatrixCityDataParserConfig
from gsl_tpu_torch.data.dataparsers.ngp import NGPDataParserConfig
from gsl_tpu_torch.data.dataparsers.nsvf import NSVFDataParserConfig
from gsl_tpu_torch.data.dataparsers.silvr import SILVRDataParserConfig
from gsl_tpu_torch.renderers.tile_renderer import TileRendererConfig
from gsl_tpu_torch.training.fit import _init_gaussians, validate
from gsl_tpu_torch.utils.convert import state_from_raw_arrays

from test_torch_fit_e2e import FOV_X, H, REPO, W, _render_views, \
    _scene_arrays

CAMERA_FIELDS = ("R", "T", "fx", "fy", "cx", "cy", "width", "height",
                 "appearance_id", "time")
N_VIEWS = 6


def _c2w_gl(T):
    """OpenGL camera-to-world of a camera at -T looking +z."""
    c2w = np.eye(4)
    c2w[:3, 3] = -T
    c2w[:3, 1:3] *= -1
    return c2w


def write_nsvf(root, views, f):
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "pose"))
    for i, (img, T) in enumerate(views):
        split = "1" if i % 3 == 2 else "0"
        name = f"{split}_{i:04d}"
        Image.fromarray(img).save(os.path.join(root, "rgb", name + ".png"))
        np.savetxt(os.path.join(root, "pose", name + ".txt"), _c2w_gl(T))
    with open(os.path.join(root, "intrinsics.txt"), "w") as fh:
        fh.write(f"{f} {W / 2} {H / 2} 0.\n0. 0. 0.\n")
    np.savetxt(os.path.join(root, "bbox.txt"),
               [[-1.0, -1.0, 1.5, 1.0, 1.0, 6.5, 0.05]])


def write_ngp(root, views, f):
    os.makedirs(os.path.join(root, "images"))
    frames = []
    for i, (img, T) in enumerate(views):
        name = f"images/{i:04d}"
        Image.fromarray(img).save(os.path.join(root, name + ".png"))
        # no extension: the parser finds the .png
        frames.append({"file_path": name,
                       "transform_matrix": _c2w_gl(T).tolist()})
    frames[1]["fl_y"] = f + 1.0          # a per-frame intrinsic
    with open(os.path.join(root, "transforms.json"), "w") as fh:
        json.dump({"camera_angle_x": FOV_X, "cx": W / 2, "cy": H / 2,
                   "frames": frames}, fh)


def write_silvr(root, views, f):
    os.makedirs(os.path.join(root, "images"))
    frames = []
    for i, (img, T) in enumerate(views):
        name = f"images/frame_{i:05d}.png"
        Image.fromarray(img).save(os.path.join(root, name))
        frames.append({"file_path": name,
                       "transform_matrix": _c2w_gl(T).tolist(),
                       "w": W, "h": H, "fl_x": f, "fl_y": f,
                       "cx": W / 2, "cy": H / 2})
    with open(os.path.join(root, "transforms.json"), "w") as fh:
        json.dump({"frames": frames}, fh)


def write_matrix_city(root, views, f, depth_files=False):
    """transforms_{train,test}.json beside rgb/ (every third view tests);
    with `depth_files`, an (unreadable) depth/<stem>.exr per train view."""
    os.makedirs(os.path.join(root, "rgb"))
    splits = {"train": [], "test": []}
    for i, (img, T) in enumerate(views):
        name = f"rgb/{i:04d}.png"
        Image.fromarray(img).save(os.path.join(root, name))
        split = "test" if i % 3 == 2 else "train"
        splits[split].append({"file_path": name,
                              "transform_matrix": _c2w_gl(T).tolist()})
        if depth_files and split == "train":
            os.makedirs(os.path.join(root, "depth"), exist_ok=True)
            with open(os.path.join(root, "depth", f"{i:04d}.exr"),
                      "wb") as fh:
                fh.write(b"not an exr file")
    for split, frames in splits.items():
        with open(os.path.join(root, f"transforms_{split}.json"),
                  "w") as fh:
            json.dump({"fl_x": f, "fl_y": f, "cx": W / 2, "cy": H / 2,
                       "w": W, "h": H, "frames": frames}, fh)


WRITERS = {"NSVF": write_nsvf, "NGP": write_ngp,
           "MatrixCity": write_matrix_city, "SILVR": write_silvr}
PARSERS = {  # name -> (port config, gsl_tpu config, point-count field)
    "NSVF": (NSVFDataParserConfig, JaxNSVF, "random_point_count"),
    "NGP": (NGPDataParserConfig, JaxNGP, "random_point_count"),
    "MatrixCity": (MatrixCityDataParserConfig, JaxMatrixCity, None),
    "SILVR": (SILVRDataParserConfig, JaxSILVR, "n_random_points"),
}


@pytest.fixture(scope="module")
def views():
    return _render_views(N_VIEWS)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory, views):
    out = {}
    for name, writer in WRITERS.items():
        root = str(tmp_path_factory.mktemp(name))
        writer(root, *views)
        out[name] = root
    return out


def assert_outputs_equal(got, want):
    for split in ("train_set", "val_set", "test_set"):
        g, w = getattr(got, split), getattr(want, split)
        assert g.image_names == w.image_names, split
        assert g.image_paths == w.image_paths, split
        for k in CAMERA_FIELDS:
            gv, wv = getattr(g.cameras, k).numpy(), np.asarray(
                getattr(w.cameras, k))
            assert gv.dtype == wv.dtype, (split, k)
            np.testing.assert_array_equal(gv, wv, err_msg=f"{split} {k}")
    np.testing.assert_array_equal(got.point_cloud.xyz, want.point_cloud.xyz)
    np.testing.assert_array_equal(got.point_cloud.rgb, want.point_cloud.rgb)
    assert got.point_cloud.xyz.dtype == want.point_cloud.xyz.dtype
    assert got.camera_extent == want.camera_extent


@pytest.mark.parametrize("name", sorted(PARSERS))
def test_parser_matches_jax(scenes, name):
    port_cfg, jax_cfg, count = PARSERS[name]
    kw = {count: 300} if count else {}
    got = port_cfg(path=scenes[name], **kw).instantiate().get_outputs()
    want = jax_cfg(path=scenes[name], **kw).instantiate().get_outputs()
    assert_outputs_equal(got, want)
    assert len(got.train_set) >= 4


def test_silvr_random_colours_match_jax(scenes):
    kw = dict(path=scenes["SILVR"], n_random_points=200,
              random_point_color=True, random_point_seed=7,
              random_point_range=3.0)
    assert_outputs_equal(
        SILVRDataParserConfig(**kw).instantiate().get_outputs(),
        JaxSILVR(**kw).instantiate().get_outputs())


def test_ngp_camera_angle_and_eval_step_match_jax(scenes):
    kw = dict(path=scenes["NGP"], eval_step=2, random_point_count=50,
              scene_box=0.5)
    got = NGPDataParserConfig(**kw).instantiate().get_outputs()
    assert_outputs_equal(got, JaxNGP(**kw).instantiate().get_outputs())
    assert len(got.val_set) == 3
    assert float(got.train_set.cameras.fy[1]) == pytest.approx(
        float(got.train_set.cameras.fx[1]) + 1.0)


def _depth_maps(views, f):
    """MatrixCity depth in its unit (cm) for each view: a slanted plane."""
    ys, xs = np.mgrid[0:H, 0:W]
    return {i: (300.0 + 2.0 * xs + 1.5 * ys + 10 * i).astype(np.float32)
            for i in range(len(views))}


def _scene_depths(views, f):
    """The known scene's expected depth at each view, in MatrixCity's unit
    (depth_scale 0.01); 0 where nothing was drawn."""
    state = state_from_raw_arrays(_scene_arrays(), device="cpu")
    renderer = TileRendererConfig().instantiate()
    maps = {}
    for i, (_, T) in enumerate(views):
        cam = make_camera(np.eye(3), T, f, f, W / 2, H / 2, W, H,
                          device="cpu")
        with torch.no_grad():
            out = renderer.forward(state, cam, H, W, torch.zeros(3), 0,
                                   render_types=frozenset({"rgb", "alpha",
                                                           "exp_depth"}))
        d = out.exp_depth.numpy() * 100.0
        maps[i] = np.where(out.alpha.numpy() > 0.5, d, 0.0).astype(
            np.float32)
    return maps


def _read_maps(monkeypatch, maps):
    """cv2.imread gives `maps` (3 channels) for depth/<i>.exr."""
    cv2 = pytest.importorskip("cv2")

    def imread(path, flags=None):
        i = int(os.path.basename(path).split(".")[0])
        return np.repeat(maps[i][..., None], 3, axis=-1)

    monkeypatch.setattr(cv2, "imread", imread)


def test_matrix_city_depth_unprojection_matches_jax(tmp_path, views,
                                                    monkeypatch):
    """Depth files that OpenCV reads: both packages unproject the same
    points and colours (the reader is replaced by the maps above)."""
    root = str(tmp_path / "mc")
    write_matrix_city(root, *views, depth_files=True)
    _read_maps(monkeypatch, _depth_maps(*views))
    kw = dict(path=root, depth_read_step=3, max_points=900)
    got = MatrixCityDataParserConfig(**kw).instantiate().get_outputs()
    assert_outputs_equal(got, JaxMatrixCity(**kw).instantiate().get_outputs())
    assert got.point_cloud.xyz.shape == (900, 3)


def test_matrix_city_unreadable_depth_raises(tmp_path, views):
    """gsl_tpu falls back to a random cloud when cv2.imread gives None;
    the port names the file and the variable OpenCV needs for .exr."""
    pytest.importorskip("cv2")
    root = str(tmp_path / "mc")
    write_matrix_city(root, *views, depth_files=True)
    with pytest.raises(RuntimeError,
                       match=r"0000\.exr.*OPENCV_IO_ENABLE_OPENEXR"):
        MatrixCityDataParserConfig(path=root).instantiate().get_outputs()
    # without depth files both keep the random cloud
    for name in os.listdir(os.path.join(root, "depth")):
        os.remove(os.path.join(root, "depth", name))
    got = MatrixCityDataParserConfig(path=root).instantiate().get_outputs()
    assert got.point_cloud.xyz.shape == (100_000, 3)


FIT_STEPS = 30
FIT_ARGS = {
    "NSVF": ["data.parser.init_args.random_point_count=400"],
    "NGP": ["data.parser.init_args.random_point_count=400",
            "data.parser.init_args.scene_box=2.0"],
    # from the depth maps: the random cloud's 100,000 rows would make the
    # CPU's brute-force neighbour search take minutes
    "MatrixCity": ["data.parser.init_args.max_points=400",
                   "data.parser.init_args.depth_read_step=2"],
    "SILVR": ["data.parser.init_args.n_random_points=400",
              "data.parser.init_args.random_point_range=8.0"],
}


@pytest.mark.parametrize("name", sorted(PARSERS))
def test_parser_fits_through_the_cli(scenes, views, tmp_path, monkeypatch,
                                    name):
    """blender.yaml with the parser's class_path: finite losses, and a val
    PSNR above the initial cloud's. MatrixCity starts from depth maps of
    the scene."""
    out = str(tmp_path)
    scene = scenes[name]
    if name == "MatrixCity":
        scene = str(tmp_path / "mc")
        write_matrix_city(scene, *views, depth_files=True)
        _read_maps(monkeypatch, _scene_depths(*views))
    argv = ["fit", "--config", os.path.join(REPO, "gsl_tpu_torch",
                                            "configs", "blender.yaml"),
            "--data.path", scene, "--output", out, "-n", "run",
            "--max_steps", str(FIT_STEPS), "--device", "cpu",
            f"data.parser.class_path={name}",
            "trainer.background_color=[0.0, 0.0, 0.0]",
            "model.gaussian.sh_degree=0", "fit.min_capacity=1024",
            "fit.log_interval=10", *FIT_ARGS[name]]
    _, results = cli.main(argv)
    run = os.path.join(out, "run")
    with open(os.path.join(run, "train_log.csv")) as fh:
        losses = [float(r[1]) for r in list(csv.reader(fh))[1:]]
    assert len(losses) == FIT_STEPS // 10 and np.isfinite(losses).all()

    cfg = cli.load_config([os.path.join(run, "config.yaml")], {})
    trainer, dp, fit_cfg = cli.build_components(cfg)
    assert type(dp).__name__ == PARSERS[name][0].__name__
    outputs = dp.instantiate().get_outputs()
    initial = trainer.setup(_init_gaussians(trainer, outputs, fit_cfg, "cpu"),
                            outputs.camera_extent)
    fit_cfg.output_dir = str(tmp_path / "initial")
    before = validate(trainer, initial, outputs, fit_cfg)["psnr"]
    print(f"{name}: val PSNR initial cloud {before:.3f} dB, after "
          f"{FIT_STEPS} steps {results['psnr']:.3f} dB")
    assert results["psnr"] > before
