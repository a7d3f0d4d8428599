"""gsl_tpu_torch's data layer against gsl_tpu's on the same files: batched
cameras, the COLMAP reader and writer, the COLMAP and Blender parsers, the
cached dataset, the loader's image sequence and the background sphere."""
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from PIL import Image

from gsl_tpu.data import colmap_io as jio
from gsl_tpu.data.cameras import Cameras as JaxCameras
from gsl_tpu.data.dataparsers.blender import (
    BlenderDataParserConfig as JaxBlender)
from gsl_tpu.data.dataparsers.colmap import ColmapDataParserConfig as JaxColmap
from gsl_tpu.data.dataset import CachedDataset as JaxDataset
from gsl_tpu.data.dataset import DataLoader as JaxLoader
from gsl_tpu.data.dataset import add_background_sphere as jax_sphere

from gsl_tpu_torch.data import colmap_io as tio
from gsl_tpu_torch.data.cameras import Cameras, stack_cameras
from gsl_tpu_torch.data.dataparsers.blender import BlenderDataParserConfig
from gsl_tpu_torch.data.dataparsers.colmap import ColmapDataParserConfig
from gsl_tpu_torch.data.dataset import (CachedDataset, DataLoader,
                                        add_background_sphere,
                                        image_to_float)

import torch_port_utils  # noqa: F401  (one intra-op thread)

CAMERA_FIELDS = ("R", "T", "fx", "fy", "cx", "cy", "width", "height",
                 "appearance_id", "time")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_IMAGES, W, H = 10, 64, 48


def _rand_quat(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    return -q if q[0] < 0 else q


def _colmap_model(rng, n_images=N_IMAGES, n_points=500):
    cams = {
        1: jio.ColmapCamera(1, "PINHOLE", W, H,
                            np.array([70.0, 72.0, 32.0, 24.0])),
        2: jio.ColmapCamera(2, "SIMPLE_RADIAL", W, H,
                            np.array([65.0, 31.5, 23.5, 0.01])),
        3: jio.ColmapCamera(3, "OPENCV", W, H,
                            np.array([68.0, 69.0, 32.5, 24.5, 0.02, -0.01,
                                      0.001, 0.002])),
    }
    images = {}
    for i in range(n_images):
        images[i + 1] = jio.ColmapImage(
            i + 1, _rand_quat(rng), rng.normal(size=3) * 0.5,
            1 + i % 3, f"img_{i:03d}.png")
    return jio.ColmapModel(
        cameras=cams, images=images,
        points_xyz=rng.uniform(-1, 1, size=(n_points, 3)),
        points_rgb=rng.randint(0, 256, size=(n_points, 3)).astype(np.uint8),
        points_err=rng.uniform(0, 2, size=n_points))


def _write_colmap_scene(root, downsampled=False, seed=1):
    """A scene written by gsl_tpu's write_model_bin, with images (and
    images_2/ at half size when `downsampled`)."""
    rng = np.random.RandomState(seed)
    model = _colmap_model(rng)
    jio.write_model_bin(model, os.path.join(root, "sparse", "0"))
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for im in model.images.values():
        arr = rng.randint(0, 256, size=(H, W, 3)).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(root, "images", im.name))
        if downsampled:
            os.makedirs(os.path.join(root, "images_2"), exist_ok=True)
            Image.fromarray(arr[::2, ::2]).save(
                os.path.join(root, "images_2", im.name))
    with open(os.path.join(root, "eval.txt"), "w") as f:
        f.write("img_001.png\nimg_004.png\n\nimg_007.png\n")
    with open(os.path.join(root, "subset.txt"), "w") as f:
        f.write("\n".join(f"img_{i:03d}.png" for i in range(0, 10, 2)))
    return model


def _write_txt_model(model, sparse_dir):
    os.makedirs(sparse_dir, exist_ok=True)
    with open(os.path.join(sparse_dir, "cameras.txt"), "w") as f:
        f.write("# CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for c in model.cameras.values():
            f.write(f"{c.camera_id} {c.model} {c.width} {c.height} "
                    + " ".join(repr(float(p)) for p in c.params) + "\n")
    with open(os.path.join(sparse_dir, "images.txt"), "w") as f:
        f.write("# IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        for im in model.images.values():
            vals = " ".join(repr(float(v)) for v in
                            list(im.qvec) + list(im.tvec))
            f.write(f"{im.image_id} {vals} {im.camera_id} {im.name}\n")
            f.write("1.0 2.0 -1\n")
    with open(os.path.join(sparse_dir, "points3D.txt"), "w") as f:
        f.write("# POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[]\n")
        for i in range(model.points_xyz.shape[0]):
            xyz = " ".join(repr(float(v)) for v in model.points_xyz[i])
            rgb = " ".join(str(int(v)) for v in model.points_rgb[i])
            f.write(f"{i} {xyz} {rgb} {float(model.points_err[i])!r} "
                    "1 0\n")


def _assert_models_equal(got, want):
    assert sorted(got.cameras) == sorted(want.cameras)
    for k, c in want.cameras.items():
        g = got.cameras[k]
        assert (g.model, g.width, g.height) == (c.model, c.width, c.height)
        np.testing.assert_array_equal(g.params, c.params)
        if c.model not in ("SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE",
                           "THIN_PRISM_FISHEYE", "FOV"):
            np.testing.assert_array_equal(g.distortion, c.distortion)
        assert (g.fx, g.fy, g.cx, g.cy) == (c.fx, c.fy, c.cx, c.cy)
    assert sorted(got.images) == sorted(want.images)
    for k, im in want.images.items():
        g = got.images[k]
        assert (g.name, g.camera_id) == (im.name, im.camera_id)
        np.testing.assert_array_equal(g.qvec, im.qvec)
        np.testing.assert_array_equal(g.tvec, im.tvec)
    np.testing.assert_array_equal(got.points_xyz, want.points_xyz)
    np.testing.assert_array_equal(got.points_rgb, want.points_rgb)
    np.testing.assert_array_equal(got.points_err, want.points_err)


def _assert_cameras_equal(got: Cameras, want: JaxCameras):
    for k in CAMERA_FIELDS:
        g, w = getattr(got, k), np.asarray(getattr(want, k))
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=k)


def _assert_image_sets_equal(got, want):
    assert got.image_names == want.image_names
    assert got.image_paths == want.image_paths
    assert got.mask_paths == want.mask_paths
    _assert_cameras_equal(got.cameras, want.cameras)
    gx, wx = got.extra_data or {}, want.extra_data or {}
    assert sorted(gx) == sorted(wx)
    for g, w in zip(gx.get("distortion", []), wx.get("distortion", [])):
        np.testing.assert_array_equal(g, w)


def _assert_outputs_equal(got, want):
    for split in ("train_set", "val_set", "test_set"):
        _assert_image_sets_equal(getattr(got, split), getattr(want, split))
    np.testing.assert_allclose(got.point_cloud.xyz, want.point_cloud.xyz,
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got.point_cloud.rgb, want.point_cloud.rgb)
    assert got.point_cloud.xyz.dtype == want.point_cloud.xyz.dtype
    assert got.camera_extent == pytest.approx(want.camera_extent, rel=1e-6)
    assert got.prune_extent == pytest.approx(want.prune_extent, rel=1e-6)
    assert got.appearance_group_ids == want.appearance_group_ids


# ---- cameras -----------------------------------------------------------

def _both_batches(n=5, seed=0):
    rng = np.random.RandomState(seed)
    arrays = dict(
        R=np.stack([jio.qvec_to_rotmat(_rand_quat(rng))
                    for _ in range(n)]).astype(np.float32),
        T=rng.normal(size=(n, 3)).astype(np.float32),
        fx=rng.uniform(50, 90, n).astype(np.float32),
        fy=rng.uniform(50, 90, n).astype(np.float32),
        cx=rng.uniform(30, 34, n).astype(np.float32),
        cy=rng.uniform(22, 26, n).astype(np.float32),
        width=rng.randint(60, 70, n).astype(np.int32),
        height=rng.randint(40, 50, n).astype(np.int32),
        appearance_id=np.arange(n, dtype=np.int32),
        time=rng.uniform(0, 1, n).astype(np.float32))
    jcams = JaxCameras(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tcams = Cameras(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    return tcams, jcams


@pytest.mark.parametrize("idx", [2, -1, np.int64(3), [4, 0, 2],
                                 np.array([1, 3]), slice(1, 4)],
                         ids=["int", "negative", "np_int", "list", "array",
                              "slice"])
def test_camera_indexing_matches_jax(idx):
    tcams, jcams = _both_batches()
    got, want = tcams[idx], jcams[np.asarray(idx) if isinstance(
        idx, list) else idx]
    _assert_cameras_equal(got, want)
    if np.ndim(np.asarray(want.fx)) == 0:
        assert isinstance(got.width, int) and isinstance(got.height, int)
    else:
        assert len(got) == len(want)


@pytest.mark.parametrize("batched", [True, False],
                         ids=["batch", "single"])
def test_camera_geometry_matches_jax(batched):
    tcams, jcams = _both_batches()
    if not batched:
        tcams, jcams = tcams[1], jcams[1]
    for name in ("world_to_camera", "camera_center", "fov_x", "fov_y"):
        np.testing.assert_allclose(getattr(tcams, name).numpy(),
                                   np.asarray(getattr(jcams, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(tcams.get_K().numpy(),
                                  np.asarray(jcams.get_K()))
    for factor in (2, 3.0, 4):
        _assert_cameras_equal(tcams.rescale(factor), jcams.rescale(factor))


def test_stack_cameras_inverts_indexing():
    tcams, _ = _both_batches()
    again = stack_cameras([tcams[i] for i in range(len(tcams))])
    for k in CAMERA_FIELDS:
        assert torch.equal(getattr(again, k), getattr(tcams, k)), k


# ---- COLMAP I/O --------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_colmap_bin_round_trip_through_both_readers(tmp_path, writer):
    model = _colmap_model(np.random.RandomState(3))
    sparse = str(tmp_path / "sparse")
    (jio if writer == "jax" else tio).write_model_bin(model, sparse)
    _assert_models_equal(tio.read_model(sparse), model)
    _assert_models_equal(jio.read_model(sparse), model)
    if writer == "port":
        # byte for byte what gsl_tpu writes
        jio.write_model_bin(model, str(tmp_path / "jax"))
        for f in ("cameras.bin", "images.bin", "points3D.bin"):
            assert (tmp_path / "sparse" / f).read_bytes() == \
                (tmp_path / "jax" / f).read_bytes(), f


def test_colmap_txt_reader_matches_jax(tmp_path):
    model = _colmap_model(np.random.RandomState(4))
    _write_txt_model(model, str(tmp_path))
    got, want = tio.read_model(str(tmp_path)), jio.read_model(str(tmp_path))
    _assert_models_equal(got, want)
    _assert_models_equal(got, model)


def test_qvec_rotmat_match_jax():
    rng = np.random.RandomState(0)
    for _ in range(20):
        q = _rand_quat(rng)
        np.testing.assert_array_equal(tio.qvec_to_rotmat(q),
                                      jio.qvec_to_rotmat(q))
        R = tio.qvec_to_rotmat(q)
        np.testing.assert_array_equal(tio.rotmat_to_qvec(R),
                                      jio.rotmat_to_qvec(R))
        np.testing.assert_allclose(tio.rotmat_to_qvec(R), q, atol=1e-6)


@pytest.mark.parametrize("model", ["FOV", "RADIAL_FISHEYE"])
def test_unsupported_camera_models_raise_in_both(model):
    params = np.arange(5, dtype=np.float64) + 1.0
    for io in (tio, jio):
        with pytest.raises(NotImplementedError, match=model):
            io.ColmapCamera(1, model, W, H, params).distortion


# ---- COLMAP parser -----------------------------------------------------

@pytest.fixture(scope="module")
def colmap_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("colmap")
    _write_colmap_scene(str(root), downsampled=False)
    return str(root)


@pytest.fixture(scope="module")
def colmap_scene_downsampled(tmp_path_factory):
    root = tmp_path_factory.mktemp("colmap2")
    _write_colmap_scene(str(root), downsampled=True)
    return str(root)


COLMAP_CASES = {
    "step": dict(eval_step=4),
    "ratio": dict(eval_image_select_mode="ratio", eval_ratio=0.3),
    "list": dict(eval_image_select_mode="list", eval_list="eval.txt"),
    "experiment": dict(eval_step=3, split_mode="experiment"),
    "max_point_error": dict(max_point_error=1.0),
    "random_points": dict(points_from="random", random_point_count=700),
    "scene_scale": dict(scene_scale=2.5),
    "downsample_no_dir": dict(down_sample_factor=2),
    "image_list": dict(image_list="subset.txt"),
}


@pytest.mark.parametrize("case", sorted(COLMAP_CASES))
def test_colmap_parser_matches_jax(colmap_scene, case):
    kw = dict(COLMAP_CASES[case])
    if "image_list" in kw:
        kw["image_list"] = os.path.join(colmap_scene, kw["image_list"])
    got = ColmapDataParserConfig(path=colmap_scene, **kw).instantiate() \
        .get_outputs()
    want = JaxColmap(path=colmap_scene, **kw).instantiate().get_outputs()
    _assert_outputs_equal(got, want)
    assert len(got.train_set) > 0 and len(got.val_set) > 0


def test_colmap_parser_prefers_downsampled_dir(colmap_scene_downsampled):
    kw = dict(down_sample_factor=2)
    got = ColmapDataParserConfig(path=colmap_scene_downsampled, **kw) \
        .instantiate().get_outputs()
    want = JaxColmap(path=colmap_scene_downsampled, **kw).instantiate() \
        .get_outputs()
    _assert_outputs_equal(got, want)
    assert all("images_2" in p for p in got.train_set.image_paths)
    # images_2/ holds pre-scaled images: intrinsics stay as COLMAP has them
    assert int(got.train_set.cameras.width[0]) == W


def test_colmap_parser_finds_sparse_fallback(tmp_path):
    _write_colmap_scene(str(tmp_path))
    kw = dict(sparse_dir="does/not/exist")
    got = ColmapDataParserConfig(path=str(tmp_path), **kw).instantiate() \
        .get_outputs()
    want = JaxColmap(path=str(tmp_path), **kw).instantiate().get_outputs()
    _assert_outputs_equal(got, want)
    with pytest.raises(FileNotFoundError):
        ColmapDataParserConfig(path=str(tmp_path / "nothing")) \
            .instantiate().get_outputs()


# ---- Blender parser and the cached dataset -----------------------------

def _write_blender(root, n=4, rgba=False, seed=2, splits=("train",)):
    rng = np.random.RandomState(seed)
    for split in splits:
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in range(n):
            name = f"{split}/r_{i}"
            c2w = np.eye(4)
            c2w[:3, :3] = jio.qvec_to_rotmat(_rand_quat(rng))
            c2w[:3, 3] = rng.normal(size=3) + [0, 0, 3]
            frames.append({"file_path": name,
                           "transform_matrix": c2w.tolist()})
            arr = rng.randint(0, 256, size=(H, W, 4 if rgba else 3))
            Image.fromarray(arr.astype(np.uint8)).save(
                os.path.join(root, name + ".png"))
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.7, "frames": frames}, f)


@pytest.mark.parametrize("splits", [("train",), ("train", "val"),
                                    ("train", "val", "test")],
                         ids=["train_only", "train_val", "all_splits"])
def test_blender_parser_matches_jax(tmp_path, splits):
    _write_blender(str(tmp_path), splits=splits)
    kw = dict(random_point_count=900, random_point_seed=5)
    got = BlenderDataParserConfig(path=str(tmp_path), **kw).instantiate() \
        .get_outputs()
    want = JaxBlender(path=str(tmp_path), **kw).instantiate().get_outputs()
    _assert_outputs_equal(got, want)


def test_blender_parser_and_dataset_match_jax_on_the_e2e_scene(tmp_path):
    """The scene tests/test_fit_e2e.py renders with gsl_tpu (RGB PNGs)."""
    from test_fit_e2e import _make_dataset
    _make_dataset(str(tmp_path), n_views=4)
    kw = dict(random_point_count=300, white_background=False)
    got = BlenderDataParserConfig(path=str(tmp_path), **kw).instantiate() \
        .get_outputs()
    want = JaxBlender(path=str(tmp_path), **kw).instantiate().get_outputs()
    _assert_outputs_equal(got, want)
    bg = np.ones(3, np.float32)
    _assert_datasets_equal(CachedDataset(got.train_set, bg),
                           JaxDataset(want.train_set, bg))


def _assert_datasets_equal(got_ds, want_ds):
    assert len(got_ds) == len(want_ds)
    for i in range(len(want_ds)):
        cam, name, img_u8, mask = got_ds.get(i)
        wcam, wname, wimg, wmask = want_ds.get(i)
        assert name == wname
        assert img_u8.dtype == torch.uint8
        got_img = image_to_float(img_u8).numpy()
        assert got_img.dtype == wimg.dtype == np.float32
        np.testing.assert_array_equal(got_img, wimg)
        _assert_cameras_equal(cam, wcam)
        if wmask is None:
            assert mask is None
        else:
            np.testing.assert_array_equal(mask.numpy(), wmask)


@pytest.mark.parametrize("rgba,background", [
    (False, None), (True, None), (True, (1.0, 1.0, 1.0)),
    (True, (0.2, 0.5, 0.9))], ids=["rgb", "rgba_black", "rgba_white",
                                   "rgba_color"])
def test_cached_dataset_matches_jax_bit_for_bit(tmp_path, rgba, background):
    _write_blender(str(tmp_path), rgba=rgba)
    out = BlenderDataParserConfig(path=str(tmp_path), random_point_count=10) \
        .instantiate().get_outputs()
    jout = JaxBlender(path=str(tmp_path), random_point_count=10) \
        .instantiate().get_outputs()
    bg = None if background is None else np.asarray(background, np.float32)
    _assert_datasets_equal(CachedDataset(out.train_set, bg),
                           JaxDataset(jout.train_set, bg))


def test_cached_dataset_masks_match_jax(tmp_path):
    _write_blender(str(tmp_path))
    out = BlenderDataParserConfig(path=str(tmp_path), random_point_count=10) \
        .instantiate().get_outputs()
    jout = JaxBlender(path=str(tmp_path), random_point_count=10) \
        .instantiate().get_outputs()
    rng = np.random.RandomState(6)
    paths = []
    for i, shape in enumerate([(H, W), (H // 2, W // 2), (H * 2, W), None]):
        if shape is None:
            paths.append(None)
            continue
        m = (rng.uniform(size=shape) > 0.5).astype(np.uint8) * 255
        if i == 2:
            m = np.stack([m] * 3, axis=-1)       # an RGB mask
        p = str(tmp_path / f"m{i}.png")
        Image.fromarray(m).save(p)
        paths.append(p)
    out.train_set.mask_paths = list(paths)
    jout.train_set.mask_paths = list(paths)
    _assert_datasets_equal(CachedDataset(out.train_set),
                           JaxDataset(jout.train_set))


def test_cached_dataset_undistorts_as_jax(colmap_scene):
    got = ColmapDataParserConfig(path=colmap_scene).instantiate() \
        .get_outputs()
    want = JaxColmap(path=colmap_scene).instantiate().get_outputs()
    pytest.importorskip("cv2")
    distorted = [i for i, d in enumerate(got.train_set.extra_data[
        "distortion"]) if np.any(d != 0)]
    assert distorted
    _assert_datasets_equal(CachedDataset(got.train_set),
                           JaxDataset(want.train_set))


def test_undistortion_without_opencv_raises_naming_the_image(
        colmap_scene, monkeypatch):
    got = ColmapDataParserConfig(path=colmap_scene).instantiate() \
        .get_outputs()
    monkeypatch.setitem(sys.modules, "cv2", None)   # import cv2 fails
    ds = CachedDataset(got.train_set)
    i = next(i for i, d in enumerate(got.train_set.extra_data["distortion"])
             if np.any(d != 0))
    with pytest.raises(RuntimeError, match=got.train_set.image_names[i]):
        ds.get(i)
    ds.get(0)      # a PINHOLE image needs no OpenCV


def test_fit_through_the_cli_raises_the_undistortion_error(
        colmap_scene, tmp_path, monkeypatch):
    """The loader's lookahead thread hands the error to the fit loop, so
    `cli.main fit` raises it (and does not wait on the thread)."""
    from gsl_tpu_torch import cli
    got = ColmapDataParserConfig(path=colmap_scene).instantiate() \
        .get_outputs()
    distorted = {got.train_set.image_names[i] for i, d in enumerate(
        got.train_set.extra_data["distortion"]) if np.any(d != 0)}
    monkeypatch.setitem(sys.modules, "cv2", None)   # import cv2 fails
    with pytest.raises(RuntimeError, match="has lens distortion") as e:
        cli.main(["fit", "--config",
                  os.path.join(REPO, "gsl_tpu_torch", "configs",
                               "colmap.yaml"),
                  "--data.path", colmap_scene, "--output", str(tmp_path),
                  "-n", "run", "--max_steps", str(len(got.train_set)),
                  "--device", "cpu", "fit.min_capacity=1024",
                  "fit.log_interval=1"])
    assert any(name in str(e.value) for name in distorted)


# ---- loader and background sphere --------------------------------------

@pytest.mark.parametrize("seed,skip,prefetch", [
    (0, 0, False), (42, 0, True), (42, 7, True), (3, 13, False),
    (3, 13, True)])
def test_loader_draws_the_jax_sequence(tmp_path, seed, skip, prefetch):
    """The port's lookahead loader against the JAX package's loader with
    and without its prefetch thread."""
    _write_blender(str(tmp_path), n=5)
    out = BlenderDataParserConfig(path=str(tmp_path), random_point_count=10) \
        .instantiate().get_outputs()
    jout = JaxBlender(path=str(tmp_path), random_point_count=10) \
        .instantiate().get_outputs()
    got = iter(DataLoader(CachedDataset(out.train_set), seed=seed,
                          skip=skip))
    want = iter(JaxLoader(JaxDataset(jout.train_set), seed=seed, skip=skip,
                          async_prefetch=prefetch))
    names = [next(got)[1] for _ in range(17)]
    assert names == [next(want)[1] for _ in range(17)]
    assert len(set(names)) == 5
    got.close()


def test_background_sphere_matches_jax():
    from gsl_tpu.data.dataparsers.dataparser import PointCloud as JaxPC
    from gsl_tpu_torch.data.dataparsers.dataparser import PointCloud
    rng = np.random.RandomState(8)
    xyz = rng.normal(size=(50, 3)).astype(np.float32)
    rgb = rng.uniform(size=(50, 3)).astype(np.float32)
    centers = rng.normal(size=(7, 3)).astype(np.float32)
    got = add_background_sphere(PointCloud(xyz, rgb), centers, 2.0, 300, 5)
    want = jax_sphere(JaxPC(xyz, rgb), centers, 2.0, 300, 5)
    np.testing.assert_array_equal(got.xyz, want.xyz)
    np.testing.assert_array_equal(got.rgb, want.rgb)
