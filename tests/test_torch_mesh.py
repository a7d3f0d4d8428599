"""gsl_tpu_torch's TSDF fusion and marching tetrahedra against gsl_tpu's
(gsl_tpu/utils/mesh.py) on the same inputs, and the port's mesh tool on a
2DGS run fitted through the port's CLI."""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gsl_tpu.utils.mesh import TSDFVolume as JaxTSDFVolume
from gsl_tpu.utils.mesh import marching_tetrahedra as jax_marching_tetrahedra

from gsl_tpu_torch import cli
from gsl_tpu_torch.data.cameras import make_camera
from gsl_tpu_torch.data.dataparsers.dataparser import camera_centers
from gsl_tpu_torch.models.gaussian_2d import Gaussian2DConfig
from gsl_tpu_torch.renderers.surfel_renderer import SurfelRendererConfig
from gsl_tpu_torch.renderers.tile_renderer import TileRendererConfig
from gsl_tpu_torch.tools import gs2d_mesh_extraction
from gsl_tpu_torch.training.gs2d import GS2DTrainer
from gsl_tpu_torch.utils.checkpoint import save_checkpoint
from gsl_tpu_torch.utils.convert import state_from_raw_arrays
from gsl_tpu_torch.utils.gaussian_model_loader import GaussianModelLoader
from gsl_tpu_torch.utils.mesh import (TSDFVolume, marching_tetrahedra,
                                      save_mesh_ply)
from gsl_tpu_torch.viewer.camera_path import orbit_c2w

from test_torch_fit_e2e import _scene_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sphere_sdf(R=48, r=15.0):
    g = np.arange(R) - (R - 1) / 2.0
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return (np.sqrt(x ** 2 + y ** 2 + z ** 2) - r).astype(np.float32)


def _random_field_with_holes():
    rng = np.random.RandomState(0)
    sdf = rng.normal(size=(20, 21, 22)).astype(np.float32)
    sdf[rng.uniform(size=sdf.shape) < 0.1] = np.nan
    return sdf


@pytest.mark.parametrize("field", ["sphere", "random_with_holes"])
def test_marching_tetrahedra_matches_jax(field):
    """The same vertices (1e-6) in the same order and the same faces."""
    sdf = _sphere_sdf() if field == "sphere" else _random_field_with_holes()
    want_v, want_f = jax_marching_tetrahedra(sdf)
    got_v, got_f = marching_tetrahedra(torch.from_numpy(sdf))
    assert len(want_f) > 1000
    np.testing.assert_allclose(got_v.numpy(), want_v, atol=1e-6)
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    assert got_v.dtype == torch.float32 and got_f.dtype == torch.int64


def test_marching_tetrahedra_of_an_empty_field():
    verts, faces = marching_tetrahedra(torch.full((4, 4, 4), np.nan))
    assert verts.shape == (0, 3) and faces.shape == (0, 3)


def _sphere_views(H=64, W=64, f=60.0, r_sphere=0.5):
    """tests/test_mesh.py's 12 analytic depth maps of a sphere, with a
    seeded alpha per view: [(depth, alpha, w2c, K)]."""
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    center = np.zeros(3, np.float32)
    views = []
    for i, ang in enumerate(np.linspace(0, 2 * np.pi, 12, endpoint=False)):
        c = np.array([2.0 * np.sin(ang), 0.0, 2.0 * np.cos(ang)],
                     np.float32)
        fwd = (center - c) / np.linalg.norm(center - c)
        right = np.cross(np.array([0.0, 1.0, 0.0], np.float32), fwd)
        right /= np.linalg.norm(right)
        Rm = np.stack([right, np.cross(fwd, right), fwd])
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = Rm
        w2c[:3, 3] = -Rm @ c
        us, vs = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
        dirs = np.stack([(us - W / 2) / f, (vs - H / 2) / f,
                         np.ones_like(us)], -1)
        dirs_w = dirs @ Rm
        oc = c - center
        b = (dirs_w * oc).sum(-1)
        disc = b * b - (dirs_w * dirs_w).sum(-1) * (
            (oc * oc).sum() - r_sphere ** 2)
        thit = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0)))
                        / (dirs_w * dirs_w).sum(-1), 0.0)
        depth = (thit * dirs[..., 2]).astype(np.float32)
        alpha = np.random.RandomState(i).uniform(size=(H, W)).astype(
            np.float32)
        views.append((depth, alpha, w2c, K))
    return views


def test_tsdf_volume_matches_jax(tmp_path):
    """The sphere's depth maps (with alpha) fused by both: weight equal,
    tsdf within 1e-5, the same mesh; the PLY is byte for byte the one
    gsl_tpu's writer makes of it."""
    kw = dict(origin=np.full(3, -0.8, np.float32), resolution=(64, 64, 64),
              voxel_size=1.6 / 64)
    want = JaxTSDFVolume(**kw)
    got = TSDFVolume(**kw, device="cpu")
    for depth, alpha, w2c, K in _sphere_views():
        want.integrate(depth, w2c, K, alpha=alpha, depth_trunc=5.0)
        got.integrate(torch.from_numpy(depth), w2c, K,
                      alpha=torch.from_numpy(alpha), depth_trunc=5.0)
    np.testing.assert_array_equal(got.weight.numpy(),
                                  np.asarray(want.weight))
    assert float(got.weight.max()) > 3
    np.testing.assert_allclose(got.tsdf.numpy(), np.asarray(want.tsdf),
                               atol=1e-5)
    sdf = got.sdf_grid().numpy()
    np.testing.assert_allclose(sdf, want.sdf_grid(), atol=1e-5)
    wv, wf = want.extract_mesh()
    gv, gf = got.extract_mesh()
    assert len(wf) > 1000
    np.testing.assert_allclose(gv.numpy(), wv, atol=1e-6)
    np.testing.assert_array_equal(gf.numpy(), wf)
    r = np.linalg.norm(gv.numpy(), axis=-1)
    assert abs(np.median(r) - 0.5) < 0.08
    from gsl_tpu.utils.mesh import save_mesh_ply as jax_save_mesh_ply
    save_mesh_ply(str(tmp_path / "a.ply"), gv, gf)
    jax_save_mesh_ply(str(tmp_path / "b.ply"), gv.numpy(), gf.numpy())
    assert (tmp_path / "a.ply").read_bytes() == \
        (tmp_path / "b.ply").read_bytes()


# ---- the mesh tool on a 2DGS run ---------------------------------------

W = H = 64
FOV_X = 0.8
N_VIEWS = 8
RADIUS = 3.0


# the scene's centre: the fit's free rows (zero means, unit scales) sit at
# the origin, which no camera of the orbit around CENTRE sees
CENTRE = np.array([0.0, 10.0, 0.0])


def _orbit_scene():
    """The port's test scene centred on CENTRE, means within 0.8 of it."""
    arrays = _scene_arrays(spread=0.8, z_range=(-0.8, 0.8))
    arrays["means"] = (arrays["means"] + CENTRE).astype(np.float32)
    return arrays


def _orbit_dataset(root):
    """The orbit scene rendered by the port from N_VIEWS cameras on a
    circle of radius RADIUS around CENTRE, as a Blender-style scene."""
    state = state_from_raw_arrays(_orbit_scene(), device="cpu")
    renderer = TileRendererConfig().instantiate()
    f = 0.5 * W / np.tan(0.5 * FOV_X)
    os.makedirs(os.path.join(root, "train"))
    frames = []
    for i in range(N_VIEWS):
        c2w = orbit_c2w(360.0 * i / N_VIEWS, 0.0, RADIUS, CENTRE)
        w2c = np.linalg.inv(c2w)
        cam = make_camera(w2c[:3, :3], w2c[:3, 3], f, f, W / 2, H / 2, W, H,
                          device="cpu")
        with torch.no_grad():
            img = renderer.forward(state, cam, H, W, torch.zeros(3),
                                   0).render
        name = f"train/r_{i}"
        Image.fromarray((np.clip(img.numpy(), 0, 1) * 255).astype(
            np.uint8)).save(os.path.join(root, name + ".png"))
        gl = c2w.copy()
        gl[:3, 1:3] *= -1           # OpenCV -> OpenGL; the parser flips back
        frames.append({"file_path": name, "transform_matrix": gl.tolist()})
    with open(os.path.join(root, "transforms_train.json"), "w") as fh:
        json.dump({"camera_angle_x": FOV_X, "frames": frames}, fh)


@pytest.fixture(scope="module")
def surfel_run(tmp_path_factory):
    """A 10-step gs2d.yaml fit of the orbit scene through the CLI, started
    (`fit.init_from`) from a checkpoint of the scene itself as surfels,
    whose splats are a few pixels wide: the CPU's plain surfel rasterizer
    takes minutes on the random cloud's wide ones."""
    root = str(tmp_path_factory.mktemp("orbit"))
    _orbit_dataset(root)
    seed = str(tmp_path_factory.mktemp("seed"))
    arrays = _orbit_scene()
    arrays["scales"] = arrays["scales"][:, :2]
    trainer = GS2DTrainer(model=Gaussian2DConfig(sh_degree=0))
    save_checkpoint(os.path.join(seed, "checkpoints"), trainer.setup(
        state_from_raw_arrays(arrays, device="cpu"), 1.0))
    out = str(tmp_path_factory.mktemp("runs"))
    cli.main(["fit", "--config", os.path.join(REPO, "gsl_tpu_torch",
                                              "configs", "gs2d.yaml"),
              "--data.path", root, "--output", out, "-n", "run",
              "--max_steps", "10", "--device", "cpu",
              "data.parser.class_path=Blender",
              "data.parser.init_args.white_background=false",
              "trainer.background_color=[0.0, 0.0, 0.0]",
              "model.gaussian.init_args.sh_degree=0",
              "fit.min_capacity=1024", "fit.log_interval=5",
              f"fit.init_from={seed}"])
    return os.path.join(out, "run")


RES = 40


def _edges_shared_by_two_faces(faces):
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]])
    key = e.min(1).astype(np.int64) * (faces.max() + 1) + e.max(1)
    _, counts = np.unique(key, return_counts=True)
    return float((counts == 2).mean())


def test_mesh_tool_writes_a_ply_from_median_depth(surfel_run, capsys):
    got = gs2d_mesh_extraction.main([surfel_run, "--resolution", str(RES),
                                     "--alpha-thres", "0.2", "--device",
                                     "cpu"])
    said = capsys.readouterr().out
    path = os.path.join(surfel_run, "mesh.ply")
    assert got["path"] == path and f"wrote {path}" in said
    head = open(path, "rb").read(300)
    assert head.startswith(b"ply") and b"element face" in head
    verts, faces = got["verts"].numpy(), got["faces"].numpy()
    assert len(faces) > 100 and bool(np.isfinite(verts).all())
    assert faces.min() >= 0 and faces.max() < len(verts)
    assert _edges_shared_by_two_faces(faces) > 0.5
    assert len(got["integrate_ms"]) == N_VIEWS


def test_mesh_tool_with_expected_depth_equals_jax_on_the_ports_maps(
        surfel_run, tmp_path):
    """--expected-depth: the tool's mesh equals gsl_tpu's TSDFVolume and
    marching tetrahedra fed the port's expected depth and alpha of each
    view, over the same volume; the median-depth mesh differs from it."""
    out = str(tmp_path / "expected.ply")
    got = gs2d_mesh_extraction.main([surfel_run, "--resolution", str(RES),
                                     "--alpha-thres", "0.2", "--device",
                                     "cpu", "--expected-depth", "--output",
                                     out])
    state, _, sh_degree = GaussianModelLoader.load(surfel_run, "cpu")
    cfg = cli.load_config([os.path.join(surfel_run, "config.yaml")], {})
    _, dp_cfg, _ = cli.build_components(cfg)
    cams = dp_cfg.instantiate().get_outputs().train_set.cameras
    centers = camera_centers(cams)
    focus = centers.mean(0)
    radius = float(np.linalg.norm(centers - focus, axis=-1).max())
    assert radius == pytest.approx(RADIUS, rel=1e-5)
    voxel = 2.0 * radius / RES
    vol = JaxTSDFVolume(origin=focus - radius, resolution=(RES,) * 3,
                        voxel_size=voxel, sdf_trunc=5.0 * voxel)
    renderer = SurfelRendererConfig(depth_ratio=0.0).instantiate()
    for i in range(len(cams)):
        cam = cams[i]
        with torch.no_grad():
            o = renderer.forward(state, cam, H, W, torch.zeros(3),
                                 sh_degree)
        vol.integrate(o.surf_depth.numpy(), cam.world_to_camera.numpy(),
                      cam.get_K().numpy(), alpha=o.alpha.numpy(),
                      depth_trunc=2.0 * radius, alpha_thres=0.2)
    want_v, want_f = vol.extract_mesh()
    assert len(want_f) > 100
    np.testing.assert_allclose(got["verts"].numpy(), want_v, atol=1e-5)
    np.testing.assert_array_equal(got["faces"].numpy(), want_f)
    median = gs2d_mesh_extraction.main([surfel_run, "--resolution",
                                        str(RES), "--alpha-thres", "0.2",
                                        "--device", "cpu", "--output",
                                        str(tmp_path / "median.ply")])
    assert len(median["faces"]) != len(want_f) or not np.array_equal(
        median["faces"].numpy(), want_f)
