"""gsl_tpu_torch's five partition tools against the repo-root tools (and
gsl_tpu's blend weights) on the same files: opacity prune and merge on PLY
runs, byte for byte; then a small COLMAP city partitioned and fitted by
train_partitions on the CPU, its blend prune, fine-tune and LoD
validation."""
import contextlib
import csv
import io
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gsl_tpu.data.dataparsers.colmap import \
    ColmapDataParserConfig as JaxColmapConfig
from gsl_tpu.models.gaussian import GaussianParams as JaxParams
from gsl_tpu.models.gaussian import GaussianState as JaxState
from gsl_tpu.renderers.tile_renderer import \
    TileRendererConfig as JaxRendererConfig
from gsl_tpu.training import light_gaussian as jl

from gsl_tpu_torch.data.cameras import make_camera
from gsl_tpu_torch.data.colmap_io import (ColmapCamera, ColmapImage,
                                          ColmapModel, write_model_bin)
from gsl_tpu_torch.data.dataparsers.colmap import ColmapDataParserConfig
from gsl_tpu_torch.renderers.tile_renderer import TileRendererConfig
from gsl_tpu_torch.tools import (finetune_partition, merge_partitions,
                                 prune_partitions, train_partitions,
                                 val_partition_lod)
from gsl_tpu_torch.training import light_gaussian as tl
from gsl_tpu_torch.utils import partitioning as tpart
from gsl_tpu_torch.utils.convert import state_from_raw_arrays
from gsl_tpu_torch.utils.gaussian_model_loader import GaussianModelLoader
from gsl_tpu_torch.utils.ply import load_gaussian_ply

import torch_port_utils  # noqa: F401  (one intra-op thread)
from test_torch_fit_e2e import REPO
from test_torch_partitions import (JAX_RENDERER, KEYS, _cloud, _npz,
                                   _write_ply_run, lod_scene)  # noqa: F401


def _run_root_tool(args):
    r = subprocess.run([sys.executable] + args, capture_output=True,
                       text=True, cwd=REPO,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    return r


# ---- the tools on PLY runs: the root tools' bytes -------------------------

def test_prune_opacity_writes_the_root_tools_bytes(lod_scene):
    _run_root_tool(["tools/prune_partitions.py", lod_scene, "--src", "lod0",
                    "--dst", "root", "--percent", "0.6", "--mode",
                    "opacity"])
    prune_partitions.main([lod_scene, "--src", "lod0", "--dst", "port",
                           "--percent", "0.6", "--mode", "opacity",
                           "--device", "cpu"])
    for pi in range(4):
        rel = os.path.join(f"partition_{pi:03d}", "point_cloud",
                           "iteration_1", "point_cloud.ply")
        with open(os.path.join(lod_scene, "root", rel), "rb") as f:
            want = f.read()
        with open(os.path.join(lod_scene, "port", rel), "rb") as f:
            assert f.read() == want
        assert load_gaussian_ply(os.path.join(
            lod_scene, "port", rel))["means"].shape[0] == 48 - 28


def test_merge_writes_the_root_tools_bytes(lod_scene):
    """Ownership by position over train_partitions' layout (the runs directly
    under the partitions dir), clouds reaching past their cells."""
    scene = tpart.PartitionedScene.load(os.path.join(lod_scene,
                                                     "partitions.npz"))
    for pi, part in enumerate(scene.partitions):
        centre = (part.xy_min + part.xy_max) / 2
        _write_ply_run(os.path.join(lod_scene, f"partition_{pi:03d}"),
                       _cloud(48, [centre[0], 0.0, centre[1]], seed=30 + pi,
                              spread=1.4))
    _run_root_tool(["tools/merge_partitions.py", lod_scene, "-o",
                    os.path.join(lod_scene, "root.ply")])
    out = merge_partitions.main([lod_scene, "-o",
                                 os.path.join(lod_scene, "port.ply"),
                                 "--device", "cpu"])
    with open(os.path.join(lod_scene, "root.ply"), "rb") as f:
        want = f.read()
    with open(out, "rb") as f:
        assert f.read() == want
    n = load_gaussian_ply(out)["means"].shape[0]
    assert 100 < n < 4 * 48


# ---- a small city, fitted through the tools on the CPU --------------------

H, W, F = 32, 48, 40.0
SPACING = 4.0
VIEWS = 4


def _city_arrays(n_cells):
    """n_cells copies of a small cloud along x, SPACING apart."""
    parts = []
    for c in range(n_cells):
        rng = np.random.RandomState(20 + c)
        n = 60
        means = np.concatenate([rng.uniform(-1, 1, (n, 2)),
                                rng.uniform(2, 4, (n, 1))], -1) \
            + [SPACING * c, 0.0, 0.0]
        op = rng.uniform(0.3, 0.95, n)
        colors = rng.uniform(0, 1, (n, 3))
        parts.append(dict(
            means=means.astype(np.float32),
            scales=np.log(rng.uniform(0.1, 0.25, (n, 3))).astype(np.float32),
            rotations=rng.normal(size=(n, 4)).astype(np.float32),
            opacities=np.log(op / (1 - op))[:, None].astype(np.float32),
            shs_dc=((colors - 0.5) / 0.28209479177387814)[:, None, :]
            .astype(np.float32),
            shs_rest=np.zeros((n, 0, 3), np.float32)))
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def write_city(root, n_cells=2):
    """A COLMAP city: n_cells clouds along x, VIEWS cameras a cell on a
    line at z = 0 looking +z, the views rendered by the port at H x W,
    and every mean as an SfM point."""
    arrays = _city_arrays(n_cells)
    state = state_from_raw_arrays(arrays, device="cpu")
    renderer = TileRendererConfig().instantiate()
    os.makedirs(os.path.join(root, "images"))
    images = {}
    for c in range(n_cells):
        for v in range(VIEWS):
            i = len(images) + 1
            T = -np.array([SPACING * c - 0.6 + 0.4 * v, 0.0, 0.0])
            cam = make_camera(R=np.eye(3), T=T, fx=F, fy=F, cx=W / 2,
                              cy=H / 2, width=W, height=H, device="cpu")
            with torch.no_grad():
                img = renderer.forward(state, cam, H, W, torch.zeros(3),
                                       0).render
            name = f"c{c}_v{v}.png"
            Image.fromarray((img.clamp(0, 1) * 255 + 0.5).to(
                torch.uint8).numpy()).save(os.path.join(root, "images",
                                                        name))
            images[i] = ColmapImage(i, np.array([1.0, 0, 0, 0]), T, 1, name)
    rgb = np.clip(0.5 + 0.28209479177387814 * arrays["shs_dc"][:, 0], 0, 1)
    write_model_bin(ColmapModel(
        cameras={1: ColmapCamera(1, "PINHOLE", W, H,
                                 np.array([F, F, W / 2, H / 2]))},
        images=images, points_xyz=arrays["means"].astype(np.float64),
        points_rgb=(rgb * 255 + 0.5).astype(np.uint8),
        points_err=np.zeros(len(rgb))), os.path.join(root, "sparse", "0"))
    return arrays


def _small_fit_config(path):
    """colmap.yaml's overrides for a CPU fit of the small city."""
    with open(path, "w") as f:
        f.write("fit:\n  min_capacity: 1024\n  log_interval: 2\n"
                "model:\n  gaussian:\n    sh_degree: 1\n")
    return path


def _train_argv(data, out, extra_config):
    return [data, "-o", out, "--n-partitions", "2", "--max-steps", "6",
            "--config", os.path.join(REPO, "gsl_tpu_torch", "configs",
                                     "colmap.yaml"),
            "--config", extra_config, "--retries", "0"]


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    """The small city trained by train_partitions on the CPU: two
    partitions of six steps, each a `cli fit` process."""
    root = str(tmp_path_factory.mktemp("city"))
    data = os.path.join(root, "scene")
    write_city(data)
    cfg = _small_fit_config(os.path.join(root, "small.yaml"))
    parts = os.path.join(root, "parts")
    train_partitions.main(_train_argv(data, parts, cfg) + ["--device",
                                                           "cpu"])
    return dict(data=data, parts=parts, config=cfg)


def test_train_partitions_dry_run_matches_the_root_tool(tmp_path):
    """The same partitions.npz arrays, image lists and scaled overrides as
    tools/train_partitions.py --dry-run (the command differs only in its
    program: `python -m gsl_tpu_torch.cli` and --device, for main.py)."""
    data = str(tmp_path / "scene")
    write_city(data, n_cells=3)
    argv = [data, "--n-partitions", "4", "--max-steps", "30000",
            "--dry-run"]
    r = _run_root_tool(["tools/train_partitions.py"] + argv
                       + ["-o", str(tmp_path / "root")])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_partitions.main(argv + ["-o", str(tmp_path / "port"),
                                      "--device", "cpu"])

    def overrides(text):
        return [[a.split("=")[0] + "=" + a.split("=")[1].rsplit("/", 1)[-1]
                 if "image_list" in a else a for a in ln.split()
                 if "=" in a] for ln in text.splitlines()
                if ln.startswith("  ")]

    want, got = overrides(r.stdout), overrides(buf.getvalue())
    assert got == want and len(got) >= 2
    j = _npz(str(tmp_path / "root" / "partitions.npz"))
    t = _npz(str(tmp_path / "port" / "partitions.npz"))
    for k in KEYS:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    for pi in range(len(j["ijs"])):
        rel = os.path.join(f"partition_{pi:03d}", "image_list.txt")
        if os.path.exists(str(tmp_path / "root" / rel)):
            with open(str(tmp_path / "root" / rel)) as f:
                lst = f.read()
            with open(str(tmp_path / "port" / rel)) as f:
                assert f.read() == lst


def test_train_partitions_trains_each_partition_on_the_cpu(city):
    """Both partitions end TRAINED with a checkpoint, a PLY and val
    metrics; a second call skips them."""
    scene = tpart.PartitionedScene.load(os.path.join(city["parts"],
                                                     "partitions.npz"))
    assert len(scene.partitions) == 2
    for pi in range(2):
        run = os.path.join(city["parts"], f"partition_{pi:03d}")
        assert os.path.isfile(os.path.join(run, "TRAINED"))
        assert os.path.isfile(os.path.join(run, "checkpoints", "step_6",
                                           "state.pt"))
        with open(os.path.join(run, "image_list.txt")) as f:
            assert len(f.read().split()) >= VIEWS
        with open(os.path.join(run, "metrics", "val.csv")) as f:
            assert list(csv.reader(f))[-1][0] == "MEAN"
    r = subprocess.run(
        [sys.executable, "-m", "gsl_tpu_torch.tools.train_partitions"]
        + _train_argv(city["data"], city["parts"], city["config"])
        + ["--device", "cpu"], capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.count("already trained, skip") == 2


def test_train_partitions_exits_nonzero_naming_a_failed_partition(
        city, tmp_path):
    bad = str(tmp_path / "bad.yaml")
    with open(bad, "w") as f:
        f.write("fit:\n  no_such_field: 1\n")
    out = str(tmp_path / "parts")
    with pytest.raises(SystemExit, match=r"partitions \[0\] failed"):
        train_partitions.main(_train_argv(city["data"], out, bad)
                              + ["--hosts", "2", "--host-id", "0",
                                 "--device", "cpu"])
    assert not os.path.exists(os.path.join(out, "partition_000", "TRAINED"))


def _blend_cameras(city, pi, n_cameras=8):
    """The cameras prune_partitions --mode blend samples for partition
    `pi`, in each package."""
    scene = tpart.PartitionedScene.load(os.path.join(city["parts"],
                                                     "partitions.npz"))
    idxs = np.nonzero(scene.partitions[pi].camera_mask)[0]
    sel = idxs[np.linspace(0, idxs.size - 1,
                           min(n_cameras, idxs.size)).astype(int)]
    jcams = JaxColmapConfig(path=city["data"]).instantiate().get_outputs(
    ).train_set.cameras
    tcams = ColmapDataParserConfig(path=city["data"]).instantiate(
    ).get_outputs().train_set.cameras
    return [jcams[int(i)] for i in sel], [tcams[int(i)] for i in sel]


def test_prune_blend_matches_jax_blend_weights(city):
    """--mode blend on the trained runs: per partition, the port's
    importance within rtol 5e-3 of gsl_tpu's accumulate_blend_weights (its
    XLA renderer) over the scene's cameras the tool samples, and the kept
    rows those of gsl_tpu's prune_by_importance on gsl_tpu's importance."""
    prune_partitions.main([city["parts"], "--dst", "lod1", "--percent",
                           "0.5", "--device", "cpu"])
    jr = JaxRendererConfig(**JAX_RENDERER).instantiate()
    for pi in range(2):
        state, renderer, shd = GaussianModelLoader.load(
            os.path.join(city["parts"], f"partition_{pi:03d}"), "cpu")
        arrays = {k: getattr(state.params, k).numpy()
                  for k in ("means", "scales", "rotations", "opacities",
                            "shs_dc", "shs_rest")}
        jstate = JaxState(params=JaxParams(**{k: jnp.asarray(v)
                                              for k, v in arrays.items()}),
                          alive=jnp.ones(state.capacity, bool))
        jcams, tcams = _blend_cameras(city, pi)

        def jrender(gs, camera, bias):
            return jr.forward(gs, camera, H, W, jnp.zeros(3), shd,
                              rgbs_override=jr.get_rgbs(gs, camera, shd)
                              + bias[:, None]).render

        want = np.asarray(jl.accumulate_blend_weights(jrender, jstate,
                                                      jcams))
        got = tl.accumulate_blend_weights(
            tl.bias_render(renderer, shd, torch.zeros(3)), state, tcams)
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-3, atol=1e-4)
        pruned, _, _ = jl.prune_by_importance(jstate, None,
                                              jnp.asarray(want), 0.5)
        kept = load_gaussian_ply(os.path.join(
            city["parts"], "lod1", f"partition_{pi:03d}", "point_cloud",
            "iteration_1", "point_cloud.ply"))
        np.testing.assert_array_equal(
            kept["means"], arrays["means"][np.asarray(pruned.alive)])


def test_prune_blend_raises_on_a_broken_or_missing_snapshot(city, tmp_path):
    parts = str(tmp_path / "parts")
    shutil.copy(os.path.join(city["parts"], "partitions.npz"), parts + ".npz")
    os.makedirs(os.path.join(parts, "partition_000"))
    shutil.copy(parts + ".npz", os.path.join(parts, "partitions.npz"))
    with pytest.raises(FileNotFoundError, match="no config.yaml snapshot"):
        prune_partitions.main([parts, "--dst", "lod1", "--device", "cpu"])
    snap = os.path.join(parts, "partition_000", "config.yaml")
    with open(snap, "w") as f:
        f.write("data:\n  path: /nonexistent/scene\n")
    with pytest.raises(RuntimeError, match="config.yaml gives no cameras"):
        prune_partitions.main([parts, "--dst", "lod1", "--device", "cpu"])


def test_finetune_partition_fits_from_lod1_on_the_cpu(city):
    """Fine-tuning partition 0 from its pruned level starts from the
    level's rows and writes its own run (gsl_tpu's writes into the base
    run, which its snapshot names)."""
    lod1 = os.path.join(city["parts"], "lod1", "partition_000")
    if not os.path.isdir(lod1):
        prune_partitions.main([city["parts"], "--dst", "lod1", "--percent",
                               "0.5", "--mode", "opacity", "--device",
                               "cpu"])
    base_snap = os.path.join(city["parts"], "partition_000", "config.yaml")
    with open(base_snap) as f:
        before = f.read()
    assert finetune_partition.main([city["parts"], "0", "--steps", "3",
                                    "--device", "cpu"]) == 0
    run = os.path.join(city["parts"], "lod1_ft", "partition_000")
    assert os.path.isfile(os.path.join(run, "checkpoints", "step_3",
                                       "state.pt"))
    with open(os.path.join(run, "train_log.csv")) as f:
        first = list(csv.reader(f))[1]
    n_lod1 = load_gaussian_ply(os.path.join(
        lod1, "point_cloud", "iteration_1", "point_cloud.ply"))[
            "means"].shape[0]
    assert int(first[2]) == n_lod1
    with open(base_snap) as f:
        assert f.read() == before


def test_val_partition_lod_matches_the_root_tool(city, tmp_path):
    """The LoD scores of the val split over two PLY levels (each run's
    final PLY whole, and its opacity prune): the root tool's CSV rows,
    names, rows assembled and levels equal, PSNR within 1e-3 dB, SSIM
    within 1e-4."""
    parts = str(tmp_path / "parts")
    os.makedirs(parts)
    shutil.copy(os.path.join(city["parts"], "partitions.npz"), parts)
    for pi in range(2):
        name = f"partition_{pi:03d}"
        _write_ply_run(os.path.join(parts, "fine", name), load_gaussian_ply(
            os.path.join(city["parts"], name, "point_cloud", "iteration_6",
                         "point_cloud.ply")))
    prune_partitions.main([parts, "--src", "fine", "--dst", "coarse",
                           "--mode", "opacity", "--device", "cpu"])
    cfg = str(tmp_path / "scene.yaml")
    with open(cfg, "w") as f:
        f.write(f"data:\n  path: {city['data']}\n"
                "  parser:\n    class_path: Colmap\n")
    args = [parts, "--names", "fine", "coarse", "--lod-distances", "0.3",
            "--config", cfg, "--split", "train", "--visibility-filter"]
    _run_root_tool(["tools/val_partition_lod.py"] + args
                   + ["--output", str(tmp_path / "root.csv")])
    val_partition_lod.main(args + ["--output", str(tmp_path / "port.csv"),
                                   "--device", "cpu"])
    with open(str(tmp_path / "root.csv")) as f:
        want = list(csv.reader(f))
    with open(str(tmp_path / "port.csv")) as f:
        got = list(csv.reader(f))
    assert len(got) == len(want) == 2 + 2 * VIEWS
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g[0] == w[0] and g[3:] == w[3:]
        assert abs(float(g[1]) - float(w[1])) < 1e-3
        assert abs(float(g[2]) - float(w[2])) < 1e-4
    assert len({r[4] for r in got[1:-1]}) >= 2     # both levels were taken
