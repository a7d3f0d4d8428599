"""gsl_tpu_torch's distributed fit on the CPU (gloo ranks spawned by the
test or by the CLI): it densifies; mixed image sizes train through the
masked loss, validate and log, step for step with gsl_tpu's fit until the
first densify; a resumed run ends bit for bit equal to an uninterrupted
one; ``cli fit`` spawns its ranks, ``cli validate`` reads what they wrote
and a failed rank fails the CLI, named; the multi-host launcher; the
DataLoader's rank slices against gsl_tpu's; the two mp tools."""
import csv
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from gsl_tpu.data.dataset import DataLoader as JDataLoader
from gsl_tpu.parallel import gaussian_sharded as jgs
from gsl_tpu.parallel.fit_distributed import fit_distributed as jfit
from gsl_tpu.renderers.tile_renderer import TileRendererConfig as JTileCfg
from gsl_tpu.training.fit import FitConfig as JFitConfig

from gsl_tpu_torch import cli
from gsl_tpu_torch.data.dataset import DataLoader
from gsl_tpu_torch.parallel.launch import spawn
from gsl_tpu_torch.utils.checkpoint import read_state_dict

import torch_parallel_ranks as ranks
from test_parallel import _dist_dataset, _dist_trainer
from test_torch_fit_e2e import make_dataset
from test_torch_parallel import _exact_train_loss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DP, MP = 2, 2
N_DEV = DP * MP
needs_devices = pytest.mark.skipif(len(jax.devices()) < N_DEV,
                                   reason="needs 4 virtual devices")


def _mp_log(run):
    with open(os.path.join(run, "mp_log.csv")) as f:
        return list(csv.reader(f))


def _fit(tmp_path, sizes, out, **fit_kwargs):
    root = tmp_path / "data"
    root.mkdir(exist_ok=True)
    outputs = ranks.dist_outputs(str(root), sizes)
    kw = dict(output_dir=str(tmp_path / out), save_ply=False,
              min_capacity=8192, save_iterations=[], resume="never")
    kw.update(fit_kwargs)
    interval = kw.pop("densification_interval", 5)
    val = kw.pop("val_at_end", True)
    return spawn(ranks.fit_rank, N_DEV, "cpu",
                 args=(DP, MP, outputs, kw, interval, val))


def test_fit_distributed_densifies(tmp_path):
    """tests/test_parallel.py::test_fit_distributed_loop: 12 steps with
    densification on the sharded state."""
    got = _fit(tmp_path, [(32, 32)] * 8, "out", max_steps=12, log_interval=6,
               save_ply=True)
    n_alive, step, _ = got[0]
    assert n_alive > 200, f"sharded densify never fired (n={n_alive})"
    assert step == 12
    assert [g[0] for g in got] == [n_alive] * N_DEV
    assert os.path.isfile(str(tmp_path / "out" / "point_cloud" /
                              "iteration_12" / "point_cloud.ply"))
    rows = _mp_log(str(tmp_path / "out"))
    assert rows[0] == ["step", "loss", "n_alive", "shard_min", "shard_max",
                       "compact_k", "exchange_bytes", "overflow",
                       "it_per_s"]
    assert [r[0] for r in rows[1:]] == ["6", "12"]


@needs_devices
def test_mixed_sizes_and_masks_step_with_jax(tmp_path):
    """Mixed sizes (test_parallel.py:369-385) through the masked loss:
    both packages pad to 32x32 here (gsl_tpu with size_bucket 8, the port
    to the largest image), so each step's loss and the exchange log equal
    gsl_tpu's up to the first densify, whose draws differ. gsl_tpu runs in
    the exact mode (its exact SSIM) with slot limits above the dead rows
    its capacity piles onto the origin's tile, so it drops no splat."""
    sizes = [(32, 32)] * 4 + [(24, 32)] * 4
    got = _fit(tmp_path, sizes, "port", max_steps=10, log_interval=1)
    n_alive, _, results = got[0]
    assert n_alive > 200
    assert results is not None and np.isfinite(results["psnr"])
    assert os.path.isfile(str(tmp_path / "port" / "metrics" / "val.csv"))

    jroot = tmp_path / "jax_data"
    jroot.mkdir()
    trainer = _dist_trainer()
    trainer.renderer_cfg = JTileCfg(min_isect_capacity=65536,
                                    max_per_tile=20480, chunk=32)
    cfg = JFitConfig(max_steps=5, output_dir=str(tmp_path / "jax"),
                     log_interval=1, save_ply=False, min_capacity=8192,
                     save_iterations=[], size_bucket=8, resume="never")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgs, "train_loss", _exact_train_loss)
        jfit(trainer, _dist_dataset(jroot, sizes), cfg,
             mesh=jgs.make_mesh(N_DEV, dp=DP, mp=MP), backend="xla",
             val_at_end=False)
    want = _mp_log(str(tmp_path / "jax"))
    mine = _mp_log(str(tmp_path / "port"))
    assert mine[0] == want[0]
    for m, w in zip(mine[1:6], want[1:]):
        np.testing.assert_allclose(float(m[1]), float(w[1]), rtol=1e-5)
        assert m[2:8] == w[2:8], (m, w)


def test_resume_is_bit_exact(tmp_path):
    """A checkpoint saved mid-run resumes to step 9 (test_parallel.py:
    388-410), through a densify after the resume, and ends equal bit for
    bit to an uninterrupted run: state, moments, statistics, generator."""
    sizes = [(32, 32)] * 8
    common = dict(log_interval=3, densification_interval=4,
                  val_at_end=False)
    _fit(tmp_path, sizes, "out", max_steps=6, save_iterations=[4],
         **common)
    assert os.path.isdir(str(tmp_path / "out" / "checkpoints" / "step_4"))
    got = _fit(tmp_path, sizes, "out", max_steps=9, resume="auto",
               **common)
    assert got[0][1] == 9
    _fit(tmp_path, sizes, "straight", max_steps=9, **common)
    a = read_state_dict(str(tmp_path / "out" / "checkpoints" / "step_9"))
    b = read_state_dict(str(tmp_path / "straight" / "checkpoints" /
                            "step_9"))

    def same(x, y, path):
        if isinstance(x, dict):
            assert x.keys() == y.keys(), path
            for k in x:
                same(x[k], y[k], f"{path}.{k}")
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), path
        else:
            assert x == y, path

    same(a, b, "state")
    assert a["step"] == 9
    cols = [r[:8] for r in _mp_log(str(tmp_path / "out"))]
    assert cols == [r[:8] for r in _mp_log(str(tmp_path / "straight"))]


def _cli_config(tmp_path, scene, spec):
    cfg = {"distributed": spec,
           "data": {"parser": {"class_path": "Blender", "init_args": {
               "path": scene, "random_point_count": 300,
               "white_background": False}}},
           "model": {"gaussian": {"sh_degree": 0}},
           "trainer": {"background_color": [0.0, 0.0, 0.0]},
           "fit": {"min_capacity": 8192, "save_iterations": [],
                   "save_ply": True, "log_interval": 4,
                   "resume": "never"}}
    path = str(tmp_path / "dist.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    make_dataset(root)
    return root


def test_cli_fit_spawns_its_ranks_and_validate_reads_the_run(tmp_path,
                                                             scene,
                                                             monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = _cli_config(tmp_path, scene,
                      {"dp": DP, "mp": MP, "compact_k": "auto"})
    state, results = cli.main(["fit", "--config", cfg, "-n", "cli_out",
                               "--output", str(tmp_path), "--max_steps",
                               "8", "--device", "cpu"])
    run = str(tmp_path / "cli_out")
    assert state is None and np.isfinite(results["psnr"])
    for rel in ("point_cloud/iteration_8/point_cloud.ply", "mp_log.csv",
                "config.yaml", "fit_timing.json", "metrics/val.csv",
                "checkpoints/step_8/state.pt",
                "checkpoints/step_8/fit_meta.json"):
        assert os.path.isfile(os.path.join(run, rel)), rel
    assert [r[0] for r in _mp_log(run)[1:]] == ["4", "8"]
    _, val = cli.main(["validate", "--output", str(tmp_path), "-n",
                       "cli_out", "--device", "cpu"])
    assert val["psnr"] == pytest.approx(results["psnr"], abs=1e-4)


def test_cli_exits_nonzero_naming_a_failed_rank(tmp_path, scene):
    """The image the rank at flat index 2 reads first is not a PNG: that
    rank raises, the others are ended, the CLI exits nonzero naming it."""
    import shutil
    data = str(tmp_path / "scene")
    shutil.copytree(scene, data)
    n_views = len([f for f in os.listdir(os.path.join(data, "train"))])
    victim = int(np.random.RandomState(42).permutation(n_views)[2])
    assert victim != 0          # the parser reads image 0 for the size
    with open(os.path.join(data, "train", f"r_{victim}.png"), "wb") as f:
        f.write(b"not a png")
    cfg = _cli_config(tmp_path, data, {"dp": DP, "mp": MP})
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "gsl_tpu_torch.cli", "fit", "--config", cfg,
         "-n", "broken", "--output", str(tmp_path), "--max_steps", "4",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert r.returncode != 0
    assert "Process 2 terminated" in r.stderr, r.stderr[-3000:]
    assert "UnidentifiedImageError" in r.stderr


def test_launcher_runs_a_distributed_fit(tmp_path, scene):
    """tests/test_multihost_launcher.py for the port: one process, a world
    of one joined by env:// on the loopback."""
    cfg = _cli_config(tmp_path, scene, True)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "gsl_tpu_torch.tools.launch_multihost",
         "--num-processes", "1", "--process-id", "0", "fit", "--config",
         cfg, "-n", "mh_out", "--output", str(tmp_path), "--max_steps", "4",
         "--device", "cpu", "fit.save_ply=false"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[multihost] process 0/1" in r.stdout
    assert "process group on gloo" in r.stdout
    assert os.path.isfile(str(tmp_path / "mh_out" / "mp_log.csv"))


class _Indices:
    """A dataset whose items are their indices."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get(self, i):
        return i


@pytest.mark.parametrize("rank,world,shuffle,prefetch,skip", [
    (0, 1, True, True, 0), (1, 3, True, False, 5), (2, 3, True, True, 0),
    (0, 2, False, False, 3), (3, 4, True, True, 7)])
def test_dataloader_slices_equal_jax(rank, world, shuffle, prefetch, skip):
    kw = dict(shuffle=shuffle, seed=11, async_prefetch=prefetch, rank=rank,
              world_size=world, skip=skip)
    got, want = iter(DataLoader(_Indices(13), **kw)), \
        iter(JDataLoader(_Indices(13), **kw))
    assert [next(got) for _ in range(20)] == [next(want) for _ in range(20)]


@pytest.mark.parametrize("tool,header", [
    ("mp_scaling_table", "| world | mesh | backend | exchange |"),
    ("mp_stage_split", "| world | mesh | mode | proj | compact |")])
def test_mp_tools_run_at_worlds_one_and_two(tmp_path, tool, header):
    out = str(tmp_path / "table.md")
    r = subprocess.run(
        [sys.executable, "-m", f"gsl_tpu_torch.tools.{tool}", "--device",
         "cpu", "--worlds", "1", "2", "--n", "1500", "--height", "32",
         "--width", "32", "--iters", "1", "--out", out], cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert header in r.stdout
    with open(out) as f:
        table = f.read()
    rows = [ln for ln in table.splitlines() if ln.startswith("| 1 ")
            or ln.startswith("| 2 ")]
    assert len(rows) == 4, table
    assert "{'dp': 1, 'mp': 2}" in table


def test_overflow_is_checked_on_every_tenth_step_only():
    """gsl_tpu counts and answers the exchange's overflow on steps 10, 20,
    ... only (fit_distributed.py:324); the port mirrors it."""
    from gsl_tpu_torch.parallel.fit_distributed import next_compact_k
    assert next_compact_k(1024, 8192, 9, 50) == 1024
    assert next_compact_k(1024, 8192, 10, 50) == 2048
    assert next_compact_k(1024, 8192, 10, 0) == 1024
    assert next_compact_k(4608, 8192, 20, 1) == 8192     # at most a shard
    assert next_compact_k(1000, 8192, 30, 1) == 2048     # 512-aligned


def test_sharded_step_ignores_four_settings(tmp_path):
    """gsl_tpu's distributed fit takes make_mp_train_step's anti_aliased
    (True), filter_2d (0.3) and lambda_dssim (0.2), and raises the SH
    degree every 1000 steps (fit_distributed.py:246-254, :314), whatever
    the configs say; the port mirrors it: a world of one rank in this
    process, two steps with the four settings changed, logs the losses of
    the defaults."""
    from gsl_tpu_torch.parallel.fit_distributed import (fit_distributed,
                                                        sh_degree_at)
    from gsl_tpu_torch.parallel.gaussian_sharded import make_mesh
    from gsl_tpu_torch.training.fit import FitConfig
    assert [sh_degree_at(s, 3) for s in (1, 999, 1000, 2500, 9000)] == \
        [0, 0, 1, 2, 3]
    assert sh_degree_at(5000, 0) == 0
    root = tmp_path / "data"
    root.mkdir()
    outputs = ranks.dist_outputs(str(root), [(32, 32)] * 4)
    logs = []
    for changed in (False, True):
        trainer = ranks.dist_trainer()
        trainer.model.sh_degree = 1
        if changed:
            trainer.renderer_cfg.anti_aliased = False
            trainer.renderer_cfg.filter_2d_kernel_size = 0.1
            trainer.metrics_cfg.lambda_dssim = 0.5
            trainer.config.sh_degree_interval = 1
        out = str(tmp_path / f"run{int(changed)}")
        fit_distributed(trainer, outputs, FitConfig(
            max_steps=2, output_dir=out, log_interval=1, save_ply=False,
            min_capacity=8192, save_iterations=[], resume="never"),
            mesh=make_mesh(1, device="cpu"), val_at_end=False)
        logs.append([r[:8] for r in _mp_log(out)])
    assert logs[0] == logs[1]
