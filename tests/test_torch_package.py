"""Rules of the gsl_tpu_torch package: no JAX and nothing of gsl_tpu in
it, the card by default, every kernel with its source, wrapper, plain
version and launch counter, chip_smoke.py refuses to run without a card."""
import ast
import inspect
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from gsl_tpu_torch.ops import cuda_build
from gsl_tpu_torch.ops import rasterize as R
from gsl_tpu_torch.ops import rasterize_stp as STP
from gsl_tpu_torch.ops import sh as SH
from gsl_tpu_torch.ops import surfel_rasterize as SR

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gsl_tpu")
# source under csrc/ -> (module, wrapper); the plain version is
# <wrapper>_plain in the same module
KERNELS = {
    "expand": (R, "expand"),
    "rasterize_fwd": (R, "rasterize_fwd"),
    "rasterize_bwd": (R, "rasterize_bwd"),
    "reduce_grads": (R, "reduce_grads"),
    "surfel_expand": (SR, "surfel_expand"),
    "surfel_fwd": (SR, "rasterize_surfels_fwd"),
    "surfel_bwd": (SR, "rasterize_surfels_bwd"),
    "rasterize_fwd_stp": (STP, "rasterize_fwd_stp"),
    "rasterize_bwd_stp": (STP, "rasterize_bwd_stp"),
    "sh_fwd": (SH, "sh_colors_fwd"),
    "sh_bwd": (SH, "sh_colors_bwd"),
}


def _launch_counts():
    return {source: getattr(module, wrapper).launches
            for source, (module, wrapper) in KERNELS.items()}


def _port_sources():
    files = sorted((REPO / "gsl_tpu_torch").rglob("*.py"))
    assert len(files) > 10
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_uses_no_compiler_and_no_triton(path):
    text = path.read_text()
    assert "torch.compile" not in text
    assert "triton" not in set(_imported_roots(path))


@pytest.mark.parametrize("name", cuda_build.SOURCES)
def test_kernel_has_source_wrapper_plain_version_and_counter(name):
    assert (cuda_build.CSRC / f"{name}.cu").is_file()
    module, fn = KERNELS[name]
    wrapper, plain = getattr(module, fn), getattr(module, f"{fn}_plain")
    assert callable(plain)
    assert isinstance(wrapper.launches, int)
    source = inspect.getsource(wrapper)
    # CPU tensors go to the plain version, CUDA tensors to the kernel,
    # which is counted where it is launched; nothing catches a failure
    assert "is_cuda" in source and f"{fn}_plain(" in source
    assert source.count(f"{fn}.launches += 1") == 1
    assert "try:" not in source and "except" not in source
    # the source says which TPU kernel it replaces and what bounds it
    text = (cuda_build.CSRC / f"{name}.cu").read_text()
    assert "Replaces gsl_tpu/ops/" in text and "Bound on the H100" in text


def test_every_cuda_source_is_built_and_the_build_is_ignored():
    sources = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))
    assert sources == sorted(cuda_build.SOURCES)
    assert cuda_build.BUILD == REPO / "gsl_tpu_torch" / "build"
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert "gsl_tpu_torch/build/" in ignored


def test_cpu_tensors_launch_no_kernel():
    before = _launch_counts()
    from gsl_tpu_torch.ops.projection import project_gaussians
    rng = np.random.RandomState(0)
    n = 30
    means = torch.tensor(np.concatenate(
        [rng.uniform(-1, 1, (n, 2)), rng.uniform(2, 5, (n, 1))], 1),
        dtype=torch.float32)
    proj = project_gaussians(
        means, torch.full((n, 3), 0.1), torch.tensor([[1.0, 0, 0, 0]] * n),
        torch.eye(4), 40.0, 40.0, 16.0, 16.0, 32, 32)
    colors = torch.rand((n, 3), requires_grad=True)
    img, alpha, _ = R.rasterize(proj, torch.full((n,), 0.5), colors, 32, 32)
    (img.sum() + alpha.sum()).backward()
    assert float(colors.grad.abs().max()) > 0.0
    from gsl_tpu_torch.ops.surfel import project_surfels
    sproj = project_surfels(
        means, torch.full((n, 2), 0.1), torch.tensor([[1.0, 0, 0, 0]] * n),
        torch.eye(4), 40.0, 40.0, 16.0, 16.0, 32, 32)
    channels = torch.rand((n, 6), requires_grad=True)
    res, _ = SR.rasterize_surfels(sproj, torch.full((n,), 0.5), channels,
                                  32, 32)
    (res.channels.sum() + res.distortion.sum()).backward()
    assert float(channels.grad.abs().max()) > 0.0
    colors.grad = None
    img, alpha, _ = R.rasterize(proj, torch.full((n,), 0.5), colors, 32, 32,
                                stp_resort=True)
    (img.sum() + alpha.sum()).backward()
    assert float(colors.grad.abs().max()) > 0.0
    shs_rest = torch.rand((n, 15, 3), requires_grad=True)
    SH.sh_colors(means, torch.zeros(3), torch.rand((n, 1, 3)), shs_rest,
                 3).sum().backward()
    assert float(shs_rest.grad.abs().max()) > 0.0
    assert before == _launch_counts()


def test_kernel_table_covers_every_source():
    assert sorted(KERNELS) == sorted(cuda_build.SOURCES)


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        "gsl_tpu_torch." + ".".join(p.relative_to(REPO / "gsl_tpu_torch")
                                    .with_suffix("").parts)
        for p in (REPO / "gsl_tpu_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_need_a_card_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    from gsl_tpu_torch.data.cameras import make_camera
    from gsl_tpu_torch.render import main
    from gsl_tpu_torch.utils.convert import state_from_raw_arrays
    from gsl_tpu_torch.utils.ply import save_state_ply

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_camera(R=[[1, 0, 0], [0, 1, 0], [0, 0, 1]], T=[0, 0, 0],
                    fx=1.0, fy=1.0, cx=0.0, cy=0.0, width=4, height=4)
    ply = tmp_path / "m.ply"
    arrays = dict(means=np.zeros((2, 3)), scales=np.zeros((2, 3)),
                  rotations=np.tile([1.0, 0, 0, 0], (2, 1)),
                  opacities=np.zeros((2, 1)), shs_dc=np.zeros((2, 1, 3)),
                  shs_rest=np.zeros((2, 0, 3)))
    save_state_ply(str(ply), state_from_raw_arrays(arrays, device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([str(ply), "--n_frames", "1", "--size", "8", "--output",
              str(tmp_path / "out")])

    from gsl_tpu_torch import cli
    argv = ["fit", "--config", str(REPO / "gsl_tpu_torch" / "configs" /
                                   "colmap.yaml"),
            "--data.path", str(tmp_path / "no_scene"), "--output",
            str(tmp_path / "runs")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)
    # on the CPU it gets past the device and on to the (missing) data
    with pytest.raises(FileNotFoundError, match="no COLMAP sparse model"):
        cli.main(argv + ["--device", "cpu"])
    # the distributed fit (a world of one without a card) and its tools
    argv = argv + ["--config", str(REPO / "gsl_tpu_torch" / "configs" /
                                   "distributed.yaml")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)
    with pytest.raises(FileNotFoundError, match="no COLMAP sparse model"):
        cli.main(argv + ["--device", "cpu"])
    from gsl_tpu_torch.tools import mp_scaling_table, mp_stage_split
    for tool in (mp_scaling_table, mp_stage_split):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tool.main(["--worlds", "1"])

    # the quality protocol and the stage profile
    from gsl_tpu_torch.tools import profile_stages, quality_benchmark
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quality_benchmark.main(["--workdir", str(tmp_path / "q")])
    assert not (tmp_path / "q").exists()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_stages.main(["--n", "10"])

    from gsl_tpu_torch.tools import get_depth_scales, gs2d_mesh_extraction
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_depth_scales.main([str(tmp_path / "no_scene")])
    with pytest.raises(SystemExit, match="no COLMAP sparse model"):
        get_depth_scales.main([str(tmp_path / "no_scene"), "--device",
                               "cpu"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gs2d_mesh_extraction.main([str(tmp_path / "no_run")])
    with pytest.raises(FileNotFoundError, match="config.yaml"):
        gs2d_mesh_extraction.main([str(tmp_path / "no_run"), "--device",
                                   "cpu"])


def _run_chip_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_a_host_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    r = _run_chip_smoke(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_without_the_package(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_chip_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
