"""The port's converged-quality protocol and per-stage profile against the
root tools they port (``tools/quality_benchmark.py``,
``tools/profile_stages.py``), which are loaded by path and not edited:
the teacher's draws, the orbit cameras, the teacher's views rendered by
both packages, the trainer and fit config of the protocol, the whole
protocol at a tiny size with its caches and its failures, and the stages
of the profile."""
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

from gsl_tpu.renderers.tile_renderer import \
    TileRendererConfig as JaxRendererConfig

import gsl_tpu_torch.training.fit as fit_module
from gsl_tpu_torch.cli import TPU_ONLY_FIELDS
from gsl_tpu_torch.ops import rasterize as R
from gsl_tpu_torch.renderers.tile_renderer import TileRendererConfig
from gsl_tpu_torch.tools import profile_stages as P
from gsl_tpu_torch.tools import quality_benchmark as Q
from gsl_tpu_torch.utils.convert import state_from_jax_arrays

import torch_port_utils  # noqa: F401  (one torch thread per worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("means", "scales", "rotations", "opacities", "shs_dc", "shs_rest")
# the tiny protocol of the CPU tests: views, resolution, teacher and steps
TINY = ["--device", "cpu", "--views", "8", "--res", "32", "--teacher-n",
        "500", "--steps", "40", "--fast-steps", "20", "--variant-steps",
        "20", "--gs2d-res", "32"]


def _root_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.fixture(scope="module")
def root_quality():
    return _root_tool("quality_benchmark")


def _jax_arrays(state):
    return {k: np.asarray(getattr(state.params, k)) for k in FIELDS}


def test_make_teacher_draws_the_root_tools_rows(root_quality):
    want = _jax_arrays(root_quality.make_teacher(2000))
    got = Q.make_teacher(2000, device="cpu")
    for k in FIELDS:
        g = getattr(got.params, k).numpy()
        assert g.dtype == want[k].dtype and g.shape == want[k].shape, k
        assert np.array_equal(g, want[k]), k
    assert bool(got.alive.all()) and got.capacity == 2000


def test_orbit_cameras_equal_the_root_tools(root_quality):
    want = root_quality.orbit_cameras(8, 64)
    got = Q.orbit_cameras(8, 64)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.world_to_camera.numpy(),
                                   np.asarray(w.world_to_camera), atol=1e-6)
        for k in ("fx", "fy", "cx", "cy"):
            np.testing.assert_allclose(float(getattr(g, k)),
                                       float(getattr(w, k)), atol=1e-6)
        assert (g.width, g.height) == (int(w.width), int(w.height)) == (64,
                                                                        64)


def test_teacher_views_match_jax_exact_mode(root_quality):
    """Four teacher views at 64^2: the port's renderer on the root tool's
    teacher rows against gsl_tpu's exact mode (fast_math=False,
    exact_sort=True) on the XLA backend, as the render parity tests run
    it, with max_per_tile above the densest tile."""
    teacher = root_quality.make_teacher(2000)
    state = state_from_jax_arrays(_jax_arrays(teacher),
                                  np.asarray(teacher.alive), device="cpu")
    jr = JaxRendererConfig(fast_math=False, exact_sort=True, backend="xla",
                           max_per_tile=4096, chunk=64).instantiate()
    tr = TileRendererConfig().instantiate()
    bg = np.zeros(3, np.float32)
    cams = Q.orbit_cameras(4, 64)
    for cam, jcam in zip(cams, root_quality.orbit_cameras(4, 64)):
        want = np.asarray(jr.forward(teacher, jcam, 64, 64, jnp.asarray(bg),
                                     3).render)
        with torch.no_grad():
            got = tr.forward(state, cam, 64, 64, torch.from_numpy(bg),
                             3).render.numpy()
        assert want.std() > 0.01        # the view sees the teacher
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


class _Captured(Exception):
    pass


def _root_protocol(root_quality, monkeypatch, tmp_path, steps):
    """The Trainer and FitConfig that the root tool builds for its full
    run of `steps` steps: its main runs up to the fit, which is replaced
    by a capture (the teacher views exist, so nothing is rendered)."""
    import gsl_tpu.training.fit as jax_fit
    work = tmp_path / f"w{steps}"
    (work / "images").mkdir(parents=True)
    for i in range(8):
        (work / "images" / f"v{i:03d}.png").write_bytes(b"")
    seen = {}

    def capture(trainer, outputs, cfg, **kw):
        seen.update(trainer=trainer, outputs=outputs, cfg=cfg)
        raise _Captured

    monkeypatch.setattr(jax_fit, "fit", capture)
    monkeypatch.setattr(sys, "argv", [
        "quality_benchmark.py", "--views", "8", "--res", "16", "--steps",
        str(steps), "--workdir", str(work)])
    with pytest.raises(_Captured):
        root_quality.main()
    return seen


def _same_fields(port, ref, what):
    """Every field of the port's dataclass equals the reference's; the
    reference's own fields are those the port has or TPU-only ones."""
    names = {f.name for f in dataclasses.fields(port)}
    extra = {f.name for f in dataclasses.fields(ref)} - names
    assert extra <= set(TPU_ONLY_FIELDS), (what, extra)
    for k in names:
        a, b = getattr(port, k), getattr(ref, k)
        if dataclasses.is_dataclass(a):
            _same_fields(a, b, f"{what}.{k}")
        else:
            assert (list(a) if isinstance(a, (list, tuple)) else a) == (
                list(b) if isinstance(b, (list, tuple)) else b), (what, k)


@pytest.mark.parametrize("steps", [30000, 1500])
def test_protocol_equals_the_root_tools(root_quality, monkeypatch, tmp_path,
                                        steps):
    seen = _root_protocol(root_quality, monkeypatch, tmp_path, steps)
    trainer = Q.protocol_trainer(steps)
    ref = seen["trainer"]
    assert type(ref.model).__name__ == type(trainer.model).__name__
    _same_fields(trainer.model, ref.model, "model")
    _same_fields(trainer.renderer_cfg, ref.renderer_cfg, "renderer")
    _same_fields(trainer.density_cfg, ref.density_cfg, "density")
    _same_fields(trainer.config, ref.config, "trainer")
    assert trainer.density_cfg.densify_until_iter == min(steps // 2, 15000)
    cfg = Q.protocol_fit_config(steps, seen["cfg"].output_dir)
    _same_fields(cfg, seen["cfg"], "fit")
    # the student's cloud and the split
    # (the port renders its own views: it refuses the root tool's cache)
    outputs = seen["outputs"]
    root_work = os.path.dirname(os.path.dirname(
        outputs.train_set.image_paths[0]))
    port_work = str(tmp_path / "port")
    port = Q.build_outputs(Q.parse_args(
        ["--device", "cpu", "--views", "8", "--res", "16", "--teacher-n",
         "500", "--workdir", port_work]), 16)
    assert np.array_equal(port.point_cloud.xyz, outputs.point_cloud.xyz)
    assert np.array_equal(port.point_cloud.rgb, outputs.point_cloud.rgb)
    assert port.camera_extent == outputs.camera_extent
    for split in ("train_set", "val_set", "test_set"):
        got, want = getattr(port, split), getattr(outputs, split)
        assert got.image_names == want.image_names
        assert [os.path.relpath(f, port_work) for f in got.image_paths] == \
            [os.path.relpath(f, root_work) for f in want.image_paths]


def _tiny(monkeypatch):
    """The protocol shrunk for the CPU: a cloud of 200 points at exactly
    its own capacity, so the plain rasterizers walk short tile lists."""
    monkeypatch.setattr(Q, "N_POINTS", 200)
    full = Q.protocol_fit_config
    monkeypatch.setattr(Q, "protocol_fit_config", lambda *a, **k: (
        dataclasses.replace(full(*a, **k), min_capacity=0,
                            capacity_multiplier=1.0)))
    monkeypatch.setattr(fit_module, "_round_capacity", lambda n: n)


@pytest.fixture(scope="module")
def tiny_protocol(tmp_path_factory):
    """One tiny protocol run: (its workdir, main's result)."""
    work = tmp_path_factory.mktemp("quality")
    with pytest.MonkeyPatch.context() as mp:
        _tiny(mp)
        result = Q.main(TINY + ["--workdir", str(work)])
    return work, result


def test_protocol_writes_the_report(tiny_protocol):
    work, result = tiny_protocol
    with open(work / "quality.json") as f:
        saved = json.load(f)
    md = (work / "QUALITY.md").read_text()
    assert saved["device"] == result["device"] == "cpu"
    rows = [saved["full"], saved["exact_short"], saved["variants"]["stp"],
            saved["variants"]["gs2d"]]
    for rec in rows:
        assert np.isfinite(rec["psnr"]) and np.isfinite(rec["ssim"])
        assert rec["n_gaussians"] > 0 and rec["minutes"] > 0
    assert saved["variants"]["stp"]["steps"] == 20
    assert saved["variants"]["gs2d"]["steps"] == 20
    for label in ("| full | 40 |", "| short, exact mode | 20 |",
                  "| STP (stp.yaml", "| 2DGS (gs2d.yaml"):
        assert label in md, label
    # the teacher's views: 8 at 32^2, one in 8 held out
    assert len([f for f in os.listdir(work / "images")
                if f.endswith(".png")]) == 8
    assert (work / "full" / "checkpoints" / "step_40").is_dir()


def test_second_call_reads_every_phase_from_its_cache(tiny_protocol,
                                                      monkeypatch,
                                                      tmp_path):
    work, result = tiny_protocol
    again = tmp_path / "again"
    shutil.copytree(work, again)

    def refuse(*a, **k):
        raise AssertionError("a cached phase was fitted or rendered")

    _tiny(monkeypatch)
    monkeypatch.setattr(Q, "fit", refuse)
    monkeypatch.setattr(Q, "make_teacher", refuse)
    second = Q.main(TINY + ["--workdir", str(again)])
    for key in ("full", "exact_short", "variants"):     # lpips NaN
        assert json.dumps(second[key]) == json.dumps(result[key]), key


def test_a_failing_variant_fails_the_protocol(tiny_protocol, monkeypatch,
                                              tmp_path):
    work, _ = tiny_protocol
    again = tmp_path / "again"
    shutil.copytree(work, again)
    (again / "result_stp.json").unlink()
    (again / "QUALITY.md").unlink()

    def broken(*a, **k):
        raise ValueError("the variant broke")

    _tiny(monkeypatch)
    monkeypatch.setattr(Q, "fit", broken)
    with pytest.raises(RuntimeError, match=r"variant stp \(stp.yaml\) "
                                           r"failed: ValueError"):
        Q.main(TINY + ["--workdir", str(again)])
    assert not (again / "QUALITY.md").exists()


@pytest.mark.parametrize("made_otherwise", [
    "result", "checkpoints", "views", "foreign views"])
def test_a_cache_made_otherwise_raises(tiny_protocol, monkeypatch, tmp_path,
                                       made_otherwise):
    """A phase record, a phase's checkpoints or the teacher's views made
    with other arguments, or views that record nothing (another tool's),
    raise naming what differs; nothing is fitted or rendered."""
    work, _ = tiny_protocol
    again = tmp_path / "again"
    shutil.copytree(work, again)
    argv = TINY + ["--workdir", str(again)]
    if made_otherwise == "result":
        argv[argv.index("--steps") + 1] = "41"
        match = r"result_full.json was made with steps=40, not 41"
    elif made_otherwise == "checkpoints":
        (again / "result_full.json").unlink()
        argv[argv.index("--steps") + 1] = "41"
        match = r"full was made with steps=40, not 41"
    elif made_otherwise == "views":
        argv[argv.index("--teacher-n") + 1] = "499"
        match = r"manifest.json was made with teacher_n=500, not 499"
    else:
        (again / "images" / "manifest.json").unlink()
        match = r"images records nothing"

    def refuse(*a, **k):
        raise AssertionError("a phase was fitted or rendered")

    _tiny(monkeypatch)
    monkeypatch.setattr(Q, "fit", refuse)
    monkeypatch.setattr(Q, "make_teacher", refuse)
    with pytest.raises(ValueError, match=match):
        Q.main(argv)


def test_default_workdir_is_the_ports_own_under_the_temporary_directory(
        monkeypatch, tmp_path):
    monkeypatch.setattr(Q.tempfile, "tempdir", str(tmp_path))
    args = Q.parse_args([])
    assert args.workdir == str(tmp_path / "gsl_tpu_torch_quality")
    assert args.out == str(tmp_path / "gsl_tpu_torch_quality" / "QUALITY.md")


def test_report_never_goes_to_the_repos_quality_file():
    with pytest.raises(SystemExit, match="QUALITY.md"):
        Q.parse_args(["--out", os.path.join(REPO, "QUALITY.md")])


def test_profile_stages_prints_every_stage(capsys):
    out = P.main(["--device", "cpu", "--n", "2000", "--height", "64",
                  "--width", "96", "--iters", "1"])
    said = capsys.readouterr().out
    for stage in P.STAGES + (P.E2E, "sum of stages", "pixels/s"):
        assert stage in said, stage
        if stage in out["ms"]:
            assert out["ms"][stage] > 0
    assert out["n_isects"] > 0
    # the e2e row's gradients are one rasterize call's autograd
    H, W = 64, 96
    p = {k: torch.from_numpy(v) for k, v in P.synthetic_arrays(
        2000, P.capacity_of(2000, 1), 3)["params"].items()}
    from gsl_tpu_torch.data.cameras import make_camera
    from gsl_tpu_torch.ops.projection import project_gaussians
    from gsl_tpu_torch.ops.sh import sh_to_rgb
    cam = make_camera(R=np.eye(3), T=np.zeros(3), fx=1600.0, fy=1600.0,
                      cx=W / 2, cy=H / 2, width=W, height=H, device="cpu")
    with torch.no_grad():
        proj = project_gaussians(p["means"], torch.exp(p["scales"]),
                                 p["rotations"], cam.world_to_camera,
                                 cam.fx, cam.fy, cam.cx, cam.cy, W, H)
        colors = sh_to_rgb(torch.cat([p["shs_dc"], p["shs_rest"]], 1),
                           p["means"] - cam.camera_center, 3)
    m2d = proj.means2d.clone().requires_grad_(True)
    con = proj.conics.clone().requires_grad_(True)
    opac = torch.sigmoid(p["opacities"][:, 0]).requires_grad_(True)
    col = colors.clone().requires_grad_(True)
    img, alpha, _ = R.rasterize(proj._replace(means2d=m2d, conics=con),
                                opac, col, H, W, 16)
    want = torch.autograd.grad(img.sum() + alpha.sum(),
                               [m2d, con, opac, col])
    for g, w in zip(out["e2e_grads"], want):
        assert torch.equal(g, w)
    assert any(bool(w.abs().sum() > 0) for w in want)


def test_probe_emulates_the_jax_fast_ssim(monkeypatch):
    """`scripts/torch_quality_probe.py`'s TPU SSIM with its bfloat16
    rounding switched off equals gsl_tpu's ``ssim(fast=True)`` on the CPU
    (where that path's default-precision products are float32) with its
    band blurs taken exact: the clamps and the cap are the JAX package's,
    value and gradient. gsl_tpu's band, split into two bfloat16 parts,
    moves the mean by less than 3e-4 of it. The rounding goes to nearest,
    or toward zero."""
    import jax
    import gsl_tpu.ops.ssim as jax_ssim_module
    spec = importlib.util.spec_from_file_location(
        "torch_quality_probe",
        os.path.join(REPO, "scripts", "torch_quality_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    x = torch.tensor([1.0, 1.0 + 3 * 2 ** -9, -3.3])
    assert probe.to_bf16(x).tolist() == [1.0, 1.0078125, -3.296875]
    assert probe.to_bf16(x, trunc=True).tolist() == [1.0, 1.0, -3.296875]

    rng = np.random.RandomState(3)
    a = rng.rand(3, 40, 52).astype(np.float32)
    b = rng.rand(3, 40, 52).astype(np.float32)
    a[:, 10:30, 10:30] = 0.5          # flat windows, where the clamps act
    b[:, 10:30, 10:30] = 0.5

    def jax_fast(u):
        return jax_ssim_module.ssim(u, jnp.asarray(b), fast=True)

    banded = float(jax_fast(jnp.asarray(a)))
    monkeypatch.setattr(jax_ssim_module, "_blur_mxu", jax_ssim_module._blur)
    want, want_g = jax.value_and_grad(jax_fast)(jnp.asarray(a))
    at = torch.from_numpy(a).requires_grad_(True)
    clamps = probe.tpu_ssim(None)(at, torch.from_numpy(b))
    clamps_g, = torch.autograd.grad(clamps, at)
    monkeypatch.setattr(probe, "to_bf16", lambda v, trunc=False: v)
    got = probe.tpu_ssim("nearest")(at, torch.from_numpy(b))
    got_g, = torch.autograd.grad(got, at)
    # the clamps-only variant is the rounding one without its rounding
    assert torch.equal(clamps, got) and torch.equal(clamps_g, got_g)
    # the two blur orders round apart by an ulp of img^2, which the flat
    # windows' SSIM divides by C2 = 9e-4
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    g = np.asarray(want_g)
    np.testing.assert_allclose(got_g.numpy(), g, rtol=1e-3,
                               atol=1e-3 * np.abs(g).max())
    assert abs(banded - float(want)) < 3e-4 * abs(float(want))
