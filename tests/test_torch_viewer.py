"""gsl_tpu_torch's web viewer, its edit panels and the in-training viewer
against gsl_tpu's: every route over HTTP on the CPU (each server bound to
port 0 and shut down), the frames against gsl_tpu's viewer at 48x48 and
against the port's own ViewerRenderer, the throttle, the measurement, a
fit with --viewer against the same fit without it, and the loader's
optional fields."""
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from gsl_tpu.renderers.surfel_renderer import \
    SurfelRendererConfig as JaxSurfelConfig
from gsl_tpu.renderers.tile_renderer import \
    TileRendererConfig as JaxRendererConfig
from gsl_tpu.viewer import panels as jpanels
from gsl_tpu.viewer.renderer import ViewerRenderer as JaxViewerRenderer
from gsl_tpu.viewer.viewer import _PAGE as JAX_PAGE
from gsl_tpu.viewer.viewer import Viewer as JaxViewer

from gsl_tpu_torch import cli
from gsl_tpu_torch.models.appearance import AppearanceFeatureGaussianConfig
from gsl_tpu_torch.models.pvg import PVGConfig
from gsl_tpu_torch.renderers.surfel_renderer import SurfelRendererConfig
from gsl_tpu_torch.renderers.tile_renderer import TileRendererConfig
from gsl_tpu_torch.training import fit as fit_module
from gsl_tpu_torch.training.trainer import Trainer
from gsl_tpu_torch.utils.checkpoint import save_checkpoint
from gsl_tpu_torch.utils.gaussian_model_loader import GaussianModelLoader
from gsl_tpu_torch.utils.ply import save_state_ply
from gsl_tpu_torch.viewer.camera_path import orbit_c2w
from gsl_tpu_torch.viewer.panels import transform_state
from gsl_tpu_torch.viewer.renderer import ViewerRenderer
from gsl_tpu_torch.viewer.training_viewer import TrainingViewer
from gsl_tpu_torch.viewer.viewer import _PAGE, Viewer

from test_torch_fit_e2e import REPO, make_dataset
from torch_port_utils import small_port_state

SIZE = 48
OUTPUTS = ["rgb", "alpha", "acc_depth", "exp_depth", "inverse_depth",
           "hard_inverse_depth", "normal"]


def _get(base, path, timeout=120):
    return urllib.request.urlopen(base + path, timeout=timeout).read()


def _decode(png):
    return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run with one PLY: 200 Gaussians of SH degree 3 (all alive)."""
    run = tmp_path_factory.mktemp("run")
    save_state_ply(str(run / "point_cloud" / "iteration_100" /
                       "point_cloud.ply"), small_port_state(n=200, seed=3))
    return str(run)


@pytest.fixture(scope="module")
def served(run_dir):
    """The port's viewer on port 0 (idle frames, no fps cap), and
    gsl_tpu's on the same run, not served, with the XLA renderer above
    the densest tile (its loader's padding piles dead rows into one)."""
    v = Viewer(run_dir, port=0, image_size=SIZE, max_fps=1e9,
               moving_window_s=0.0, device="cpu")
    v.start(block=False)
    jv = JaxViewer(run_dir, image_size=SIZE, max_fps=1e9,
                   moving_window_s=0.0)
    jv.renderer.renderer = JaxRendererConfig(
        backend="xla", max_per_tile=8192).instantiate()
    yield v, jv, f"http://127.0.0.1:{v.port}"
    v.stop()


def test_page_and_outputs_match_jax(served):
    v, jv, base = served
    assert v.port > 0
    page = _get(base, "/").decode()
    assert page.replace("gsl_tpu_torch viewer", "gsl_tpu viewer") \
        == JAX_PAGE == _PAGE.replace("gsl_tpu_torch", "gsl_tpu")
    names = json.loads(_get(base, "/outputs"))
    assert names == v.renderer.available_output_types() \
        == jv.renderer.available_output_types() == OUTPUTS
    with pytest.raises(urllib.error.HTTPError, match="404"):
        _get(base, "/nothing")


@pytest.mark.parametrize("output", OUTPUTS)
def test_render_route_matches_jax_and_the_renderer(served, output):
    v, jv, base = served
    png = _get(base, f"/render?yaw=20&pitch=-10&dist=5&output={output}")
    got = _decode(png)
    assert got.shape == (SIZE, SIZE, 3)
    v.renderer.output_type = output
    own = v.renderer.get_outputs(orbit_c2w(20.0, -10.0, 5.0, v.target),
                                 SIZE, SIZE)
    np.testing.assert_array_equal(got, own)
    want = _decode(jv.render_frame(20.0, -10.0, 5.0, output)[0])
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1


def test_concurrent_requests_get_their_own_output(run_dir):
    """Requests for different outputs at once: each PNG is its own
    output's frame (the output type and the render share one lock)."""
    import concurrent.futures
    v = Viewer(run_dir, port=0, image_size=16, max_fps=1e9,
               moving_window_s=0.0, device="cpu")
    want = {}
    for output in OUTPUTS:
        v.renderer.output_type = output
        want[output] = v.renderer.get_outputs(
            orbit_c2w(20.0, -10.0, 5.0, v.target), 16, 16)
    v.start(block=False)
    base = f"http://127.0.0.1:{v.port}"
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        jobs = [OUTPUTS[i % len(OUTPUTS)] for i in range(28)]
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            got = list(pool.map(lambda o: _decode(_get(
                base, f"/render?yaw=20&pitch=-10&dist=5&output={o}",
                timeout=60)), jobs))
    finally:
        sys.setswitchinterval(switch)
        v.stop()
    for output, img in zip(jobs, got):
        np.testing.assert_array_equal(img, want[output], err_msg=output)


def test_throttle_and_measure(run_dir):
    """As tests/test_viewer_http.py::test_viewer_throttle_and_measure, and
    the distance against gsl_tpu's."""
    v = Viewer(run_dir, port=0, image_size=32, max_fps=1000.0,
               moving_window_s=0.2, device="cpu")
    png, res = v.render_frame(0.0, -15.0, 6.0)
    assert res == 32
    v.moving_window_s, v.max_fps = 1e9, 1e9
    png2, res2 = v.render_frame(5.0, -15.0, 6.0)
    assert res2 == 16 and _decode(png2).shape == (16, 16, 3)
    v.moving_window_s, v.max_fps = 0.2, 0.0001
    png3, res3 = v.render_frame(5.0, -15.0, 6.0)
    assert png3 == png2 and res3 == res2
    # an idle frame stands for its pose: asked again, it comes back cached
    v.moving_window_s, v.max_fps = 0.0, 1e9
    idle = v.render_frame(30.0, -15.0, 6.0)
    assert v.render_frame(30.0, -15.0, 6.0) is idle

    jv = JaxViewer(run_dir, image_size=32)
    jv.renderer.renderer = JaxRendererConfig(
        backend="xla", max_per_tile=8192).instantiate()
    for uv in (((0.3, 0.5), (0.7, 0.5)), ((0.45, 0.4), (0.5, 0.62))):
        d, a, b = v.measure(10.0, -15.0, 5.0, *uv)
        jd, ja, jb = jv.measure(10.0, -15.0, 5.0, *uv)
        assert d == pytest.approx(jd, rel=1e-3)
        np.testing.assert_allclose(a, ja, rtol=1e-3)
    v.max_fps = 1000.0
    v.start(block=False)
    try:
        text = _get(f"http://127.0.0.1:{v.port}",
                    "/measure?p1=0.3,0.5&p2=0.7,0.5&yaw=10&pitch=-15"
                    "&dist=5").decode()
        d, _, _ = v.measure(10.0, -15.0, 5.0, (0.3, 0.5), (0.7, 0.5))
        assert text == f"distance {d:.4f}"
    finally:
        v.stop()


def _jax_state_arrays(state):
    alive = np.asarray(state.alive)
    return {k: np.asarray(getattr(state.params, k))[alive]
            for k in ("means", "scales", "rotations", "opacities", "shs_dc",
                      "shs_rest")}


def test_transform_and_delete_routes_match_jax(run_dir):
    v = Viewer(run_dir, port=0, image_size=SIZE, device="cpu")
    jv = JaxViewer(run_dir, image_size=SIZE)
    v.start(block=False)
    base = f"http://127.0.0.1:{v.port}"
    try:
        q = "tx=0.5&ty=-0.25&tz=1&rx=10&ry=-35&rz=60&s=1.5"
        assert _get(base, f"/transform?{q}") == b"ok"
        kw = dict(translate=(0.5, -0.25, 1.0), rotate_deg=(10.0, -35.0, 60.0),
                  scale=1.5)
        direct = transform_state(v._base_state, **kw)
        want = _jax_state_arrays(jpanels.transform_state(jv._base_state,
                                                         **kw))
        for k, w in want.items():
            got = getattr(v.renderer.state.params, k)
            assert torch.equal(got, getattr(direct.params, k)), k
            np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=1e-5,
                                       err_msg=k)

        means = v.renderer.state.params.means.numpy()
        lo = np.round(np.percentile(means, 10, axis=0), 2)
        hi = np.round(np.percentile(means, 80, axis=0), 2)
        box = f"min={','.join(map(str, lo))}&max={','.join(map(str, hi))}"
        n_port = int(_get(base, f"/edit/delete_box?{box}").split()[1])
        js, n_jax = jpanels.delete_in_box(
            jpanels.transform_state(jv._base_state, **kw), lo, hi)
        assert 0 < n_port == n_jax < 200
        assert n_port == int(((means >= lo) & (means <= hi)).all(1).sum())
        np.testing.assert_array_equal(v.renderer.state.alive.numpy(),
                                      np.asarray(js.alive)[:200])
        # a second delete of the same box finds nothing alive there
        assert _get(base, f"/edit/delete_box?{box}") == b"deleted 0"
        assert _get(base, "/transform?reset=1") == b"reset"
        assert v.renderer.state is v._base_state
    finally:
        v.stop()


def test_camera_path_routes(run_dir, tmp_path):
    v = Viewer(run_dir, port=0, image_size=24, device="cpu")
    v.start(block=False)
    base = f"http://127.0.0.1:{v.port}"
    try:
        assert _get(base, "/path/add?yaw=0&pitch=-10&dist=5") \
            == b"1 keyframes"
        assert _get(base, "/path/add?yaw=45&pitch=-20&dist=6") \
            == b"2 keyframes"
        kf = str(tmp_path / "camera_path.json")
        assert _get(base, f"/path/save?file={kf}") == f"saved {kf}".encode()
        with open(kf) as f:
            assert json.load(f)["keyframes"] == [[0, -10, 5], [45, -20, 6]]
        gif = Image.open(io.BytesIO(_get(base, "/path/render.gif")))
        assert gif.n_frames == 30 and gif.size == (24, 24)
        # the last frame is the last keyframe's render
        gif.seek(29)
        v.renderer.output_type = "rgb"
        last = v.renderer.get_outputs(orbit_c2w(45, -20, 6, v.target), 24, 24)
        assert np.abs(np.asarray(gif.convert("RGB")).astype(int)
                      - last.astype(int)).mean() < 8   # GIF's palette
        assert _get(base, "/path/clear") == b"cleared"
        assert v.camera_path.keyframes == []
    finally:
        v.stop()


def test_module_entry_point_serves_on_the_cpu(run_dir):
    """python -m gsl_tpu_torch.viewer RUN --device cpu --port 0 prints the
    port it bound and serves the page and a frame."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "gsl_tpu_torch.viewer", run_dir, "--device",
         "cpu", "--port", "0", "--host", "127.0.0.1", "--image_size", "16"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        port = int(re.search(r":(\d+)$", line.strip()).group(1))
        base = f"http://127.0.0.1:{port}"
        assert b"gsl_tpu_torch viewer" in _get(base, "/")
        assert _decode(_get(base, "/render?output=exp_depth")).shape \
            == (16, 16, 3)
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_surfel_checkpoint_is_served(tmp_path):
    """A 2DGS checkpoint serves through SurfelRenderer, whose outputs the
    viewer lists as gsl_tpu's renderer lists them."""
    state = Trainer().setup(small_port_state(n=120, seed=4), 1.3)
    params = state.params.map(
        lambda k, x: x[:, :2].contiguous() if k == "scales" else x)
    save_checkpoint(str(tmp_path / "checkpoints"),
                    dataclasses.replace(state, params=params))
    v = Viewer(str(tmp_path), port=0, image_size=32, max_fps=1e9,
               moving_window_s=0.0, device="cpu")
    v.start(block=False)
    try:
        base = f"http://127.0.0.1:{v.port}"
        names = json.loads(_get(base, "/outputs"))
        assert names == list(
            JaxSurfelConfig().instantiate().get_available_outputs()) \
            == list(SurfelRendererConfig().instantiate()
                    .get_available_outputs())
        for output in ("rgb", "rend_normal", "surf_depth"):
            got = _decode(_get(base, f"/render?yaw=5&output={output}"))
            v.renderer.output_type = output
            np.testing.assert_array_equal(got, v.renderer.get_outputs(
                orbit_c2w(5.0, -15.0, 6.0, v.target), 32, 32))
        # the measurement unprojects through the surface depth
        text = _get(base, "/measure?p1=0.3,0.5&p2=0.7,0.5&yaw=5").decode()
        d, _, _ = v.measure(5.0, -15.0, 6.0, (0.3, 0.5), (0.7, 0.5))
        assert text == f"distance {d:.4f}" and d > 0
    finally:
        v.stop()


def test_available_output_types_match_jax():
    state = small_port_state(n=20)
    for cfg, jcfg in ((TileRendererConfig, JaxRendererConfig),
                      (SurfelRendererConfig, JaxSurfelConfig)):
        got = ViewerRenderer(state, cfg().instantiate(), 0)
        want = JaxViewerRenderer(None, jcfg().instantiate(), 0)
        assert got.available_output_types() == want.available_output_types()


def test_training_viewer_pump():
    """As tests/test_viewer_http.py::test_training_viewer_pump, on port
    0."""
    tv = TrainingViewer(port=0, image_size=16, pump_interval=2).start()
    base = f"http://127.0.0.1:{tv.port}"
    try:
        st = json.loads(_get(base, "/status?yaw=10&pitch=-10&dist=5"))
        assert st.get("frame") is None
        with pytest.raises(urllib.error.HTTPError, match="404"):
            _get(base, "/frame")
        seen = []

        def render_fn(yaw, pitch, dist):
            seen.append((yaw, pitch, dist))
            return np.full((16, 16, 3), 128, np.uint8)

        tv.pump(1, render_fn, {"loss": 0.25, "n_gaussians": 100})
        assert not seen                  # not a pump step
        tv.pump(2, render_fn, {"loss": 0.5, "n_gaussians": 100})
        assert seen == [(10.0, -10.0, 5.0)] and tv.frames == 1
        tv.pump(4, render_fn, {"loss": 0.5})
        assert len(seen) == 1            # no request pending
        st = json.loads(_get(base, "/status?yaw=10&pitch=-10&dist=5"))
        assert st["frame"] == 1 and st["loss"] == 0.5 and st["step"] == 4
        assert _get(base, "/frame")[:2] == b"\xff\xd8"        # JPEG
        assert b"gsl_tpu_torch training" in _get(base, "/")
    finally:
        tv.stop()


def _fit_argv(scene, out, name, steps, viewer):
    argv = ["fit", "--config", os.path.join(REPO, "gsl_tpu_torch", "configs",
                                            "blender.yaml"),
            "--data.path", scene, "--output", out, "-n", name,
            "--max_steps", str(steps), "--device", "cpu",
            "data.parser.init_args.random_point_count=400",
            "data.parser.init_args.white_background=false",
            "trainer.background_color=[0.0, 0.0, 0.0]",
            "model.gaussian.sh_degree=1", "fit.min_capacity=1024",
            "fit.log_interval=1",
            "model.density.init_args.densify_from_iter=10",
            "model.density.init_args.densification_interval=10"]
    return argv + (["--viewer", "--viewer_port", "0"] if viewer else [])


def _losses(run):
    with open(os.path.join(run, "train_log.csv")) as f:
        return [r.split(",")[1] for r in f.read().splitlines()[1:]]


def test_fit_with_the_viewer_gives_the_same_losses(tmp_path, monkeypatch):
    """A client polls /status and fetches /frame while the fit runs; every
    logged loss equals the same fit's without the viewer."""
    scene = str(tmp_path / "scene")
    make_dataset(scene)
    out = str(tmp_path / "out")
    started = []

    class Recorded(TrainingViewer):
        def start(self):
            started.append(super().start())
            return started[-1]

    monkeypatch.setattr(fit_module, "TrainingViewer", Recorded)
    frames, stop = [], threading.Event()

    def client():
        while not started and not stop.is_set():
            time.sleep(0.01)
        base = f"http://127.0.0.1:{started[0].port}" if started else None
        while base and not stop.is_set():
            try:
                st = json.loads(_get(base, "/status?yaw=15&pitch=-5&dist=3",
                                     timeout=10))
                if st.get("frame"):
                    frames.append(_get(base, "/frame", timeout=10))
            except OSError:
                return                   # the fit ended and stopped it
            time.sleep(0.02)

    poller = threading.Thread(target=client)
    poller.start()
    try:
        cli.main(_fit_argv(scene, out, "viewed", 30, viewer=True))
    finally:
        stop.set()
        poller.join(timeout=30)
    cli.main(_fit_argv(scene, out, "plain", 30, viewer=False))
    assert started and started[0]._server is None     # stopped by the fit
    assert len(frames) > 0 and all(f[:2] == b"\xff\xd8" for f in frames)
    assert _losses(os.path.join(out, "viewed")) \
        == _losses(os.path.join(out, "plain"))
    assert len(_losses(os.path.join(out, "plain"))) == 30


def test_cli_viewer_flag_reaches_fit_config():
    cfg = cli.load_config([os.path.join(REPO, "gsl_tpu_torch", "configs",
                                        "colmap.yaml")],
                          {"fit": {"viewer": True, "viewer_port": 0}})
    _, _, fit_cfg = cli.build_components(cfg)
    assert fit_cfg.viewer is True and fit_cfg.viewer_port == 0


@pytest.mark.parametrize("model,fields", [
    (AppearanceFeatureGaussianConfig(sh_degree=1,
                                     appearance_feature_dims=8,
                                     appearance_feature_init="normal"),
     ("appearance_features",)),
    (PVGConfig(sh_degree=1), ("t_centers", "t_scales", "velocities"))])
def test_loader_keeps_a_checkpoints_optional_fields(tmp_path, model, fields):
    """gsl_tpu's loader keeps every property of a checkpoint; the port's
    keeps them too, alive rows only, and serves the run."""
    rng = np.random.RandomState(0)
    gaussians = model.init_from_pcd(
        rng.uniform(-1, 1, (90, 3)) + [0, 0, 4], rng.rand(90, 3), 128,
        device="cpu")
    state = Trainer(model=model).setup(gaussians, 1.3)
    alive = state.alive.clone()
    alive[::5] = False
    params = state.params.map(
        lambda k, x: x + 0.01 * torch.arange(x.shape[0]).reshape(
            (-1,) + (1,) * (x.ndim - 1)) if k in fields else x)
    save_checkpoint(str(tmp_path / "checkpoints"),
                    dataclasses.replace(state, params=params, alive=alive))
    loaded, _, _ = GaussianModelLoader.load(str(tmp_path), "cpu")
    assert loaded.params.fields() == params.fields()
    for k in params.fields():
        assert torch.equal(getattr(loaded.params, k),
                           getattr(params, k)[alive]), k
    v = ViewerRenderer(loaded, TileRendererConfig().instantiate(), 1)
    assert v.get_outputs(orbit_c2w(0, -10, 6, np.zeros(3)), 16, 16).shape \
        == (16, 16, 3)
