"""The port's serving path against gsl_tpu's on the same parameters:
TileRenderer for every render type, PLY files both ways, the model
loader, ViewerRenderer and the render command."""
import json
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gsl_tpu.data.cameras import make_camera as jax_make_camera
from gsl_tpu.models.gaussian import GaussianParams as JaxParams
from gsl_tpu.models.gaussian import GaussianState as JaxState
from gsl_tpu.renderers.tile_renderer import \
    TileRendererConfig as JaxRendererConfig
from gsl_tpu.utils.gaussian_model_loader import \
    GaussianModelLoader as JaxLoader
from gsl_tpu.utils.ply import load_gaussian_ply as jax_load_ply
from gsl_tpu.utils.ply import save_state_ply as jax_save_state_ply
from gsl_tpu.viewer.renderer import ViewerRenderer as JaxViewerRenderer

from gsl_tpu_torch.data.cameras import make_camera
from gsl_tpu_torch.renderers.tile_renderer import TileRendererConfig
from gsl_tpu_torch.utils.convert import state_from_jax_arrays
from gsl_tpu_torch.utils.gaussian_model_loader import GaussianModelLoader
from gsl_tpu_torch.utils.ply import load_gaussian_ply, save_state_ply
from gsl_tpu_torch.viewer.camera_path import orbit_c2w
from gsl_tpu_torch.viewer.renderer import ViewerRenderer

from scene_utils import random_scene

W, H = 64, 48
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL_TYPES = frozenset({"rgb", "alpha", "acc_depth", "exp_depth",
                       "inverse_depth", "hard_inverse_depth", "normal"})


def scene_params(n=300, cap=320, seed=0):
    """Raw parameters of a random scene, capacity-padded like gsl_tpu's
    states, with the last cap - n slots dead."""
    means, scales, quats, opac, colors = (np.asarray(a) for a in
                                          random_scene(n, seed))
    rng = np.random.RandomState(seed + 100)
    raw = dict(means=means, scales=np.log(scales), rotations=quats,
               opacities=np.log(opac / (1 - opac))[:, None],
               shs_dc=((colors - 0.5) / 0.28209479177387814)[:, None, :],
               shs_rest=0.1 * rng.normal(size=(n, 15, 3)))
    params = {}
    for k, v in raw.items():
        pad = np.zeros((cap - n,) + v.shape[1:])
        if k == "rotations":
            pad[:, 0] = 1.0
        params[k] = np.concatenate([v, pad]).astype(np.float32)
    alive = np.arange(cap) < n
    return params, alive


def jax_state(params, alive):
    return JaxState(params=JaxParams(**{k: jnp.asarray(v)
                                        for k, v in params.items()}),
                    alive=jnp.asarray(alive))


CAMERAS = {"front": np.eye(4),
           "orbit": orbit_c2w(25.0, -15.0, 4.5, np.array([0.0, 0.0, 4.0]))}


@pytest.mark.parametrize("view", sorted(CAMERAS))
def test_tile_renderer_matches_jax_xla_every_output(view):
    """Held against backend="xla" (rasterize_tiles, the same compositing
    semantics; the JAX Pallas branch cannot run on the CPU from the
    renderer, and its hard_inverse_depth call is broken), with
    max_per_tile above the densest tile. rtol 1e-4 / atol 1e-5 as the
    rasterizer tests; exp_depth = acc_depth / alpha divides by alphas as
    small as 1/255, which scales the same error up, hence rtol 1e-3."""
    params, alive = scene_params()
    w2c = np.linalg.inv(CAMERAS[view])
    kw = dict(R=w2c[:3, :3], T=w2c[:3, 3], fx=70.0, fy=70.0, cx=W / 2,
              cy=H / 2, width=W, height=H)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jr = JaxRendererConfig(backend="xla", max_per_tile=4096,
                           chunk=64).instantiate()
    jo = jr.forward(jax_state(params, alive), jax_make_camera(**kw), H, W,
                    jnp.asarray(bg), 3, render_types=ALL_TYPES)
    tr = TileRendererConfig().instantiate()
    to = tr.forward(state_from_jax_arrays(params, alive, device="cpu"),
                    make_camera(device="cpu", **kw), H, W,
                    torch.from_numpy(bg), 3, render_types=ALL_TYPES)
    for key in ("render", "alpha", "acc_depth", "inverse_depth",
                "hard_inverse_depth", "normal", "exp_depth"):
        rtol = 1e-3 if key == "exp_depth" else 1e-4
        got, want = getattr(to, key), np.asarray(getattr(jo, key))
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=1e-5,
                                   err_msg=key)
    assert np.array_equal(to.radii.numpy(), np.asarray(jo.radii))
    assert to.n_isects == int(jo.n_isects) and to.n_dropped == 0
    assert set(tr.get_available_outputs()) == set(jr.get_available_outputs())


def test_stp_resort_renders():
    """The renderer that stp.yaml configures: every output finite, the
    same splats in the same tiles as the plain renderer, and an image close
    to it (only the order inside windows of 16 and the missing stop
    differ). The STP path itself is held to gsl_tpu in test_torch_stp.py."""
    params, alive = scene_params()
    state = state_from_jax_arrays(params, alive, device="cpu")
    cam = make_camera(R=np.eye(3), T=np.zeros(3), fx=70.0, fy=70.0, cx=W / 2,
                      cy=H / 2, width=W, height=H, device="cpu")
    bg = torch.tensor([0.1, 0.2, 0.3])
    stp = TileRendererConfig(stp_resort=True).instantiate()
    assert stp.config.stp_resort and stp.config.tile_based_culling
    out = stp.forward(state, cam, H, W, bg, 3, render_types=ALL_TYPES)
    ref = TileRendererConfig().instantiate().forward(
        state, cam, H, W, bg, 3, render_types=ALL_TYPES)
    for key in ("render", "alpha", "acc_depth", "exp_depth", "inverse_depth",
                "hard_inverse_depth", "normal"):
        got, want = getattr(out, key), getattr(ref, key)
        assert got.shape == want.shape, key
        assert bool(torch.isfinite(got).all()), key
    assert out.n_isects == ref.n_isects
    assert float((out.render - ref.render).abs().mean()) < 0.05
    assert float((out.alpha - ref.alpha).abs().max()) < 0.05


def test_ply_round_trip_both_ways(tmp_path):
    params, alive = scene_params(n=40, cap=48)
    jpath = str(tmp_path / "from_jax.ply")
    assert jax_save_state_ply(jpath, jax_state(params, alive)) == 40
    loaded = load_gaussian_ply(jpath)
    for k, v in params.items():
        np.testing.assert_array_equal(loaded[k], v[alive], err_msg=k)

    tstate = state_from_jax_arrays(params, alive, device="cpu")
    tpath = str(tmp_path / "from_torch.ply")
    assert save_state_ply(tpath, tstate) == 40
    loaded = jax_load_ply(tpath)
    for k, v in params.items():
        np.testing.assert_array_equal(loaded[k], v[alive], err_msg=k)


def _run_dir(tmp_path, n=120):
    params, alive = scene_params(n=n, cap=n)
    for it in (7, 30):   # the loader takes the largest iteration
        jax_save_state_ply(
            str(tmp_path / "run" / "point_cloud" / f"iteration_{it}"
                / "point_cloud.ply"), jax_state(params, alive))
    return str(tmp_path / "run"), params


def test_loader_finds_largest_iteration_and_refuses_checkpoints(tmp_path):
    run, params = _run_dir(tmp_path)
    assert GaussianModelLoader.search_load_file(run).endswith(
        os.path.join("iteration_30", "point_cloud.ply"))
    state, renderer, sh_degree = GaussianModelLoader.load(run, device="cpu")
    assert sh_degree == 3 and state.n_alive == 120
    np.testing.assert_array_equal(state.params.means.numpy(),
                                  params["means"])
    ckpt_only = tmp_path / "ckpt_run" / "checkpoints" / "step_100"
    ckpt_only.mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="orbax"):
        GaussianModelLoader.search_load_file(str(tmp_path / "ckpt_run"))


@pytest.mark.parametrize("output_type", ["rgb", "exp_depth", "normal"])
def test_viewer_renderer_matches_jax(tmp_path, output_type):
    """uint8 images within 1 on at least 99.9% of the values: the float
    images agree to ~1e-5, which moves a value across a rounding edge of
    the x255 quantization now and then.

    The JAX loader pads the state to 4096 slots; the dead slots all
    project to the world origin, and the XLA path's default max_per_tile
    (2048) then cuts real splats out of that tile. So the JAX side renders
    with max_per_tile above the densest tile."""
    run, params = _run_dir(tmp_path)
    js, _, jdeg = JaxLoader.load(run)
    jrend = JaxRendererConfig(backend="xla", max_per_tile=8192).instantiate()
    ts, trend, tdeg = GaussianModelLoader.load(run, device="cpu")
    jv = JaxViewerRenderer(js, jrend, jdeg)
    tv = ViewerRenderer(ts, trend, tdeg)
    jv.output_type = tv.output_type = output_type
    c2w = orbit_c2w(30.0, -10.0, 6.0, params["means"].mean(0))
    got = tv.get_outputs(c2w, W, H)
    want = jv.get_outputs(c2w, W, H)
    assert got.shape == want.shape == (H, W, 3) and got.dtype == np.uint8
    close = np.abs(got.astype(int) - want.astype(int)) <= 1
    assert close.mean() >= 0.999
    np.testing.assert_allclose(tv.get_depth(c2w, W, H),
                               jv.get_depth(c2w, W, H), rtol=1e-3,
                               atol=1e-5)


def test_render_command_writes_frames(tmp_path):
    run, _ = _run_dir(tmp_path, n=60)
    kf = tmp_path / "camera_path.json"
    kf.write_text(json.dumps({"keyframes": [[0, -10, 5], [45, -20, 6]]}))
    out = tmp_path / "frames"
    r = subprocess.run(
        [sys.executable, "-m", "gsl_tpu_torch.render", run, "--device",
         "cpu", "--keyframes", str(kf), "--n_frames", "3", "--size", "24",
         "--output", str(out)],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-1500:]
    assert sorted(os.listdir(out))[:3] == ["00000.png", "00001.png",
                                           "00002.png"]
