"""gsl_tpu_torch's SH-preserving transforms, model editor, LPIPS and the
PLY / checkpoint tools against gsl_tpu's on the same seeded inputs; the
tools against the repo-root tools on the same files."""
import csv
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gsl_tpu import cli as jcli
from gsl_tpu.models.gaussian import GaussianParams as JaxParams
from gsl_tpu.models.gaussian import GaussianState as JaxState
from gsl_tpu.ops import lpips as jlpips
from gsl_tpu.utils import gaussian_transforms as jtf
from gsl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from gsl_tpu.utils.gaussian_model_editor import \
    MultipleGaussianModelEditor as JaxEditor

from gsl_tpu_torch import cli
from gsl_tpu_torch.ops import lpips as L
from gsl_tpu_torch.training.fit import _init_gaussians, validate
from gsl_tpu_torch.utils import gaussian_transforms as tf
from gsl_tpu_torch.utils.checkpoint import save_checkpoint
from gsl_tpu_torch.utils.convert import (state_dict_from_flax,
                                         state_from_raw_arrays)
from gsl_tpu_torch.utils.gaussian_model_editor import \
    MultipleGaussianModelEditor
from gsl_tpu_torch.utils.ply import load_gaussian_ply, save_gaussian_ply

from test_lpips import _random_weights
from test_torch_fit_e2e import REPO, make_colmap_dataset, make_dataset
from torch_port_utils import PARAM_FIELDS

sys.path.insert(0, os.path.join(REPO, "tools"))


def _arrays(n, k_rest, seed):
    rng = np.random.RandomState(seed)
    return dict(
        means=rng.normal(size=(n, 3)).astype(np.float32) + [0, 0, 4],
        scales=rng.uniform(-4, -2, (n, 3)).astype(np.float32),
        rotations=rng.normal(size=(n, 4)).astype(np.float32),
        opacities=rng.normal(size=(n, 1)).astype(np.float32),
        shs_dc=rng.normal(size=(n, 1, 3)).astype(np.float32),
        shs_rest=rng.normal(0, 0.3, (n, k_rest, 3)).astype(np.float32))


def _jax_state(arrays, alive=None):
    n = arrays["means"].shape[0]
    alive = np.ones(n, bool) if alive is None else alive
    return JaxState(params=JaxParams(**{k: jnp.asarray(v)
                                        for k, v in arrays.items()}),
                    alive=jnp.asarray(alive))


def _port_state(arrays, alive=None):
    s = state_from_raw_arrays(arrays, device="cpu")
    return s if alive is None else dataclasses.replace(
        s, alive=torch.from_numpy(alive))


def _rot(seed):
    q = np.random.RandomState(seed).normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


# ---- transforms -----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sh_rotation_matrices_match_jax(seed):
    R = _rot(seed)
    got, want = tf.sh_rotation_matrices(R, 3), jtf.sh_rotation_matrices(R, 3)
    assert [m.shape for m in got] == [(3, 3), (5, 5), (7, 7)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5)
        np.testing.assert_allclose(g @ g.T, np.eye(len(g)), atol=1e-10)
    for M in tf.sh_rotation_matrices(np.eye(3), 2):
        np.testing.assert_allclose(M, np.eye(len(M)), atol=1e-12)


@pytest.mark.parametrize("k_rest", [0, 3, 8, 15])
def test_rotate_scale_translate_state_match_jax(k_rest):
    arrays = _arrays(150, k_rest, seed=k_rest)
    R, t = _rot(7).astype(np.float32), np.array([0.3, -1.0, 2.0], np.float32)
    got = tf.translate_state(tf.scale_state(tf.rotate_state(
        _port_state(arrays), R), 1.7), t)
    want = jtf.translate_state(jtf.scale_state(jtf.rotate_state(
        _jax_state(arrays), R), 1.7), t)
    for k in PARAM_FIELDS:
        np.testing.assert_allclose(getattr(got.params, k).numpy(),
                                   np.asarray(getattr(want.params, k)),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


# ---- the editor -----------------------------------------------------------

def test_editor_merge_transform_delete_match_jax(tmp_path):
    a, b = _arrays(60, 0, seed=10), _arrays(40, 8, seed=11)
    alive_a = np.arange(60) % 7 != 0
    ed = MultipleGaussianModelEditor([_port_state(a, alive_a),
                                      _port_state(b)])
    jed = JaxEditor([_jax_state(a, alive_a), _jax_state(b)])
    assert ed.n_gaussians() == jed.n_gaussians() == int(alive_a.sum()) + 40
    for e in (ed, jed):
        e.transform(0, translate=(1.0, -2.0, 0.5), rotation=_rot(3),
                    scale=0.8)
    lo, hi = [-1.0, -1.0, 3.0], [1.0, 1.0, 5.0]
    n = ed.delete_in_box(1, lo, hi)
    assert n == jed.delete_in_box(1, lo, hi) and 0 < n < 40
    assert ed.n_gaussians(1) == jed.n_gaussians(1) == 40 - n

    got, want = ed.merged(), jed.merged()
    assert bool(got.alive.all()) and got.capacity == ed.n_gaussians()
    walive = np.asarray(want.alive)
    for k in PARAM_FIELDS:
        np.testing.assert_allclose(getattr(got.params, k).numpy(),
                                   np.asarray(getattr(want.params, k))[walive],
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert got.params.shs_rest.shape[1] == 8

    ed.reset(0)
    jed.reset(0)
    np.testing.assert_array_equal(
        ed.merged().params.means.numpy(),
        np.asarray(jed.merged().params.means)[np.asarray(
            jed.merged().alive)])
    assert ed.save_ply(str(tmp_path / "m.ply")) == ed.n_gaussians()
    mask = np.zeros(60, bool)
    mask[:10] = True
    ed.delete_gaussians(0, mask)
    jed.delete_gaussians(0, mask)
    assert ed.n_gaussians() == jed.n_gaussians()


# ---- LPIPS ----------------------------------------------------------------

def test_lpips_matches_jax_with_random_weights(tmp_path):
    path = _random_weights(tmp_path)
    w, jw = L.load_weights(path), jlpips.load_weights(path)
    rng = np.random.RandomState(1)
    a = rng.rand(64, 96, 3).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1).astype(np.float32)
    c = rng.rand(64, 96, 3).astype(np.float32)
    for x, y in ((a, b), (a, c), (b, c), (a, a)):
        got = float(L.lpips(torch.from_numpy(x), torch.from_numpy(y), w))
        want = float(jlpips.lpips(jnp.asarray(x), jnp.asarray(y), jw))
        assert got == pytest.approx(want, rel=1e-4, abs=1e-7)
    assert float(L.lpips(torch.from_numpy(a), torch.from_numpy(a), w)) \
        == pytest.approx(0.0, abs=1e-6)


def test_lpips_weights_search_path(tmp_path, monkeypatch):
    monkeypatch.setenv("GSL_LPIPS_WEIGHTS", str(tmp_path / "missing.npz"))
    L.get_lpips_fn.cache_clear()
    assert L.load_weights() is None and L.get_lpips_fn() is None
    monkeypatch.delenv("GSL_LPIPS_WEIGHTS")
    assert L.default_weights_path() == os.path.join(REPO, "weights",
                                                    "lpips_alex.npz")
    assert L.default_weights_path() == jlpips.default_weights_path()
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, x=np.zeros(1))
    with pytest.raises(ValueError, match="missing keys"):
        L.load_weights(bad)
    L.get_lpips_fn.cache_clear()


def test_validate_fills_the_lpips_column(tmp_path, monkeypatch):
    """With weights the column is `lpips` and every row and the MEAN hold
    a value (the port's lpips of that render); without, it is
    `lpips(unavailable)` and empty, as gsl_tpu writes it."""
    scene = str(tmp_path / "scene")
    make_dataset(scene, n_views=3)
    cfg = cli.load_config([os.path.join(REPO, "gsl_tpu_torch", "configs",
                                        "blender.yaml")], cli.parse_overrides(
        [f"data.path={scene}", "data.parser.init_args.random_point_count=300",
         "model.gaussian.sh_degree=0", "fit.min_capacity=1024",
         f"fit.output_dir={tmp_path / 'run'}"]))
    trainer, dp, fit_cfg = cli.build_components(cfg)
    outputs = dp.instantiate().get_outputs()
    state = trainer.setup(_init_gaussians(trainer, outputs, fit_cfg, "cpu"),
                          outputs.camera_extent)

    def rows():
        with open(os.path.join(fit_cfg.output_dir, "metrics",
                               "val.csv")) as f:
            return list(csv.reader(f))

    monkeypatch.setenv("GSL_LPIPS_WEIGHTS", _random_weights(tmp_path))
    L.get_lpips_fn.cache_clear()
    try:
        res = validate(trainer, state, outputs, fit_cfg)
    finally:
        L.get_lpips_fn.cache_clear()
    got = rows()
    assert got[0] == ["name", "psnr", "ssim", "lpips"]
    values = [float(r[3]) for r in got[1:-1]]
    assert len(values) == 3 and all(v > 0 for v in values)
    assert float(got[-1][3]) == pytest.approx(np.mean(values))
    assert res["lpips"] == pytest.approx(np.mean(values))

    monkeypatch.setenv("GSL_LPIPS_WEIGHTS", str(tmp_path / "missing.npz"))
    res = validate(trainer, state, outputs, fit_cfg)
    L.get_lpips_fn.cache_clear()
    got = rows()
    assert got[0][3] == "lpips(unavailable)"
    assert [r[3] for r in got[1:]] == [""] * 4 and np.isnan(res["lpips"])


# ---- the tools ------------------------------------------------------------

def _write_ply(path, arrays):
    save_gaussian_ply(path, *(arrays[k] for k in PARAM_FIELDS))


@pytest.fixture()
def run_with_ply(tmp_path):
    run = tmp_path / "run"
    ply = run / "point_cloud" / "iteration_7" / "point_cloud.ply"
    os.makedirs(ply.parent)
    _write_ply(str(ply), _arrays(120, 15, seed=4))
    return str(run), str(ply)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_ckpt2ply_and_convert2splat_write_the_root_tools_bytes(
        run_with_ply, tmp_path, monkeypatch):
    import ckpt2ply as root_ckpt2ply
    import convert2splat as root_convert2splat
    from gsl_tpu_torch.tools import ckpt2ply, convert2splat

    run, ply = run_with_ply
    ckpt2ply.main([run, "-o", str(tmp_path / "port.ply"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["ckpt2ply", run, "-o",
                                      str(tmp_path / "root.ply")])
    root_ckpt2ply.main()
    assert _bytes(tmp_path / "port.ply") == _bytes(tmp_path / "root.ply")
    for src in (ply, run):
        convert2splat.main([src, str(tmp_path / "port.splat"), "--device",
                            "cpu"])
        root_convert2splat.main([src, str(tmp_path / "root.splat")])
        data = _bytes(tmp_path / "port.splat")
        assert len(data) == 120 * 32
        assert data == _bytes(tmp_path / "root.splat")

    # a checkpoint of the port exports its alive rows
    state = state_from_raw_arrays(_arrays(50, 3, seed=5), device="cpu")
    from gsl_tpu_torch.training.trainer import Trainer
    ts = Trainer().setup(state, 1.0)
    alive = ts.alive.clone()
    alive[::4] = False
    save_checkpoint(str(tmp_path / "ck" / "checkpoints"),
                    dataclasses.replace(ts, alive=alive))
    out = ckpt2ply.main([str(tmp_path / "ck"), "--device", "cpu"])
    got = load_gaussian_ply(out)
    np.testing.assert_array_equal(got["means"],
                                  state.params.means[alive].numpy())


def test_merge_ply_writes_the_root_tools_bytes(tmp_path):
    import merge_ply as root_merge_ply
    from gsl_tpu_torch.tools import merge_ply

    paths = [str(tmp_path / f"{i}.ply") for i in range(3)]
    for i, (p, k) in enumerate(zip(paths, (3, 0, 8))):
        _write_ply(p, _arrays(30 + 10 * i, k, seed=20 + i))
    merge_ply.main([str(tmp_path / "port.ply"), *paths, "--device", "cpu"])
    root_merge_ply.main([str(tmp_path / "root.ply"), *paths])
    assert _bytes(tmp_path / "port.ply") == _bytes(tmp_path / "root.ply")
    assert load_gaussian_ply(str(tmp_path / "port.ply"))["shs_rest"].shape \
        == (120, 8, 3)


def test_gaussian_transform_matches_the_root_tool(run_with_ply, tmp_path):
    import gaussian_transform as root_gaussian_transform
    from gsl_tpu_torch.tools import gaussian_transform

    _, ply = run_with_ply
    args = ["--rotate-euler", "20", "-35", "90", "--translate", "1", "2",
            "3", "--scale", "1.5"]
    gaussian_transform.main([ply, str(tmp_path / "port.ply"), *args,
                             "--device", "cpu"])
    root_gaussian_transform.main([ply, str(tmp_path / "root.ply"), *args])
    got = load_gaussian_ply(str(tmp_path / "port.ply"))
    want = load_gaussian_ply(str(tmp_path / "root.ply"))
    for k in PARAM_FIELDS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_fuse_mip_filter_matches_the_root_tool(tmp_path, monkeypatch):
    import fuse_mip_filter as root_fuse_mip_filter
    from gsl_tpu_torch.tools import fuse_mip_filter

    scene = str(tmp_path / "scene")
    make_colmap_dataset(scene, n_views=4)
    run = tmp_path / "run"
    ply = run / "point_cloud" / "iteration_1" / "point_cloud.ply"
    os.makedirs(ply.parent)
    arrays = _arrays(200, 3, seed=6)
    arrays["means"][::9] += [0, 0, -50]          # behind every camera
    _write_ply(str(ply), arrays)
    fuse_mip_filter.main([str(run), "--dataset_path", scene, "-o",
                          str(tmp_path / "port.ply"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", [
        "fuse_mip_filter", str(run), "--dataset_path", scene, "-o",
        str(tmp_path / "root.ply")])
    root_fuse_mip_filter.main()
    got = load_gaussian_ply(str(tmp_path / "port.ply"))
    want = load_gaussian_ply(str(tmp_path / "root.ply"))
    for k in PARAM_FIELDS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert not np.allclose(got["scales"], arrays["scales"])


def test_fuse_appearance_embeddings_matches_the_root_tool(tmp_path,
                                                          monkeypatch):
    """One appearance state (gsl_tpu's at setup, its features and network
    as the port's) saved by each package under the same config: both
    tools bake the same colours."""
    import fuse_appearance_embeddings as root_fuse
    from gsl_tpu_torch.tools import fuse_appearance_embeddings

    scene = str(tmp_path / "scene")
    make_dataset(scene, n_views=4)
    overrides = [f"data.path={scene}", "data.parser.class_path=Blender",
                 "data.parser.init_args.random_point_count=300",
                 "data.parser.init_args.white_background=false",
                 "trainer.background_color=[0.0, 0.0, 0.0]",
                 "model.gaussian.init_args.sh_degree=1",
                 "model.gaussian.init_args.appearance_feature_dims=16",
                 "model.n_appearances=4", "fit.min_capacity=1024"]
    presets = [os.path.join(REPO, "gsl_tpu_torch", "configs", p)
               for p in ("blender.yaml", "appearance_embedding.yaml")]
    cfg = cli.load_config(presets, cli.parse_overrides(overrides))
    jtrainer, jdp, jfit = jcli.build_components(
        jcli.load_config(presets, jcli.parse_overrides(overrides)))
    joutputs = jdp.instantiate().get_outputs()
    pc = joutputs.point_cloud
    rng = np.random.RandomState(8)
    jg = jtrainer.model.init_from_pcd(pc.xyz, pc.rgb, 16384)
    feats = np.asarray(jg.params.appearance_features).copy()
    feats[:300] = rng.normal(0, 0.5, (300, 16))
    jg = JaxState(params=jg.params.replace(
        appearance_features=jnp.asarray(feats)), alive=jg.alive)
    jstate = jtrainer.setup(jg, joutputs.camera_extent)
    runs = {}
    for name in ("root", "port"):
        runs[name] = str(tmp_path / name)
        os.makedirs(runs[name])
        with open(os.path.join(runs[name], "config.yaml"), "w") as f:
            import yaml
            yaml.safe_dump(cfg, f)
    jax_save_checkpoint(os.path.join(runs["root"], "checkpoints"), jstate,
                        step=1, meta={"capacity": 16384})

    trainer, dp, fit_cfg = cli.build_components(cfg)
    outputs = dp.instantiate().get_outputs()
    from gsl_tpu_torch.training.fit import setup_state
    state = setup_state(trainer, outputs, trainer.model.init_from_pcd(
        pc.xyz, pc.rgb, 16384, "cpu"))
    params = dataclasses.replace(state.params, appearance_features=(
        torch.from_numpy(feats)))
    net = dict(state.extra["__net__"], params=state_dict_from_flax(
        jax_numpy(jstate.extra["__net__"].params), "cpu"))
    save_checkpoint(os.path.join(runs["port"], "checkpoints"),
                    dataclasses.replace(state, params=params, step=1,
                                        extra=dict(state.extra,
                                                   __net__=net)))
    args = ["--n-average-cameras", "2", "--max-cameras", "3"]
    fuse_appearance_embeddings.main([runs["port"], *args, "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["fuse", runs["root"], *args])
    root_fuse.main()
    got = load_gaussian_ply(os.path.join(runs["port"], "fused.ply"))
    want = load_gaussian_ply(os.path.join(runs["root"], "fused.ply"))
    for k in PARAM_FIELDS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert np.abs(got["shs_dc"] - (pc.rgb[:, None] - 0.5)
                  / 0.28209479177387814).max() > 1e-3


def jax_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def test_entry_points_need_a_card_unless_asked_for_cpu(run_with_ply,
                                                       tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    from gsl_tpu_torch.tools import (ckpt2ply, convert2splat,
                                     fuse_appearance_embeddings,
                                     fuse_mip_filter, gaussian_transform,
                                     merge_ply)
    from gsl_tpu_torch.viewer import __main__ as viewer_main

    run, ply = run_with_ply
    out = str(tmp_path / "out.ply")
    for main, argv in (
            (ckpt2ply.main, [run]), (convert2splat.main, [run, out]),
            (merge_ply.main, [out, ply]),
            (gaussian_transform.main, [ply, out]),
            (fuse_mip_filter.main, [run, "--dataset_path", run]),
            (fuse_appearance_embeddings.main, [run]),
            (viewer_main.main, [run, "--port", "0"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
