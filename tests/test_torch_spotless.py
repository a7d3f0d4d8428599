"""gsl_tpu_torch's SpotLess slice against gsl_tpu's on the same seeded
numpy inputs: the bilinear resize (`ops/resize.py`, against
`jax.image.resize`), the positional encodings, the robust mask, the
histogram quantile, one SpotLess step with gsl_tpu's weights and keep
draw, the specular reset, the keyword-split parser, the parts the step
refuses, and a CLI fit of `spotless.yaml` resumed bit for bit."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from gsl_tpu.data.dataparsers.spotless_colmap import \
    SpotLessColmapDataParserConfig as JaxSpotLessParser
from gsl_tpu.models.gaussian import VanillaGaussianConfig as JaxModelConfig
from gsl_tpu.renderers.tile_renderer import \
    TileRendererConfig as JaxRendererConfig
from gsl_tpu.training import spotless as jsl
from gsl_tpu.training.trainer import Trainer as JaxTrainer

from gsl_tpu_torch import cli
from gsl_tpu_torch.data.colmap_io import (ColmapCamera, ColmapImage,
                                          ColmapModel, rotmat_to_qvec,
                                          write_model_bin)
from gsl_tpu_torch.data.dataparsers.spotless_colmap import \
    SpotLessColmapDataParserConfig
from gsl_tpu_torch.models.gaussian import VanillaGaussianConfig
from gsl_tpu_torch.ops.resize import resize
from gsl_tpu_torch.training import spotless as tsl
from gsl_tpu_torch.training.trainer import Trainer
from gsl_tpu_torch.utils.convert import (spotless_state_from_jax,
                                         train_state_from_jax_arrays,
                                         train_state_to_numpy)

from test_torch_fit_e2e import _log, _render_views, _scene_arrays
from test_torch_training import (CAPACITY, N_GT, H, W, _gt_state,
                                 _jax_camera, _port_camera, _targets)
from torch_port_utils import PARAM_FIELDS, jax_train_state_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_RTOL, GRAD_ATOL = 5e-3, 1e-4
RESIZE_ATOL = 1e-5
JAX_RENDERER = dict(backend="xla", max_per_tile=256, chunk=32,
                    min_isect_capacity=4096)
N_FEAT = 16           # SD channels of the step test (1280 in the preset)
MASK_SIZE = 32        # the MLP's mask side there (800 in the preset)


# ---- resize ---------------------------------------------------------------

# up and down, by integer and other factors, one axis or two; the SD
# features' 50 -> 800 (x16) at a few channels
@pytest.mark.parametrize("src,dst", [
    ((3, 50, 50), (3, 800, 800)), ((4, 7, 9), (4, 14, 27)),
    ((2, 13, 11), (2, 30, 17)), ((16, 24, 24), (16, 8, 12)),
    ((5, 17, 23), (5, 6, 10)), ((12, 20, 9, 3), (12, 20, 4, 3)),
    ((1, 40, 64), (1, 48, 64))])
def test_resize_matches_jax_image_resize(src, dst):
    """Values within 1e-5, and the gradient of a weighted sum within
    1e-5."""
    rng = np.random.RandomState(sum(src) + sum(dst))
    x = rng.randn(*src).astype(np.float32)
    g = rng.randn(*dst).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst, "bilinear"))
    t = torch.from_numpy(x).requires_grad_(True)
    got = resize(t, dst)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=RESIZE_ATOL)
    (got * torch.from_numpy(g)).sum().backward()
    jg = jax.grad(lambda a: jnp.sum(jax.image.resize(a, dst, "bilinear")
                                    * g))(jnp.asarray(x))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=RESIZE_ATOL)


# ---- the step's parts -----------------------------------------------------

def test_positional_encodings_match_jax():
    """At the preset's mask side and at a small one; the highest
    frequencies (2^19 pi) take sines of arguments up to 1.6e6, where the
    two libraries' range reductions round apart by a few 1e-5 at most."""
    for h, w in ((800, 800), (48, 64)):
        got = tsl.positional_encodings(h, w).numpy()
        want = np.asarray(jsl.positional_encodings(h, w))
        assert got.shape == want.shape == (h, w, 80)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        # the lower 16 frequencies to 1e-5
        low = np.r_[0:16, 20:36, 40:56, 60:76]
        np.testing.assert_allclose(got[..., low], want[..., low], rtol=0,
                                   atol=1e-5)


def test_robust_mask_and_hist_quantile_match_jax():
    """The masks bit for bit at thresholds inside and at the edges of the
    errors; the quantiles of a decayed histogram, an empty one and one
    with a single full bin exactly."""
    rng = np.random.RandomState(4)
    err = rng.uniform(0, 0.3, (48, 64)).astype(np.float32)
    for thr in (0.0, 0.05, 0.15, 0.31):
        np.testing.assert_array_equal(
            tsl.robust_mask(torch.from_numpy(err), thr).numpy(),
            np.asarray(jsl.robust_mask(jnp.asarray(err), thr)))
    hist = (rng.poisson(3.0, 1000) * 0.95 ** rng.randint(0, 9, 1000)
            ).astype(np.float32)
    one = np.zeros(1000, np.float32)
    one[417] = 5.0
    for h in (hist, np.zeros(1000, np.float32), one):
        for q in (0.0, 0.5, 0.7, 0.9, 1.0):
            assert float(tsl.hist_quantile(torch.from_numpy(h), q)) == \
                float(jsl._hist_quantile(jnp.asarray(h), q))


def _jax_spotless(jcfg, hist, seed=0):
    """gsl_tpu's SpotLess state with a given histogram."""
    sls = jsl.init_spotless_state(jax.random.PRNGKey(seed), jcfg)
    return dict(sls, hist=jnp.asarray(hist))


def _spotless_arrays(sls):
    """gsl_tpu's SpotLess state as `spotless_state_from_jax` takes it."""
    adam = sls["opt"][0]
    return {"hist": np.asarray(sls["hist"]),
            "mlp": {k: np.asarray(v) for k, v in sls["mlp"].items()},
            "opt": {"mu": {k: np.asarray(v) for k, v in adam.mu.items()},
                    "nu": {k: np.asarray(v) for k, v in adam.nu.items()},
                    "count": int(adam.count)}}


def _step_setup(step=0):
    gt = _gt_state(1)
    xyz = np.asarray(gt.params.means[:N_GT])
    rgb = np.full((N_GT, 3), 0.5, np.float32)
    kw = dict(n_feature_dims=N_FEAT, max_mlp_mask_size=MASK_SIZE,
              opacity_reg=0.01, densify_until_iter=5)
    jcfg = jsl.SpotLessMetricsConfig(**kw)
    cfg = tsl.SpotLessMetricsConfig(**kw)
    jtrainer = JaxTrainer(model=JaxModelConfig(sh_degree=1),
                          renderer=JaxRendererConfig(**JAX_RENDERER),
                          metrics=jcfg)
    jstate = jtrainer.setup(JaxModelConfig(sh_degree=1).init_from_pcd(
        xyz, rgb, CAPACITY), 1.5)
    # a histogram with mass over the errors' range, so that both robust
    # masks carry information
    rng = np.random.RandomState(8)
    hist = np.zeros(cfg.bin_size, np.float32)
    hist[:3000] = rng.uniform(0, 5, 3000)
    sls = _jax_spotless(jcfg, hist)
    jstate = jstate.replace(step=jnp.asarray(step, jnp.int32),
                            extra={"__spotless__": sls})
    trainer = Trainer(model=VanillaGaussianConfig(sh_degree=1), metrics=cfg)
    trainer.setup(VanillaGaussianConfig(sh_degree=1).init_from_pcd(
        xyz, rgb, CAPACITY, device="cpu"), 1.5)
    arrays = jax_train_state_arrays(jstate.replace(extra=None))
    state = train_state_from_jax_arrays(**arrays, device="cpu",
                                        spotless=_spotless_arrays(sls))
    return jtrainer, jcfg, jstate, trainer, cfg, state, _targets(gt, 1)


@pytest.mark.parametrize("step", [0, 7])
def test_spotless_step_matches_jax(step):
    """One step from the same state, MLP weights, histogram and keep draw
    (gsl_tpu's Bernoulli is its uniform < p): the loss, the MLP's loss,
    L1, SSIM and the mask mean within 1e-5; every Gaussian property's
    gradient (first moment / 0.1) and the MLP's within rtol 5e-3 / atol
    1e-4; the histogram within 4 counts, since an error on a bin edge may
    move a pixel to the next bin (at step 7, past `densify_until_iter`,
    it stays as it was, bit for bit); the density statistics equal."""
    jtrainer, jcfg, jstate, trainer, cfg, state, targets = _step_setup(step)
    sd = np.random.RandomState(5).randn(N_FEAT, 12, 12).astype(np.float32)
    key = jax.random.PRNGKey(11)
    uniform = np.asarray(jax.random.uniform(key, (H, W), jnp.float32))
    jstep = jsl.make_spotless_step(jtrainer, jcfg)
    jnew, jsc = jstep(jstate, _jax_camera(1), jnp.asarray(targets[1].numpy()),
                      jnp.asarray(sd), jnp.zeros(3), key, H, W, 1)
    new, sc = tsl.spotless_step(trainer, cfg, state, _port_camera(1),
                                targets[1], torch.from_numpy(sd),
                                torch.zeros(3), H, W, 1,
                                keep_uniform=torch.from_numpy(uniform))
    for k in ("loss", "spot", "l1", "ssim", "mask_mean"):
        assert float(sc[k]) == pytest.approx(float(jsc[k]), abs=1e-5), k
    assert 0.0 < float(sc["mask_mean"]) < 1.0
    want = train_state_from_jax_arrays(
        **jax_train_state_arrays(jnew.replace(extra=None)), device="cpu",
        spotless=_spotless_arrays(jnew.extra["__spotless__"]))
    alive = new.alive.numpy()
    for k in PARAM_FIELDS:
        np.testing.assert_allclose(
            new.opt_state.exp_avg[k].numpy()[alive] / 0.1,
            want.opt_state.exp_avg[k].numpy()[alive] / 0.1,
            rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)
    got, ref = new.extra["__spotless__"], want.extra["__spotless__"]
    for k in ("w1", "b1", "w2", "b2"):
        g = got["opt"]["exp_avg"][k].numpy() / 0.1
        np.testing.assert_allclose(g, ref["opt"]["exp_avg"][k].numpy() / 0.1,
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)
        assert float(np.abs(g).max()) > 1e-4, k
        # Adam's first step is -lr sign(g) where the gradient is clear
        sure = np.abs(g) > 1e-5
        np.testing.assert_allclose(got["mlp"][k].numpy()[sure],
                                   ref["mlp"][k].numpy()[sure], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert got["opt"]["count"] == 1
    if step < cfg.densify_until_iter:
        moved = np.abs(got["hist"].numpy() - ref["hist"].numpy()).sum()
        assert moved <= 4.0
        assert float(got["hist"].sum()) == pytest.approx(
            float(ref["hist"].sum()), rel=1e-6)
    else:
        np.testing.assert_array_equal(got["hist"].numpy(),
                                      state.extra["__spotless__"][
                                          "hist"].numpy())
    np.testing.assert_array_equal(new.density.denom.numpy(),
                                  want.density.denom.numpy())
    np.testing.assert_allclose(new.density.grad_accum.numpy(),
                               want.density.grad_accum.numpy(),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert new.step == step + 1


def test_spotless_step_draws_from_its_generator_and_takes_a_mask():
    """Without a draw, the keep-mask comes from the generator: the same
    seed, the same step. A mask of zeros on half the image keeps those
    pixels out of the histogram."""
    _, _, _, trainer, cfg, state, targets = _step_setup()
    sd = torch.from_numpy(
        np.random.RandomState(5).randn(N_FEAT, 12, 12).astype(np.float32))

    def run(seed, mask=None):
        return tsl.spotless_step(
            trainer, cfg, state, _port_camera(1), targets[1], sd,
            torch.zeros(3), H, W, 1, mask=mask,
            generator=torch.Generator().manual_seed(seed))

    a, b = run(3), run(3)
    assert torch.equal(a[0].params.means, b[0].params.means)
    assert float(a[1]["loss"]) == float(b[1]["loss"])
    mask = torch.ones((H, W))
    mask[:, W // 2:] = 0.0
    c, _ = run(3, mask)
    added = (c.extra["__spotless__"]["hist"]
             - 0.95 * state.extra["__spotless__"]["hist"])
    assert float(added.sum()) == pytest.approx(H * W / 2, abs=1e-2)


def test_reset_shs_rest_matches_jax():
    """shs_rest clamped at 0.001 and its moments zeroed, the other
    properties' moments and the counts as they were."""
    jtrainer, _, jstate, _, _, state, _ = _step_setup()
    rng = np.random.RandomState(2)
    rest = rng.normal(0, 0.01, jstate.params.shs_rest.shape).astype(
        np.float32)
    jstate = jstate.replace(params=jstate.params.replace(
        shs_rest=jnp.asarray(rest)))
    opt = {k: torch.full_like(v, 0.5)
           for k, v in state.opt_state.exp_avg.items()}
    state = dataclasses.replace(
        state, params=dataclasses.replace(state.params,
                                          shs_rest=torch.from_numpy(rest)),
        opt_state=dataclasses.replace(state.opt_state, exp_avg=opt,
                                      exp_avg_sq=opt))
    jopt = jax.tree.map(lambda x: jnp.full_like(x, 0.5)
                        if x.ndim > 0 else x, jstate.opt_state)
    jnew = jsl.reset_shs_rest(jstate.replace(opt_state=jopt))
    new = tsl.reset_shs_rest(state)
    np.testing.assert_array_equal(new.params.shs_rest.numpy(),
                                  np.asarray(jnew.params.shs_rest))
    assert float(new.params.shs_rest.max()) == np.float32(0.001)
    arrays = jax_train_state_arrays(jnew.replace(extra=None))
    for k in PARAM_FIELDS:
        for m, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            np.testing.assert_array_equal(
                getattr(new.opt_state, key)[k].numpy(), arrays["opt"][k][m])
    assert new.opt_state.count == state.opt_state.count


# ---- the parser, the CLI and resume ----------------------------------------

def make_keyword_scene(root, n_views=7, sd_features=True):
    """The fit tests' COLMAP scene with image names that carry the split's
    keywords (`clutter_i.png` trains, `extra_i.png` evaluates, one name
    with neither), and the SD features `SD/<stem>.npy` [N_FEAT, 8, 8]
    float16 of the first two train images (the others have none)."""
    views, f = _render_views(n_views)
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "SD"))
    images, rng = {}, np.random.RandomState(6)
    for i, (img, T) in enumerate(views):
        name = (f"extra_{i}.png" if i % 3 == 2 else
                "plain.png" if i == n_views - 1 else f"clutter_{i}.png")
        Image.fromarray(img).save(os.path.join(root, "images", name))
        images[i + 1] = ColmapImage(i + 1, rotmat_to_qvec(np.eye(3)), T, 1,
                                    name)
        if sd_features and name.startswith("clutter") and i < 3:
            np.save(os.path.join(root, "SD", name[:-4] + ".npy"),
                    rng.randn(N_FEAT, 8, 8).astype(np.float16))
    arrays = _scene_arrays()
    rgb = np.clip(0.5 + 0.28209479177387814 * arrays["shs_dc"][:, 0], 0, 1)
    write_model_bin(ColmapModel(
        cameras={1: ColmapCamera(1, "PINHOLE", 64, 64,
                                 np.array([f, f, 32.0, 32.0]))},
        images=images, points_xyz=arrays["means"].astype(np.float64),
        points_rgb=(rgb * 255 + 0.5).astype(np.uint8),
        points_err=np.zeros(len(rgb))), os.path.join(root, "sparse", "0"))


def test_spotless_parser_matches_jax(tmp_path):
    """The keyword split (train: `clutter`, val and test: `extra`), the
    image paths, the stacked cameras and the SD feature paths; and
    without the split, the COLMAP split with the feature paths."""
    root = str(tmp_path / "scene")
    make_keyword_scene(root)
    for split in (True, False):
        got = SpotLessColmapDataParserConfig(
            path=root, keyword_split=split).instantiate().get_outputs()
        want = JaxSpotLessParser(path=root, keyword_split=split
                                 ).instantiate().get_outputs()
        for s in ("train_set", "val_set", "test_set"):
            g, w = getattr(got, s), getattr(want, s)
            assert g.image_names == w.image_names, s
            assert g.image_paths == w.image_paths, s
            for k in ("R", "T", "fx", "fy", "cx", "cy"):
                np.testing.assert_allclose(
                    getattr(g.cameras, k).numpy(),
                    np.asarray(getattr(w.cameras, k)), rtol=1e-6, err_msg=k)
            np.testing.assert_array_equal(g.cameras.width.numpy(),
                                          np.asarray(w.cameras.width))
        for s in ("train_set", "val_set"):
            assert (getattr(got, s).extra_data["sd_feature_paths"]
                    == getattr(want, s).extra_data["sd_feature_paths"])
        if split:
            assert got.train_set.image_names == [
                "clutter_0.png", "clutter_1.png", "clutter_3.png",
                "clutter_4.png"]
            assert got.val_set.image_names == ["extra_2.png",
                                               "extra_5.png"]
            assert got.train_set.extra_data == {"sd_feature_paths": [
                os.path.join(root, "SD", f"clutter_{i}.npy")
                for i in (0, 1, 3, 4)]}


def _spotless_argv(root, out, name, steps, extra=()):
    return ["fit", "--config", os.path.join(REPO, "gsl_tpu_torch",
                                            "configs", "spotless.yaml"),
            "--data.path", root, "--output", out, "-n", name,
            "--max_steps", str(steps), "--device", "cpu",
            "fit.min_capacity=1024", "fit.log_interval=1",
            "fit.save_ply=false", "model.gaussian.sh_degree=1",
            f"model.metric.init_args.n_feature_dims={N_FEAT}",
            "model.metric.init_args.max_mlp_mask_size=24",
            "model.metric.init_args.reset_sh=3",
            "model.density.init_args.densify_from_iter=1",
            "model.density.init_args.densification_interval=3", *extra]


def test_spotless_fit_through_the_cli_resumes_bit_for_bit(tmp_path, capsys):
    """`spotless.yaml` on the keyword scene: 6 steps (a densify at 3, the
    specular reset at 3, images with and without SD features), and the
    same run stopped at 4 and resumed to 6; the two end states equal bit
    for bit, the SpotLess state in them too."""
    root = str(tmp_path / "scene")
    make_keyword_scene(root)
    out = str(tmp_path / "runs")
    state, results = cli.main(_spotless_argv(root, out, "full", 6))
    log = _log(os.path.join(out, "full"))
    assert len(log) == 7 and all(np.isfinite(float(r[1])) for r in log[1:])
    assert np.isfinite(results["psnr"])
    sls = state.extra["__spotless__"]
    assert sorted(state.extra) == ["__spotless__"]
    assert sls["mlp"]["w1"].shape == (N_FEAT + 80, 16)
    assert sls["opt"]["count"] == 6
    assert float(sls["hist"].sum()) > 0
    cli.main(_spotless_argv(root, out, "cut", 4,
                            ("fit.save_iterations=[4]",)))
    again, _ = cli.main(_spotless_argv(root, out, "cut", 6))
    assert "resumed" in capsys.readouterr().out
    a, b = train_state_to_numpy(state), train_state_to_numpy(again)
    for k in PARAM_FIELDS:
        np.testing.assert_array_equal(a["params"][k], b["params"][k])
    np.testing.assert_array_equal(a["alive"], b["alive"])
    for x, y in zip(jax.tree.leaves(a["extra"]), jax.tree.leaves(b["extra"])):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("override,part", [
    ("plugins=[normal_reg]", "plugins"),
    ("model.output_processor=exposure", "an output processor"),
    ("model.metric.init_args.rgb_diff_loss=l2", "rgb_diff_loss l2"),
    ("model.metric.init_args.scale_reg=0.01", "scale regulariser"),
    ("model.density.init_args.absgrad=true", "absgrad"),
    ("model.density.class_path=AccurateVisibilityFilterDensityController",
     "accurate-visibility"),
    ("model.density.class_path=GNS", "GNS"),
    ("model.glossy=true", "GlossyTrainer step"),
    ("opt_strategy=grad_acc", "GradAccTrainer step")])
def test_spotless_step_refuses_what_it_would_drop(override, part):
    """Each component gsl_tpu's SpotLess step would drop raises
    ValueError naming both, when the CLI builds the trainer."""
    cfg = cli.load_config(
        [os.path.join(REPO, "gsl_tpu_torch", "configs", "spotless.yaml")],
        cli.parse_overrides([override]))
    with pytest.raises(ValueError, match=rf"SpotLess with .*{part}"):
        cli.build_components(cfg)


def test_spotless_state_converts_from_jax():
    """gsl_tpu's SpotLess state (its MLP drawn from a PRNGKey, optax's
    Adam state) converts to the port's layout, which the step reads."""
    jcfg = jsl.SpotLessMetricsConfig(n_feature_dims=N_FEAT)
    sls = _jax_spotless(jcfg, np.arange(jcfg.bin_size, dtype=np.float32))
    got = spotless_state_from_jax(_spotless_arrays(sls), device="cpu")
    assert sorted(got) == ["hist", "mlp", "opt"]
    np.testing.assert_array_equal(got["mlp"]["w1"].numpy(),
                                  np.asarray(sls["mlp"]["w1"]))
    assert got["opt"]["count"] == 0
    assert sorted(got["opt"]["exp_avg"]) == ["b1", "b2", "w1", "w2"]
    own = tsl.init_spotless_state(tsl.SpotLessMetricsConfig(
        n_feature_dims=N_FEAT), "cpu", torch.Generator().manual_seed(0))
    for k, v in got["mlp"].items():
        assert own["mlp"][k].shape == v.shape, k
    # the draws' scales: N(0, 1/F') and N(0, 1/16)
    assert float(own["mlp"]["w1"].std()) == pytest.approx(
        1 / np.sqrt(N_FEAT + 80), rel=0.1)
    assert isinstance(optax.adam(1e-3).init(sls["mlp"])[0].count,
                      jax.Array)
