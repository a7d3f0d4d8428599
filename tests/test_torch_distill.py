"""gsl_tpu_torch's second stages, SegAny and Feature3DGS, against
gsl_tpu's on the same seeded numpy inputs: the scale gate, the
correspondence loss with gsl_tpu's sampled pixels, the feature render at
C = 37 and 64 with its gradient in the features (on the card the backward
takes those in channel groups; tests/test_torch_kernel_emulation.py holds
the groups to one pass), the SegAny step, the Feature3DGS step with and
without `speedup`, the selection score in its three modes, both parsers,
the state conversions, and the two entry points on the CPU."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_tpu.data.dataparsers.feature_3dgs import \
    Feature3DGSColmapDataParserConfig as JaxFeatureParser
from gsl_tpu.data.dataparsers.segany_colmap import \
    SegAnyColmapDataParserConfig as JaxSegAnyParser
from gsl_tpu.ops.projection import project_gaussians as jax_project
from gsl_tpu.ops.tiling import isect_encode as jax_isect_encode
from gsl_tpu.training import feature3dgs as jf3
from gsl_tpu.training import segany as jsa

from gsl_tpu_torch import feature3dgs as feature3dgs_main
from gsl_tpu_torch import seganygs as seganygs_main
from gsl_tpu_torch.data.dataparsers.feature_3dgs import \
    Feature3DGSColmapDataParserConfig
from gsl_tpu_torch.data.dataparsers.segany_colmap import \
    SegAnyColmapDataParserConfig
from gsl_tpu_torch.training import feature3dgs as tf3
from gsl_tpu_torch.training import segany as tsa
from gsl_tpu_torch.utils.convert import (adam_state_from_jax,
                                         state_from_jax_arrays,
                                         tensors_from_numpy)
from gsl_tpu_torch.utils.ply import save_state_ply

from test_torch_fit_e2e import make_colmap_dataset
from test_torch_training import H, W, _gt_state, _jax_camera, _port_camera

GRAD_RTOL, GRAD_ATOL = 5e-3, 1e-4
RENDER_ATOL = 1e-4
# gsl_tpu's render_features defaults, which the port accepts and ignores
J_CAPACITY, J_PER_TILE = 1 << 18, 1024


def _scene():
    """(gsl_tpu's state, the port's) of the training tests' scene: 150
    alive rows at capacity 256."""
    gt = _gt_state(1)
    port = state_from_jax_arrays(
        {k: np.asarray(getattr(gt.params, k)) for k in (
            "means", "scales", "rotations", "opacities", "shs_dc",
            "shs_rest")}, np.asarray(gt.alive), device="cpu")
    return gt, port


def _assert_nothing_dropped(gt, view):
    """gsl_tpu's XLA render keeps every intersection at this size: the
    slots fit its capacity and every tile its window."""
    cam = _jax_camera(view)
    proj = jax_project(gt.get_means(), gt.get_scales(), gt.get_rotations(),
                       cam.world_to_camera, cam.fx, cam.fy, cam.cx, cam.cy,
                       W, H)
    isects = jax_isect_encode(proj, H, W, 16, J_CAPACITY)
    assert int(isects.n_isects) <= J_CAPACITY
    assert int(jnp.max(isects.tile_counts)) <= J_PER_TILE


def test_scale_gate_matches_jax():
    rng = np.random.RandomState(0)
    f = rng.randn(50, 32).astype(np.float32)
    for s in (0.0, 0.3, 1.0, 1.7):
        np.testing.assert_allclose(
            tsa.scale_gate(torch.from_numpy(f), s).numpy(),
            np.asarray(jsa.scale_gate(jnp.asarray(f), s)), rtol=1e-6,
            atol=1e-7)


def _pixels(key, n, height, width):
    """gsl_tpu's sampled pixels for `key` (correspondence_loss's split)."""
    k1, k2 = jax.random.split(key)
    return (torch.from_numpy(np.asarray(jax.random.randint(
                k1, (n,), 0, height)).astype(np.int64)),
            torch.from_numpy(np.asarray(jax.random.randint(
                k2, (n,), 0, width)).astype(np.int64)))


def _masks(m, height, width, seed):
    """[m, H, W] bool: random rectangles, and a few pixels under none."""
    rng = np.random.RandomState(seed)
    masks = np.zeros((m, height, width), bool)
    for i in range(m):
        y0, x0 = rng.randint(0, height - 4), rng.randint(0, width - 4)
        masks[i, y0:y0 + rng.randint(4, height),
              x0:x0 + rng.randint(4, width)] = True
    masks[:, :3, :3] = False
    return masks


@pytest.mark.parametrize("scale", [None, 0.6])
def test_correspondence_loss_matches_jax(scale):
    """gsl_tpu's draws passed in: the loss within 1e-6 relative and its
    gradient in the feature map within rtol 1e-4 / atol 1e-7."""
    rng = np.random.RandomState(1)
    fmap = rng.randn(H, W, 32).astype(np.float32)
    masks = _masks(6, H, W, 2)
    scales = np.ones(6, np.float32)
    key = jax.random.PRNGKey(4)
    jscale = None if scale is None else jnp.asarray(scale)
    jl, jg = jax.value_and_grad(lambda f: jsa.correspondence_loss(
        key, f, jnp.asarray(masks), jnp.asarray(scales), n_samples=256,
        scale=jscale))(jnp.asarray(fmap))
    t = torch.from_numpy(fmap).requires_grad_(True)
    loss = tsa.correspondence_loss(t, torch.from_numpy(masks),
                                   torch.from_numpy(scales),
                                   *_pixels(key, 256, H, W), scale=scale)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-7)
    assert float(t.grad.abs().max()) > 0


@pytest.mark.parametrize("dims", [37, 64])
def test_render_features_matches_jax(dims):
    """At C = 37 (one channel past K3's group at tile 16) and 64: the map
    and alpha within 1e-4, the gradient of a weighted sum in the features
    within rtol 5e-3 / atol 1e-4; gsl_tpu's XLA buffers drop nothing
    here."""
    gt, port = _scene()
    _assert_nothing_dropped(gt, 1)
    rng = np.random.RandomState(dims)
    feats = rng.randn(port.capacity, dims).astype(np.float32)
    w = rng.randn(H, W, dims).astype(np.float32)

    def jloss(f):
        fmap, alpha = jsa.render_features(gt, f, _jax_camera(1), H, W)
        return jnp.sum(fmap * w), (fmap, alpha)

    (_, (jmap, jalpha)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(feats))
    t = torch.from_numpy(feats).requires_grad_(True)
    fmap, alpha = tsa.render_features(port, t, _port_camera(1), H, W)
    (fmap * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(fmap.detach().numpy(), np.asarray(jmap),
                               rtol=0, atol=RENDER_ATOL)
    np.testing.assert_allclose(alpha.detach().numpy(), np.asarray(jalpha),
                               rtol=0, atol=RENDER_ATOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert float(alpha.max()) > 0.5
    assert float(t.grad.abs().max()) > 0.1


def test_segany_step_matches_jax():
    """Two steps from gsl_tpu's initial features, with its key's pixels:
    the losses within 1e-5 relative and the features after each step
    where their gradient is clear of the tolerance (Adam's first steps are
    near -lr sign(g))."""
    gt, port = _scene()
    cfg = jsa.SegAnyConfig(n_sampled_pixels=256)
    jtrainer = jsa.SegAnyTrainer(cfg, gt)
    jfeat, tx, jopt = jtrainer.init(jax.random.PRNGKey(0))
    jstep = jtrainer.make_train_step(tx, H, W)
    trainer = tsa.SegAnyTrainer(tsa.SegAnyConfig(n_sampled_pixels=256),
                                port)
    feat, opt = trainer.init(features=np.asarray(jfeat))
    masks, scales = _masks(5, H, W, 3), np.ones(5, np.float32)
    for i, view in enumerate((0, 2)):
        key = jax.random.PRNGKey(10 + i)
        jfeat, jopt, jl = jstep(jfeat, jopt, key, _jax_camera(view),
                                jnp.asarray(masks), jnp.asarray(scales),
                                jnp.asarray(1.0))
        feat, opt, loss = trainer.train_step(
            feat, opt, _port_camera(view), torch.from_numpy(masks),
            torch.from_numpy(scales), 1.0, H, W,
            pixels=_pixels(key, 256, H, W))
        assert float(loss) == pytest.approx(float(jl), rel=1e-5)
        mu = opt["exp_avg"]["features"].numpy()
        np.testing.assert_allclose(mu, np.asarray(jopt[0].mu),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL * 0.1)
        sure = np.abs(mu) > 1e-6
        assert sure.sum() > 100
        np.testing.assert_allclose(feat.numpy()[sure],
                                   np.asarray(jfeat)[sure], rtol=1e-5,
                                   atol=1e-6)
    assert opt["count"] == 2


@pytest.mark.parametrize("speedup", [False, True])
def test_feature3dgs_step_matches_jax(speedup):
    """Two steps against a teacher map at a third of the render's size
    (the render resized down) from gsl_tpu's initial state: the losses
    within 1e-5 relative; the features' and the decoder's gradients (first
    moment / 0.1 after step 1) within rtol 5e-3 / atol 1e-4; the values
    after step 1 where the gradient is clear."""
    gt, port = _scene()
    jcfg = jf3.Feature3DGSConfig(speedup=speedup)
    cfg = tf3.Feature3DGSConfig(speedup=speedup)
    assert cfg.actual_dims == jcfg.actual_dims == (64 if speedup else 128)
    jtrainer = jf3.Feature3DGSTrainer(jcfg, gt)
    jparams, _, jopt = jtrainer.init(jax.random.PRNGKey(0))
    jstep = jtrainer.make_train_step(H, W)
    trainer = tf3.Feature3DGSTrainer(cfg, port)
    params, opt = trainer.init(dec_w=(np.asarray(jparams["dec_w"])
                                      if speedup else None))
    teacher = np.random.RandomState(7).randn(16, 21, 128).astype(
        np.float32)
    for step, view in enumerate((1, 0)):
        jparams, jopt, jl = jstep(jparams, jopt, _jax_camera(view),
                                  jnp.asarray(teacher))
        params, opt, loss = trainer.train_step(
            params, opt, _port_camera(view), torch.from_numpy(teacher), H,
            W)
        assert float(loss) == pytest.approx(float(jl), rel=1e-5)
        if step:
            continue
        jmu = _first_moments(jopt, speedup)
        assert sorted(jmu) == sorted(params)
        for k in params:
            g = opt["exp_avg"][k].numpy() / 0.1
            np.testing.assert_allclose(g, jmu[k] / 0.1, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=k)
            sure = np.abs(g) > 1e-4
            # the features start at zero, so the first map is zero and so
            # is the decoder weights' first gradient
            assert sure.sum() > 0 or k == "dec_w", k
            np.testing.assert_allclose(params[k].numpy()[sure],
                                       np.asarray(jparams[k])[sure],
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    assert opt["count"] == 2
    assert sorted(params) == sorted(jparams)


def _first_moments(jopt, speedup):
    """{name: mu} of gsl_tpu's Feature3DGS optimiser state: one adam, or
    under `speedup` optax.multi_transform's two, each masked to its
    labels."""
    import optax
    if not speedup:
        return {k: np.asarray(v) for k, v in jopt[0].mu.items()}
    out = {}
    for label in ("features", "decoder"):
        adam = jopt.inner_states[label].inner_state[0]
        out.update({k: np.asarray(v) for k, v in adam.mu.items()
                    if not isinstance(v, optax.MaskedNode)})
    return out


def test_selection_score_matches_jax():
    """One query (threshold default and given), several with a
    threshold, several by argmax membership with one and two positives;
    and query_edit_mask through the decoder."""
    rng = np.random.RandomState(3)
    f = rng.randn(300, 16).astype(np.float32)
    q1 = rng.randn(1, 16).astype(np.float32)
    q3 = rng.randn(3, 16).astype(np.float32)
    cases = [(q1, {}), (q1, {"score_threshold": 0.6}),
             (q3, {"score_threshold": 0.4}), (q3, {}),
             (q3, {"positive_ids": (0, 2)}),
             (q3, {"positive_ids": (1, 2), "score_threshold": 0.5})]
    for q, kw in cases:
        got = tf3.selection_score(torch.from_numpy(f), torch.from_numpy(q),
                                  **kw).numpy()
        want = np.asarray(jf3.selection_score(jnp.asarray(f),
                                              jnp.asarray(q), **kw))
        np.testing.assert_array_equal(got, want, err_msg=str(kw))
        assert 0 < got.sum() < len(got)
    dec = {"features": f[:, :8], "dec_w": rng.randn(8, 16).astype(
        np.float32), "dec_b": rng.randn(16).astype(np.float32)}
    np.testing.assert_array_equal(
        tf3.query_edit_mask(tensors_from_numpy(dec, "cpu"),
                            torch.from_numpy(q3)).numpy(),
        np.asarray(jf3.query_edit_mask(
            {k: jnp.asarray(v) for k, v in dec.items()}, jnp.asarray(q3))))


# ---- parsers and entry points ----------------------------------------------

def _distill_scene(root, teacher_dims=16):
    """The fit tests' COLMAP scene (six views named view_i.png) with SAM
    masks for views 0-3 at the parser's names (`<stem>.npz`), scales for
    views 0-1, and teacher maps [teacher_dims, 8, 8] for views 1-4."""
    make_colmap_dataset(root)
    for d in ("semantic/masks", "semantic/scales", "semantic/sam_features"):
        os.makedirs(os.path.join(root, d))
    for i in range(6):
        if i < 4:
            np.savez(os.path.join(root, "semantic/masks", f"view_{i}.npz"),
                     masks=_masks(4, 64, 64, i))
        if i < 2:
            np.save(os.path.join(root, "semantic/scales", f"view_{i}.npy"),
                    np.linspace(0.5, 1.5, 4).astype(np.float32))
        if 1 <= i <= 4:
            np.save(os.path.join(root, "semantic/sam_features",
                                 f"view_{i}.png.npy"),
                    np.random.RandomState(i).randn(
                        teacher_dims, 8, 8).astype(np.float32))


def test_parsers_match_jax(tmp_path):
    """The SegAny parser's mask and scale paths (None where missing) and
    the Feature3DGS parser's map paths, with and without the image's
    extension and with a suffix, per train and val image."""
    root = str(tmp_path / "scene")
    _distill_scene(root)
    got = SegAnyColmapDataParserConfig(path=root).instantiate().get_outputs()
    want = JaxSegAnyParser(path=root).instantiate().get_outputs()
    for s in ("train_set", "val_set"):
        g, w = getattr(got, s), getattr(want, s)
        assert g.image_names == w.image_names
        for k in ("sam_masks", "mask_scales"):
            assert g.extra_data[k] == w.extra_data[k], (s, k)
    assert got.train_set.extra_data["sam_masks"][0].endswith(
        "semantic/masks/view_0.npz")
    assert got.train_set.extra_data["mask_scales"][-1] is None
    for kw in ({}, {"filename_include_image_ext": False,
                    "filename_suffix": "_fmap"}):
        got = Feature3DGSColmapDataParserConfig(
            path=root, **kw).instantiate().get_outputs()
        want = JaxFeatureParser(path=root, **kw).instantiate().get_outputs()
        for s in ("train_set", "val_set"):
            assert (getattr(got, s).extra_data["feature_map_paths"]
                    == getattr(want, s).extra_data["feature_map_paths"])


def test_adam_state_converts_from_optax():
    """optax.adam's state of a feature table as TensorAdam's, which then
    steps as optax does."""
    import optax
    rng = np.random.RandomState(0)
    p = {"features": jnp.asarray(rng.randn(20, 4).astype(np.float32))}
    g = {"features": jnp.asarray(rng.randn(20, 4).astype(np.float32))}
    tx = optax.adam(5e-3)
    s = tx.init(p)
    _, s = tx.update(g, s, p)
    u, s2 = tx.update(g, s, p)
    st = adam_state_from_jax({"features": np.asarray(s[0].mu["features"])},
                             {"features": np.asarray(s[0].nu["features"])},
                             s[0].count, "cpu")
    new, st2 = tsa.SegAnyTrainer(tsa.SegAnyConfig(), None).tx.update(
        tensors_from_numpy(p, "cpu"), tensors_from_numpy(g, "cpu"), st)
    np.testing.assert_allclose(new["features"].numpy(),
                               np.asarray(p["features"] + u["features"]),
                               rtol=1e-6, atol=1e-7)
    assert st2["count"] == int(s2[0].count) == 2


def test_entry_points_distil_on_the_cpu(tmp_path, capsys):
    """`python -m gsl_tpu_torch.seganygs fit` and `python -m
    gsl_tpu_torch.feature3dgs fit [--speedup]` on a PLY and the distill
    scene, `--device cpu`: the root scripts' files and keys, teacher maps
    given channel-first (transposed as the root script does), finite
    losses on the images that have masks or maps; without a device they
    ask for the card and raise."""
    root = str(tmp_path / "scene")
    _distill_scene(root)
    _, port = _scene()
    ply = str(tmp_path / "scene.ply")
    save_state_ply(ply, port)
    n_rows = int(port.alive.sum())          # the PLY keeps the alive rows
    out = str(tmp_path / "seg")
    feats, losses = seganygs_main.main(
        ["fit", ply, "--data.path", root, "--max_steps", "6", "--output",
         out, "--feature_dims", "8", "--device", "cpu"])
    saved = np.load(os.path.join(out, "scene_features.npy"))
    assert saved.shape == (n_rows, 8)
    np.testing.assert_array_equal(saved, feats.numpy())
    # train views are 1-3, 5, 6 of the COLMAP split's order; masks exist
    # for the first three of them
    assert len(losses) >= 3 and all(np.isfinite(list(losses.values())))
    for speedup, keys in ((False, ["features"]),
                          (True, ["dec_b", "dec_w", "features"])):
        out = str(tmp_path / f"f3_{speedup}")
        params, losses = feature3dgs_main.main(
            ["fit", ply, "--data.path", root, "--max_steps", "5",
             "--n_feature_dims", "16", "--output", out, "--device", "cpu"]
            + ["--speedup"] * speedup)
        with np.load(os.path.join(out, "features.npz")) as z:
            assert sorted(z.files) == keys
            assert z["features"].shape == (n_rows, 8 if speedup else 16)
        assert losses and all(np.isfinite(list(losses.values())))
    said = capsys.readouterr().out
    assert "saved features to" in said and "features.npz" in said
    if not torch.cuda.is_available():
        for main in (seganygs_main.main, feature3dgs_main.main):
            with pytest.raises(RuntimeError, match="CUDA"):
                main(["fit", ply, "--data.path", root, "--max_steps", "1",
                      "--output", str(tmp_path / "never")])
