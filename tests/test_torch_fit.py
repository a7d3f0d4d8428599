"""gsl_tpu_torch's CLI, checkpoints, model loader and fit loop against
gsl_tpu's: the presets, the components both packages build from them, a
checkpoint round trip, the loader's search order, and a short fit of both
packages on the same scene."""
import csv
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from gsl_tpu import cli as jcli
from gsl_tpu.training.fit import fit as jax_fit

from gsl_tpu_torch import cli
from gsl_tpu_torch.training.fit import _round_capacity, fit, validate
from gsl_tpu_torch.training.trainer import Trainer
from gsl_tpu_torch.utils.checkpoint import (find_latest_checkpoint,
                                            load_checkpoint,
                                            load_checkpoint_meta,
                                            save_checkpoint)
from gsl_tpu_torch.utils.convert import (train_state_from_jax_arrays,
                                         train_state_to_numpy)
from gsl_tpu_torch.utils.gaussian_model_loader import GaussianModelLoader
from gsl_tpu_torch.utils.ply import save_state_ply

from test_fit_e2e import _make_dataset
from torch_port_utils import (PARAM_FIELDS, jax_train_state_arrays,
                              small_port_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = ("colmap.yaml", "blender.yaml", "stp.yaml", "gs2d.yaml",
           "absgrad.yaml", "mip_splatting.yaml", "mcmc.yaml",
           "depth_regularization.yaml", "normal_reg.yaml", "ground_reg.yaml",
           "scale_reg.yaml", "appearance_embedding.yaml",
           "appearance_visibility_map.yaml",
           "appearance_visibility_map_hash.yaml", "swag.yaml",
           "bilagrid.yaml", "exposure.yaml", "grad_acc.yaml",
           "revising.yaml", "taming.yaml", "gns.yaml", "light_gaussian.yaml",
           "glossy.yaml", "deformable.yaml", "gs4d.yaml", "pvg.yaml",
           "spotless.yaml", "segany.yaml")
OVERRIDES = ["data.path=/data/scene",
             "model.density.init_args.densify_from_iter=100",
             "model.density.init_args.densification_interval=50",
             "model.renderer.init_args.max_per_tile=256",
             "model.gaussian.optimization.scales_lr=0.004",
             "fit.log_interval=7", "fit.min_isect_capacity=65536",
             "fit.save_iterations=[10, 20]", "trainer.max_steps=300"]


@pytest.mark.parametrize("name", PRESETS)
def test_preset_copies_equal_the_jax_presets(name):
    with open(os.path.join(REPO, "gsl_tpu_torch", "configs", name),
              "rb") as f:
        got = f.read()
    with open(os.path.join(REPO, "gsl_tpu", "configs", name), "rb") as f:
        assert got == f.read()


def _assert_common_fields_equal(got, want, path):
    assert type(got).__name__ == type(want).__name__, path
    gf = {f.name for f in dataclasses.fields(got)}
    wf = {f.name for f in dataclasses.fields(want)}
    assert gf <= wf, f"{path}: fields the JAX config lacks {gf - wf}"
    assert wf - gf <= set(cli.TPU_ONLY_FIELDS), \
        f"{path}: unported fields {wf - gf}"
    for name in sorted(gf):
        g, w = getattr(got, name), getattr(want, name)
        if dataclasses.is_dataclass(g):
            _assert_common_fields_equal(g, w, f"{path}.{name}")
        elif isinstance(g, (list, tuple)):
            assert list(g) == list(w), f"{path}.{name}"
        else:
            assert g == w, f"{path}.{name}: {g!r} != {w!r}"


@pytest.mark.parametrize("name", PRESETS)
def test_build_components_matches_jax(name, capsys):
    paths = [os.path.join(REPO, "gsl_tpu_torch", "configs", name)]
    cfg = cli.load_config(paths, cli.parse_overrides(OVERRIDES))
    jcfg = jcli.load_config(paths, jcli.parse_overrides(OVERRIDES))
    assert cfg == jcfg
    trainer, dp_cfg, fit_cfg = cli.build_components(cfg)
    jtrainer, jdp_cfg, jfit_cfg = jcli.build_components(jcfg)
    assert type(trainer).__name__ == type(jtrainer).__name__
    for attr in ("model", "renderer_cfg", "density_cfg", "metrics_cfg",
                 "config"):
        _assert_common_fields_equal(getattr(trainer, attr),
                                    getattr(jtrainer, attr), attr)
    if hasattr(jtrainer, "deform_cfg"):
        assert trainer.field == jtrainer.field
        _assert_common_fields_equal(trainer.deform_cfg, jtrainer.deform_cfg,
                                    "deform_cfg")
    _assert_common_fields_equal(dp_cfg, jdp_cfg, "dataparser")
    _assert_common_fields_equal(fit_cfg, jfit_cfg, "fit")
    printed = capsys.readouterr().out
    assert "ignoring the TPU-only field max_per_tile=256" in printed
    assert "ignoring the TPU-only field min_isect_capacity=65536" in printed


def test_unknown_field_raises():
    for spec in ({"model": {"renderer": {"init_args": {"tile_sz": 8}}}},
                 {"fit": {"max_step": 10}},
                 {"model": {"gaussian": {"shdegree": 2}}}):
        with pytest.raises(KeyError, match="unknown field"):
            cli.build_components(spec)
    with pytest.raises(KeyError, match="unknown component"):
        cli.build_components({"model": {"renderer": {"class_path": "Nope"}}})


# Every preset but distributed.yaml is ported, and it raises naming its
# item
@pytest.mark.parametrize("preset,overrides,item", [
    ("distributed.yaml", {}, 13)])
def test_unported_presets_raise_naming_their_item(preset, overrides, item):
    cfg = cli.load_config([os.path.join(REPO, "gsl_tpu", "configs", preset)],
                          overrides)
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP item {item}\b"):
        cli.build_components(cfg)


# The components that raised naming their item until they were ported (the
# parsers of item 12c, the viewer of item 14d) now build in ported presets
@pytest.mark.parametrize("preset,overrides,want", [
    ("deformable.yaml", {"data": {"parser": {"class_path": "NSVF"}}},
     "NSVFDataParserConfig"),
    ("gs4d.yaml", {"data": {"parser": {"class_path": "MatrixCity"}}},
     "MatrixCityDataParserConfig"),
    ("pvg.yaml", {"data": {"parser": {"class_path": "NGP"}}},
     "NGPDataParserConfig"),
    ("spotless.yaml", {"data": {"parser": {"class_path": "SILVR"}}},
     "SILVRDataParserConfig"),
    ("segany.yaml", {"fit": {"viewer": True}}, "viewer")])
def test_formerly_unported_components_build(preset, overrides, want):
    cfg = cli.load_config([os.path.join(REPO, "gsl_tpu", "configs", preset)],
                          overrides)
    _, dp_cfg, fit_cfg = cli.build_components(cfg)
    if want == "viewer":
        assert fit_cfg.viewer is True and fit_cfg.viewer_port == 8080
    else:
        assert type(dp_cfg).__name__ == want
        assert type(dp_cfg).__module__.startswith("gsl_tpu_torch.")
        jcfg = jcli.build_components(jcli.load_config(
            [os.path.join(REPO, "gsl_tpu", "configs", preset)],
            overrides))[1]
        _assert_common_fields_equal(dp_cfg, jcfg, "dataparser")


def test_viewer_flag_reaches_fit_config(tmp_path, monkeypatch):
    _make_dataset(str(tmp_path / "scene"), n_views=2)
    seen = {}

    def no_fit(trainer, outputs, fit_cfg, device=None):
        seen["fit"] = fit_cfg
        return None, None

    monkeypatch.setattr(cli, "fit", no_fit)
    cli.main(["fit", "--config", os.path.join(REPO, "gsl_tpu_torch",
                                              "configs", "blender.yaml"),
              "--data.path", str(tmp_path / "scene"), "--output",
              str(tmp_path / "out"), "--viewer", "--viewer_port", "0",
              "--device", "cpu"])
    assert seen["fit"].viewer is True and seen["fit"].viewer_port == 0


# ---- checkpoints ---------------------------------------------------------

def _trained_like_state(seed=0):
    """A port TrainState with non-trivial moments, statistics and step."""
    trainer = Trainer()
    state = trainer.setup(small_port_state(n=120, seed=seed), 1.3)
    rng = np.random.RandomState(seed)

    def noise(t):
        return torch.from_numpy(rng.normal(size=tuple(t.shape)).astype(
            np.float32))

    opt = state.opt_state
    opt = dataclasses.replace(
        opt, exp_avg={k: noise(v) for k, v in opt.exp_avg.items()},
        exp_avg_sq={k: noise(v).abs() for k, v in opt.exp_avg_sq.items()},
        count=37)
    alive = state.alive.clone()
    alive[::7] = False
    density = dataclasses.replace(
        state.density, grad_accum=noise(state.density.grad_accum).abs(),
        denom=torch.from_numpy(rng.randint(0, 9, 120).astype(np.float32)))
    return trainer, dataclasses.replace(state, opt_state=opt, alive=alive,
                                        density=density, step=37)


def _assert_train_states_equal(got, want):
    a, b = train_state_to_numpy(got), train_state_to_numpy(want)
    for k in PARAM_FIELDS:
        np.testing.assert_array_equal(a["params"][k], b["params"][k])
        for m in ("mu", "nu"):
            np.testing.assert_array_equal(a["opt"][k][m], b["opt"][k][m])
        assert a["opt"][k]["count"] == b["opt"][k]["count"]
    np.testing.assert_array_equal(a["alive"], b["alive"])
    for k in a["density"]:
        np.testing.assert_array_equal(a["density"][k], b["density"][k])
    assert a["step"] == b["step"]


def test_checkpoint_round_trip_with_generator(tmp_path):
    trainer, state = _trained_like_state()
    gen = torch.Generator().manual_seed(5)
    torch.randn(10, generator=gen)
    path = save_checkpoint(str(tmp_path / "checkpoints"), state,
                           meta={"capacity": state.params.capacity},
                           generator=gen)
    assert path.endswith("step_37")
    assert load_checkpoint_meta(path) == {"capacity": 120, "step": 37}
    expect = torch.randn(16, generator=gen)

    _, template = _trained_like_state(seed=1)
    gen2 = torch.Generator().manual_seed(99)
    loaded = load_checkpoint(path, template, generator=gen2)
    _assert_train_states_equal(loaded, state)
    assert torch.equal(torch.randn(16, generator=gen2), expect)

    kept = load_checkpoint(path, template, drop_optimizer_states=True)
    assert kept.opt_state is template.opt_state
    assert torch.equal(kept.params.means, state.params.means)


def test_checkpoint_rejects_another_model(tmp_path):
    _, state = _trained_like_state()
    path = save_checkpoint(str(tmp_path), state)
    other = dataclasses.replace(state, params=state.params.map(
        lambda k, x: x[:, :1] if k == "shs_rest" else x))
    with pytest.raises(ValueError, match="shs_rest"):
        load_checkpoint(path, other)
    grown = Trainer().grow_state(state, 256)
    with pytest.raises(ValueError, match="capacity"):
        load_checkpoint(path, grown, drop_optimizer_states=True)
    # without dropping the optimizer the stored capacity comes back
    assert load_checkpoint(path, grown).params.capacity == 120


def _orbax_like_dir(path):
    os.makedirs(path)
    with open(os.path.join(path, "_METADATA"), "w") as f:
        f.write("{}")


def test_latest_checkpoint_and_loader_search_order(tmp_path):
    run = str(tmp_path / "run")
    _, state = _trained_like_state()
    ckpts = os.path.join(run, "checkpoints")
    assert find_latest_checkpoint(ckpts) is None
    save_state_ply(os.path.join(run, "point_cloud", "iteration_50",
                                "point_cloud.ply"), state.gaussians)
    save_state_ply(os.path.join(run, "point_cloud", "iteration_7",
                                "point_cloud.ply"), state.gaussians)
    assert GaussianModelLoader.search_load_file(run).endswith(
        os.path.join("iteration_50", "point_cloud.ply"))
    for step in (5, 12):
        save_checkpoint(ckpts, state, step=step)
    os.makedirs(os.path.join(ckpts, "step_notanumber"))
    # a checkpoint wins over a newer PLY; the largest step wins
    assert GaussianModelLoader.search_load_file(run) == os.path.join(
        os.path.abspath(ckpts), "step_12")
    assert find_latest_checkpoint(ckpts).endswith("step_12")

    loaded, renderer, sh_degree = GaussianModelLoader.load(run, "cpu")
    alive = state.alive
    assert loaded.capacity == int(alive.sum()) and bool(loaded.alive.all())
    for k in PARAM_FIELDS:
        assert torch.equal(getattr(loaded.params, k),
                           getattr(state.params, k)[alive])
    assert type(renderer).__name__ == "TileRenderer" and sh_degree == 3


def test_loader_reads_a_surfel_checkpoint(tmp_path):
    _, state = _trained_like_state()
    params = state.params.map(
        lambda k, x: x[:, :2].contiguous() if k == "scales" else x)
    surfel = dataclasses.replace(state, params=params)
    save_checkpoint(os.path.join(str(tmp_path), "checkpoints"), surfel)
    loaded, renderer, _ = GaussianModelLoader.load(str(tmp_path), "cpu")
    assert type(renderer).__name__ == "SurfelRenderer"
    assert loaded.params.scales.shape == (int(state.alive.sum()), 2)


def test_loader_and_resume_refuse_an_orbax_checkpoint(tmp_path):
    run = str(tmp_path)
    _, state = _trained_like_state()
    save_checkpoint(os.path.join(run, "checkpoints"), state, step=10)
    _orbax_like_dir(os.path.join(run, "checkpoints", "step_20"))
    save_state_ply(os.path.join(run, "point_cloud", "iteration_20",
                                "point_cloud.ply"), state.gaussians)
    state_pt = os.path.join(run, "checkpoints", "step_20", "state.pt")
    with pytest.raises(FileNotFoundError, match="orbax") as e:
        GaussianModelLoader.load(run, "cpu")
    assert state_pt in str(e.value)
    with pytest.raises(FileNotFoundError, match="orbax"):
        load_checkpoint(os.path.dirname(state_pt), state)
    # the PLY itself still loads
    loaded, _, _ = GaussianModelLoader.load(os.path.join(
        run, "point_cloud", "iteration_20", "point_cloud.ply"), "cpu")
    assert loaded.capacity == int(state.alive.sum())


def test_round_capacity_matches_jax():
    from gsl_tpu.training.fit import _round_capacity as jax_round
    for n in (0, 1, 16384, 16385, 100_000, 400_000, 1 << 20):
        assert _round_capacity(n) == jax_round(n)


# ---- the fit against gsl_tpu's --------------------------------------------

FIT_STEPS = 6


def _fit_cfg(root, out_dir):
    """A tiny Blender-style scene; no density op within the window."""
    return {
        "data": {"parser": {"class_path": "Blender",
                            "init_args": {"path": root,
                                          "random_point_count": 500,
                                          "white_background": False}}},
        "trainer": {"background_color": [0.0, 0.0, 0.0],
                    "max_steps": FIT_STEPS},
        "model": {"gaussian": {"sh_degree": 1},
                  "renderer": {"init_args": {"max_per_tile": 1024,
                                             "chunk": 32,
                                             "min_isect_capacity": 16384}}},
        "fit": {"max_steps": FIT_STEPS, "output_dir": out_dir,
                "min_capacity": 1024, "log_interval": 1,
                "save_iterations": [4], "resume": "never"},
    }


def _csv_rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_fit_matches_jax(tmp_path):
    """Six steps of both packages' fit on one scene. Losses per step within
    3e-3 (the JAX loss uses its bf16-split SSIM, and Adam at eps 1e-15
    turns small gradient differences into parameter differences, as in
    test_torch_training.py::test_train_steps_and_densify_match_jax).
    Then the port's validate on the JAX package's final state: per-image
    PSNR within 1e-3 dB and SSIM within 1e-4 of the JAX package's."""
    root = str(tmp_path / "data")
    _make_dataset(root, n_views=6)
    jout_dir, tout_dir = str(tmp_path / "jax"), str(tmp_path / "port")

    jtrainer, jdp, jfit_cfg = jcli.build_components(_fit_cfg(root, jout_dir))
    joutputs = jdp.instantiate().get_outputs()
    jstate, jresults = jax_fit(jtrainer, joutputs, jfit_cfg)

    trainer, dp, fit_cfg = cli.build_components(_fit_cfg(root, tout_dir))
    outputs = dp.instantiate().get_outputs()
    state, results = fit(trainer, outputs, fit_cfg, device="cpu")

    jlog = _csv_rows(os.path.join(jout_dir, "train_log.csv"))
    tlog = _csv_rows(os.path.join(tout_dir, "train_log.csv"))
    assert tlog[0] == jlog[0] == ["step", "loss", "n_gaussians",
                                  "steps_per_s"]
    assert [r[0] for r in tlog] == [r[0] for r in jlog]
    assert len(tlog) == FIT_STEPS + 1
    for t, j in zip(tlog[1:], jlog[1:]):
        assert abs(float(t[1]) - float(j[1])) < 3e-3, (t, j)
        assert t[2] == j[2]
    assert state.params.capacity == int(jstate.params.capacity) == 16384
    for rel in ("train_log.csv", "metrics/val.csv",
                "checkpoints/step_4/fit_meta.json",
                f"checkpoints/step_{FIT_STEPS}/fit_meta.json",
                "point_cloud/iteration_4/point_cloud.ply",
                f"point_cloud/iteration_{FIT_STEPS}/point_cloud.ply"):
        assert os.path.isfile(os.path.join(jout_dir, rel)), rel
        assert os.path.isfile(os.path.join(tout_dir, rel)), rel
    for step in (4, FIT_STEPS):
        rel = f"checkpoints/step_{step}/fit_meta.json"
        with open(os.path.join(tout_dir, rel)) as f:
            tmeta = json.load(f)
        with open(os.path.join(jout_dir, rel)) as f:
            jmeta = json.load(f)
        assert tmeta == {"capacity": jmeta["capacity"], "step": step}
    assert _csv_rows(os.path.join(tout_dir, "metrics", "val.csv"))[0] == \
        _csv_rows(os.path.join(jout_dir, "metrics", "val.csv"))[0]
    assert results["psnr"] == pytest.approx(jresults["psnr"], abs=0.02)

    # the port's validate on the JAX package's state
    converted = train_state_from_jax_arrays(
        **jax_train_state_arrays(jstate), device="cpu")
    check_cfg = dataclasses.replace(fit_cfg,
                                    output_dir=str(tmp_path / "check"))
    validate(trainer, converted, outputs, check_cfg)
    got = _csv_rows(os.path.join(str(tmp_path / "check"), "metrics",
                                 "val.csv"))
    want = _csv_rows(os.path.join(jout_dir, "metrics", "val.csv"))
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got[1:], want[1:]):
        assert abs(float(g[1]) - float(w[1])) < 1e-3, (g, w)
        assert abs(float(g[2]) - float(w[2])) < 1e-4, (g, w)


def test_fit_densify_counts_match_jax(tmp_path):
    """One densify inside both packages' fit (at step 3, with a low
    gradient threshold, a percent_dense that makes clones and splits both,
    and an opacity cull that prunes): equal Gaussian counts at every step,
    so the fit loop feeds the density control what gsl_tpu's does. Losses
    within 3e-3 up to the densify; after it the split offsets come from
    each package's own random stream. The port's fit_timing.json splits
    the densify into cloned, split and pruned rows."""
    root = str(tmp_path / "data")
    _make_dataset(root, n_views=6)

    def cfg(out_dir):
        c = _fit_cfg(root, out_dir)
        c["model"]["density"] = {"init_args": {
            "densify_from_iter": 2, "densification_interval": 3,
            "densify_until_iter": 4, "densify_grad_threshold": 2e-5,
            "percent_dense": 0.5, "cull_opacity_threshold": 0.093}}
        return c

    jout_dir, tout_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jtrainer, jdp, jfit_cfg = jcli.build_components(cfg(jout_dir))
    jax_fit(jtrainer, jdp.instantiate().get_outputs(), jfit_cfg,
            val_at_end=False)
    trainer, dp, fit_cfg = cli.build_components(cfg(tout_dir))
    fit(trainer, dp.instantiate().get_outputs(), fit_cfg, val_at_end=False,
        device="cpu")

    jlog = _csv_rows(os.path.join(jout_dir, "train_log.csv"))[1:]
    tlog = _csv_rows(os.path.join(tout_dir, "train_log.csv"))[1:]
    assert [r[0] for r in tlog] == [r[0] for r in jlog]
    assert [r[2] for r in tlog] == [r[2] for r in jlog]
    for t, j in zip(tlog[:3], jlog[:3]):
        assert abs(float(t[1]) - float(j[1])) < 3e-3, (t, j)
    with open(os.path.join(tout_dir, "fit_timing.json")) as f:
        (d,) = json.load(f)["densify"]
    assert d["step"] == 3 and d["before"] == int(tlog[1][2])
    assert d["after"] == int(tlog[2][2]) < d["before"]
    assert min(d["clone"], d["split"], d["pruned"]) > 0, d
    assert d["after"] == d["before"] + d["clone"] + d["split"] - d["pruned"]
