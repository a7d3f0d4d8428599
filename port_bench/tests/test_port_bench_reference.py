"""The benchmark's plain reference agrees with the port's CPU path (its
kernels' plain versions) at a tiny size. This test imports both; the
reference itself imports nothing of the port."""
import copy
import dataclasses
import time

import numpy as np
import pytest
import torch

from port_bench import check, execute, harness, scene
from port_bench.reference import model

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny_cell(name, n=3000):
    cell = harness.resolve(BENCH, name)
    cfg = copy.deepcopy(cell.config)
    cfg.update(n_gaussians=n, width=72, height=40, views=10)
    mix = copy.deepcopy(cell.traffic)
    if mix["kind"] == "viewer":
        mix.update(width=80, height=48, stations=6, warmup_frames=1,
                   traced_frames=2)
    else:
        mix.update(warmup_steps=1, traced_steps=2)
    return dataclasses.replace(cell, config=cfg, traffic=mix)


@pytest.mark.parametrize("stp", [False, True])
def test_reference_render_equals_the_ports_tile_renderer(stp):
    from gsl_tpu_torch.data.cameras import make_camera
    from gsl_tpu_torch.renderers.tile_renderer import TileRendererConfig
    from port_bench.renderers.splats import program_state
    cell = tiny_cell("render_vanilla_bicycle")
    params = scene.draw_scene(cell.config, 7, "cpu")
    c = scene.viewer_camera(scene.viewer_poses(cell.config, cell.traffic,
                                               7)[0], 80, 48, 60.0)
    bg = torch.tensor([0.2, 0.3, 0.4])
    ours = model.render(params, check.reference_camera(c, "cpu"), bg,
                        model.Precision(), stp)
    renderer = TileRendererConfig(stp_resort=stp).instantiate()
    cam = make_camera(R=c["R"], T=c["T"], fx=c["fx"], fy=c["fy"], cx=c["cx"],
                      cy=c["cy"], width=80, height=48, device="cpu")
    theirs = renderer.forward(program_state(params, "cpu"), cam, 48, 80, bg,
                              3).render
    assert ours.abs().max() > 0.05      # the frame shows the scene
    torch.testing.assert_close(ours, theirs, rtol=0, atol=1e-6)


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_is_correct_against_the_reference(cell, capsys):
    """The whole run on the CPU: the program's readings of the checked
    steps or frames against the reference's, within the cell's limits."""
    c = tiny_cell(cell)
    result, checks = execute.execute(c, 2 ** 31 + 5, 0.5, False,
                                     torch.device("cpu"),
                                     time.perf_counter())
    assert result["correct"], checks
    assert result["attempted"] >= 1
    for name, v in checks.items():
        assert v["value"] <= 1e-5, (name, v)


def test_reference_step_matches_the_ports_first_moment_and_update():
    """One training step: the reference's gradient and Adam update
    against the port's `Trainer.train_step` on the CPU."""
    from gsl_tpu_torch.cli import build_components, load_config
    from gsl_tpu_torch.data.cameras import make_camera
    from port_bench.renderers.splats import program_state
    c = tiny_cell("train_vanilla_bicycle")
    cfg = c.config
    params = scene.perturb(scene.draw_scene(cfg, 9, "cpu"),
                           c.traffic["perturb"], 9, "cpu")
    rig = scene.rig(cfg)[1]
    gt = scene.target(scene.target_draws(cfg, c.traffic, 9, 1, "cpu"), 0,
                      40, 72).float() / 255.0
    trainer, _, _ = build_components(load_config(
        [str(harness.ROOT / p) for p in cfg["preset"]], {}))
    state = trainer.setup(program_state(params, "cpu"), 2.5)
    state = dataclasses.replace(state, opt_state=dataclasses.replace(
        state.opt_state, count=15000))
    cam = make_camera(R=rig["R"], T=rig["T"], fx=rig["fx"], fy=rig["fy"],
                      cx=rig["cx"], cy=rig["cy"], width=72, height=40,
                      device="cpu")
    new, scalars = trainer.train_step(state, cam, gt, 40, 72, 3,
                                      torch.zeros(3))
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    loss, grads, p1, mu, _ = model.train_step(
        params, zeros, dict(zeros), 15000, check.reference_camera(rig, "cpu"),
        gt, torch.zeros(3), 2.5, model.Precision(), False)
    assert loss == pytest.approx(float(scalars["loss"]), rel=1e-6)
    for k in model.FIELDS:
        torch.testing.assert_close(new.opt_state.exp_avg[k], mu[k],
                                   rtol=1e-4, atol=1e-9)
        torch.testing.assert_close(getattr(new.params, k), p1[k],
                                   rtol=1e-5, atol=1e-7)
    assert np.isclose(model.means_lr(15000, 2.5),
                      trainer.tx.learning_rate("means", 15000), rtol=1e-7)
