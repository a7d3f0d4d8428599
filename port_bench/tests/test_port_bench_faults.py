"""`correct` comes out false when the timed path is broken underneath,
and for the control. Each run here skips the look for a card and drives
the rest of a run on the CPU at a tiny size, with a fault planted in the
program: a step that returns its state unchanged, half of the image left
out of the loss (the mean taken over the rest), a frame altered where it
is produced. One chip runs no exchange between chips, so that fault has
no cell here. The control is the reference computed in TF32, put in the
program's place."""
import copy
import dataclasses
import time

import numpy as np
import pytest
import torch

from port_bench import execute, harness

BENCH = harness.load_benchmark()
TRAIN = [w["name"] for w in BENCH["workloads"]
         if harness.resolve(BENCH, w["name"]).traffic["kind"] == "train"]
RENDER = [w["name"] for w in BENCH["workloads"] if w["name"] not in TRAIN]
SEED = 2 ** 31 + 11


def tiny_cell(name, n=6000, width=96, height=64):
    cell = harness.resolve(BENCH, name)
    cfg = copy.deepcopy(cell.config)
    cfg.update(n_gaussians=n, width=width, height=height, views=10)
    mix = copy.deepcopy(cell.traffic)
    if mix["kind"] == "viewer":
        mix.update(width=width, height=height, stations=6, warmup_frames=1,
                   traced_frames=2)
    else:
        mix.update(warmup_steps=1, traced_steps=2)
    return dataclasses.replace(cell, config=cfg, traffic=mix)


def run(cell):
    result, checks = execute.execute(cell, SEED, 0.3, False,
                                     torch.device("cpu"), time.perf_counter())
    return result["correct"], checks


@pytest.mark.parametrize("name", TRAIN)
def test_a_sound_tiny_run_is_correct(name):
    ok, checks = run(tiny_cell(name))
    assert ok, checks


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_that_returns_its_state_unchanged(name, monkeypatch):
    from gsl_tpu_torch.training.trainer import Trainer
    step = Trainer.train_step

    def unchanged(self, state, *args, **kwargs):
        new, scalars = step(self, state, *args, **kwargs)
        return dataclasses.replace(state, step=new.step), scalars

    monkeypatch.setattr(Trainer, "train_step", unchanged)
    ok, checks = run(tiny_cell(name))
    assert not ok
    assert checks["grad_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_half_of_the_image_left_out_of_the_loss(name, monkeypatch):
    import gsl_tpu_torch.training.trainer as trainer_module
    loss = trainer_module.train_loss

    def half(pred, gt, mask=None, **kwargs):
        h = pred.shape[0] // 2
        return loss(pred[:h], gt[:h], None if mask is None else mask[:h],
                    **kwargs)

    monkeypatch.setattr(trainer_module, "train_loss", half)
    ok, _ = run(tiny_cell(name))
    assert not ok


@pytest.mark.parametrize("name", RENDER)
def test_a_frame_altered_where_it_is_produced(name, monkeypatch):
    from gsl_tpu_torch.viewer.renderer import ViewerRenderer
    frame = ViewerRenderer.get_outputs

    def altered(self, *args, **kwargs):
        img = frame(self, *args, **kwargs).copy()
        h, w = img.shape[0] // 2, img.shape[1] // 2
        img[h:h + 16, w:w + 16] = 255 - img[h:h + 16, w:w + 16]
        return img                       # one tile of the frame inverted

    monkeypatch.setattr(ViewerRenderer, "get_outputs", altered)
    ok, checks = run(tiny_cell(name))
    assert not ok, checks


@pytest.mark.parametrize("name", TRAIN)
def test_the_control_is_not_correct_in_training(name):
    cell = tiny_cell(name)
    kind, dev = harness.kind(cell), torch.device("cpu")
    ref = kind.reference(cell, SEED, dev)
    ctl = kind.reference(cell, SEED, dev, precision="tf32")
    ok, checks = harness.check_numbers(kind.numbers(ctl, ref), cell.limits)
    assert not ok, checks


@pytest.mark.parametrize("name", RENDER)
def test_the_control_is_not_correct_in_serving(name):
    cell = tiny_cell(name)
    cell.traffic["checked_frames"] = 3
    kind, dev = harness.kind(cell), torch.device("cpu")
    ref = kind.reference(cell, SEED, dev)
    ctl = kind.reference(cell, SEED, dev, precision="tf32")
    assert not np.array_equal(ref["frames"][0][1], ctl["frames"][0][1])
    ok, checks = harness.check_numbers(kind.numbers(ctl, ref), cell.limits)
    assert not ok, checks
