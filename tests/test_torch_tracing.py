"""The port's spans (``gsl_tpu_torch/utils/tracing.py``) on the CPU with
the kernels' plain versions: nothing enters the profiler while none
records; under ``torch.profiler`` one training step, one viewer frame and
the loader emit their spans once each, nested layer in layer; a fit's
``--trace_steps`` writes a Chrome trace that holds them."""
import json
import os

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from gsl_tpu_torch import cli
from gsl_tpu_torch.data.cameras import make_camera
from gsl_tpu_torch.data.dataset import DataLoader, image_to_float
from gsl_tpu_torch.renderers.tile_renderer import TileRendererConfig
from gsl_tpu_torch.training.trainer import Trainer
from gsl_tpu_torch.utils.convert import state_from_raw_arrays
from gsl_tpu_torch.utils.tracing import span
from gsl_tpu_torch.viewer.renderer import ViewerRenderer

from test_torch_fit_e2e import _argv, _scene_arrays, make_dataset

torch.set_num_threads(1)

W, H = 32, 24

# each span of one training step, with the program span it sits in
TRAIN_SPANS = {
    "train.step": None,
    "train.forward": "train.step",
    "render.project": "train.forward",
    "render.colors": "train.forward",
    "render.channels": "train.forward",
    "render.rasterize": "train.forward",
    "raster.isect_encode": "render.rasterize",
    "wait.slot_count": "raster.isect_encode",
    "raster.expand": "render.rasterize",
    "raster.sort": "render.rasterize",
    "raster.tile_bounds": "render.rasterize",
    "raster.fwd": "render.rasterize",
    "train.loss": "train.forward",
    "train.backward": "train.step",
    "raster.backward": "train.backward",
    "raster.bwd": "raster.backward",
    "raster.reduce": "raster.backward",
    "sh.backward": "train.backward",
    "train.density_stats": "train.step",
    "wait.grad_scale": "train.density_stats",
    "train.adam": "train.step",
}
VIEWER_SPANS = {
    "viewer.frame": None,
    "viewer.camera": "viewer.frame",
    "wait.camera_upload": "viewer.camera",
    "viewer.render": "viewer.frame",
    "render.project": "viewer.render",
    "render.colors": "viewer.render",
    "render.channels": "viewer.render",
    "render.rasterize": "viewer.render",
    "raster.isect_encode": "render.rasterize",
    "wait.slot_count": "raster.isect_encode",
    "raster.expand": "render.rasterize",
    "raster.sort": "render.rasterize",
    "raster.tile_bounds": "render.rasterize",
    "raster.fwd": "render.rasterize",
    "viewer.quantise": "viewer.frame",
    "wait.frame_copy": "viewer.frame",
}
LAYERS = ("data.", "train.", "render.", "raster.", "sh.", "viewer.",
          "wait.")


def _spans(prof):
    """[(name, the innermost program span around it or None, event)] of
    the program spans in the profile."""
    out = []
    for e in prof.events():
        if not e.name.startswith(LAYERS):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith(LAYERS):
            parent = parent.cpu_parent
        out.append((e.name, None if parent is None else parent.name, e))
    return out


def _check(spans, want):
    names = [n for n, _, _ in spans]
    assert sorted(names) == sorted(want), names
    assert {n: p for n, p, _ in spans} == want


@pytest.fixture(scope="module")
def gstate():
    return state_from_raw_arrays(_scene_arrays(), device="cpu")


def _camera():
    return make_camera(np.eye(3), np.zeros(3), 25.0, 25.0, W / 2, H / 2,
                       W, H, device="cpu")


def _step(gstate, stp):
    trainer = Trainer(renderer=TileRendererConfig(stp_resort=stp))
    state = trainer.setup(gstate, 1.0)
    gt = torch.rand(H, W, 3, generator=torch.Generator().manual_seed(0))
    return lambda: trainer.train_step(state, _camera(), gt, H, W, 0,
                                      torch.zeros(3))


def test_the_profiler_flag_is_set_exactly_while_a_profiler_records():
    assert not autograd_profiler._is_profiler_enabled
    with torch.profiler.profile():
        assert autograd_profiler._is_profiler_enabled
    assert not autograd_profiler._is_profiler_enabled


def test_no_span_enters_the_profiler_while_none_records(gstate,
                                                        monkeypatch):
    def refuse(name, *args, **kwargs):
        raise AssertionError(f"span {name} entered record_function")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    assert span("train.step") is span("viewer.frame")
    _step(gstate, False)()
    viewer = ViewerRenderer(gstate, TileRendererConfig().instantiate(), 0)
    viewer.get_outputs(np.eye(4), W, H)
    loader = iter(DataLoader(_Images(), seed=0))
    image_to_float(next(loader)[2])
    loader.close()


@pytest.mark.parametrize("stp", [False, True], ids=["vanilla", "stp"])
def test_one_training_step_emits_each_span_once_nested(gstate, stp):
    step = _step(gstate, stp)
    with torch.profiler.profile() as prof:
        step()
    _check(_spans(prof), TRAIN_SPANS)


def test_one_viewer_frame_emits_each_span_once_nested(gstate):
    viewer = ViewerRenderer(gstate, TileRendererConfig().instantiate(), 0)
    with torch.profiler.profile() as prof:
        img = viewer.get_outputs(np.eye(4), W, H)
    assert img.shape == (H, W, 3) and img.dtype == np.uint8
    _check(_spans(prof), VIEWER_SPANS)


class _Images:
    """Four tiny cached images, as `CachedDataset.get` serves them."""

    def __len__(self):
        return 4

    def get(self, i):
        img = torch.full((2, 3, 3), i, dtype=torch.uint8)
        return None, f"view_{i}", img, None


def test_no_span_is_held_across_the_loaders_yield():
    loader = iter(DataLoader(_Images(), seed=0))
    with torch.profiler.profile() as prof:
        for _ in range(3):
            _, _, img, _ = next(loader)
            with torch.profiler.record_function("consumer"):
                image_to_float(img)
    loader.close()
    spans = _spans(prof)
    waits = [e for n, _, e in spans if n == "data.wait"]
    floats = [(p, e) for n, p, e in spans if n == "data.to_float"]
    consumers = [e for e in prof.events() if e.name == "consumer"]
    assert len(waits) == 3 and len(consumers) == 3 and len(floats) == 3
    for w in waits:
        assert w.cpu_parent is None
        for c in consumers:
            assert (w.time_range.end <= c.time_range.start
                    or w.time_range.start >= c.time_range.end)
    for parent, e in floats:
        assert parent is None and e.cpu_parent.name == "consumer"


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    make_dataset(root, n_views=3)
    return root


def test_fit_trace_steps_writes_a_chrome_trace_of_those_steps(scene,
                                                              tmp_path):
    out = str(tmp_path)
    cli.main(_argv("fit", scene, out, "run", 3,
                   extra=("model.gaussian.sh_degree=0", "--trace_steps",
                          "2", "3", "fit.save_ply=false")))
    path = os.path.join(out, "run", "trace_2-3.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events if e.get("ph") == "X"]
    assert names.count("train.step") == 2
    assert names.count("wait.slot_count") == 2
    assert names.count("data.to_float") == 2


def test_fit_trace_steps_outside_the_run_fail_before_training(scene,
                                                              tmp_path):
    with pytest.raises(ValueError, match="trace_steps"):
        cli.main(_argv("fit", scene, str(tmp_path), "run", 3,
                       extra=("--trace_steps", "2", "5")))
