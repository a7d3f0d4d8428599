"""`spans.attribute` on a hand-built trace (the correlation join, the
autograd thread's fallback, self time, what no span covers), `trace.parse`
unchanged beside it, the twelve span metrics' readers and entries, and a
tiny traced run of each kind on the CPU through the harness with the
spans read."""
import copy
import dataclasses
import json
import time

import pytest
import torch

from port_bench import execute, harness, span_report, spans, trace
from port_bench.tests.test_port_bench_faults import SEED, tiny_cell

MARK = trace.STEP_MARK
BENCH = harness.load_benchmark()
ENTRIES = json.loads((harness.BENCH / "span_metrics.json").read_text())
US = 1e-6


def X(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 0, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def span(name, ts, end, tid=1):
    return X(name, "user_annotation", ts, end - ts, tid)


def launch(corr, ts, tid=1, name="cudaLaunchKernel"):
    return X(name, "cuda_runtime", ts, 0.2, tid, corr)


def kernel(corr, ts, end, name="k", cat="kernel"):
    return X(name, cat, ts, end - ts, 7, corr)


# one training step: the items' thread 1, autograd's thread 2
TRAIN_EVENTS = [
    span(MARK, 0, 100),
    span("data.wait", 1, 4),
    span("train.step", 5, 90),
    span("train.forward", 10, 40),
    span("render.project", 11, 14),
    span("render.colors", 14, 15),
    span("render.rasterize", 15, 35),
    span("wait.slot_count", 20, 25),
    span("train.backward", 45, 80),
    span("raster.backward", 50, 70, tid=2),
    span("train.adam", 82, 88),
    launch(6, 0.5), kernel(6, 3, 6),              # in no span
    launch(1, 12), kernel(1, 30, 40),             # render.project
    launch(2, 16), kernel(2, 40, 44),             # render.rasterize
    launch(3, 21, name="cudaStreamSynchronize"),  # inside its wait span
    launch(4, 55, tid=2), kernel(4, 56, 60),      # raster.backward
    launch(5, 75, tid=2), kernel(5, 76, 80),      # autograd, no span: ->
    #                                               train.backward
    launch(9, 83), kernel(9, 87, 88, "fill", "gpu_memset"),
    launch(7, 84, name="cudaMemcpyAsync"),
    kernel(7, 85, 86, "Memcpy DtoH (Device -> Pageable)", "gpu_memcpy"),
    launch(8, 86.5, name="cudaStreamSynchronize"),  # no wait span
    launch(10, 92, name="cudaStreamSynchronize"),   # in no span
]
VIEWER_EVENTS = [
    span(MARK, 0, 50),
    span("viewer.frame", 2, 48),
    span("render.project", 4, 8),
    span("render.colors", 8, 10),
    span("wait.slot_count", 12, 20),
    span("wait.frame_copy", 40, 47),
    launch(1, 5), kernel(1, 6, 9),
    launch(2, 9), kernel(2, 9, 12),
    launch(3, 41, name="cudaMemcpyAsync"),
    kernel(3, 42, 46, "Memcpy DtoH (Device -> Pageable)", "gpu_memcpy"),
]


@pytest.fixture(scope="module")
def train():
    return spans.attribute(TRAIN_EVENTS, MARK)


def approx(x):
    return pytest.approx(x, abs=1e-12)


def test_device_time_joins_its_launch_by_correlation(train):
    by = train["by_span"]
    assert by["render.project"]["device_s"] == approx(10 * US)
    assert by["render.rasterize"]["device_s"] == approx(4 * US)
    assert by["train.forward"]["device_s"] == approx(14 * US)
    assert by["train.adam"]["device_s"] == approx(2 * US)
    assert by["train.adam"]["kernel_s"] == approx(0.0)
    assert by["train.step"]["device_s"] == approx(24 * US)
    assert train["device_s"] == approx(27 * US)
    assert train["kernel_s"] == approx(25 * US)
    assert train["device_outside_s"] == approx(3 * US)


def test_autograds_thread_falls_to_the_items_thread(train):
    by = train["by_span"]
    assert by["raster.backward"]["device_s"] == approx(4 * US)
    assert by["train.backward"]["device_s"] == approx(8 * US)
    assert by["train.backward"]["kernel_s"] == approx(8 * US)


def test_self_and_wait_host_time(train):
    by = train["by_span"]
    assert by["train.step"]["host_s"] == approx(85 * US)
    # less its children on its own thread; raster.backward is on another
    assert by["train.step"]["self_host_s"] == approx((85 - 30 - 35 - 6) * US)
    assert by["render.rasterize"]["self_host_s"] == approx(15 * US)
    assert by["train.step"]["wait_host_s"] == approx(5 * US)
    assert by["train.forward"]["wait_host_s"] == approx(5 * US)
    assert by["train.adam"]["wait_host_s"] == 0.0
    assert all(v["calls"] == 1 for v in by.values())


def test_idle_outside_and_by_span(train):
    # busy: 3-6, 30-44, 56-60, 76-80, 85-86, 87-88 of the window 0-100
    assert train["idle_s"] == approx(73 * US)
    # 0-1 before data.wait, 90-100 after the step
    assert train["idle_outside_s"] == approx(11 * US)
    by = train["by_span"]
    assert by["data.wait"]["idle_s"] == approx(2 * US)
    assert by["wait.slot_count"]["idle_s"] == approx(5 * US)
    assert by["render.rasterize"]["idle_s"] == approx(10 * US)
    # raster.backward is on autograd's thread, not the items'
    assert by["raster.backward"]["idle_s"] == 0.0
    assert by["train.backward"]["idle_s"] == approx(27 * US)
    assert sum(v["idle_s"] for v in by.values()) \
        + train["idle_outside_s"] == approx(train["idle_s"])


def test_blocking_calls_outside_a_wait_span_are_listed(train):
    assert train["blocking_outside"] == [
        {"span": "train.adam", "call": "cudaMemcpyAsync", "count": 1},
        {"span": "train.adam", "call": "cudaStreamSynchronize", "count": 1}]
    assert train["blocking_unspanned"] == [
        {"call": "cudaStreamSynchronize", "count": 1}]


def test_a_trace_without_marks_or_spans():
    assert spans.attribute([], MARK)["by_span"] == {}
    plain = [e for e in TRAIN_EVENTS if e["cat"] != "user_annotation"
             or e["name"] == MARK]
    out = spans.attribute(plain, MARK)
    assert out["by_span"] == {} and out["blocking_outside"] == []
    assert out["device_outside_s"] == approx(out["device_s"])
    assert out["idle_outside_s"] == approx(out["idle_s"])


@pytest.mark.parametrize("events", [TRAIN_EVENTS, VIEWER_EVENTS],
                         ids=["train", "viewer"])
def test_parse_keeps_every_key_it_had(events):
    before = trace.parse(copy.deepcopy(events))
    wrapped = span_report.with_spans(trace.parse, {})(events)
    assert set(wrapped) == set(before) | {"spans"}
    assert {k: v for k, v in wrapped.items() if k != "spans"} == before
    assert wrapped["spans"] == spans.attribute(events, MARK)
    assert set(before) == {"device_seen", "by_class", "by_name", "busy_s",
                           "window_s", "gaps"}


def _ctx(kind, events, window_s):
    t = dict(trace.parse(events), items=1,
             spans=spans.attribute(events, MARK))
    t["window_s"] = window_s
    return {"kind": kind, "host": {}, "trace": t, "least": {}}


WANT = {
    "forward_ms.train": 14e-3, "backward_ms.train": 8e-3,
    "adam_ms.train": 2e-3, "project_sh_ms.train": 10e-3,
    "issue_ms.train": 80e-3, "host_wait_ms.train": 5e-3,
    "host_waits.train": 1.0, "data_wait_share.train": 3.0,
    "project_sh_ms.render": 6e-3, "issue_ms.render": (46 - 15) * 1e-3,
    "host_wait_ms.render": 15e-3, "host_waits.render": 2.0,
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_span_metric_reads_its_value_and_nothing_elsewhere(name):
    read = harness.reader(name)
    train = _ctx("train", TRAIN_EVENTS, 100 * US)
    viewer = _ctx("viewer", VIEWER_EVENTS, 50 * US)
    mine, other = (train, viewer) if name.endswith(".train") \
        else (viewer, train)
    assert read(mine) == pytest.approx(WANT[name], rel=1e-9)
    assert read(dict(other)) is None
    # the parent's trace, which has no spans: nothing, and no raise
    bare = dict(mine, trace={k: v for k, v in mine["trace"].items()
                             if k != "spans"})
    assert read(bare) is None
    assert read({"kind": mine["kind"], "host": {}, "trace": None,
                 "least": {}}) is None


def test_the_entries_are_per_layer_entries_of_the_accepted_cells():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    layers = {m["layer"] for m in BENCH["per_layer"]} | {"viewer"}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    names = [m["name"] for m in ENTRIES]
    assert sorted(names) == sorted(WANT)
    assert not set(names) & {m["name"] for m in BENCH["per_layer"]}
    for m in ENTRIES:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] == "device_trace" and m["better"] == "lower"
        assert m["layer"] in layers
        kind = "train" if m["name"].endswith(".train") else "viewer"
        assert m["workloads"] == [
            c for c in cells
            if harness.resolve(BENCH, c).traffic["kind"] == kind]
        assert set(m["workloads"]) <= set(e2e[m["moves"]]["workloads"])


def _traced_tiny_run(name):
    cell = tiny_cell(name)
    cell = dataclasses.replace(
        cell, per_layer=cell.per_layer + span_report.span_metrics(name))
    reading = {}
    parse = trace.parse
    trace.parse = span_report.with_spans(parse, reading)
    try:
        result, checks = execute.execute(cell, SEED, 0.3, True,
                                         torch.device("cpu"),
                                         time.perf_counter())
    finally:
        trace.parse = parse
    return cell, result, reading


@pytest.mark.parametrize("name", ["train_stp_room",
                                  "render_vanilla_bicycle"])
def test_a_tiny_traced_run_reads_every_span_metric(name):
    cell, result, reading = _traced_tiny_run(name)
    kind = cell.traffic["kind"]
    mine = {m["name"] for m in span_report.span_metrics(name)}
    # the CPU's trace has no device events, so no window for a share
    assert mine - {"data_wait_share.train"} <= set(result["metrics"])
    n = reading["items"]
    assert n == cell.traffic["traced_steps" if kind == "train"
                             else "traced_frames"]
    by = reading["by_span"]
    if kind == "train":
        # a step: the slot count and the density statistics' upload, and
        # the camera's on a view's first visit
        firsts = by.get("wait.camera_to", {"calls": 0})["calls"]
        assert result["metrics"]["host_waits.train"]["value"] \
            == 2.0 + firsts / n
        assert by["train.step"]["calls"] == n == by["data.wait"]["calls"]
        assert by["raster.backward"]["calls"] == n
    else:
        # one frame: the camera's upload, the slot count, the frame's copy
        assert result["metrics"]["host_waits.render"]["value"] == 3.0
        assert by["viewer.frame"]["calls"] == n
    assert reading["blocking_outside"] == []
    line = span_report.summary(reading, kind)
    assert line["items"] == n and line["by_span"]
