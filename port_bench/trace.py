"""The device trace of a short window: ``torch.profiler`` over a fixed
number of steps or frames, read back from its Chrome trace.

What it gives: the kernels' device time by class (the port's
hand-written kernels by name, ``work/kernels.json``; the sort's; every
other kernel, the plain-torch layers), the busy time (the union of every
device operation's interval, copies included), the longest device
operations by name and the idle gaps labelled by what the host was doing
then. Names are matched from ``work/kernels.json``, so a later kernel is
added there.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile
import time

import torch

from .work import KERNELS

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
STEP_MARK = "port_bench_item"


def _classify():
    own = [(k, re.compile(r"\b" + v["symbol"] + r"\b"))
           for k, v in KERNELS["hand_written"].items()]
    sort = re.compile(KERNELS["sort_pattern"])

    def klass(name):
        for k, pat in own:
            if pat.search(name):
                return k
        return "sort" if sort.search(name) else "torch"
    return klass


def short(name: str, n: int = 96) -> str:
    """A kernel's or op's name without its return type, anonymous
    namespace and argument list."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    name = re.sub(r"\(.*", "", name)
    return name[:n]


def profile(step, n_items: int) -> dict:
    """Run `step(i)` for i < n_items under the profiler, then read the
    trace. Returns the parsed trace (`parse`) with `items` and the host
    window `window_s` (first item's start to the synchronise after the
    last)."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with prof_ctx(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n_items):
            with torch.profiler.record_function(STEP_MARK):
                step(i)
        sync()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    events = events.get("traceEvents", events)
    out = parse(events)
    out.update(items=n_items, host_window_s=window)
    return out


def _union(intervals):
    total, segs = 0.0, []
    for s, e in sorted(intervals):
        if segs and s <= segs[-1][1]:
            segs[-1][1] = max(segs[-1][1], e)
        else:
            segs.append([s, e])
    for s, e in segs:
        total += e - s
    return total, segs


def parse(events: list) -> dict:
    """Chrome-trace events (µs) -> seconds of device time by class and by
    kernel name, busy and window seconds, and the idle gaps by the host
    activity that spans them."""
    klass = _classify()
    dev, host, marks = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        s, d = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            dev.append((s, s + d, e.get("name", ""), cat))
        elif cat in HOST_CATS:
            host.append((s, s + d, e.get("name", ""), cat))
            if e.get("name") == STEP_MARK:
                marks.append((s, s + d))
    by_class = collections.Counter()
    by_name = collections.Counter()
    for s, e, name, cat in dev:
        if cat == "kernel":
            by_class[klass(name)] += (e - s) * 1e-6
        by_name[short(name)] += (e - s) * 1e-6
    if not dev or not marks:
        return dict(device_seen=False, by_class={}, by_name={}, busy_s=0.0,
                    window_s=0.0, gaps={})
    w0 = min(m[0] for m in marks)
    w1 = max(max(m[1] for m in marks), max(d[1] for d in dev))
    inside = [(max(s, w0), min(e, w1)) for s, e, _, _ in dev
              if e > w0 and s < w1]
    busy, segs = _union(inside)
    gaps = collections.Counter()
    edges = [w0] + [x for seg in segs for x in seg] + [w1]
    host_ops = sorted(h for h in host if h[2] != STEP_MARK)
    starts = [h[0] for h in host_ops]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        # the latest-starting host op that spans the gap's middle: with
        # nested ops, the innermost
        label = "host: no traced op"
        last = bisect.bisect_right(starts, mid) - 1
        for j in range(last, max(-1, last - 256), -1):
            if host_ops[j][1] >= mid:
                label = host_ops[j][2]
                break
        gaps[short(label)] += (b - a) * 1e-6
    return dict(device_seen=True, by_class=dict(by_class),
                by_name=dict(by_name), busy_s=busy * 1e-6,
                window_s=(w1 - w0) * 1e-6, gaps=dict(gaps))


def breakdown(parsed: dict, top: int = 10) -> dict:
    def most(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]
    return {"device_ops": most(parsed["by_name"]),
            "idle_gaps": most(parsed["gaps"])}
