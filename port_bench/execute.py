"""One run of one cell, after the look for a card: drive the program
through the cell's kind (``kinds/``), close the window, check for JAX,
free the program's state, check what the timed path produced against the
reference, read the per-layer metrics and assemble the result line. The
tests call this on the CPU at a tiny size with faults planted in the
program."""
from __future__ import annotations

import os
import sys
import time

import torch

from . import harness, program
from .check import reference_camera
from .work import least_time


def _path_numbers(cell, window_launches: dict, device) -> dict:
    """On the card: how many of the nine kernels launched in the window
    that the cell's path does not take, or did not launch that it
    takes."""
    if device.type != "cuda":
        return {}
    want = set(cell.config["kernels"][cell.traffic["kind"]])
    return {"path_kernels_off": float(len(want ^ set(window_launches)))}


def _least(cell, kind, items: list, seed: int, device) -> dict:
    """The least seconds of the traced window's items, counted from the
    benchmark's own inputs (``work/``) on a sample: the mix's first
    `counted_items` distinct views or poses of the window, whose mean
    stands for every item."""
    rend = harness.renderer(cell)
    params, camera_of = kind.counted_scene(cell, seed, device)
    sample = list(dict.fromkeys(items))[:cell.traffic["counted_items"]]
    tot = {"all_s": 0.0, "kernels_s": 0.0}
    first = {}
    for it in sample:
        c = rend.view_counts(cell.config, params,
                             reference_camera(camera_of(it), device))
        first = first or c
        for k, v in least_time.totals(kind.parts(cell, c)).items():
            tot[k] += v * len(items) / len(sample)
    return dict(tot, counts=first)


def execute(cell, seed: int, seconds: float, trace: bool, device,
            t_process: float):
    """-> (result dict, checks), or (None, None) where JAX was loaded."""
    kind = harness.kind(cell)
    out = kind.run(cell, seed, seconds, trace, device, t_process)
    path = _path_numbers(cell, out.host["launches"], device)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in the run's process: {', '.join(bad)}",
              file=sys.stderr)
        return None, None
    program.free()
    t_ref = time.perf_counter()
    numbers = kind.numbers(out.readings,
                           kind.reference(cell, seed, device, out.readings))
    numbers.update(path)
    correct, checks = harness.check_numbers(numbers, cell.limits)

    per_item = dict(out.info, reference_s=time.perf_counter() - t_ref)
    n = max(out.host.get("items", 0), 1)
    if out.trace is not None:
        least = _least(cell, kind, out.items, seed, device)
        ctx = {"kind": cell.traffic["kind"], "host": out.host,
               "trace": out.trace, "least": least}
        metrics = {}
        for m in cell.per_layer:
            v = harness.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        per_item["depth_counts_first_traced"] = least["counts"]
    else:
        metrics = {m["name"]: {"value": out.metrics[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in out.metrics}
    launches = out.host["launches"]
    print("info " + repr(dict(per_item, items=out.host.get("items"),
                              window_cpu_s=out.host.get("cpu_s"),
                              window_steal_s=out.host.get("steal_s"),
                              loadavg=os.getloadavg(),
                              launches=launches,
                              launches_per_item={k: v / n for k, v in
                                                 launches.items()},
                              card=harness.card() if device.type == "cuda"
                              else {})), flush=True)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if out.trace is not None:
        from . import trace as tr
        busy = out.trace["busy_s"]
        dev.update(busy_s=busy, window_s=out.trace["window_s"])
        if out.trace["device_seen"]:
            result["breakdown"] = tr.breakdown(out.trace)
    return result, checks

