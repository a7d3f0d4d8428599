"""What every kind of cell shares in driving the program: the outcome a
run hands back, the port's trainer built from a configuration's presets,
the kernels' launch counters, the device's peak memory and the host's
CPU time. The kinds themselves are ``kinds/<kind>.py``; the program
receives only what they make from the seed.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import time

import torch

from .harness import ROOT

GIB = float(1 << 30)


@dataclasses.dataclass
class Outcome:
    metrics: dict               # end-to-end, by name
    host: dict                  # spans for the per-layer readers
    readings: dict              # the program's, for `correct`
    items: list                 # what the traced window served
    trace: dict = None
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    info: dict = dataclasses.field(default_factory=dict)


def build_trainer(cfg: dict):
    """The port's trainer from the configuration's presets, as its CLI
    builds it."""
    from gsl_tpu_torch.cli import build_components, load_config
    paths = [str(ROOT / p) for p in cfg["preset"]]
    trainer, _, fit_cfg = build_components(load_config(paths, {}))
    return trainer, fit_cfg


def free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def launches() -> dict:
    """Each kernel wrapper's launch count, by its source's name."""
    from gsl_tpu_torch.training.fit import _kernel_launches
    return _kernel_launches()


def host_times() -> dict:
    """This process's CPU seconds and the host's stolen seconds (a
    virtual machine's time taken by its neighbours), for the info line:
    what a run that reads slow was up against."""
    steal = 0.0
    try:
        with open("/proc/stat") as f:
            steal = int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return {"cpu_s": time.process_time(), "steal_s": steal}


def host_delta(before: dict) -> dict:
    now = host_times()
    return {k: now[k] - before[k] for k in now}


def launches_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in launches().items() if v > before[k]}
