"""Checkpoint save/load of the fit's TrainState, on ``torch.save``.

Port of ``gsl_tpu/utils/checkpoint.py``. Layout, as the JAX package's:

    <ckpt_dir>/step_N/state.pt        the TrainState: params, alive, Adam
                                      moments and count, density statistics,
                                      step, and the fit's generator state
    <ckpt_dir>/step_N/fit_meta.json   {"capacity": ..., "step": N, ...}

``state.pt`` holds only tensors, numbers, strings and dicts of them, so it
loads with ``torch.load(weights_only=True)``. A ``step_N`` directory of the
JAX package holds an orbax tree instead of ``state.pt``; the port cannot
read it, and `load_checkpoint` says so.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import torch

from ..models.gaussian import PARAM_FIELDS, GaussianParams
from ..training.density import DensityControlState
from ..training.optimizers import AdamState
from ..training.trainer import TrainState

STATE_FILE = "state.pt"
_DENSITY_FIELDS = ("grad_accum", "denom", "max_radii")


def _state_dict(state: TrainState, generator: Optional[torch.Generator]):
    def cpu(t):
        return t.detach().cpu()

    return {
        "params": {k: cpu(getattr(state.params, k)) for k in PARAM_FIELDS},
        "alive": cpu(state.alive),
        "exp_avg": {k: cpu(v) for k, v in state.opt_state.exp_avg.items()},
        "exp_avg_sq": {k: cpu(v)
                       for k, v in state.opt_state.exp_avg_sq.items()},
        "count": int(state.opt_state.count),
        "density": {k: cpu(getattr(state.density, k))
                    for k in _DENSITY_FIELDS},
        "step": int(state.step),
        "generator": None if generator is None else generator.get_state(),
    }


def save_checkpoint(ckpt_dir: str, state: TrainState,
                    step: Optional[int] = None, meta: Optional[dict] = None,
                    generator: Optional[torch.Generator] = None) -> str:
    """Write ``step_N/state.pt`` (and ``fit_meta.json`` when `meta` is
    given: the capacity and anything else resume needs before the load).
    Returns the directory."""
    step = int(step if step is not None else state.step)
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step}"))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(_state_dict(state, generator), tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if meta is not None:
        with open(os.path.join(path, "fit_meta.json"), "w") as f:
            json.dump(dict(meta, step=step), f)
    return path


def load_checkpoint_meta(path: str) -> Optional[dict]:
    meta_path = os.path.join(path, "fit_meta.json")
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        return json.load(f)


def find_latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The ``step_N`` directory with the largest N under `ckpt_dir`, or
    None. It looks at names only: the newest directory wins even when it
    is a JAX package's orbax checkpoint, and `load_checkpoint` then raises
    naming the missing ``state.pt``, rather than an older port checkpoint
    being taken in its place."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            try:
                s = int(name.split("_", 1)[1])
            except ValueError:
                continue
            if s > best_step:
                best, best_step = os.path.join(ckpt_dir, name), s
    return best


def read_state_dict(path: str, device=None) -> dict:
    """The raw contents of ``<path>/state.pt`` on `device`."""
    f = os.path.join(path, STATE_FILE)
    if not os.path.isfile(f):
        raise FileNotFoundError(
            f"{f} does not exist: {path} is not a checkpoint of this "
            "package (a step_N directory of the JAX package holds an orbax "
            "tree, which it cannot read; load that run's PLY instead)")
    return torch.load(f, map_location=device, weights_only=True)


def load_checkpoint(path: str, target: TrainState,
                    drop_optimizer_states: bool = False,
                    generator: Optional[torch.Generator] = None
                    ) -> TrainState:
    """The checkpoint at `path` as a TrainState on `target`'s device, at
    the capacity it was saved with (`fit_meta.json` records it). Each
    property's trailing shape (scale columns, SH bands) must equal
    `target`'s. With `drop_optimizer_states`, `target`'s Adam state is
    kept, and the capacities must be equal. With a `generator`, the saved
    generator state is restored into it."""
    dev = target.alive.device
    raw = read_state_dict(path, dev)
    params = GaussianParams(**raw["params"])
    for k in PARAM_FIELDS:
        got = tuple(getattr(params, k).shape[1:])
        want = tuple(getattr(target.params, k).shape[1:])
        if got != want:
            raise ValueError(f"{path}: {k} rows have shape {got}, the "
                             f"target's {want}")
    if drop_optimizer_states:
        if params.capacity != target.params.capacity:
            raise ValueError(
                f"{path} holds capacity {params.capacity}, the target "
                f"{target.params.capacity}: its optimizer state cannot be "
                "kept")
        opt_state = target.opt_state
    else:
        opt_state = AdamState(exp_avg=raw["exp_avg"],
                              exp_avg_sq=raw["exp_avg_sq"],
                              count=int(raw["count"]))
    if generator is not None and raw["generator"] is not None:
        generator.set_state(raw["generator"].cpu())
    return TrainState(params=params, alive=raw["alive"], opt_state=opt_state,
                      density=DensityControlState(**raw["density"]),
                      step=int(raw["step"]))
