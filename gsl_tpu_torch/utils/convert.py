"""Build the port's states from the JAX package's arrays, and back."""
from __future__ import annotations

import numpy as np
import torch

from ..models.gaussian import (PARAM_FIELDS, GaussianParams,
                               GaussianState)
from ..training.density import DensityControlState
from ..training.optimizers import AdamState
from ..training.trainer import TrainState
from .device import resolve_device


def state_from_jax_arrays(params: dict, alive: np.ndarray,
                          device=None) -> GaussianState:
    """`params`: the JAX ``GaussianParams`` fields as numpy arrays
    (``np.asarray`` of each); `alive`: the [CAP] mask. Fields the serving
    path does not use are ignored."""
    dev = resolve_device(device)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype).to(dev)

    return GaussianState(
        params=GaussianParams(**{k: t(params[k]) for k in PARAM_FIELDS}),
        alive=t(alive, torch.bool))


def state_from_raw_arrays(arrays: dict, device=None) -> GaussianState:
    """PLY arrays (`load_gaussian_ply`) -> state with every row alive."""
    n = arrays["means"].shape[0]
    return state_from_jax_arrays(arrays, np.ones(n, bool), device)


def train_state_from_jax_arrays(params: dict, alive: np.ndarray, opt: dict,
                                density: dict, step: int, extra=None,
                                device=None):
    """The port's `TrainState` from a JAX ``TrainState`` taken apart into
    numpy arrays: `params` and `alive` as for `state_from_jax_arrays`;
    `opt` = {property: {"mu": ..., "nu": ..., "count": int}}, the optax
    Adam state of each property; `density` = {"grad_accum", "denom",
    "max_radii"}; `extra`: None or {name: array}, e.g. {"filter_3d"}."""
    gstate = state_from_jax_arrays(params, alive, device)
    dev = gstate.device

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x),
                               dtype=torch.float32).to(dev)

    counts = {int(opt[k]["count"]) for k in PARAM_FIELDS}
    if len(counts) != 1:
        raise ValueError(f"per-property Adam counts differ: {counts}")
    return TrainState(
        params=gstate.params, alive=gstate.alive,
        opt_state=AdamState(
            exp_avg={k: t(opt[k]["mu"]) for k in PARAM_FIELDS},
            exp_avg_sq={k: t(opt[k]["nu"]) for k in PARAM_FIELDS},
            count=counts.pop()),
        density=DensityControlState(**{k: t(density[k]) for k in (
            "grad_accum", "denom", "max_radii")}),
        step=int(step),
        extra=None if extra is None else {k: t(v) for k, v in extra.items()})


def train_state_to_numpy(state) -> dict:
    """The inverse of `train_state_from_jax_arrays`: a dict with its
    arguments' names as keys and numpy arrays as values."""
    def a(x):
        return x.detach().cpu().numpy()

    return dict(
        params={k: a(getattr(state.params, k)) for k in PARAM_FIELDS},
        alive=a(state.alive),
        opt={k: {"mu": a(state.opt_state.exp_avg[k]),
                 "nu": a(state.opt_state.exp_avg_sq[k]),
                 "count": state.opt_state.count} for k in PARAM_FIELDS},
        density={k: a(getattr(state.density, k)) for k in (
            "grad_accum", "denom", "max_radii")},
        step=state.step,
        extra=(None if state.extra is None
               else {k: a(v) for k, v in state.extra.items()}))
