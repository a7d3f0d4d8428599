"""Build the port's states from the JAX package's arrays, and back; and a
flax parameter tree as the port's network ``state_dict``."""
from __future__ import annotations

import numpy as np
import torch

from ..models.gaussian import (OPTIONAL_FIELDS, PARAM_FIELDS,
                               GaussianParams, GaussianState)
from ..training.density import DensityControlState
from ..training.optimizers import AdamState
from ..training.trainer import TrainState
from .device import resolve_device


def state_from_jax_arrays(params: dict, alive: np.ndarray,
                          device=None) -> GaussianState:
    """`params`: the JAX ``GaussianParams`` fields as numpy arrays
    (``np.asarray`` of each); `alive`: the [CAP] mask. The appearance
    features come along where `params` has them (not None); fields the
    port does not have are ignored."""
    dev = resolve_device(device)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype).to(dev)

    names = PARAM_FIELDS + tuple(k for k in OPTIONAL_FIELDS
                                 if params.get(k) is not None)
    return GaussianState(
        params=GaussianParams(**{k: t(params[k]) for k in names}),
        alive=t(alive, torch.bool))


def _nested(x, fn):
    """fn applied to every leaf of dicts of leaves (None stays None)."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _nested(v, fn) for k, v in x.items()}
    return fn(x)


def state_from_raw_arrays(arrays: dict, device=None) -> GaussianState:
    """PLY arrays (`load_gaussian_ply`) -> state with every row alive."""
    n = arrays["means"].shape[0]
    return state_from_jax_arrays(arrays, np.ones(n, bool), device)


def train_state_from_jax_arrays(params: dict, alive: np.ndarray, opt: dict,
                                density: dict, step: int, extra=None,
                                device=None, glossy=None, deform=None):
    """The port's `TrainState` from a JAX ``TrainState`` taken apart into
    numpy arrays: `params` and `alive` as for `state_from_jax_arrays`;
    `opt` = {property: {"mu": ..., "nu": ..., "count": int}}, the optax
    Adam state of each property; `density` = {"grad_accum", "denom",
    "max_radii"}; `extra`: None or {name: array, or a dict of them}, e.g.
    {"filter_3d"}, or an output processor's ``__outproc__`` and
    ``__outproc_opt__`` in the port's layout. The core properties share
    one Adam count; a property that stepped more often (the appearance
    features, under the similarity regulariser) keeps its own. `glossy`:
    gsl_tpu's ``extra["__glossy__"]`` as {"envmap", "metalness_raw",
    "opt": {"envmap": {"mu", "nu", "count"}, "metalness_raw": {...}}};
    the metalness becomes the Gaussian property `metalness` with its
    moments, the map and its Adam ``extra["__glossy__"]``. PVG's
    `t_centers`, `t_scales` and `velocities` come along in `params` and
    `opt` where the JAX state has them. `deform`: gsl_tpu's
    ``extra["__deform__"]`` as {"params": the field's flax tree, "opt":
    {"mu": tree, "nu": tree, "count": int}}; it becomes
    ``extra["__deform__"]`` = {"params", "opt"} in the port's layout
    (`state_dict_from_flax`)."""
    if glossy is not None:
        params = dict(params, metalness=glossy["metalness_raw"])
        opt = dict(opt, metalness=glossy["opt"]["metalness_raw"])
        env = glossy["opt"]["envmap"]
        extra = dict(extra or {}, __glossy__={
            "envmap": glossy["envmap"],
            "opt": {"exp_avg": {"envmap": env["mu"]},
                    "exp_avg_sq": {"envmap": env["nu"]},
                    "count": int(env["count"])}})
    gstate = state_from_jax_arrays(params, alive, device)
    dev = gstate.device

    def t(x):
        x = np.asarray(x)
        if x.dtype.kind in "iub" and x.ndim == 0:
            return int(x)
        return torch.as_tensor(np.ascontiguousarray(x),
                               dtype=torch.float32).to(dev)

    counts = {int(opt[k]["count"]) for k in PARAM_FIELDS}
    if len(counts) != 1:
        raise ValueError(f"per-property Adam counts differ: {counts}")
    count = counts.pop()
    names = gstate.params.fields()
    solo = {k: int(opt[k]["count"]) - count for k in names
            if int(opt[k]["count"]) != count}
    return TrainState(
        params=gstate.params, alive=gstate.alive,
        opt_state=AdamState(
            exp_avg={k: t(opt[k]["mu"]) for k in names},
            exp_avg_sq={k: t(opt[k]["nu"]) for k in names},
            count=count, solo_counts=solo),
        density=DensityControlState(**{k: t(density[k]) for k in (
            "grad_accum", "denom", "max_radii")}),
        step=int(step), extra=_with_deform(_nested(extra, t), deform, dev))


def _with_deform(extra, deform, device):
    """`extra` with gsl_tpu's field state (see
    `train_state_from_jax_arrays`) as ``__deform__`` in the port's
    layout."""
    if deform is None:
        return extra
    o = deform["opt"]
    return dict(extra or {}, __deform__={
        "params": state_dict_from_flax(deform["params"], device),
        "opt": {"exp_avg": state_dict_from_flax(o["mu"], device),
                "exp_avg_sq": state_dict_from_flax(o["nu"], device),
                "count": int(o["count"])}})


def train_state_to_numpy(state) -> dict:
    """The inverse of `train_state_from_jax_arrays`: a dict with its
    arguments' names as keys and numpy arrays as values."""
    def a(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else x

    names = state.params.fields()
    return dict(
        params={k: a(getattr(state.params, k)) for k in names},
        alive=a(state.alive),
        opt={k: {"mu": a(state.opt_state.exp_avg[k]),
                 "nu": a(state.opt_state.exp_avg_sq[k]),
                 "count": state.opt_state.count_of(k)} for k in names},
        density={k: a(getattr(state.density, k)) for k in (
            "grad_accum", "denom", "max_radii")},
        step=state.step, extra=_nested(state.extra, a))


# flax module and parameter names -> the port's, for the appearance and
# visibility networks (models/appearance.py, training/visibility_map.py)
# and the HexPlane field (models/hexplane.py)
_FLAX_MODULES = {"Embed_0": "embedding", "SkipMLP_0": "mlp",
                 "DenseGrid2DEncoding_0": "encoding",
                 "HashGridEncoding_0": "encoding",
                 "HexPlaneField_0": "field"}


def state_dict_from_flax(tree: dict, device=None) -> dict:
    """A flax parameter tree (``{"params": {...}}`` or its inside, leaves
    as numpy arrays) as the port's ``state_dict``: ``Dense_i/kernel``
    [in, out] -> ``layers.i.weight`` [out, in], ``Dense_i/bias`` ->
    ``layers.i.bias``, ``Embed_0/embedding`` -> ``embedding.weight``,
    ``grid_{lv}`` and ``table_{lv}`` under ``encoding.``, ``SkipMLP_0``'s
    layers under ``mlp.``, ``HexPlaneField_0``'s planes under
    ``field.``."""
    dev = resolve_device(device)
    tree = tree.get("params", tree)
    out = {}

    def walk(node, prefix):
        for name, v in node.items():
            if isinstance(v, dict):
                if name.startswith("Dense_"):
                    sub = f"layers.{name.split('_')[1]}"
                else:
                    sub = _FLAX_MODULES[name]
                walk(v, prefix + sub + ".")
                continue
            x = np.asarray(v, np.float32)
            if name == "kernel":
                name, x = "weight", x.T
            elif name == "embedding":
                name = "weight"
            out[prefix + name] = torch.from_numpy(
                np.ascontiguousarray(x)).to(dev)

    walk(tree, "")
    return out
