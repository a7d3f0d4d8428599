"""Build the port's state from the JAX package's parameter arrays."""
from __future__ import annotations

import numpy as np
import torch

from ..models.gaussian import GaussianParams, GaussianState
from .device import resolve_device

FIELDS = ("means", "scales", "rotations", "opacities", "shs_dc", "shs_rest")


def state_from_jax_arrays(params: dict, alive: np.ndarray,
                          device=None) -> GaussianState:
    """`params`: the JAX ``GaussianParams`` fields as numpy arrays
    (``np.asarray`` of each); `alive`: the [CAP] mask. Fields the serving
    path does not use are ignored."""
    dev = resolve_device(device)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype).to(dev)

    return GaussianState(
        params=GaussianParams(**{k: t(params[k]) for k in FIELDS}),
        alive=t(alive, torch.bool))


def state_from_raw_arrays(arrays: dict, device=None) -> GaussianState:
    """PLY arrays (`load_gaussian_ply`) -> state with every row alive."""
    n = arrays["means"].shape[0]
    return state_from_jax_arrays(arrays, np.ones(n, bool), device)
