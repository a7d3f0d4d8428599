"""Several models kept apart for editing, merged on demand.

Port of ``gsl_tpu/utils/gaussian_model_editor.py``: each loaded model
takes its own rigid transforms (SH-preserving, ``gaussian_transforms``)
and deletions, and `merged()` joins the alive rows of all of them into
one state. The JAX package pads the merged state to a capacity for its
compiled renderer; the port's renderers take any row count, so the merged
state holds alive rows only, like the port's loader. The SH bands are
unified to the widest model, the missing bands zero. Deletions clear
`alive` on the state's device.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.gaussian import PARAM_FIELDS, GaussianParams, GaussianState
from .gaussian_transforms import rotate_state, scale_state, translate_state
from .ply import save_state_ply


def inside_box(state: GaussianState, bbox_min, bbox_max) -> torch.Tensor:
    """[N] bool on the state's device: alive rows whose centre lies in the
    axis-aligned box (bounds included), compared in float64 as the JAX
    package compares its float32 means with float64 bounds."""
    m = state.params.means.double()
    lo = torch.as_tensor(np.asarray(bbox_min, np.float64), device=m.device)
    hi = torch.as_tensor(np.asarray(bbox_max, np.float64), device=m.device)
    return ((m >= lo) & (m <= hi)).all(dim=-1) & state.alive


def without(state: GaussianState, mask: torch.Tensor) -> GaussianState:
    """`state` with the rows of `mask` marked dead."""
    return GaussianState(params=state.params, alive=state.alive & ~mask,
                         extra=state.extra)


class MultipleGaussianModelEditor:
    def __init__(self, states: Sequence[GaussianState]):
        self._orig = list(states)
        self._edited: List[GaussianState] = list(states)

    def __len__(self):
        return len(self._edited)

    def n_gaussians(self, i: Optional[int] = None) -> int:
        if i is not None:
            return self._edited[i].n_alive
        return sum(s.n_alive for s in self._edited)

    def reset(self, i: int):
        self._edited[i] = self._orig[i]

    def transform(self, i: int, translate=(0, 0, 0), rotation=None,
                  scale: float = 1.0):
        """Rotation, then uniform scale, then translation of model i."""
        s = self._edited[i]
        if rotation is not None and not np.allclose(rotation, np.eye(3)):
            s = rotate_state(s, np.asarray(rotation))
        if scale != 1.0:
            s = scale_state(s, float(scale))
        if any(t != 0 for t in translate):
            s = translate_state(s, np.asarray(translate, np.float32))
        self._edited[i] = s

    def delete_gaussians(self, i: int, mask):
        """mask [N_i], True = delete."""
        s = self._edited[i]
        self._edited[i] = without(s, torch.as_tensor(
            mask, dtype=torch.bool, device=s.device))

    def delete_in_box(self, i: int, bbox_min, bbox_max) -> int:
        s = self._edited[i]
        inside = inside_box(s, bbox_min, bbox_max)
        self._edited[i] = without(s, inside)
        return int(inside.sum())

    def merged(self) -> GaussianState:
        """The alive rows of every model, in model order, as one state."""
        max_rest = max(s.params.shs_rest.shape[1] for s in self._edited)
        rows = {k: [] for k in PARAM_FIELDS}
        for s in self._edited:
            for k in PARAM_FIELDS:
                v = getattr(s.params, k)[s.alive]
                if k == "shs_rest" and v.shape[1] < max_rest:
                    v = torch.cat([v, v.new_zeros(
                        (v.shape[0], max_rest - v.shape[1], 3))], dim=1)
                rows[k].append(v)
        params = GaussianParams(**{k: torch.cat(v) for k, v in rows.items()})
        return GaussianState(params=params, alive=torch.ones(
            params.capacity, dtype=torch.bool, device=params.means.device))

    def save_ply(self, path: str) -> int:
        return save_state_ply(path, self.merged())
