"""Find a trained model and build the state and renderer to view it.

Port of ``gsl_tpu/utils/gaussian_model_loader.py``. A path is a ``.ply``
file or a run directory. In a run directory the search follows the JAX
package: the newest checkpoint (``checkpoints/step_N``, the largest N)
first, then the newest ``point_cloud/iteration_N/point_cloud.ply``. A
checkpoint of the JAX package (an orbax tree) cannot be read here, and
loading it raises: pass that run's PLY path instead.

Rows are not padded to a capacity: a PLY gives every row alive, and a
checkpoint gives its alive rows only, with the optional properties it
holds (appearance features, metalness, PVG's temporal fields), as the
JAX package's loader keeps every property of a checkpoint. The renderer
is a plain one whatever the run trained, as the JAX package's. A state
whose scales have two columns is a surfel (2DGS) state and comes with a
``SurfelRenderer``.
"""
from __future__ import annotations

import os
from typing import Tuple, Union

from ..models.gaussian import (OPTIONAL_FIELDS, PARAM_FIELDS, GaussianParams,
                               GaussianState)
from ..renderers.surfel_renderer import SurfelRenderer, SurfelRendererConfig
from ..renderers.tile_renderer import TileRenderer, TileRendererConfig
from .checkpoint import find_latest_checkpoint, read_state_dict
from .convert import state_from_raw_arrays
from .device import resolve_device
from .ply import load_gaussian_ply

_SH_DEGREE_OF_REST = {0: 0, 3: 1, 8: 2, 15: 3}


def _newest_ply(path: str):
    pc_dir = os.path.join(path, "point_cloud")
    if not os.path.isdir(pc_dir):
        return None
    best, best_iter = None, -1
    for name in os.listdir(pc_dir):
        if name.startswith("iteration_"):
            it = int(name.split("_", 1)[1])
            cand = os.path.join(pc_dir, name, "point_cloud.ply")
            if os.path.isfile(cand) and it > best_iter:
                best, best_iter = cand, it
    return best


def _state_from_checkpoint(path: str, device) -> GaussianState:
    raw = read_state_dict(path, resolve_device(device))
    alive = raw["alive"]
    names = PARAM_FIELDS + tuple(k for k in OPTIONAL_FIELDS
                                 if raw["params"].get(k) is not None)
    return GaussianState(
        params=GaussianParams(**{k: raw["params"][k][alive].contiguous()
                                 for k in names}),
        alive=alive[alive])


class GaussianModelLoader:
    @staticmethod
    def search_load_file(path: str) -> str:
        """Resolve a run dir / ply path to a checkpoint directory or a PLY
        file (the newest checkpoint, then the newest PLY)."""
        if path.endswith(".ply"):
            return path
        ckpt = find_latest_checkpoint(os.path.join(path, "checkpoints"))
        if ckpt:
            return ckpt
        ply = _newest_ply(path)
        if ply:
            return ply
        raise FileNotFoundError(f"no checkpoint or ply under {path}")

    @classmethod
    def load(cls, path: str, device=None
             ) -> Tuple[GaussianState, Union[TileRenderer, SurfelRenderer],
                        int]:
        """-> (state, renderer, sh_degree), on `device` (default cuda)."""
        artifact = cls.search_load_file(path)
        if artifact.endswith(".ply"):
            arrays = load_gaussian_ply(artifact)
            state = state_from_raw_arrays(arrays, device)
        else:
            state = _state_from_checkpoint(artifact, device)
        params = state.params
        sh_degree = _SH_DEGREE_OF_REST.get(params.shs_rest.shape[1], 3)
        renderer = (SurfelRendererConfig() if params.scales.shape[1] == 2
                    else TileRendererConfig()).instantiate()
        return state, renderer, sh_degree

