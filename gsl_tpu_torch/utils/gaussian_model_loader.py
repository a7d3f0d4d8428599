"""Find a trained model's PLY and build the state and renderer to view it.

Port of ``gsl_tpu/utils/gaussian_model_loader.py`` for PLY files: a path
to a ``.ply``, or a run directory holding
``point_cloud/iteration_N/point_cloud.ply`` (the largest N wins). Rows are
not padded to a capacity: every loaded Gaussian is alive. Orbax
checkpoints (``checkpoints/step_N``) come with the fit loop.
"""
from __future__ import annotations

import os
from typing import Tuple

from ..models.gaussian import GaussianState
from ..renderers.tile_renderer import TileRenderer, TileRendererConfig
from .convert import state_from_raw_arrays
from .ply import load_gaussian_ply

_SH_DEGREE_OF_REST = {0: 0, 3: 1, 8: 2, 15: 3}


def _has_checkpoint(path: str) -> bool:
    ckpt_dir = os.path.join(path, "checkpoints")
    return os.path.isdir(ckpt_dir) and any(
        name.startswith("step_") for name in os.listdir(ckpt_dir))


class GaussianModelLoader:
    @staticmethod
    def search_load_file(path: str) -> str:
        """Resolve a run dir or ply path to a PLY file."""
        if path.endswith(".ply"):
            return path
        pc_dir = os.path.join(path, "point_cloud")
        if os.path.isdir(pc_dir):
            best, best_iter = None, -1
            for name in os.listdir(pc_dir):
                if name.startswith("iteration_"):
                    it = int(name.split("_", 1)[1])
                    cand = os.path.join(pc_dir, name, "point_cloud.ply")
                    if os.path.isfile(cand) and it > best_iter:
                        best, best_iter = cand, it
            if best:
                return best
        if _has_checkpoint(path):
            raise NotImplementedError(
                f"{path} holds only orbax checkpoints, which the PyTorch "
                "port cannot read yet (they come with the fit loop); "
                "export a PLY with gsl_tpu first")
        raise FileNotFoundError(f"no ply under {path}")

    @classmethod
    def load(cls, path: str, device=None
             ) -> Tuple[GaussianState, TileRenderer, int]:
        """-> (state, renderer, sh_degree), on `device` (default cuda)."""
        arrays = load_gaussian_ply(cls.search_load_file(path))
        state = state_from_raw_arrays(arrays, device)
        sh_degree = _SH_DEGREE_OF_REST.get(arrays["shs_rest"].shape[1], 3)
        return state, TileRendererConfig().instantiate(), sh_degree
