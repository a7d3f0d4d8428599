"""2D Gaussian (surfel) model: 2-column scales and random initial rotations.

Port of ``gsl_tpu/models/gaussian_2d.py``. The random rotations come from
numpy's ``RandomState(rotation_seed)``, so both packages start from the
same state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .gaussian import GaussianState, VanillaGaussianConfig


@dataclasses.dataclass
class Gaussian2DConfig(VanillaGaussianConfig):
    rotation_seed: int = 17

    def init_from_pcd(self, xyz: np.ndarray, rgb: np.ndarray,
                      capacity: int, device=None) -> GaussianState:
        state = super().init_from_pcd(xyz, rgb, capacity, device)
        n = xyz.shape[0]
        rng = np.random.RandomState(self.rotation_seed)
        rand_rot = torch.from_numpy(
            rng.uniform(0.0, 1.0, size=(capacity, 4)).astype(np.float32))
        rotations = state.params.rotations.clone()
        rotations[:n] = rand_rot[:n].to(rotations.device)
        params = dataclasses.replace(
            state.params, scales=state.params.scales[:, :2].contiguous(),
            rotations=rotations)
        return GaussianState(params=params, alive=state.alive)
