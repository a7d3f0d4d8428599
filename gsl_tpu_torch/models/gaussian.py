"""Gaussian scene model for serving: raw parameters plus an alive mask.

Port of ``GaussianParams`` / ``GaussianState`` in
``gsl_tpu/models/gaussian.py``: the same raw parameterization (scales =
log(s), opacities = logit(o), rotations = wxyz) and the same activated
getters. Dead slots (alive False) get opacity 0, so they never rasterize.
Initialization, optimizer settings and capacity growth come with the
training slice.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.transforms import normalize_quat


@dataclasses.dataclass
class GaussianParams:
    means: torch.Tensor       # [N, 3]
    scales: torch.Tensor      # [N, 3] log-space
    rotations: torch.Tensor   # [N, 4] wxyz, unnormalized
    opacities: torch.Tensor   # [N, 1] logit-space
    shs_dc: torch.Tensor      # [N, 1, 3]
    shs_rest: torch.Tensor    # [N, K-1, 3]

    @property
    def capacity(self) -> int:
        return self.means.shape[0]


@dataclasses.dataclass
class GaussianState:
    params: GaussianParams
    alive: torch.Tensor       # [N] bool

    @property
    def capacity(self) -> int:
        return self.params.capacity

    @property
    def device(self) -> torch.device:
        return self.params.means.device

    @property
    def n_alive(self) -> int:
        return int(self.alive.sum())

    def get_means(self):
        return self.params.means

    def get_scales(self):
        return torch.exp(self.params.scales)

    def get_rotations(self):
        return normalize_quat(self.params.rotations)

    def get_opacities(self):
        """[N] activated opacity; dead slots forced to 0."""
        return torch.sigmoid(self.params.opacities[:, 0]) * self.alive

    def get_shs(self):
        return torch.cat([self.params.shs_dc, self.params.shs_rest], dim=1)
