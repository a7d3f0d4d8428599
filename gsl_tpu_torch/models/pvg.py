"""Periodic Vibration Gaussians (PVG): dynamic scenes.

Port of ``gsl_tpu/models/pvg.py``. Each Gaussian gains a life peak tau
(``t_centers``), a lifespan beta (``t_scales``, log-space) and a
velocity; at the camera's time t, with vibration cycle T:

  means(t)   = means + v * sin(2 pi (t - tau) / T) * T / (2 pi)
  opacity(t) = opacity * exp(-0.5 (t - tau)^2 / beta^2)

`PVGRenderer` applies both through the renderer's `get_means` and
`get_opacities` seams, so a PVG render runs K1-K4 as the plain one does,
in training and in validation alike. The three properties train with one
Adam at 1e-3 (``training/optimizers.PVG_LR``): gsl_tpu never reads
`PVGConfig.pvg_lr`, nor `PVGConfig.cycle_length` (the renderer keeps its
own), and the port mirrors both.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..data.cameras import Cameras
from ..renderers.tile_renderer import TileRenderer, TileRendererConfig
from .gaussian import GaussianState, VanillaGaussianConfig


@dataclasses.dataclass
class PVGConfig(VanillaGaussianConfig):
    cycle_length: float = 0.2      # not read (gsl_tpu's neither)
    initial_t_scale: float = 1.0   # large lifespan ~= static at init
    pvg_lr: float = 1e-3           # not read (gsl_tpu's neither)

    def init_from_pcd(self, xyz: np.ndarray, rgb: np.ndarray,
                      capacity: int, device=None) -> GaussianState:
        """The vanilla rows, plus life peaks uniform in [0, 1) from
        ``RandomState(3)`` (gsl_tpu's draws), log lifespans
        log(initial_t_scale) in every row and zero velocities."""
        state = super().init_from_pcd(xyz, rgb, capacity, device)
        n = xyz.shape[0]
        t0 = np.zeros((capacity, 1), np.float32)
        t0[:n, 0] = np.random.RandomState(3).uniform(0, 1, n)
        dev = state.device
        return dataclasses.replace(state, params=dataclasses.replace(
            state.params,
            t_centers=torch.from_numpy(t0).to(dev),
            t_scales=torch.full((capacity, 1),
                                float(np.float32(np.log(
                                    self.initial_t_scale))),
                                dtype=torch.float32, device=dev),
            velocities=torch.zeros((capacity, 3), dtype=torch.float32,
                                   device=dev)))


def pvg_modulate(gstate: GaussianState, t, cycle_length: float):
    """-> (means at time t [CAP, 3], temporal opacity factor [CAP])."""
    p = gstate.params
    tau = p.t_centers[:, 0]
    beta = torch.exp(p.t_scales[:, 0])
    phase = 2.0 * math.pi * (t - tau) / cycle_length
    amp = cycle_length / (2.0 * math.pi)
    means_t = p.means + p.velocities * (torch.sin(phase) * amp)[:, None]
    rho = torch.exp(-0.5 * ((t - tau) / torch.clamp(beta, min=1e-6)) ** 2)
    return means_t, rho


@dataclasses.dataclass
class PVGRendererConfig(TileRendererConfig):
    cycle_length: float = 0.2

    def instantiate(self) -> "PVGRenderer":
        return PVGRenderer(self)


class PVGRenderer(TileRenderer):
    """The tile renderer at the camera's time: vibrating means, opacities
    faded by the distance from each life peak."""

    def get_means(self, gaussians: GaussianState, camera: Cameras):
        means_t, _ = pvg_modulate(gaussians, camera.time,
                                  self.config.cycle_length)
        return means_t

    def get_opacities(self, gaussians, camera, proj):
        _, rho = pvg_modulate(gaussians, camera.time,
                              self.config.cycle_length)
        op = gaussians.get_opacities() * rho
        if self.config.anti_aliased:
            op = op * proj.compensations
        return op
