"""3D Gaussian splats, with the rasterizer the configuration's
`stp_resort` picks: K2/K3 in depth order, or StopThePop's K2s/K3s."""
from __future__ import annotations

import torch

from .. import scene
from ..reference import model
from ..work import counts, least_time

draw_scene = scene.draw_scene


def program_state(arrays: dict, device):
    from gsl_tpu_torch.models.gaussian import GaussianParams, GaussianState
    n = arrays["means"].shape[0]
    return GaussianState(params=GaussianParams(**arrays),
                         alive=torch.ones(n, dtype=torch.bool, device=device))


def render(cfg, params, cam, background, prec):
    return model.render(params, cam, background, prec, cfg["stp_resort"])


def train_step(cfg, params, mu, nu, count, cam, gt, background, extent,
               prec, rows=None):
    return model.train_step(params, mu, nu, count, cam, gt, background,
                            extent, prec, cfg["stp_resort"], rows)


def view_counts(cfg, params, cam) -> dict:
    return counts.view_counts(params, cam, cfg["stp_resort"])


def frame_parts(cfg, c: dict) -> dict:
    return least_time.frame_parts(c, cfg["stp_resort"])


def step_parts(cfg, c: dict) -> dict:
    return least_time.step_parts(c, cfg["stp_resort"])
