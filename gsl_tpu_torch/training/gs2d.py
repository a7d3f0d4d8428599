"""2DGS training: the surfel renderer with the normal-consistency and
depth-distortion losses.

Port of ``gsl_tpu/training/gs2d.py``:
loss += lambda_normal * mean(1 - rend_normal . surf_normal) after step
        normal_from_iter
      + lambda_dist * mean(rend_dist) after step dist_from_iter.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.gaussian_2d import Gaussian2DConfig
from ..renderers.surfel_renderer import SurfelRendererConfig
from .metrics import VanillaMetricsConfig, train_loss
from .trainer import Trainer


@dataclasses.dataclass
class GS2DMetricsConfig(VanillaMetricsConfig):
    lambda_normal: float = 0.05
    lambda_dist: float = 0.0
    normal_from_iter: int = 7000
    dist_from_iter: int = 3000


class GS2DTrainer(Trainer):
    """Trainer over a `SurfelRenderer` and a `GS2DMetricsConfig`."""

    # gsl_tpu's 2DGS losses never apply an output processor
    takes_output_processor = False

    def __init__(self, model: Gaussian2DConfig = None,
                 renderer: SurfelRendererConfig = None, density=None,
                 metrics: GS2DMetricsConfig = None, config=None,
                 plugins: tuple = (), output_processor=None):
        super().__init__(model=model or Gaussian2DConfig(),
                         renderer=renderer or SurfelRendererConfig(),
                         density=density,
                         metrics=metrics or GS2DMetricsConfig(),
                         config=config, plugins=plugins,
                         output_processor=output_processor)

    def render_losses(self, gstate, camera, img_height, img_width, bg_color,
                      sh_degree, gt_image, mask, tap, abstap, step,
                      aux_inputs=None):
        """As gsl_tpu's: the plugins act at setup only, and `aux_inputs`
        is not read."""
        out = self.renderer.forward(
            gstate, camera, img_height, img_width, bg_color, sh_degree,
            means2d_tap=tap)
        loss, scalars = train_loss(
            out.render, gt_image, mask,
            lambda_dssim=self.metrics_cfg.lambda_dssim,
            rgb_diff_loss=self.metrics_cfg.rgb_diff_loss)

        m = self.metrics_cfg
        lam_n = m.lambda_normal if step > m.normal_from_iter else 0.0
        lam_d = m.lambda_dist if step > m.dist_from_iter else 0.0
        normal_err = 1.0 - torch.sum(out.rend_normal * out.surf_normal,
                                     dim=-1)
        normal_loss = lam_n * torch.mean(normal_err)
        dist_loss = lam_d * torch.mean(out.rend_dist)
        loss = loss + normal_loss + dist_loss
        scalars = dict(scalars, loss=loss, normal_loss=normal_loss,
                       dist_loss=dist_loss)
        return loss, (scalars, out.radii, out.n_dropped)
