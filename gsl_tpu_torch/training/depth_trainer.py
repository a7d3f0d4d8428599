"""Depth-regularised training.

Port of ``gsl_tpu/training/depth_trainer.py``:
loss += weight(step) * D(predicted inverse depth, given inverse depth),
the weight decaying exponentially from `depth_weight_init` by
`depth_weight_final_factor` over `depth_weight_max_steps`, D one of l1,
l2 and l1 + SSIM; the prediction is the renderer's "inverse_depth"
(blended 1/z, composited beside rgb) or "hard_inverse_depth" (a second
pass with every splat opaque). As gsl_tpu's, this loss has neither the
plugins' terms nor the opacity and scale regularisers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.ssim import ssim
from .metrics import VanillaMetricsConfig, train_loss
from .trainer import Trainer


@dataclasses.dataclass
class DepthMetricsConfig(VanillaMetricsConfig):
    depth_loss_type: str = "l1"          # l1 | l2 | l1+ssim
    depth_loss_ssim_weight: float = 0.2
    depth_weight_init: float = 1.0
    depth_weight_final_factor: float = 0.01
    depth_weight_max_steps: int = 30_000
    depth_output_key: str = "inverse_depth"  # or hard_inverse_depth


def depth_weight(m: DepthMetricsConfig, step: int) -> float:
    """The depth term's weight after `step` steps, in float32 as gsl_tpu
    computes it."""
    t = np.clip(np.float32(step) / np.float32(m.depth_weight_max_steps),
                np.float32(0.0), np.float32(1.0))
    return float(np.float32(m.depth_weight_init)
                 * np.power(np.float32(m.depth_weight_final_factor), t))


class DepthTrainer(Trainer):
    """`train_step(..., aux_inputs=map)`: the scaled inverse-depth map
    [H, W] of the view on the state's device; None leaves the depth term
    out."""

    # gsl_tpu's depth step never applies an output processor
    takes_output_processor = False

    def render_losses(self, gstate, camera, img_height, img_width, bg_color,
                      sh_degree, gt_image, mask, tap, abstap, step,
                      aux_inputs=None):
        m: DepthMetricsConfig = self.metrics_cfg
        out = self.renderer.forward(
            gstate, camera, img_height, img_width, bg_color, sh_degree,
            render_types=frozenset({"rgb", m.depth_output_key}),
            means2d_tap=tap, absgrad_tap=abstap)
        loss, scalars = train_loss(
            out.render, gt_image, mask,
            lambda_dssim=m.lambda_dssim, rgb_diff_loss=m.rgb_diff_loss)

        gt_inv_depth = aux_inputs
        if gt_inv_depth is not None:
            pred = (out.hard_inverse_depth
                    if m.depth_output_key == "hard_inverse_depth"
                    else out.inverse_depth)
            if m.depth_loss_type == "l2":
                d = torch.mean((pred - gt_inv_depth) ** 2)
            else:
                d = torch.mean(torch.abs(pred - gt_inv_depth))
                if m.depth_loss_type == "l1+ssim":
                    s = ssim(pred[None], gt_inv_depth[None])
                    d = ((1 - m.depth_loss_ssim_weight) * d
                         + m.depth_loss_ssim_weight * (1 - s))
            loss = loss + depth_weight(m, step) * d
            scalars = dict(scalars, loss=loss, depth_loss=d)
        return loss, (scalars, out.radii, out.n_dropped)
