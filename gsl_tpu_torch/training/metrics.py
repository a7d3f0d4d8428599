"""Training and evaluation metrics.

Port of ``gsl_tpu/training/metrics.py``: train loss =
(1 - lambda) * L1 + lambda * (1 - SSIM), lambda = 0.2, with masked pixels
zeroed in prediction and ground truth before the loss; validation adds
PSNR. The SSIM term is the exact float32 one (see ``ops/ssim.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.ssim import ssim


@dataclasses.dataclass
class VanillaMetricsConfig:
    lambda_dssim: float = 0.2
    rgb_diff_loss: str = "l1"  # "l1" | "l2"
    # MCMC regularizers; 0 disables
    opacity_reg: float = 0.0
    scale_reg: float = 0.0

    def instantiate(self):
        return self


@dataclasses.dataclass
class MCMCMetricsConfig(VanillaMetricsConfig):
    opacity_reg: float = 0.01
    scale_reg: float = 0.01


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def train_loss(pred_hwc: torch.Tensor, gt_hwc: torch.Tensor,
               mask_hw: Optional[torch.Tensor] = None,
               lambda_dssim: float = 0.2, rgb_diff_loss: str = "l1"):
    """Returns (loss, dict of scalars). Inputs [H, W, 3]."""
    if mask_hw is not None:
        m = mask_hw[..., None]
        pred_hwc = pred_hwc * m
        gt_hwc = gt_hwc * m
    if rgb_diff_loss == "l2":
        rgb_loss = torch.mean((pred_hwc - gt_hwc) ** 2)
    else:
        rgb_loss = torch.mean(torch.abs(pred_hwc - gt_hwc))
    ssim_val = ssim(pred_hwc.permute(2, 0, 1), gt_hwc.permute(2, 0, 1))
    loss = ((1.0 - lambda_dssim) * rgb_loss
            + lambda_dssim * (1.0 - ssim_val))
    return loss, {"rgb_diff": rgb_loss, "ssim": ssim_val, "loss": loss}
