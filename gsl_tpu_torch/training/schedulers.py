"""Learning-rate schedules as callables of the step.

Port of ``gsl_tpu/training/schedulers.py``: log-space interpolation from
lr_init to lr_final over max_steps, with an optional warm-up ramp from
lr_pre_warmup.
"""
from __future__ import annotations

import math

import torch


def exponential_decay(lr_init: float, lr_final: float, max_steps: int,
                      warmup_steps: int = 0, lr_pre_warmup: float = 1e-8,
                      ramp: str = "cosine"):
    def schedule(step) -> torch.Tensor:
        """step: int or tensor -> float32 tensor of the same shape."""
        step = torch.as_tensor(step, dtype=torch.float32)
        if warmup_steps > 0:
            frac = torch.clamp(step / warmup_steps, 0.0, 1.0)
            w = torch.sin(0.5 * math.pi * frac) if ramp == "cosine" else frac
            pre = lr_pre_warmup + (lr_init - lr_pre_warmup) * w
        else:
            pre = torch.full_like(step, lr_init)
        t = torch.clamp((step - warmup_steps)
                        / max(max_steps - warmup_steps, 1), 0.0, 1.0)
        decayed = torch.exp((1.0 - t) * math.log(lr_init)
                            + t * math.log(lr_final))
        return torch.where(step < warmup_steps, pre, decayed)

    return schedule
