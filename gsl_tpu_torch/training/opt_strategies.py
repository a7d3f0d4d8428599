"""Gradient accumulation.

Port of ``gsl_tpu/training/opt_strategies.py``: staged accumulation
(1, then 5 from step 20,000, then 20 from 24,000 by default). The
gradients of k consecutive steps are summed in a buffer and their mean
applied on every k-th; the density statistics accumulate on every step.
The buffer is the caller's (the fit's `GradAccStepHook` holds it), as in
gsl_tpu: it is not part of the train state and not checkpointed.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from ..models.gaussian import GaussianParams
from .trainer import Trainer, TrainState


@dataclasses.dataclass
class GradAccConfig:
    # (from_step, factor) stages
    stages: Sequence[Tuple[int, int]] = ((0, 1), (20_000, 5), (24_000, 20))

    def accumulation_at(self, step: int) -> int:
        k = 1
        for frm, factor in self.stages:
            if step >= frm:
                k = factor
        return k


class GradAccTrainer(Trainer):
    # gsl_tpu's accumulating step never applies an output processor
    takes_output_processor = False

    def __init__(self, *args, grad_acc: GradAccConfig = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.grad_acc = grad_acc or GradAccConfig()

    def init_grad_buffer(self, state: TrainState) -> GaussianParams:
        return state.params.map(lambda _, x: torch.zeros_like(x))

    def train_step_accumulate(self, state: TrainState,
                              grad_buffer: GaussianParams, camera,
                              gt_image, img_height: int, img_width: int,
                              sh_degree: int, bg_color, apply: bool,
                              inv_k: float, mask=None):
        """One step's gradients added to `grad_buffer`; with `apply`, the
        buffer times `inv_k` goes through Adam and the buffer restarts at
        zero. Returns (state, buffer, scalars)."""
        def loss_of(gstate, tap, abstap):
            return self.render_losses(
                gstate, camera, img_height, img_width, bg_color, sh_degree,
                gt_image, mask, tap, None, state.step)

        pgrads, tap_grad, _, _, (scalars, radii, n_dropped) = \
            self.gradients(state, loss_of)
        density = self.density_stats(state, tap_grad, radii, img_width,
                                     img_height)
        with torch.no_grad():
            grad_buffer = grad_buffer.map(
                lambda k, b: b + getattr(pgrads, k))
        params, opt_state = state.params, state.opt_state
        if apply:
            params, opt_state = self.adam_step(
                state, grad_buffer.map(lambda _, g: g * inv_k))
            grad_buffer = self.init_grad_buffer(state)
        scalars = {k: v.detach() for k, v in scalars.items()}
        scalars["n_dropped_isects"] = n_dropped
        return (TrainState(params=params, alive=state.alive,
                           opt_state=opt_state, density=density,
                           step=state.step + 1, extra=state.extra),
                grad_buffer, scalars)
