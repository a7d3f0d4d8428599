"""Variant dispatch for the fit loop, as trainer-owned hooks.

Port of the vanilla part of ``gsl_tpu/training/hooks.py``. `build_hooks`
inspects the trainer's component configs once and returns the objects the
fit loop calls uniformly:

- `StepHook(state, generator, step, ...) -> (state, scalars)`: which train
  step runs;
- `DensityHook(state, generator, step) -> state`: which density-control
  schedule runs after the step;
- lists of hooks whose `periodic(state, generator, step) -> state` runs
  before and after the density hook.

The port runs the vanilla 3DGS trainer (AbsGS and StopThePop are options
of its density controller and renderer) and the 2DGS trainer. The JAX
package's variant hooks (MCMC, Taming, GNS, SpotLess, gradient
accumulation, the Mip filter, the similarity regulariser, LightGaussian)
come with their variants; until then `build_hooks` raises for them.
"""
from __future__ import annotations

import dataclasses

import torch

from .density import VanillaDensityControllerConfig
from .gs2d import GS2DTrainer
from .trainer import Trainer


@dataclasses.dataclass
class FitContext:
    """Loop-invariant context shared by all hooks."""
    trainer: Trainer
    outputs: "DataParserOutputs"
    dataset: "CachedDataset"
    cfg: "FitConfig"
    bg: torch.Tensor


class StepHook:
    """Vanilla: `Trainer.train_step` on the view."""

    def __init__(self, ctx: FitContext):
        self.ctx = ctx
        self.trainer = ctx.trainer

    def __call__(self, state, generator, step, sh_degree, cam, name, img,
                 mask, H, W):
        return self.trainer.train_step(state, cam, img, H, W, sh_degree,
                                       self.ctx.bg, mask=mask)

    def periodic(self, state, generator, step):
        return state


class DensityHook:
    """Vanilla adaptive density control via `Trainer.maybe_density_ops`;
    the generator draws the split offsets."""

    def __init__(self, ctx: FitContext):
        self.ctx = ctx
        self.trainer = ctx.trainer

    def densifies_at(self, step: int) -> bool:
        return self.trainer.densifies_at(step)

    def __call__(self, state, generator, step):
        return self.trainer.maybe_density_ops(state, generator, step)


def build_hooks(ctx: FitContext):
    """Resolve the trainer's component configs into (step_hook,
    density_hook, pre_density_hooks, post_density_hooks)."""
    trainer = ctx.trainer
    if type(trainer) not in (Trainer, GS2DTrainer):
        raise NotImplementedError(
            f"{type(trainer).__name__}: the fit runs Trainer and "
            "GS2DTrainer; variant trainers come with their variants "
            "(ROADMAP item 12)")
    if type(trainer.density_cfg) is not VanillaDensityControllerConfig:
        raise NotImplementedError(
            f"{type(trainer.density_cfg).__name__}: the fit runs the "
            "vanilla density controller; the others come with their "
            "variants (ROADMAP items 8 and 12)")
    step_hook = StepHook(ctx)
    return step_hook, DensityHook(ctx), [step_hook], []
