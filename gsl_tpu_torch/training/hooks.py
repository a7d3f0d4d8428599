"""Variant dispatch for the fit loop, as trainer-owned hooks.

Port of ``gsl_tpu/training/hooks.py`` for the variants the port has.
`build_hooks` inspects the trainer's component configs once and returns
the objects the fit loop calls uniformly:

- `StepHook(state, generator, step, ...) -> (state, scalars)`: which train
  step runs, and what it is fed (the depth trainer's step gets the view's
  inverse-depth map);
- `DensityHook(state, generator, step) -> state`: which density-control
  schedule runs after the step (vanilla adaptive density control, or
  MCMC's relocation and growth followed by its position noise);
- lists of hooks whose `periodic(state, generator, step) -> state` runs
  before and after the density hook (the Mip-Splatting 3D-filter
  recompute).

The port runs the vanilla 3DGS trainer (AbsGS and StopThePop are options
of its density controller and renderer, plugins an argument of it), the
depth-regularised trainer and the 2DGS trainer. The JAX
package's other variant hooks (Taming, GNS, SpotLess, gradient
accumulation, the similarity regulariser, LightGaussian) come with their
variants; until then `build_hooks` raises for them.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.mip_splatting import MipSplattingConfig, compute_3d_filter
from .density import VanillaDensityControllerConfig, densify_masks
from .depth_trainer import DepthTrainer
from .gs2d import GS2DTrainer
from .mcmc import (MCMCDensityControllerConfig, dead_mask, grow_target,
                   mcmc_densify, mcmc_noise_step)
from .schedulers import exponential_decay
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


class DepthStepHook(StepHook):
    """`DepthTrainer.train_step` fed the view's scaled inverse-depth map,
    uploaded to the state's device, or None where the parser gave the
    image none. (gsl_tpu's fit calls every train step without it, so its
    depth term never acts in a fit.)"""

    def __call__(self, state, generator, step, sh_degree, cam, name, img,
                 mask, H, W):
        depth = self.ctx.dataset.get_depth(name, (H, W))
        if depth is not None:
            depth = depth.to(state.alive.device)
        return self.trainer.train_step(state, cam, img, H, W, sh_degree,
                                       self.ctx.bg, mask=mask,
                                       aux_inputs=depth)


class DensityHook:
    """Vanilla adaptive density control via `Trainer.maybe_density_ops`;
    the generator draws the split offsets."""

    def __init__(self, ctx: FitContext):
        self.ctx = ctx
        self.trainer = ctx.trainer

    def densifies_at(self, step: int) -> bool:
        return self.trainer.densifies_at(step)

    def counts_before(self, state) -> dict:
        """What the fit's densify timer records before a round."""
        clone, split = densify_masks(
            state.gaussians, state.density, self.trainer.density_cfg,
            self.trainer.cameras_extent)
        return {"clone": int(clone.sum()), "split": int(split.sum())}

    def counts_after(self, counts: dict) -> dict:
        """... and after it (`counts` holds "before" and "after")."""
        counts["pruned"] = (counts["before"] + counts["clone"]
                            + counts["split"] - counts["after"])
        return counts

    def __call__(self, state, generator, step):
        return self.trainer.maybe_density_ops(state, generator, step)


class MCMCDensityHook(DensityHook):
    """Relocation and growth every `densification_interval` steps in
    (densify_from_iter, densify_until_iter); then, on every step before the
    last, the position noise at the means' learning rate of that step.

    gsl_tpu grows only into free slots, so its MCMC fit stops at the fit's
    initial capacity (4x the points, rounded up). The port grows the
    capacity to hold the round's target first (`Trainer.grow_state`, to a
    power of two), so a fit reaches `cap_max`; where the capacity does not
    bind, both give the same rounds."""

    def __init__(self, ctx: FitContext):
        super().__init__(ctx)
        self.d = ctx.trainer.density_cfg
        opt = ctx.trainer.model.optimization
        extent = ctx.trainer.cameras_extent
        self.means_lr = exponential_decay(
            lr_init=opt.means_lr_init * extent,
            lr_final=opt.means_lr_init * opt.means_lr_final_factor * extent,
            max_steps=opt.means_lr_max_steps)
        self.n_new = 0

    def densifies_at(self, step: int) -> bool:
        d = self.d
        return (d.densify_from_iter < step < d.densify_until_iter
                and step % d.densification_interval == 0)

    def counts_before(self, state) -> dict:
        return {"dead": int(dead_mask(state.gaussians, self.d).sum())}

    def counts_after(self, counts: dict) -> dict:
        counts["added"] = self.n_new
        return counts

    def density_round(self, state, generator):
        """One relocation and growth round, growing the capacity first
        when the round's target exceeds it."""
        n_alive = int(state.alive.sum())
        target = grow_target(n_alive, self.d)
        if target > state.params.capacity:
            from .fit import _round_capacity
            state = self.trainer.grow_state(state, _round_capacity(target))
        gstate, opt_state, self.n_new = mcmc_densify(
            generator, state.gaussians, state.opt_state, self.d)
        return dataclasses.replace(state, params=gstate.params,
                                   alive=gstate.alive, opt_state=opt_state)

    def noise(self, state, generator, step):
        gstate = mcmc_noise_step(generator, state.gaussians,
                                 self.means_lr(step), self.d.noise_lr)
        return dataclasses.replace(state, params=gstate.params)

    @torch.no_grad()
    def __call__(self, state, generator, step):
        if self.densifies_at(step):
            state = self.density_round(state, generator)
        if step < self.ctx.cfg.max_steps:
            state = self.noise(state, generator, step)
        return state


class MipFilterHook:
    """The Mip-Splatting 3D filter, recomputed over the train cameras every
    `filter_3d_update_interval` steps while a whole interval remains.
    Between recomputes a densified row keeps its source's filter."""

    def __init__(self, ctx: FitContext):
        self.ctx = ctx
        self.train_cams = ctx.outputs.train_set.cameras
        self.interval = ctx.trainer.model.filter_3d_update_interval

    def periodic(self, state, generator, step):
        if (step % self.interval == 0
                and step + self.interval <= self.ctx.cfg.max_steps):
            f3d = compute_3d_filter(state.params.means, state.alive,
                                    self.train_cams)
            state = dataclasses.replace(
                state, extra=dict(state.extra or {}, filter_3d=f3d))
        return state


def build_hooks(ctx: FitContext):
    """Resolve the trainer's component configs into (step_hook,
    density_hook, pre_density_hooks, post_density_hooks)."""
    trainer = ctx.trainer
    if type(trainer) not in (Trainer, DepthTrainer, GS2DTrainer):
        raise NotImplementedError(
            f"{type(trainer).__name__}: the fit runs Trainer, DepthTrainer "
            "and GS2DTrainer; variant trainers come with their variants "
            "(ROADMAP item 12)")
    density_type = type(trainer.density_cfg)
    if density_type is VanillaDensityControllerConfig:
        density_hook = DensityHook(ctx)
    elif density_type is MCMCDensityControllerConfig:
        density_hook = MCMCDensityHook(ctx)
    else:
        raise NotImplementedError(
            f"{density_type.__name__}: the fit runs the vanilla and MCMC "
            "density controllers; the others come with their variants "
            "(ROADMAP item 12)")
    step_hook = (DepthStepHook if isinstance(trainer, DepthTrainer)
                 else StepHook)(ctx)
    post_density = []
    if isinstance(trainer.model, MipSplattingConfig):
        post_density.append(MipFilterHook(ctx))
    return step_hook, density_hook, [step_hook], post_density
