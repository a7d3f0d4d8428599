"""Variant dispatch for the fit loop, as trainer-owned hooks.

Port of ``gsl_tpu/training/hooks.py`` for the variants the port has.
`build_hooks` inspects the trainer's component configs once and returns
the objects the fit loop calls uniformly:

- `StepHook(state, generator, step, ...) -> (state, scalars)`: which train
  step runs, and what it is fed (the view's index in the train set for an
  output processor, the depth trainer's inverse-depth map, the
  appearance trainers' warm-up flag, gradient accumulation's buffer);
  its `init_state(state, generator)` runs before a resume and sets up
  what the step keeps outside the state (the accumulation buffer);
- `DensityHook(state, generator, step) -> state`: which density-control
  schedule runs after the step (vanilla adaptive density control, or
  MCMC's relocation and growth followed by its position noise);
- lists of hooks whose `periodic(state, generator, step) -> state` runs
  before and after the density hook (the similarity regulariser before,
  the Mip-Splatting 3D-filter recompute after).

The port runs the vanilla 3DGS trainer (AbsGS and StopThePop are options
of its density controller and renderer, plugins and output processors
arguments of it), the depth-regularised trainer, the 2DGS trainer, the
appearance trainers (with visibility maps and the similarity regulariser)
and gradient accumulation. The JAX package's other variant hooks (Taming,
GNS, SpotLess, LightGaussian, deform, glossy) come with their variants;
until then `build_hooks` raises for them.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.mip_splatting import MipSplattingConfig, compute_3d_filter
from .appearance_trainer import AppearanceTrainer
from .density import VanillaDensityControllerConfig, densify_masks
from .depth_trainer import DepthTrainer
from .gs2d import GS2DTrainer
from .mcmc import (MCMCDensityControllerConfig, dead_mask, grow_target,
                   mcmc_densify, mcmc_noise_step)
from .opt_strategies import GradAccTrainer
from .schedulers import exponential_decay
from .similarity_reg import draw_sample, similarity_reg_step
from .trainer import Trainer
from .visibility_map_trainer import VisibilityMapAppearanceTrainer


@dataclasses.dataclass
class FitContext:
    """Loop-invariant context shared by all hooks."""
    trainer: Trainer
    outputs: "DataParserOutputs"
    dataset: "CachedDataset"
    cfg: "FitConfig"
    bg: torch.Tensor
    # image name -> its index in the train set
    name_to_idx: dict = dataclasses.field(default_factory=dict)


class StepHook:
    """Vanilla: `Trainer.train_step` on the view, with the view's index in
    the train set (for an output processor)."""

    def __init__(self, ctx: FitContext):
        self.ctx = ctx
        self.trainer = ctx.trainer

    def init_state(self, state, generator):
        """What the step needs before the first one, or a resume; returns
        the state."""
        return state

    def image_idx(self, name) -> int:
        return self.ctx.name_to_idx.get(name, 0)

    def __call__(self, state, generator, step, sh_degree, cam, name, img,
                 mask, H, W):
        return self.trainer.train_step(state, cam, img, H, W, sh_degree,
                                       self.ctx.bg, mask=mask,
                                       image_idx=self.image_idx(name))

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
                                       aux_inputs=depth,
                                       image_idx=self.image_idx(name))


class AppearanceStepHook(StepHook):
    """`train_step_appearance`, in its warm-up before
    `appearance_opt.warm_up`. The network takes the camera's appearance
    id."""

    def __call__(self, state, generator, step, sh_degree, cam, name, img,
                 mask, H, W):
        return self.trainer.train_step_appearance(
            state, cam, img, H, W, sh_degree, self.ctx.bg,
            warm_up=step < self.trainer.appearance_opt.warm_up, mask=mask)


class GradAccStepHook(StepHook):
    """Gradient accumulation. The buffer rides on the hook; it starts at
    zero again when the capacity has changed under it (a densify that
    grew the state)."""

    def __init__(self, ctx: FitContext):
        super().__init__(ctx)
        self.grad_buffer = None

    def init_state(self, state, generator):
        self.grad_buffer = self.trainer.init_grad_buffer(state)
        return state

    def __call__(self, state, generator, step, sh_degree, cam, name, img,
                 mask, H, W):
        if (self.grad_buffer is None
                or self.grad_buffer.capacity != state.params.capacity):
            self.grad_buffer = self.trainer.init_grad_buffer(state)
        k = self.trainer.grad_acc.accumulation_at(step)
        state, self.grad_buffer, scalars = \
            self.trainer.train_step_accumulate(
                state, self.grad_buffer, cam, img, H, W, sh_degree,
                self.ctx.bg, apply=(step % k == 0), inv_k=1.0 / k,
                mask=mask)
        return state, scalars


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


class SimilarityRegHook:
    """The appearance-feature similarity step every
    `similarity_reg_interval` steps from `similarity_reg_from`, on rows
    drawn from the fit's generator."""

    def __init__(self, ctx: FitContext):
        self.ctx = ctx
        self.cfg = ctx.trainer.similarity_reg

    def periodic(self, state, generator, step):
        c = self.cfg
        if step >= c.similarity_reg_from \
                and step % c.similarity_reg_interval == 0:
            sample = draw_sample(c, state.params.capacity, generator,
                                 state.alive.device)
            state, _ = similarity_reg_step(c, self.ctx.trainer.tx, state,
                                           sample)
        return state


TRAINERS = (Trainer, DepthTrainer, GS2DTrainer, AppearanceTrainer,
            VisibilityMapAppearanceTrainer, GradAccTrainer)


def build_hooks(ctx: FitContext):
    """Resolve the trainer's component configs into (step_hook,
    density_hook, pre_density_hooks, post_density_hooks)."""
    trainer = ctx.trainer
    if type(trainer) not in TRAINERS:
        raise NotImplementedError(
            f"{type(trainer).__name__}: the fit runs "
            f"{', '.join(t.__name__ for t in TRAINERS)}; variant trainers "
            "come with their variants (ROADMAP item 12)")
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
    if isinstance(trainer, AppearanceTrainer):
        step_hook = AppearanceStepHook(ctx)
    elif isinstance(trainer, GradAccTrainer):
        step_hook = GradAccStepHook(ctx)
    elif isinstance(trainer, DepthTrainer):
        step_hook = DepthStepHook(ctx)
    else:
        step_hook = StepHook(ctx)
    pre_density = [step_hook]
    if getattr(trainer, "similarity_reg", None) is not None:
        pre_density.append(SimilarityRegHook(ctx))
    post_density = []
    if isinstance(trainer.model, MipSplattingConfig):
        post_density.append(MipFilterHook(ctx))
    return step_hook, density_hook, pre_density, post_density
