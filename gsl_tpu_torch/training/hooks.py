"""Variant dispatch for the fit loop, as trainer-owned hooks.

Port of ``gsl_tpu/training/hooks.py``. `build_hooks` inspects the
trainer's component configs once and returns the objects the fit loop
calls uniformly:

- `StepHook(state, generator, step, ...) -> (state, scalars)`: which train
  step runs, and what it is fed (the view's index in the train set for an
  output processor, the depth trainer's inverse-depth map, the
  appearance trainers' and the deform trainer's warm-up flags, gradient
  accumulation's buffer, GNS's opacity regulariser and update factor; the
  deform trainer's AST noise draws from the fit's generator);
  its `init_state(state, generator)` runs before a resume and sets up
  what the step keeps outside the state (the accumulation buffer) or in
  its `extra` (GNS's schedule);
- `DensityHook(state, generator, step) -> state`: which density-control
  schedule runs after the step (vanilla adaptive density control and its
  variants, with background removal before a densify; none for the
  static controller; MCMC's relocation and growth followed by its
  position noise; Taming's and GNS's budgeted rounds and GNS's prunes);
- lists of hooks whose `periodic(state, generator, step) -> state` runs
  before and after the density hook (the similarity regulariser before,
  the Mip-Splatting 3D-filter recompute and LightGaussian's pruning
  after).

PVG needs no hook of its own: it is a model and a renderer on the plain
step. The JAX package's SpotLess hook comes with its variant; until then
`build_hooks` raises for it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data.dataparsers.dataparser import camera_centers
from ..data.dataset import image_to_float
from ..models.mip_splatting import MipSplattingConfig, compute_3d_filter
from .appearance_trainer import AppearanceTrainer
from .density import (AccurateVisibilityFilterDensityControllerConfig,
                      BackgroundRemovalDensityControllerConfig,
                      H3DGSDensityControllerConfig,
                      NoCullingBigScaleDensityControllerConfig,
                      RevisingDensityControllerConfig,
                      StaticDensityControllerConfig,
                      VanillaDensityControllerConfig,
                      background_removal_step, densify_masks, mean_grads)
from .deform_trainer import DeformTrainer
from .depth_trainer import DepthTrainer
from .glossy_trainer import GlossyTrainer
from .gns import (GNSController, GNSDensityControllerConfig,
                  edge_weighted_blend_scores, final_budget_prune,
                  gns_budget_at, gns_densify, gns_opacity_reg_loss,
                  prune_by_opacity)
from .gs2d import GS2DTrainer
from .light_gaussian import (accumulate_blend_weights, bias_render,
                             prune_by_importance)
from .mcmc import (MCMCDensityControllerConfig, dead_mask, grow_target,
                   mcmc_densify, mcmc_noise_step)
from .opt_strategies import GradAccTrainer
from .schedulers import exponential_decay
from .similarity_reg import draw_sample, similarity_reg_step
from .taming import (Taming3DGSDensityControllerConfig,
                     compute_gaussian_scores, densify_selected,
                     draw_uniforms, get_count_array, get_edges,
                     taming_masks)
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


class DeformStepHook(StepHook):
    """`train_step_deform`, in its warm-up (the field idle) before
    `deform_cfg.warm_up`; the AST noise draws from the fit's generator."""

    def __call__(self, state, generator, step, sh_degree, cam, name, img,
                 mask, H, W):
        return self.trainer.train_step_deform(
            state, cam, img, H, W, sh_degree, self.ctx.bg,
            warm_up=step < self.trainer.deform_cfg.warm_up,
            generator=generator, mask=mask)


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


class GlossyStepHook(StepHook):
    """`train_step_glossy`: SH albedo plus the environment light's
    specular term, with the env map and metalness trained alongside."""

    def __call__(self, state, generator, step, sh_degree, cam, name, img,
                 mask, H, W):
        return self.trainer.train_step_glossy(state, cam, img, H, W,
                                              sh_degree, self.ctx.bg,
                                              mask=mask)


class DensityHook:
    """Vanilla adaptive density control via `Trainer.maybe_density_ops`
    (its variants are branches of the same pass); the generator draws the
    split offsets. With the background-removal controller, the rows
    outside the sphere around the train cameras' centres (radius: the
    farthest camera, times `foreground_radius_scaling`) lose their opacity
    before each densify after `background_removal_from`."""

    def __init__(self, ctx: FitContext):
        self.ctx = ctx
        self.trainer = ctx.trainer
        d = ctx.trainer.density_cfg
        self.bg_removal = d if isinstance(
            d, BackgroundRemovalDensityControllerConfig) else None
        if self.bg_removal is not None:
            centers = camera_centers(ctx.outputs.train_set.cameras)
            self.br_center = centers.mean(0)
            self.br_radius = float(
                np.linalg.norm(centers - self.br_center, axis=-1).max()
                * d.foreground_radius_scaling)

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

    @torch.no_grad()
    def __call__(self, state, generator, step):
        d = self.bg_removal
        if (d is not None
                and d.background_removal_from < step < d.densify_until_iter
                and step % d.densification_interval == 0):
            gstate = background_removal_step(state.gaussians, self.br_center,
                                             self.br_radius)
            state = dataclasses.replace(state, params=gstate.params)
        return self.trainer.maybe_density_ops(state, generator, step)


class StaticDensityHook(DensityHook):
    """The static controller: no densify, prune or opacity reset."""

    def densifies_at(self, step: int) -> bool:
        return False

    def __call__(self, state, generator, step):
        return state


def _grown(trainer, state, redo, pads):
    """`redo(state, *pads) -> (result, n_truncated)` on `state`, and
    again from `state` grown 2x (with each [CAP] tensor of `pads` padded
    with zeros) while the pass runs out of free slots, at most 3 times.
    Returns the last result."""
    result, n_trunc = redo(state, *pads)
    tries = 0
    while int(n_trunc) > 0 and tries < 3:
        state = trainer.grow_state(state, 2 * state.params.capacity)
        pads = [torch.cat([x, x.new_zeros(state.params.capacity
                                          - x.shape[0])]) for x in pads]
        result, n_trunc = redo(state, *pads)
        tries += 1
    if int(n_trunc) > 0:
        print(f"[fit] densify still truncating {int(n_trunc)} after "
              f"{tries} capacity growths")
    return result


def _score_views(ctx: FitContext, indices, device):
    """The train views `indices` as (one-camera Cameras, float image
    [H, W, 3]) on `device`."""
    cams, images = [], []
    for i in indices:
        cam, _, img_u8, _ = ctx.dataset.get(int(i))
        cams.append(cam.to(device))
        images.append(image_to_float(img_u8.to(device)))
    return cams, images


class TamingDensityHook(DensityHook):
    """Taming 3DGS: every `densification_interval` steps in
    (densify_from_iter, densify_until_iter) a budgeted round over the
    scores of `n_score_cameras` evenly spaced train views; opacity resets
    as the vanilla schedule has them (without the white-background one).
    The count curve starts from the initial count, as gsl_tpu's does. A
    round that runs out of free slots grows the capacity and is redone
    (its scores padded with zeros)."""

    def __init__(self, ctx: FitContext, initial_n_alive: int):
        super().__init__(ctx)
        d = self.d = ctx.trainer.density_cfg
        self.budgets = get_count_array(
            initial_n_alive, d.budget, d.densify_until_iter,
            d.densify_from_iter, d.densification_interval, d.mode)
        self.counts = {}

    def budget_at(self, step: int) -> int:
        d = self.d
        i = (step - d.densify_from_iter) // d.densification_interval
        return self.budgets[min(max(i, 0), len(self.budgets) - 1)]

    def counts_before(self, state) -> dict:
        return {}

    def counts_after(self, counts: dict) -> dict:
        """The round's budget and the rows it drew to clone and split."""
        counts.update(self.counts)
        return super().counts_after(counts)

    def density_round(self, state, generator, step):
        d, ctx, trainer = self.d, self.ctx, self.trainer
        dev = state.alive.device
        n = len(ctx.outputs.train_set)
        cams, gts = _score_views(ctx, np.linspace(
            0, n - 1, min(d.n_score_cameras, n)).astype(int), dev)
        scores = compute_gaussian_scores(
            trainer.renderer, state.gaussians, cams, gts,
            mean_grads(state.density), ctx.bg, trainer.sh_degree_at(step),
            d.score_coeffs, lambda_dssim=trainer.metrics_cfg.lambda_dssim)
        budget = self.budget_at(step)
        use_size_prune = step > d.opacity_reset_interval

        def one_pass(st, sc):
            cap = st.params.capacity
            clone, split = taming_masks(
                (draw_uniforms(generator, cap, dev),
                 draw_uniforms(generator, cap, dev)), st.gaussians,
                st.density, d, sc, budget, trainer.cameras_extent)
            gstate, opt_state, dstate, n_trunc = densify_selected(
                generator, st.gaussians, st.opt_state, st.density, d,
                clone, split, trainer.cameras_extent, trainer.prune_extent,
                use_size_prune)
            self.counts = {"budget": budget, "clone": int(clone.sum()),
                           "split": int(split.sum())}
            return dataclasses.replace(
                st, params=gstate.params, alive=gstate.alive,
                opt_state=opt_state, density=dstate,
                extra=gstate.extra), n_trunc

        return _grown(trainer, state, one_pass, [scores])

    @torch.no_grad()
    def __call__(self, state, generator, step):
        d = self.d
        if self.densifies_at(step):
            state = self.density_round(state, generator, step)
        if (step < d.densify_until_iter
                and step % d.opacity_reset_interval == 0):
            state = self.trainer.opacity_reset_step(state)
        return state


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


class GNSHooks(StepHook):
    """GNS couples the step (the opacity regulariser's schedule and update
    factor) with its density schedule: one object serves as the step hook
    and, through `density_hook`, as the density hook. The controller's
    state rides in ``state.extra["__gns__"]``; the alive count is read from
    the state at the first step (after a resume, the resumed state's) and
    after each densify or prune, never on other steps."""

    def __init__(self, ctx: FitContext):
        super().__init__(ctx)
        self.d = ctx.trainer.density_cfg
        GNSController(self.d)          # the budget must be set
        self.n_alive = None
        self.counts = {}

    def init_state(self, state, generator):
        if "__gns__" in (state.extra or {}):
            return state
        return self._with(state, GNSController(self.d))

    @staticmethod
    def _with(state, ctl: GNSController):
        return dataclasses.replace(
            state, extra=dict(state.extra or {}, __gns__=ctl.as_extra()))

    def controller(self, state) -> GNSController:
        if self.n_alive is None:
            self.n_alive = state.gaussians.n_alive
        return GNSController.from_extra(self.d, state.extra["__gns__"])

    def __call__(self, state, generator, step, sh_degree, cam, name, img,
                 mask, H, W):
        d = self.d
        ctl = self.controller(state)
        in_phase = ctl.in_reg_phase(step, self.n_alive)
        if in_phase and (step - 1) % 100 == 0:
            with torch.no_grad():
                ops = torch.sigmoid(state.params.opacities[:, 0])
                ops_sorted = torch.sort(ops[state.alive]).values.cpu()
            ctl.update_reg_weight(step, ops_sorted.numpy(), self.n_alive)
            state = self._with(state, ctl)
        weight = ctl.reg_weight if in_phase else 0.0
        prior = step < d.opacity_reg_from + d.opacity_reg_prior_free_steps
        factor = ctl.opacity_update_factor(step, self.n_alive)
        return self.trainer.train_step(
            state, cam, img, H, W, sh_degree, self.ctx.bg, mask=mask,
            image_idx=self.image_idx(name),
            extra_loss=(None if weight == 0.0 else lambda gs: (
                gns_opacity_reg_loss(gs.params, gs.alive, weight, prior))),
            update_scale=(None if factor == 1.0
                          else {"opacities": factor}))

    def densifies_at(self, step: int) -> bool:
        return self.trainer.densifies_at(step)

    def densify(self, state, generator, step):
        d, ctx, trainer = self.d, self.ctx, self.trainer
        dev = state.alive.device
        if d.edge_aware:
            n = len(ctx.outputs.train_set)
            cams, images = _score_views(
                ctx, np.random.RandomState(step).permutation(n)[
                    :min(d.n_sample_cameras, n)], dev)
            importance = edge_weighted_blend_scores(
                trainer.renderer, state.gaussians, cams,
                [get_edges(im) for im in images], ctx.bg,
                trainer.sh_degree_at(step))
        else:
            importance = mean_grads(state.density)
        budget = gns_budget_at(d, step)

        def one_pass(st, imp):
            gstate, opt_state, dstate, n_trunc = gns_densify(
                generator, st.gaussians, st.opt_state, st.density, d, imp,
                budget)
            return dataclasses.replace(
                st, params=gstate.params, alive=gstate.alive,
                opt_state=opt_state, density=dstate,
                extra=gstate.extra), n_trunc

        before = state.gaussians.n_alive
        state = _grown(trainer, state, one_pass, [importance])
        self.n_alive = state.gaussians.n_alive
        self.counts = {"budget": budget, "net": self.n_alive - before}
        return state

    @torch.no_grad()
    def density(self, state, generator, step):
        d = self.d
        ctl = self.controller(state)
        if self.densifies_at(step):
            state = self.densify(state, generator, step)
        if ctl.in_reg_phase(step, self.n_alive):
            near_budget = (step != d.opacity_reg_from
                           and self.n_alive < d.budget * 1.05)
            if near_budget or step == d.opacity_reg_until:
                gstate, opt_state = final_budget_prune(
                    generator, state.gaussians, state.opt_state, d.budget)
                state = dataclasses.replace(state, alive=gstate.alive,
                                            opt_state=opt_state)
                self.n_alive = state.gaussians.n_alive
                ctl.final_pruned, ctl.prune_step = True, step
                state = self._with(state, ctl)
                print(f"[fit] GNS final prune at {step} -> {self.n_alive}")
            elif (step % d.opacity_reg_interval == 0
                  and step >= d.opacity_reg_from + 1000):
                gstate, opt_state, _ = prune_by_opacity(
                    state.gaussians, state.opt_state,
                    d.natural_selection_min_opacity)
                state = dataclasses.replace(state, alive=gstate.alive,
                                            opt_state=opt_state)
                self.n_alive = state.gaussians.n_alive
        return state

    @property
    def density_hook(self) -> "DensityHook":
        return _GNSDensity(self)


class _GNSDensity(DensityHook):
    """GNS's density schedule as the fit's density hook."""

    def __init__(self, gns: GNSHooks):
        self.gns = gns

    def densifies_at(self, step: int) -> bool:
        return self.gns.densifies_at(step)

    def counts_before(self, state) -> dict:
        return {}

    def counts_after(self, counts: dict) -> dict:
        """The round's budget and its net change of the alive count (the
        split's new rows less its opacity prune)."""
        counts.update(self.gns.counts)
        return counts

    def __call__(self, state, generator, step):
        return self.gns.density(state, generator, step)


class LightGaussianPruneHook:
    """LightGaussian's importance pruning at the fit's `lg_prune_steps`:
    the lowest lg_prune_percent * lg_prune_decay^(prunes before) of the
    alive rows by blend weight over `lg_n_cameras` evenly spaced train
    views (the colours the renderer computes, no variant's)."""

    def __init__(self, ctx: FitContext):
        self.ctx = ctx

    def periodic(self, state, generator, step):
        cfg, ctx = self.ctx.cfg, self.ctx
        if step not in cfg.lg_prune_steps:
            return state
        trainer = ctx.trainer
        n_done = sum(1 for s in cfg.lg_prune_steps if s < step)
        pct = cfg.lg_prune_percent * (cfg.lg_prune_decay ** n_done)
        n = len(ctx.outputs.train_set)
        dev = state.alive.device
        cams = [ctx.outputs.train_set.cameras[int(i)].to(dev)
                for i in np.linspace(0, n - 1, min(cfg.lg_n_cameras, n)
                                     ).astype(int)]
        imp = accumulate_blend_weights(
            bias_render(trainer.renderer, trainer.sh_degree_at(step),
                        ctx.bg), state.gaussians, cams)
        gstate, opt_state, n_pruned = prune_by_importance(
            state.gaussians, state.opt_state, imp, pct)
        print(f"[fit] LightGaussian pruned {int(n_pruned)} at {step}")
        return dataclasses.replace(state, alive=gstate.alive,
                                   opt_state=opt_state)


TRAINERS = (Trainer, DepthTrainer, GS2DTrainer, AppearanceTrainer,
            VisibilityMapAppearanceTrainer, GradAccTrainer, GlossyTrainer,
            DeformTrainer)
# the controllers whose schedule is Trainer.maybe_density_ops
VANILLA_FAMILY = (VanillaDensityControllerConfig,
                  RevisingDensityControllerConfig,
                  NoCullingBigScaleDensityControllerConfig,
                  H3DGSDensityControllerConfig,
                  AccurateVisibilityFilterDensityControllerConfig,
                  BackgroundRemovalDensityControllerConfig)


def build_hooks(ctx: FitContext, initial_n_alive: int):
    """Resolve the trainer's component configs into (step_hook,
    density_hook, pre_density_hooks, post_density_hooks).
    `initial_n_alive`: the alive count before any step or resume, where
    Taming's count curve starts."""
    trainer = ctx.trainer
    if type(trainer) not in TRAINERS:
        raise NotImplementedError(
            f"{type(trainer).__name__}: the fit runs "
            f"{', '.join(t.__name__ for t in TRAINERS)}; variant trainers "
            "come with their variants (ROADMAP item 12)")
    density_type = type(trainer.density_cfg)
    gns = None
    if density_type in VANILLA_FAMILY:
        density_hook = DensityHook(ctx)
    elif density_type is StaticDensityControllerConfig:
        density_hook = StaticDensityHook(ctx)
    elif density_type is MCMCDensityControllerConfig:
        density_hook = MCMCDensityHook(ctx)
    elif density_type is Taming3DGSDensityControllerConfig:
        density_hook = TamingDensityHook(ctx, initial_n_alive)
    elif density_type is GNSDensityControllerConfig:
        if type(trainer) not in (Trainer, GS2DTrainer):
            # their steps are not train_step: gsl_tpu's GNS step replaces
            # them and drops what they add
            raise ValueError(
                f"GNS with {type(trainer).__name__}: gsl_tpu's GNS step "
                "would drop the trainer's own step silently")
        gns = GNSHooks(ctx)
        density_hook = gns.density_hook
    else:
        raise NotImplementedError(
            f"{density_type.__name__}: the fit runs the vanilla, static, "
            "Revising, no-culling-big-scale, H3DGS, accurate-visibility, "
            "background-removal, MCMC, Taming and GNS density controllers; "
            "the others come with their variants (ROADMAP item 12)")
    if gns is not None:
        step_hook = gns
    elif isinstance(trainer, GlossyTrainer):
        step_hook = GlossyStepHook(ctx)
    elif isinstance(trainer, DeformTrainer):
        step_hook = DeformStepHook(ctx)
    elif isinstance(trainer, AppearanceTrainer):
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
    if ctx.cfg.lg_prune_steps:
        post_density.append(LightGaussianPruneHook(ctx))
    return step_hook, density_hook, pre_density, post_density
