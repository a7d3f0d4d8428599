"""Training orchestrator.

Port of ``gsl_tpu/training/trainer.py`` (the vanilla trainer; plugins and
output processors come with their variants), as plain functions on an
explicit `TrainState`:

- `train_step`: render -> L1 + SSIM loss -> gradients (through the
  rasterizer's backward kernels, with the means2d tap for the
  densification statistics) -> per-property Adam update;
- `density_step`: clone / split / prune; `opacity_reset_step`;
- `maybe_density_ops`: both at the reference schedule, growing the
  capacity and redoing a densify that ran out of free slots.

Nothing is compiled ahead: the steps run eagerly, with autograd recording
only the loss. Each step returns a new state and leaves the old one valid.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..data.cameras import Cameras
from ..models.gaussian import (PARAM_FIELDS, GaussianParams, GaussianState,
                               VanillaGaussianConfig, grow_capacity)
from ..renderers.tile_renderer import (TileRendererConfig,
                                       viewspace_grad_scale)
from ..utils.device import float32_math
from .density import (DensityControlState, VanillaDensityControllerConfig,
                      densify_and_prune, init_density_state, reset_opacities,
                      update_stats)
from .metrics import VanillaMetricsConfig, psnr, train_loss
from .optimizers import AdamState, GaussianAdam, grow_opt_state


@dataclasses.dataclass
class TrainState:
    params: GaussianParams
    alive: torch.Tensor
    opt_state: AdamState
    density: DensityControlState
    step: int

    @property
    def gaussians(self) -> GaussianState:
        return GaussianState(params=self.params, alive=self.alive)


@dataclasses.dataclass
class TrainerConfig:
    max_steps: int = 30_000
    background_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    sh_degree_interval: int = 1000


class Trainer:
    """Composes the model, renderer, density and metrics configs into the
    step functions."""

    def __init__(
        self,
        model: VanillaGaussianConfig = None,
        renderer: TileRendererConfig = None,
        density: VanillaDensityControllerConfig = None,
        metrics: VanillaMetricsConfig = None,
        config: TrainerConfig = None,
    ):
        self.model = model or VanillaGaussianConfig()
        self.renderer_cfg = renderer or TileRendererConfig()
        self.renderer = self.renderer_cfg.instantiate()
        self.density_cfg = density or VanillaDensityControllerConfig()
        self.metrics_cfg = metrics or VanillaMetricsConfig()
        self.config = config or TrainerConfig()
        self.cameras_extent: float = 1.0
        self.prune_extent: float = 1.0
        self.tx: Optional[GaussianAdam] = None

    def setup(self, gaussians: GaussianState, cameras_extent: float,
              prune_extent: Optional[float] = None) -> TrainState:
        factor = self.density_cfg.camera_extent_factor
        self.cameras_extent = float(cameras_extent) * factor
        self.prune_extent = float(
            prune_extent if prune_extent is not None else cameras_extent
        ) * factor
        if self.density_cfg.scene_extent_override > 0:
            self.cameras_extent = self.density_cfg.scene_extent_override
            self.prune_extent = self.density_cfg.scene_extent_override
        self.tx = GaussianAdam(self.model.optimization,
                               spatial_lr_scale=self.cameras_extent)
        return TrainState(
            params=gaussians.params,
            alive=gaussians.alive,
            opt_state=self.tx.init(gaussians.params),
            density=init_density_state(gaussians.capacity,
                                       gaussians.device),
            step=0)

    def render_losses(self, gstate: GaussianState, camera: Cameras,
                      img_height: int, img_width: int, bg_color, sh_degree,
                      gt_image, mask, tap, abstap, step: int):
        """-> (loss, (scalars, radii, n_dropped)). `step`: the steps taken
        before this one, for losses that start at an iteration."""
        out = self.renderer.forward(
            gstate, camera, img_height, img_width, bg_color, sh_degree,
            means2d_tap=tap, absgrad_tap=abstap)
        loss, scalars = train_loss(
            out.render, gt_image, mask,
            lambda_dssim=self.metrics_cfg.lambda_dssim,
            rgb_diff_loss=self.metrics_cfg.rgb_diff_loss)
        # MCMC opacity / scale L1 regularizers
        m = self.metrics_cfg
        if m.opacity_reg > 0.0 or m.scale_reg > 0.0:
            alive = gstate.alive.to(torch.float32)
            n_alive = torch.clamp(alive.sum(), min=1.0)
            if m.opacity_reg > 0.0:
                loss = loss + m.opacity_reg * torch.sum(
                    torch.sigmoid(gstate.params.opacities[:, 0])
                    * alive) / n_alive
            if m.scale_reg > 0.0:
                loss = loss + m.scale_reg * torch.sum(
                    torch.exp(gstate.params.scales)
                    * alive[:, None]) / (3.0 * n_alive)
        return loss, (scalars, out.radii, out.n_dropped)

    def train_step(self, state: TrainState, camera: Cameras,
                   gt_image: torch.Tensor, img_height: int, img_width: int,
                   sh_degree: int, bg_color: torch.Tensor,
                   mask: Optional[torch.Tensor] = None):
        """One optimization step on one view. Returns (new state, scalars);
        the scalars are 0-d tensors on the state's device, so the step
        itself never waits for the device beyond the rasterizer's one
        read that sizes its slot buffers."""
        dev = state.alive.device
        use_absgrad = (self.density_cfg.absgrad
                       and self.renderer.supports_absgrad())
        leaves = state.params.map(
            lambda _, x: x.detach().requires_grad_(True))
        tap = torch.zeros((state.params.capacity, 2), dtype=torch.float32,
                          device=dev, requires_grad=True)
        abstap = torch.zeros_like(tap, requires_grad=True) \
            if use_absgrad else None
        # full float32 for the projection's matrix product, the SSIM
        # convolutions and their gradients
        with float32_math():
            loss, (scalars, radii, n_dropped) = self.render_losses(
                GaussianState(params=leaves, alive=state.alive), camera,
                img_height, img_width, bg_color, sh_degree, gt_image, mask,
                tap, abstap, state.step)
            wrt = [getattr(leaves, k) for k in PARAM_FIELDS] + [tap]
            if use_absgrad:
                wrt.append(abstap)
            grads = torch.autograd.grad(loss, wrt)
        with torch.no_grad():
            pgrads = GaussianParams(**dict(zip(PARAM_FIELDS, grads)))
            stat_grad = grads[-1]   # the abs tap when configured
            gscale = viewspace_grad_scale(
                img_width, img_height,
                self.renderer_cfg.max_viewspace_grad_scale, dev)
            density = update_stats(state.density, stat_grad, radii, gscale)
            updates, opt_state = self.tx.update(pgrads, state.opt_state)
            params = state.params.map(
                lambda k, x: x + getattr(updates, k))
        scalars = {k: v.detach() for k, v in scalars.items()}
        scalars["n_dropped_isects"] = n_dropped
        return TrainState(params=params, alive=state.alive,
                          opt_state=opt_state, density=density,
                          step=state.step + 1), scalars

    @torch.no_grad()
    def density_step(self, state: TrainState, noise, use_size_prune):
        """-> (new state, n_truncated). `noise`: see `densify_and_prune`."""
        gstate, opt_state, density, n_trunc = densify_and_prune(
            noise, state.gaussians, state.opt_state, state.density,
            self.density_cfg, self.cameras_extent, self.prune_extent,
            use_size_prune)
        return TrainState(
            params=gstate.params, alive=gstate.alive, opt_state=opt_state,
            density=density, step=state.step), n_trunc

    @torch.no_grad()
    def opacity_reset_step(self, state: TrainState) -> TrainState:
        gstate, opt_state = reset_opacities(
            state.gaussians, state.opt_state,
            self.density_cfg.opacity_reset_value)
        return dataclasses.replace(state, params=gstate.params,
                                   opt_state=opt_state)

    @torch.no_grad()
    def eval_step(self, state: TrainState, camera: Cameras,
                  gt_image: torch.Tensor, img_height: int, img_width: int,
                  sh_degree: int, bg_color: torch.Tensor):
        with float32_math():
            out = self.renderer.forward(
                state.gaussians, camera, img_height, img_width, bg_color,
                sh_degree)
        return out.render, {"psnr": psnr(out.render, gt_image)}

    @torch.no_grad()
    def grow_state(self, state: TrainState, new_capacity: int) -> TrainState:
        """Grow the capacity, carrying the Adam moments, the schedule count
        and the density statistics of the existing rows."""
        extra = new_capacity - state.params.capacity
        gstate = grow_capacity(state.gaussians, new_capacity)

        def pad(x):
            return torch.cat([x, torch.zeros(extra, dtype=x.dtype,
                                             device=x.device)])

        d = state.density
        return TrainState(
            params=gstate.params, alive=gstate.alive,
            opt_state=grow_opt_state(state.opt_state, new_capacity),
            density=DensityControlState(
                grad_accum=pad(d.grad_accum), denom=pad(d.denom),
                max_radii=pad(d.max_radii)),
            step=state.step)

    def maybe_density_ops(self, state: TrainState, noise, step: int
                          ) -> TrainState:
        """Densify / prune and reset opacities at the reference schedule.
        `step` is the 1-based global step. `noise` is a generator: a redo
        after a capacity growth draws again for the larger state."""
        cfg = self.density_cfg
        if step < cfg.densify_until_iter:
            if self.densifies_at(step):
                use_size_prune = step > cfg.opacity_reset_interval
                prev = state
                state, n_trunc = self.density_step(state, noise,
                                                   use_size_prune)
                tries = 0
                while int(n_trunc) > 0 and tries < 3:
                    # out of free slots: grow 2x from the snapshot before
                    # the densify and redo the pass, so this round's
                    # children are not dropped
                    prev = self.grow_state(prev, 2 * prev.params.capacity)
                    state, n_trunc = self.density_step(prev, noise,
                                                       use_size_prune)
                    tries += 1
                if int(n_trunc) > 0:  # pathological single round
                    print(f"[trainer] densify at step {step} still "
                          f"truncating {int(n_trunc)} after {tries} "
                          f"capacity growths")
            white_bg = all(c == 1.0 for c in self.config.background_color)
            if (step % cfg.opacity_reset_interval == 0
                    or (white_bg and step == cfg.densify_from_iter)):
                state = self.opacity_reset_step(state)
        return state

    def densifies_at(self, step: int) -> bool:
        """Whether `maybe_density_ops` densifies at the 1-based `step`."""
        cfg = self.density_cfg
        return (cfg.densify_from_iter < step < cfg.densify_until_iter
                and step % cfg.densification_interval == 0)

    def sh_degree_at(self, step: int) -> int:
        return min(step // self.config.sh_degree_interval,
                   self.model.sh_degree)
