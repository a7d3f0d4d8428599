"""Training orchestrator.

Port of ``gsl_tpu/training/trainer.py``, as plain functions on an
explicit `TrainState`, whose `extra` carries the non-trainable properties
of a variant (Mip-Splatting's `filter_3d`) and the variants' own states
(``__outproc__``: an output processor's parameters, ``__outproc_opt__``:
their Adam; the appearance trainers' networks) through every step:

- `train_step`: render -> the output processor of the image
  (`image_idx`), if any -> L1 + SSIM loss, the processor's regulariser,
  the plugins' terms and a variant's per-image input (`aux_inputs`, the
  depth trainer's map) -> gradients (through the rasterizer's backward
  kernels, with the means2d tap for the densification statistics) ->
  per-property Adam update, and the processor's own Adam;
- `density_step`: clone / split / prune; `opacity_reset_step`;
- `maybe_density_ops`: both at the reference schedule, growing the
  capacity and redoing a densify that ran out of free slots.

Nothing is compiled ahead: the steps run eagerly, with autograd recording
only the loss. Each step returns a new state and leaves the old one valid.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..data.cameras import Cameras
from ..models.gaussian import (GaussianParams, GaussianState,
                               VanillaGaussianConfig, grow_capacity)
from ..renderers.tile_renderer import (TileRendererConfig,
                                       viewspace_grad_scale)
from ..utils.device import float32_math
from ..utils.tracing import span
from .density import (AccurateVisibilityFilterDensityControllerConfig,
                      DensityControlState, VanillaDensityControllerConfig,
                      densify_and_prune, init_density_state, reset_opacities,
                      update_stats)
from .metrics import VanillaMetricsConfig, psnr, train_loss
from .optimizers import AdamState, GaussianAdam, TensorAdam, grow_opt_state
from .output_processors import apply_processor, init_processor


@dataclasses.dataclass
class TrainState:
    params: GaussianParams
    alive: torch.Tensor
    opt_state: AdamState
    density: DensityControlState
    step: int
    extra: Optional[Dict[str, torch.Tensor]] = None

    @property
    def gaussians(self) -> GaussianState:
        return GaussianState(params=self.params, alive=self.alive,
                             extra=self.extra)


@dataclasses.dataclass
class TrainerConfig:
    max_steps: int = 30_000
    background_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    sh_degree_interval: int = 1000


class Trainer:
    """Composes the model, renderer, density and metrics configs into the
    step functions."""

    # whether this trainer's step applies an output processor (gsl_tpu's
    # other trainers take one and drop it unapplied)
    takes_output_processor = True

    def __init__(
        self,
        model: VanillaGaussianConfig = None,
        renderer: TileRendererConfig = None,
        density: VanillaDensityControllerConfig = None,
        metrics: VanillaMetricsConfig = None,
        config: TrainerConfig = None,
        output_processor=None,
        plugins: tuple = (),
    ):
        if output_processor is not None and not self.takes_output_processor:
            raise ValueError(
                f"{type(self).__name__} with an output processor "
                f"({type(output_processor).__name__}): its step would not "
                "apply it (gsl_tpu drops it silently)")
        self.plugins = tuple(plugins)
        self.model = model or VanillaGaussianConfig()
        self.renderer_cfg = renderer or TileRendererConfig()
        self.renderer = self.renderer_cfg.instantiate()
        self.density_cfg = density or VanillaDensityControllerConfig()
        self.metrics_cfg = metrics or VanillaMetricsConfig()
        self.config = config or TrainerConfig()
        self.output_processor = output_processor
        # the processor's own Adam (optax.adam's eps)
        self.op_tx = (None if output_processor is None
                      else TensorAdam(output_processor.lr, eps=1e-8))
        self.cameras_extent: float = 1.0
        self.prune_extent: float = 1.0
        self.tx: Optional[GaussianAdam] = None

    def size_from_data(self, outputs) -> None:
        """Size what depends on the scene's images before `setup` (the
        appearance trainers' embeddings); this trainer has nothing to
        size."""

    def init_output_processor(self, state: "TrainState",
                              n_images: int) -> "TrainState":
        """The processor's parameters for `n_images` images and their Adam
        state, in ``state.extra``, so they checkpoint and resume with the
        run."""
        cfg = dataclasses.replace(self.output_processor, n_images=n_images)
        self.output_processor = cfg
        params = init_processor(cfg, state.alive.device)
        return dataclasses.replace(state, extra=dict(
            state.extra or {}, __outproc__=params,
            __outproc_opt__=TensorAdam.init({"__outproc__": params})))

    def setup(self, gaussians: GaussianState, cameras_extent: float,
              prune_extent: Optional[float] = None) -> TrainState:
        # the MCMC controller has neither field; gsl_tpu's setup raises
        # AttributeError for it
        factor = getattr(self.density_cfg, "camera_extent_factor", 1.0)
        override = getattr(self.density_cfg, "scene_extent_override", -1.0)
        self.cameras_extent = float(cameras_extent) * factor
        self.prune_extent = float(
            prune_extent if prune_extent is not None else cameras_extent
        ) * factor
        if override > 0:
            self.cameras_extent = override
            self.prune_extent = override
        self.tx = GaussianAdam(self.model.optimization,
                               spatial_lr_scale=self.cameras_extent)
        state = TrainState(
            params=gaussians.params,
            alive=gaussians.alive,
            opt_state=self.tx.init(gaussians.params),
            density=init_density_state(gaussians.capacity,
                                       gaussians.device),
            step=0, extra=gaussians.extra)
        for plugin in self.plugins:
            state = plugin.on_setup(state)
        return state

    def render_losses(self, gstate: GaussianState, camera: Cameras,
                      img_height: int, img_width: int, bg_color, sh_degree,
                      gt_image, mask, tap, abstap, step: int,
                      aux_inputs=None, op_params=None, image_idx=None):
        """-> (loss, (scalars, radii, n_dropped)). `step`: the steps taken
        before this one, for losses that start at an iteration;
        `aux_inputs`: a variant trainer's per-image input (this trainer
        takes none); `op_params`: the output processor's parameters, of
        which image `image_idx`'s process the render."""
        render_types = frozenset({"rgb"}).union(
            *[p.required_render_types for p in self.plugins])
        out = self.renderer.forward(
            gstate, camera, img_height, img_width, bg_color, sh_degree,
            render_types=render_types, means2d_tap=tap, absgrad_tap=abstap)
        render, op_reg = out.render, 0.0
        if op_params is not None:
            render, op_reg = apply_processor(self.output_processor,
                                             op_params, image_idx, render)
        with span("train.loss"):
            loss, scalars = train_loss(
                render, gt_image, mask,
                lambda_dssim=self.metrics_cfg.lambda_dssim,
                rgb_diff_loss=self.metrics_cfg.rgb_diff_loss)
        loss = loss + op_reg
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
        for plugin in self.plugins:
            term, sc = plugin.extra_loss(out, gt_image, mask, gstate, step,
                                         camera=camera)
            loss = loss + term
            scalars = dict(scalars, **sc)
        return loss, (scalars, out.radii, out.n_dropped)

    def gradients(self, state: TrainState, loss_of, others=(),
                  use_absgrad: bool = False):
        """Differentiate ``loss_of(gstate, tap, abstap) -> (loss, aux)``
        with respect to the Gaussian parameters, the statistic's tap (the
        means2d tap, or with `use_absgrad` the AbsGS tap) and the leaf
        tensors `others` that `loss_of` reads. A tensor the loss does not
        reach gets a zero gradient, as jax.grad gives it. Returns (the
        parameters' gradients, the tap's, [the others'], loss, aux)."""
        dev = state.alive.device
        leaves = state.params.map(
            lambda _, x: x.detach().requires_grad_(True))
        tap = torch.zeros((state.params.capacity, 2), dtype=torch.float32,
                          device=dev, requires_grad=True)
        abstap = torch.zeros_like(tap, requires_grad=True) \
            if use_absgrad else None
        # full float32 for the projection's matrix product, the SSIM
        # convolutions and their gradients
        with float32_math():
            with span("train.forward"):
                loss, aux = loss_of(GaussianState(params=leaves,
                                                  alive=state.alive,
                                                  extra=state.extra),
                                    tap, abstap)
            fields = leaves.fields()
            wrt = ([getattr(leaves, k) for k in fields]
                   + [abstap if use_absgrad else tap] + list(others))
            with span("train.backward"):
                grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for g, w in zip(grads, wrt)]
        n = len(fields)
        return (GaussianParams(**dict(zip(fields, grads[:n]))), grads[n],
                grads[n + 1:], loss, aux)

    @torch.no_grad()
    def density_stats(self, state: TrainState, stat_grad, radii,
                      img_width: int, img_height: int):
        """The density statistics after a step whose tap gradient is
        `stat_grad`."""
        with span("train.density_stats"):
            # a host list uploaded: the copy waits on the stream
            with span("wait.grad_scale"):
                gscale = viewspace_grad_scale(
                    img_width, img_height,
                    self.renderer_cfg.max_viewspace_grad_scale,
                    state.alive.device)
            return update_stats(
                state.density, stat_grad, radii, gscale,
                accurate_visibility=isinstance(
                    self.density_cfg,
                    AccurateVisibilityFilterDensityControllerConfig))

    @torch.no_grad()
    def adam_step(self, state: TrainState, pgrads: GaussianParams,
                  update_scale: Optional[Dict[str, float]] = None):
        """-> (parameters, Adam state) after one step with `pgrads`;
        `update_scale` multiplies the named properties' updates after Adam
        (its moments stay as Adam left them)."""
        with span("train.adam"):
            updates, opt_state = self.tx.update(pgrads, state.opt_state)
            scale = update_scale or {}

            def step(k, x):
                u = getattr(updates, k)
                return x + (u * scale[k] if k in scale else u)

            return state.params.map(step), opt_state

    def apply_gradients(self, state: TrainState, pgrads: GaussianParams,
                        stat_grad, radii, img_width: int, img_height: int,
                        update_scale: Optional[Dict[str, float]] = None):
        """-> (parameters, Adam state, density statistics) after one
        step."""
        density = self.density_stats(state, stat_grad, radii, img_width,
                                     img_height)
        return (*self.adam_step(state, pgrads, update_scale), density)

    def train_step(self, state: TrainState, camera: Cameras,
                   gt_image: torch.Tensor, img_height: int, img_width: int,
                   sh_degree: int, bg_color: torch.Tensor,
                   mask: Optional[torch.Tensor] = None, aux_inputs=None,
                   image_idx=None, extra_loss=None,
                   update_scale: Optional[Dict[str, float]] = None):
        """One optimization step on one view. Returns (new state, scalars);
        the scalars are 0-d tensors on the state's device, so the step
        itself never waits for the device beyond the rasterizer's one
        read that sizes its slot buffers. `aux_inputs` goes to
        `render_losses`; `image_idx` (the view's index in the train set)
        picks the output processor's parameters when the state has
        them. A density controller's own terms (GNS's): `extra_loss`
        (gstate -> 0-d tensor) joins the loss, and `update_scale` scales
        properties' Adam updates (see `adam_step`)."""
        with span("train.step"):
            use_absgrad = (getattr(self.density_cfg, "absgrad", False)
                           and self.renderer.supports_absgrad())
            has_op = (self.output_processor is not None
                      and state.extra is not None
                      and "__outproc__" in state.extra)
            others, op_kwargs = [], {}
            if has_op:
                others = [state.extra["__outproc__"].detach().requires_grad_(
                    True)]
                op_kwargs = dict(
                    op_params=others[0],
                    image_idx=0 if image_idx is None else image_idx)

            def loss_of(gstate, tap, abstap):
                loss, aux = self.render_losses(
                    gstate, camera, img_height, img_width, bg_color, sh_degree,
                    gt_image, mask, tap, abstap, state.step,
                    aux_inputs=aux_inputs, **op_kwargs)
                if extra_loss is not None:
                    loss = loss + extra_loss(gstate)
                return loss, aux

            pgrads, stat_grad, op_grads, _, (scalars, radii, n_dropped) = \
                self.gradients(state, loss_of, others, use_absgrad)
            params, opt_state, density = self.apply_gradients(
                state, pgrads, stat_grad, radii, img_width, img_height,
                update_scale)
            extra = state.extra
            if has_op:
                with torch.no_grad():
                    new, op_opt = self.op_tx.update(
                        {"__outproc__": state.extra["__outproc__"]},
                        {"__outproc__": op_grads[0]},
                        state.extra["__outproc_opt__"])
                extra = dict(state.extra, __outproc__=new["__outproc__"],
                             __outproc_opt__=op_opt)
            scalars = {k: v.detach() for k, v in scalars.items()}
            scalars["n_dropped_isects"] = n_dropped
            return TrainState(params=params, alive=state.alive,
                              opt_state=opt_state, density=density,
                              step=state.step + 1, extra=extra), scalars

    @torch.no_grad()
    def density_step(self, state: TrainState, noise, use_size_prune):
        """-> (new state, n_truncated). `noise`: see `densify_and_prune`."""
        gstate, opt_state, density, n_trunc = densify_and_prune(
            noise, state.gaussians, state.opt_state, state.density,
            self.density_cfg, self.cameras_extent, self.prune_extent,
            use_size_prune)
        return TrainState(
            params=gstate.params, alive=gstate.alive, opt_state=opt_state,
            density=density, step=state.step, extra=gstate.extra), n_trunc

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
        """Grow the capacity, carrying the Adam moments, the schedule count,
        the density statistics and the per-Gaussian extras of the existing
        rows; the variants' own states in `extra` stay as they are."""
        n_new = new_capacity - state.params.capacity
        gstate = grow_capacity(state.gaussians, new_capacity)

        def pad(x):
            return torch.cat([x, torch.zeros(n_new, dtype=x.dtype,
                                             device=x.device)])

        d = state.density
        return TrainState(
            params=gstate.params, alive=gstate.alive,
            opt_state=grow_opt_state(state.opt_state, new_capacity),
            density=DensityControlState(
                grad_accum=pad(d.grad_accum), denom=pad(d.denom),
                max_radii=pad(d.max_radii)),
            step=state.step, extra=gstate.extra)

    def maybe_density_ops(self, state: TrainState, noise, step: int
                          ) -> TrainState:
        """Densify / prune and reset opacities at the reference schedule.
        `step` is the 1-based global step. `noise` is a generator: a redo
        after a capacity growth draws again for the larger state."""
        cfg = self.density_cfg
        if step < cfg.densify_until_iter:
            if self.densifies_at(step):
                with span("train.density"):
                    use_size_prune = step > cfg.opacity_reset_interval
                    prev = state
                    state, n_trunc = self.density_step(state, noise,
                                                       use_size_prune)
                    tries = 0
                    while int(n_trunc) > 0 and tries < 3:
                        # out of free slots: grow 2x from the snapshot
                        # before the densify and redo the pass, so this
                        # round's children are not dropped
                        prev = self.grow_state(prev,
                                               2 * prev.params.capacity)
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
                with span("train.density"):
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
