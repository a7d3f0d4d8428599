"""Glossy Gaussians: a learned environment light and per-Gaussian
metalness.

Port of ``gsl_tpu/training/glossy_trainer.py``: SH albedo plus a specular
term, the metalness-weighted latlong environment map at each Gaussian's
reflection direction (`models/glossy.py`), handed to the renderer as
`rgbs_override`, so the step runs K1-K4 as the plain one does. The map
is looked up for the alive rows only: the dead rows sit together on one
texel, whose gradient the lookup's backward would sum row by row. The map
(Adam 1e-2, clipped at >= 0 after each step) and its Adam state ride in
``TrainState.extra["__glossy__"]`` = {"envmap", "opt"}, which no row edit
touches. The metalness is a Gaussian property
(`GaussianParams.metalness`, logit-space, -3 at setup, Adam 5e-3 with
optax's eps 1e-8), so it follows densify, prune and growth row by row;
new rows' moments start at zero. (gsl_tpu keeps it in `extra`, whose row
rule copies the source row's moments too.)

Validation renders the SH colours without the specular term, as
gsl_tpu's `eval_step` does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..data.cameras import Cameras
from ..models.gaussian import GaussianState
from ..models.glossy import EnvLightConfig, glossy_rgbs, init_envmap
from .metrics import train_loss
from .optimizers import TensorAdam
from .trainer import Trainer, TrainState

OPTAX_EPS = 1e-8          # optax.adam's, which gsl_tpu's glossy Adam takes


class GlossyTrainer(Trainer):
    # gsl_tpu's glossy step never applies an output processor
    takes_output_processor = False

    def __init__(self, *args, envlight: EnvLightConfig = None,
                 env_lr: float = 1e-2, metalness_lr: float = 5e-3,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.envlight = envlight or EnvLightConfig()
        self.metalness_lr = metalness_lr
        self.env_tx = TensorAdam(env_lr, eps=OPTAX_EPS)

    def setup(self, gaussians: GaussianState, cameras_extent: float,
              prune_extent: Optional[float] = None) -> TrainState:
        params = dataclasses.replace(
            gaussians.params, metalness=torch.full(
                (gaussians.capacity,), -3.0, dtype=torch.float32,
                device=gaussians.device))
        state = super().setup(dataclasses.replace(gaussians, params=params),
                              cameras_extent, prune_extent)
        self.tx.learning_rates["metalness"] = self.metalness_lr
        self.tx.eps_of["metalness"] = OPTAX_EPS
        envmap = init_envmap(self.envlight, gaussians.device)
        return dataclasses.replace(state, extra=dict(
            state.extra or {}, __glossy__={
                "envmap": envmap, "opt": TensorAdam.init({"envmap": envmap})}))

    def glossy_colours(self, gstate: GaussianState, camera: Cameras,
                       sh_degree: int, envmap: torch.Tensor):
        """-> (colours [N, 3], activated metalness [N]). The map is looked
        up for the alive rows only (the dead rows' metalness is 0)."""
        base = self.renderer.get_rgbs(gstate, camera, sh_degree)
        metal = torch.sigmoid(gstate.params.metalness)
        return glossy_rgbs(base, metal * gstate.alive, envmap,
                           gstate.get_means(), gstate.params.scales,
                           gstate.params.rotations, camera.camera_center,
                           rows=torch.nonzero(gstate.alive).flatten()), metal

    def train_step_glossy(self, state: TrainState, camera: Cameras,
                          gt_image: torch.Tensor, img_height: int,
                          img_width: int, sh_degree: int,
                          bg_color: torch.Tensor,
                          mask: Optional[torch.Tensor] = None):
        """One step of the Gaussians (metalness included) and the map.
        Returns (new state, scalars), with the mean metalness among
        them."""
        env = state.extra["__glossy__"]
        env_leaf = env["envmap"].detach().requires_grad_(True)

        def loss_of(gstate, tap, abstap):
            rgbs, metal = self.glossy_colours(gstate, camera, sh_degree,
                                              env_leaf)
            out = self.renderer.forward(
                gstate, camera, img_height, img_width, bg_color, sh_degree,
                means2d_tap=tap, rgbs_override=rgbs)
            loss, scalars = train_loss(
                out.render, gt_image, mask,
                lambda_dssim=self.metrics_cfg.lambda_dssim,
                rgb_diff_loss=self.metrics_cfg.rgb_diff_loss)
            scalars = dict(scalars, metal_mean=torch.mean(metal))
            return loss, (scalars, out.radii, out.n_dropped)

        pgrads, tap_grad, (env_grad,), _, (scalars, radii, n_dropped) = \
            self.gradients(state, loss_of, [env_leaf])
        params, opt_state, density = self.apply_gradients(
            state, pgrads, tap_grad, radii, img_width, img_height)
        with torch.no_grad():
            new, env_opt = self.env_tx.update(
                {"envmap": env["envmap"]}, {"envmap": env_grad}, env["opt"])
        extra = dict(state.extra, __glossy__={
            "envmap": torch.clamp(new["envmap"], min=0.0), "opt": env_opt})
        scalars = {k: v.detach() for k, v in scalars.items()}
        scalars["n_dropped_isects"] = n_dropped
        return TrainState(params=params, alive=state.alive,
                          opt_state=opt_state, density=density,
                          step=state.step + 1, extra=extra), scalars
