"""Dynamic-scene trainer: a deformation field over a canonical Gaussian
set.

Port of ``gsl_tpu/training/deform_trainer.py``. Two field backends behind
one trainer:

- ``"mlp"``: the Deformable-3DGS MLP D(PE(xyz), PE(t)) of
  `DeformModelConfig`, with annealed smooth temporal noise on the
  camera's time after the warm-up (`models/deform.py`);
- ``"hexplane"``: the 4DGS HexPlane field at its defaults (resolutions 32
  and 64, 16 features, 64 neurons; `models/hexplane.py`), whatever the
  deform config's widths say, as gsl_tpu builds it.

In a step the field moves the alive rows' raw means, rotations and
scales at the camera's time before the render, so the step runs K1-K4 as
the plain one does. The network's input is the canonical means detached:
gradients reach the network's weights and the Gaussians. In the warm-up
the Gaussians train undeformed and the network stays as it is. The
network's weights and its Adam (optax.adam's eps, the rate decayed from
`lr_init` to `lr_init * lr_final_factor` over `max_steps` of its own
updates) ride in ``TrainState.extra["__deform__"]`` = {"params", "opt"},
which no row edit touches, and checkpoint with the run. The density
statistics come from the deformed means' tap.

The step is gsl_tpu's: the L1 + SSIM loss alone. Where gsl_tpu's step
would drop a component silently (an output processor, plugins'
terms, appearance features, the depth or 2DGS losses, MCMC's opacity and
scale regularisers, the AbsGS or accurate-visibility statistic), the
trainer raises ``ValueError`` naming both.

Validation renders the canonical set: the trainer has no `eval_step` of
its own, and `Trainer.eval_step` renders the Gaussians undeformed at
every time, as gsl_tpu's does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..data.cameras import Cameras
from ..models.appearance import AppearanceFeatureGaussianConfig
from ..models.deform import (DeformModelConfig, DeformNetwork, ast_noise,
                             deform_gaussians)
from ..models.gaussian import GaussianState
from ..models.hexplane import HexPlaneDeformation
from .appearance_trainer import leaves_of, network_state, step_network
from .density import AccurateVisibilityFilterDensityControllerConfig
from .depth_trainer import DepthMetricsConfig
from .gs2d import GS2DMetricsConfig
from .metrics import train_loss
from .optimizers import TensorAdam
from .schedulers import exponential_decay
from .trainer import Trainer, TrainState

OPTAX_EPS = 1e-8          # optax.adam's, which gsl_tpu's field Adam takes
FIELDS = ("mlp", "hexplane")


class DeformTrainer(Trainer):
    # gsl_tpu's deform step never applies an output processor
    takes_output_processor = False

    def __init__(self, *args, field: str = "mlp",
                 deform_cfg: DeformModelConfig = None, **kwargs):
        super().__init__(*args, **kwargs)
        if field not in FIELDS:
            raise ValueError(f"deform field {field!r}: one of {FIELDS}")
        self.field = field
        self.deform_cfg = deform_cfg or DeformModelConfig()
        for part, dropped in self._dropped_parts():
            if dropped:
                raise ValueError(
                    f"deform ({field}) with {part}: gsl_tpu's deform step "
                    "would drop it silently")
        gen = torch.Generator().manual_seed(2)
        # the module keeps its initial weights on the CPU; the state holds
        # the weights that train
        self.deform_net = (HexPlaneDeformation(generator=gen)
                           if field == "hexplane"
                           else DeformNetwork(self.deform_cfg, gen))
        d = self.deform_cfg
        schedule = exponential_decay(d.lr_init, d.lr_init * d.lr_final_factor,
                                     d.max_steps)
        self.deform_tx = TensorAdam(lambda _, n: schedule(n), eps=OPTAX_EPS)

    def _dropped_parts(self):
        m = self.metrics_cfg
        return (
            ("plugins", bool(self.plugins)),
            (f"appearance ({type(self.model).__name__})",
             isinstance(self.model, AppearanceFeatureGaussianConfig)),
            (f"metrics {type(m).__name__}",
             isinstance(m, (DepthMetricsConfig, GS2DMetricsConfig))),
            ("the MCMC opacity or scale regulariser",
             getattr(m, "opacity_reg", 0.0) > 0.0
             or getattr(m, "scale_reg", 0.0) > 0.0),
            ("absgrad (the AbsGS statistic)",
             bool(getattr(self.density_cfg, "absgrad", False))),
            ("the accurate-visibility statistic",
             isinstance(self.density_cfg,
                        AccurateVisibilityFilterDensityControllerConfig)))

    def setup(self, gaussians: GaussianState, cameras_extent: float,
              prune_extent: Optional[float] = None) -> TrainState:
        state = super().setup(gaussians, cameras_extent, prune_extent)
        return dataclasses.replace(state, extra=dict(
            state.extra or {}, __deform__=network_state(
                self.deform_net, self.deform_tx, gaussians.device)))

    def deform(self, net_params, gstate: GaussianState, t) -> GaussianState:
        """`gstate` with the field's output at time t added to the alive
        rows' raw means, rotations and scales."""
        means, rotations, scales = deform_gaussians(self.deform_net,
                                                    net_params, gstate, t)
        return dataclasses.replace(gstate, params=dataclasses.replace(
            gstate.params, means=means, rotations=rotations, scales=scales))

    def step_time(self, state: TrainState, camera: Cameras, warm_up: bool,
                  generator: Optional[torch.Generator] = None,
                  ast_draw: Optional[torch.Tensor] = None):
        """The time the field sees: the camera's, with AST noise for the
        MLP field after the warm-up (a standard normal from `generator`,
        or `ast_draw` where given)."""
        t = camera.time
        if warm_up or self.field != "mlp":
            return t
        if ast_draw is None:
            ast_draw = torch.randn((), generator=generator, device=t.device)
        d = self.deform_cfg
        return ast_noise(ast_draw, t, state.step, d.max_steps,
                         d.ast_noise_scale)

    def train_step_deform(self, state: TrainState, camera: Cameras,
                          gt_image: torch.Tensor, img_height: int,
                          img_width: int, sh_degree: int,
                          bg_color: torch.Tensor, warm_up: bool,
                          generator: Optional[torch.Generator] = None,
                          mask: Optional[torch.Tensor] = None,
                          ast_draw: Optional[torch.Tensor] = None):
        """One step of the Gaussians and, after the warm-up, the field.
        Returns (new state, scalars)."""
        net = state.extra["__deform__"]
        net_leaves = leaves_of(net, not warm_up)
        t = self.step_time(state, camera, warm_up, generator, ast_draw)

        def loss_of(gstate, tap, abstap):
            if not warm_up:
                gstate = self.deform(net_leaves, gstate, t)
            out = self.renderer.forward(
                gstate, camera, img_height, img_width, bg_color, sh_degree,
                means2d_tap=tap)
            loss, scalars = train_loss(
                out.render, gt_image, mask,
                lambda_dssim=self.metrics_cfg.lambda_dssim,
                rgb_diff_loss=self.metrics_cfg.rgb_diff_loss)
            return loss, (scalars, out.radii, out.n_dropped)

        pgrads, tap_grad, ngrads, _, (scalars, radii, n_dropped) = \
            self.gradients(state, loss_of,
                           [] if warm_up else list(net_leaves.values()))
        params, opt_state, density = self.apply_gradients(
            state, pgrads, tap_grad, radii, img_width, img_height)
        extra = dict(state.extra)
        if not warm_up:
            extra["__deform__"] = step_network(self.deform_tx, net, ngrads)
        scalars = {k: v.detach() for k, v in scalars.items()}
        scalars["n_dropped_isects"] = n_dropped
        return TrainState(params=params, alive=state.alive,
                          opt_state=opt_state, density=density,
                          step=state.step + 1, extra=extra), scalars
