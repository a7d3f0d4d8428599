"""Appearance-embedding training: a Trainer that carries the embedding and
MLP network alongside the Gaussians.

Port of ``gsl_tpu/training/appearance_trainer.py``:
- during the warm-up (the first 4000 steps) the colours are the plain SH
  colours and the network stays as it is;
- after it, rgb = clamp(SH + 0.5 + (net(features, embedding, dir) * 2 - 1),
  0, 1), handed to the renderer as `rgbs_override`;
- with the opacity head (SWAG), opacity = min(op + offset, 1) through
  `opacity_offset`, and the loss gains 0.05 * mean(offset);
- the network has two Adams of eps 1e-15 (the embedding at 2e-3, the
  layers at 1e-3), each decayed from `warm_up` updates after the first
  one: the schedule reads the network's own update count, which does not
  advance in the warm-up.

The network's weights and Adam state ride in ``TrainState.extra["__net__"]``
= {"params": {name: tensor}, "opt": TensorAdam state}, which no row edit
touches, and checkpoint with the run. The colours reach the rasterizer's
kernels as their channels and the offset through the opacities, so the
step runs K1-K4 as the plain one does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.func import functional_call

from ..data.cameras import Cameras
from ..models.appearance import AppearanceNetwork, network_lr_schedule
from ..models.gaussian import GaussianState
from ..ops.sh import sh_to_rgb
from .metrics import train_loss
from .optimizers import TensorAdam
from .trainer import Trainer, TrainState


@dataclasses.dataclass
class AppearanceOptimizationConfig:
    embedding_lr_init: float = 2e-3
    lr_init: float = 1e-3
    lr_final_factor: float = 0.1
    eps: float = 1e-15
    max_steps: int = 30_000
    warm_up: int = 4000


def n_appearances_of(outputs) -> int:
    """The largest appearance id of the parser's cameras, plus one."""
    return max(int(s.cameras.appearance_id.max()) + 1
               for s in (outputs.train_set, outputs.val_set,
                         outputs.test_set) if len(s) > 0)


def network_state(net: torch.nn.Module, tx: TensorAdam, device) -> dict:
    """A network's weights on `device` and a fresh Adam state for them."""
    params = {k: v.detach().to(device, copy=True)
              for k, v in net.named_parameters()}
    return {"params": params, "opt": tx.init(params)}


def step_network(tx: TensorAdam, state: dict, grads) -> dict:
    """`state` after one Adam step with `grads` (in its params' order)."""
    with torch.no_grad():
        params, opt = tx.update(state["params"],
                                dict(zip(state["params"], grads)),
                                state["opt"])
    return {"params": params, "opt": opt}


def leaves_of(state: dict, trained: bool) -> dict:
    """A network's weights as fresh leaves, requiring grad if `trained`."""
    return {k: v.detach().requires_grad_(trained)
            for k, v in state["params"].items()}


class AppearanceTrainer(Trainer):
    """Trainer with a per-image appearance network. `n_appearances` None
    sizes the embedding from the data (`size_from_data`: the largest
    appearance id + 1), where gsl_tpu's network cannot be built without a
    count. `appearance_opt` is read at `setup`."""

    # gsl_tpu's appearance step never applies an output processor
    takes_output_processor = False

    def __init__(self, *args, n_appearances: Optional[int] = None,
                 with_opacity: bool = False, is_view_dependent: bool = False,
                 appearance_opt: AppearanceOptimizationConfig = None,
                 similarity_reg=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.n_appearances = n_appearances
        self.with_opacity = with_opacity
        self.is_view_dependent = is_view_dependent
        self.appearance_opt = appearance_opt or AppearanceOptimizationConfig()
        self.similarity_reg = similarity_reg
        self.net: Optional[AppearanceNetwork] = None
        self.net_tx: Optional[TensorAdam] = None

    def size_from_data(self, outputs) -> None:
        if self.n_appearances is None:
            self.n_appearances = n_appearances_of(outputs)

    def setup(self, gaussians: GaussianState, cameras_extent: float,
              prune_extent: Optional[float] = None) -> TrainState:
        feats = gaussians.params.appearance_features
        if feats is None:
            raise ValueError(
                "AppearanceTrainer needs Gaussians with appearance "
                "features (AppearanceFeatureGaussianConfig)")
        if self.n_appearances is None:
            raise ValueError(
                "AppearanceTrainer: n_appearances is not set; pass it, or "
                "call size_from_data(outputs) before setup")
        state = super().setup(gaussians, cameras_extent, prune_extent)
        o = self.appearance_opt
        embedding_lr = network_lr_schedule(
            o.embedding_lr_init, o.lr_final_factor, o.max_steps, o.warm_up)
        layer_lr = network_lr_schedule(o.lr_init, o.lr_final_factor,
                                       o.max_steps, o.warm_up)
        self.net_tx = TensorAdam(
            lambda name, n: (embedding_lr if name.startswith("embedding.")
                             else layer_lr)(n), eps=o.eps)
        # the module keeps its initial weights on the CPU; the state
        # holds the weights that train
        self.net = AppearanceNetwork(
            self.n_appearances, feats.shape[-1],
            with_opacity=self.with_opacity,
            is_view_dependent=self.is_view_dependent,
            generator=torch.Generator().manual_seed(0))
        return dataclasses.replace(state, extra=dict(
            state.extra or {}, __net__=network_state(
                self.net, self.net_tx, gaussians.device)))

    def _rgbs(self, gstate: GaussianState, camera: Cameras, sh_degree: int,
              net_params, warm_up: bool):
        """-> (colours [N, 3], opacity offset [N] or None)."""
        viewdirs = gstate.get_means().detach() - camera.camera_center
        viewdirs = viewdirs / torch.clamp(
            torch.linalg.norm(viewdirs, dim=-1, keepdim=True), min=1e-12)
        base = torch.clamp(sh_to_rgb(gstate.get_shs(), viewdirs, sh_degree,
                                     normalize_dirs=False) + 0.5, min=0.0)
        if warm_up:
            return base, None
        pred = functional_call(self.net, net_params, (
            gstate.params.appearance_features, camera.appearance_id,
            viewdirs))
        rgbs = torch.clamp(base + (pred[:, :3] * 2.0 - 1.0), 0.0, 1.0)
        return rgbs, (pred[:, 3] if self.with_opacity else None)

    def render_appearance(self, gstate, camera, img_height, img_width,
                          bg_color, sh_degree, tap, net_params, warm_up):
        """-> (render outputs, opacity offset or None): the render with
        the network's colours and offset."""
        rgbs, op_offset = self._rgbs(gstate, camera, sh_degree, net_params,
                                     warm_up)
        out = self.renderer.forward(
            gstate, camera, img_height, img_width, bg_color, sh_degree,
            means2d_tap=tap, rgbs_override=rgbs, opacity_offset=op_offset)
        return out, op_offset

    def train_step_appearance(self, state: TrainState, camera: Cameras,
                              gt_image: torch.Tensor, img_height: int,
                              img_width: int, sh_degree: int,
                              bg_color: torch.Tensor, warm_up: bool,
                              mask: Optional[torch.Tensor] = None):
        """One step: the Gaussians (appearance features included) always,
        the network after the warm-up. Returns (new state, scalars)."""
        net = state.extra["__net__"]
        net_leaves = leaves_of(net, not warm_up)

        def loss_of(gstate, tap, abstap):
            out, op_offset = self.render_appearance(
                gstate, camera, img_height, img_width, bg_color, sh_degree,
                tap, net_leaves, warm_up)
            loss, scalars = train_loss(
                out.render, gt_image, mask,
                lambda_dssim=self.metrics_cfg.lambda_dssim,
                rgb_diff_loss=self.metrics_cfg.rgb_diff_loss)
            if op_offset is not None:
                loss = loss + 0.05 * torch.mean(op_offset)
            return loss, (scalars, out.radii, out.n_dropped)

        pgrads, tap_grad, ngrads, _, (scalars, radii, n_dropped) = \
            self.gradients(state, loss_of,
                           [] if warm_up else list(net_leaves.values()))
        params, opt_state, density = self.apply_gradients(
            state, pgrads, tap_grad, radii, img_width, img_height)
        extra = dict(state.extra)
        if not warm_up:
            extra["__net__"] = step_network(self.net_tx, net, ngrads)
        scalars = {k: v.detach() for k, v in scalars.items()}
        scalars["n_dropped_isects"] = n_dropped
        return TrainState(params=params, alive=state.alive,
                          opt_state=opt_state, density=density,
                          step=state.step + 1, extra=extra), scalars
