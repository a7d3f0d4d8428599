"""Training plugins: composable extension seams of the trainer.

Port of ``gsl_tpu/training/plugins.py``. A plugin is a config
(`instantiate()`) whose runtime object hooks into the trainer:

- `on_setup(state)` runs at the end of `Trainer.setup`;
- `extra_loss(out, gt_image, mask, gstate, step, camera)` runs inside
  the training step and returns (loss term, scalars);
  `required_render_types` extends the renderer's outputs so the term's
  inputs exist;
- `after_step(state, step)` runs in the fit loop after each step.

`step` in `extra_loss` is the count of steps taken before this one, as in
the trainer's other losses.
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet, Optional, Tuple

import numpy as np
import torch

from ..ops.transforms import depth_to_normal


class Plugin:
    required_render_types: FrozenSet[str] = frozenset()

    def on_setup(self, state):
        return state

    def extra_loss(self, out, gt_image, mask, gstate, step, camera=None):
        return 0.0, {}

    def after_step(self, state, step):
        return state


@dataclasses.dataclass
class BackgroundRemovalPluginConfig:
    """From `background_removal_from` on, adds
    weight * mean(hard_inverse_depth * (1 - mask)): background pixels are
    pushed to zero inverse depth, so backdrop Gaussians collapse."""
    background_removal_from: int = 7_000
    background_removal_weight: float = 0.1

    def instantiate(self) -> "BackgroundRemovalPlugin":
        return BackgroundRemovalPlugin(self)


class BackgroundRemovalPlugin(Plugin):
    required_render_types = frozenset({"hard_inverse_depth"})

    def __init__(self, config: BackgroundRemovalPluginConfig):
        self.config = config

    def extra_loss(self, out, gt_image, mask, gstate, step, camera=None):
        if mask is None:
            return 0.0, {}
        term = torch.mean(out.hard_inverse_depth * (1.0 - mask)) \
            * self.config.background_removal_weight
        if step < self.config.background_removal_from:
            term = term.new_zeros(())
        return term, {"bkg_removal": term}


@dataclasses.dataclass
class FreezeBilagridPluginConfig:
    """From `freeze_from` on, the output processor's parameters are held
    at their value after that step; its Adam state is left alone."""
    freeze_from: int = 15_000

    def instantiate(self) -> "FreezeBilagridPlugin":
        return FreezeBilagridPlugin(self)


class FreezeBilagridPlugin(Plugin):
    """The frozen value rides in ``extra["__outproc_frozen__"]``, so a run
    resumed past `freeze_from` holds the value the first run froze.
    (gsl_tpu keeps it on the plugin, so its resumed run freezes the grid
    one step later, at that step's value.)"""

    def __init__(self, config: FreezeBilagridPluginConfig):
        self.config = config

    def after_step(self, state, step):
        extra = state.extra
        if step < self.config.freeze_from or not extra \
                or "__outproc__" not in extra:
            return state
        frozen = extra.get("__outproc_frozen__", extra["__outproc__"])
        return dataclasses.replace(state, extra=dict(
            extra, __outproc__=frozen, __outproc_frozen__=frozen))


@dataclasses.dataclass
class NormalRegPluginConfig:
    """The rendered normal map must agree with normals differenced from
    the expected depth, and the last scale axis is pushed flat. Setup draws
    the rotations anew and shrinks the last scale axis by 5, so the flat
    axis is free to turn."""
    normal_reg_lambda: float = 0.05
    flatten_reg: float = 0.02

    def instantiate(self) -> "NormalRegPlugin":
        return NormalRegPlugin(self)


class NormalRegPlugin(Plugin):
    required_render_types = frozenset({"normal", "exp_depth", "alpha"})
    SEED = 7

    def __init__(self, config: NormalRegPluginConfig):
        self.config = config

    def on_setup(self, state, rotations: Optional[torch.Tensor] = None):
        """`rotations`: the uniform [0, 1) draws to take; None draws them
        from a generator seeded SEED on the state's device (gsl_tpu draws
        from jax.random.PRNGKey(7))."""
        p = state.params
        if rotations is None:
            gen = torch.Generator(device=p.rotations.device)
            gen.manual_seed(self.SEED)
            rotations = torch.rand(p.rotations.shape, generator=gen,
                                   device=p.rotations.device)
        scales = p.scales.clone()
        scales[..., -1] -= float(np.log(np.float32(5.0)))
        return dataclasses.replace(state, params=dataclasses.replace(
            p, rotations=rotations.to(p.rotations), scales=scales))

    def extra_loss(self, out, gt_image, mask, gstate, step, camera=None):
        n_from_depth = depth_to_normal(
            out.exp_depth.detach(), camera.world_to_camera, camera.fx,
            camera.fy, camera.cx, camera.cy)
        n_from_depth = n_from_depth * out.alpha.detach()[..., None]
        normal_err = torch.mean(
            1.0 - torch.sum(out.normal * n_from_depth, dim=-1))
        normal_loss = normal_err * self.config.normal_reg_lambda
        alive = gstate.alive.to(torch.float32)
        flatten = torch.sum(torch.exp(gstate.params.scales[..., -1])
                            * alive) / torch.clamp(alive.sum(), min=1.0)
        flatten_loss = flatten * self.config.flatten_reg
        return normal_loss + flatten_loss, {"normal_loss": normal_loss,
                                            "flatten_loss": flatten_loss}


@dataclasses.dataclass
class GroundRegPluginConfig:
    """Gaussians below a known ground plane: at setup they are projected
    onto it, made transparent and shrunk; every `ground_reg_interval`
    steps their mean depth below it is penalised."""
    up_direction: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    ground_alt: float = 0.0
    ground_reg_lambda: float = 1.0
    ground_reg_interval: int = 10

    def instantiate(self) -> "GroundRegPlugin":
        return GroundRegPlugin(self)


class GroundRegPlugin(Plugin):
    def __init__(self, config: GroundRegPluginConfig):
        self.config = config
        up = np.asarray(config.up_direction, np.float32)
        self.up = up / np.linalg.norm(up)

    def _alt(self, params):
        """Height below the plane, [N]: positive under it."""
        up = torch.from_numpy(self.up).to(params.means)
        return self.config.ground_alt - (params.means * up).sum(-1)

    def on_setup(self, state):
        # -15 in logit space is opacity ~3e-7 (finite, so gradients stay
        # NaN-free), as gsl_tpu sets it
        p = state.params
        alt = self._alt(p)
        below = alt > 0.0
        up = torch.from_numpy(self.up).to(p.means)
        means = p.means + torch.where(below, alt, 0.0)[:, None] * up
        opacities = torch.where(below[:, None],
                                torch.tensor(-15.0).to(p.opacities),
                                p.opacities)
        scales = torch.where(below[:, None],
                             torch.log(torch.tensor(1e-4)).to(p.scales),
                             p.scales)
        return dataclasses.replace(state, params=dataclasses.replace(
            p, means=means, opacities=opacities, scales=scales))

    def extra_loss(self, out, gt_image, mask, gstate, step, camera=None):
        alt = self._alt(gstate.params)
        below = (alt > 0.0).to(alt.dtype).detach() \
            * gstate.alive.to(alt.dtype)
        reg = torch.sum(alt * below) / (torch.sum(below) + 1.0)
        term = reg * self.config.ground_reg_lambda
        if step % self.config.ground_reg_interval != 0:
            term = term.new_zeros(())
        return term, {"ground": term}


PLUGIN_REGISTRY = {
    "background_removal": BackgroundRemovalPluginConfig,
    "freeze_bilagrid": FreezeBilagridPluginConfig,
    "normal_reg": NormalRegPluginConfig,
    "ground_reg": GroundRegPluginConfig,
}
