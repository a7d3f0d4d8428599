"""Deformable 3DGS: a time-conditioned deformation field over a canonical
Gaussian set.

Port of ``gsl_tpu/models/deform.py``: an MLP D(PE(xyz), PE(t)) ->
(d_xyz, d_rotation, d_scaling), added to the raw means, rotations and
scales before projection; no deformation during the warm-up steps;
annealed smooth temporal noise (AST) on t during training.

`DeformNetwork` is a plain ``nn.Module`` whose layers follow the flax
tree (``layers.{i}`` for ``Dense_{i}``: the hidden layers, then the three
heads), so ``utils/convert.state_dict_from_flax`` carries gsl_tpu's
weights across. The hidden layers start as flax's Dense (lecun normal,
zero bias) and the heads at zero, so the field is the identity at step 0.
The trainer keeps the weights in the train state and applies the module
with ``torch.func.functional_call``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .appearance import positional_encoding
from .encodings import dense
from .gaussian import GaussianState


@dataclasses.dataclass
class DeformModelConfig:
    n_neurons: int = 256
    n_layers: int = 8
    skip_layers: Tuple[int, ...] = (4,)
    xyz_frequencies: int = 10
    time_frequencies: int = 6
    warm_up: int = 3000
    lr_init: float = 8e-4
    lr_final_factor: float = 0.002
    max_steps: int = 40_000
    ast_noise_scale: float = 0.1     # annealed smooth temporal noise

    def instantiate(self):
        return self


def zero_dense(n_in: int, n_out: int) -> nn.Linear:
    """A dense layer at zero (flax's zeros kernel and bias)."""
    layer = nn.Linear(n_in, n_out)
    with torch.no_grad():
        layer.weight.zero_()
        layer.bias.zero_()
    return layer


def deformation_heads(n_in: int):
    """The three zero-initialised heads: d_xyz, d_rotation, d_scaling."""
    return [zero_dense(n_in, 3), zero_dense(n_in, 4), zero_dense(n_in, 3)]


class DeformNetwork(nn.Module):
    """(xyz [N, 3], t 0-d) -> (d_xyz [N, 3], d_rot [N, 4], d_scale [N, 3])."""

    def __init__(self, config: DeformModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg = config
        n_inp = 6 * cfg.xyz_frequencies + 2 * cfg.time_frequencies
        layers, width = [], n_inp
        for i in range(cfg.n_layers):
            if i in cfg.skip_layers:
                width += n_inp
            layers.append(dense(width, cfg.n_neurons, generator))
            width = cfg.n_neurons
        self.layers = nn.ModuleList(layers + deformation_heads(width))

    def forward(self, xyz: torch.Tensor, t: torch.Tensor):
        cfg = self.config
        pe_x = positional_encoding(xyz, cfg.xyz_frequencies)
        tt = torch.as_tensor(t, dtype=xyz.dtype, device=xyz.device
                             ).reshape(1, 1).expand(xyz.shape[0], 1)
        inp = torch.cat([pe_x, positional_encoding(tt, cfg.time_frequencies)],
                        dim=-1)
        x = inp
        for i in range(cfg.n_layers):
            if i in cfg.skip_layers:
                x = torch.cat([x, inp], dim=-1)
            x = torch.relu(self.layers[i](x))
        n = cfg.n_layers
        return tuple(self.layers[n + k](x) for k in range(3))


def deform_gaussians(net: nn.Module, net_params, gstate: GaussianState, t,
                     warm_up_active: bool = False):
    """-> deformed (means, raw rotations, raw scales): the field's output
    at time t added in the alive rows. The canonical means enter the
    network detached, as the reference detaches them. `net_params`: the
    module's weights by name (None: its own)."""
    p = gstate.params
    if warm_up_active:
        return p.means, p.rotations, p.scales
    xyz = p.means.detach()
    d_xyz, d_rot, d_scale = (
        net(xyz, t) if net_params is None
        else torch.func.functional_call(net, net_params, (xyz, t)))
    m = gstate.alive[:, None].to(d_xyz.dtype)
    return (p.means + d_xyz * m, p.rotations + d_rot * m,
            p.scales + d_scale * m)


def ast_noise(draw, t, step: int, max_steps: int, scale: float = 0.1):
    """Annealed smooth temporal noise: t + draw * scale * (1 - clip(step /
    max_steps, 0, 1)), with `draw` a standard normal 0-d tensor (the
    trainer's generator gives it; a test passes gsl_tpu's)."""
    # in float32, as gsl_tpu divides its int32 step
    anneal = float(np.float32(1.0) - np.clip(
        np.float32(step) / np.float32(max_steps), 0.0, 1.0))
    return t + draw * scale * anneal
