"""Input encodings and the small MLP of the appearance networks.

Port of ``gsl_tpu/models/encodings.py``: multi-level dense 2D grids, the
multi-resolution hash grid (instant-ngp) and the skip MLP, as
``nn.Module``s. The lookups are gathers and lerps in plain torch.

Parameters start as flax's do: a dense layer's weight from a truncated
normal of variance 1 / fan_in (lecun normal) and a zero bias, an
embedding from N(0, 1 / features), grids and tables uniform in
[0, 1e-4). The draws come from a ``torch.Generator`` on the CPU, so a
seed fixes them on any device. Parameter names follow the flax tree, so
``utils/convert.state_dict_from_flax`` carries its weights across:
``grid_{lv}``, ``table_{lv}``, ``layers.{i}`` for ``Dense_{i}``.
"""
from __future__ import annotations

import itertools
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

# flax's truncated normal is cut at 2 standard deviations; this is the
# standard deviation of the unit normal cut there
_TRUNCATED_STD = 0.87962566103423978


def truncated_normal(shape, std: float, generator) -> torch.Tensor:
    """N(0, 1) cut to [-2, 2], scaled so its standard deviation is `std`
    (flax's variance_scaling "truncated_normal")."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
    return (x * (std / _TRUNCATED_STD)).to(torch.float32)


def uniform_param(shape, generator, scale: float = 1e-4) -> nn.Parameter:
    """flax's uniform(scale): U[0, scale)."""
    return nn.Parameter(torch.rand(shape, generator=generator) * scale)


def dense(n_in: int, n_out: int, generator) -> nn.Linear:
    """nn.Linear with flax Dense's initialisation: lecun normal weight,
    zero bias."""
    layer = nn.Linear(n_in, n_out)
    with torch.no_grad():
        layer.weight.copy_(truncated_normal((n_out, n_in),
                                            math.sqrt(1.0 / n_in),
                                            generator))
        layer.bias.zero_()
    return layer


def embedding(n: int, features: int, generator) -> nn.Embedding:
    """nn.Embedding with flax Embed's initialisation, N(0, 1 / features)."""
    emb = nn.Embedding(n, features)
    with torch.no_grad():
        emb.weight.copy_(torch.randn((n, features), generator=generator)
                         / math.sqrt(features))
    return emb


class DenseGrid2DEncoding(nn.Module):
    """Multi-level learned 2D feature grids with bilinear interpolation:
    uv in [0, 1]^2 -> the levels' features concatenated, [...,
    n_levels * n_features]. `n_instances` > 1 keeps one grid set per
    image."""

    def __init__(self, n_levels: int = 4, base_resolution: int = 16,
                 per_level_scale: float = 2.0, n_features: int = 2,
                 n_instances: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_levels, self.n_features = n_levels, n_features
        self.resolutions = [int(round(base_resolution * per_level_scale ** lv))
                            for lv in range(n_levels)]
        for lv, res in enumerate(self.resolutions):
            setattr(self, f"grid_{lv}", uniform_param(
                (n_instances, res, res, n_features), generator))

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features

    def forward(self, uv: torch.Tensor, instance=0) -> torch.Tensor:
        outs = []
        for lv, res in enumerate(self.resolutions):
            g = getattr(self, f"grid_{lv}")[instance]
            x = torch.clamp(uv[..., 0], 0.0, 1.0) * (res - 1)
            y = torch.clamp(uv[..., 1], 0.0, 1.0) * (res - 1)
            x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, res - 2)
            y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, res - 2)
            fx = (x - x0)[..., None]
            fy = (y - y0)[..., None]
            v00 = g[y0, x0]
            v01 = g[y0, x0 + 1]
            v10 = g[y0 + 1, x0]
            v11 = g[y0 + 1, x0 + 1]
            outs.append(v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
                        + v10 * (1 - fx) * fy + v11 * fx * fy)
        return torch.cat(outs, dim=-1)


def hash_level_resolutions(n_levels: int, base_resolution: int,
                           max_resolution: int) -> List[int]:
    """tcnn's growth rule: exponentially spaced from base to max."""
    if n_levels <= 1:
        return [base_resolution]
    growth = np.exp((np.log(max_resolution) - np.log(base_resolution))
                    / (n_levels - 1))
    return [int(np.floor(base_resolution * growth ** lv))
            for lv in range(n_levels)]


# the spatial hashing primes of Teschner et al., as instant-ngp uses them
# (the first coordinate is left unmultiplied), as int32: the products wrap
_HASH_PRIMES = tuple(int(np.uint32(p).astype(np.int32))
                     for p in (1, 2654435761, 805459861))


def hash_grid_lookup(table: torch.Tensor, x: torch.Tensor, res: int,
                     hashmap_size: int) -> torch.Tensor:
    """One level of the hash encoding: d-linear interpolation of the
    corners' features. table [T, F]; x [..., d] in [0, 1] -> [..., F].
    Where the vertex grid fits the table ((res + 1)^d <= T) a corner's
    row is its dense index; otherwise the int32 coordinates times the
    primes, XORed, modulo T (the sign of the divisor, as jnp.remainder)."""
    d = x.shape[-1]
    pos = torch.clamp(x, 0.0, 1.0) * res
    p0 = torch.clamp(torch.floor(pos).to(torch.int32), 0, res - 1)
    frac = pos - p0
    dense = (res + 1) ** d <= hashmap_size
    feats = 0.0
    for c in itertools.product((0, 1), repeat=d):
        pc = p0 + torch.tensor(c, dtype=torch.int32, device=x.device)
        if dense:
            idx = pc[..., 0]
            for i in range(1, d):
                idx = idx * (res + 1) + pc[..., i]
        else:
            idx = pc[..., 0] * _HASH_PRIMES[0]
            for i in range(1, d):
                idx = torch.bitwise_xor(idx, pc[..., i] * _HASH_PRIMES[i])
            idx = torch.remainder(idx, hashmap_size)
        w = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
        for i in range(d):
            w = w * (frac[..., i] if c[i] == 1 else 1.0 - frac[..., i])
        feats = feats + w[..., None] * table[idx.to(torch.int64)]
    return feats


class HashGridEncoding(nn.Module):
    """Multi-resolution hash encoding: x in [0, 1]^d -> [...,
    n_levels * n_features_per_level]. Level lv has min(2^log2, (res + 1)^d)
    rows."""

    def __init__(self, n_input_dims: int = 3, n_levels: int = 8,
                 n_features_per_level: int = 4, log2_hashmap_size: int = 19,
                 base_resolution: int = 16, max_resolution: int = 2048,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_levels = n_levels
        self.n_features_per_level = n_features_per_level
        self.resolutions = hash_level_resolutions(n_levels, base_resolution,
                                                  max_resolution)
        t = 1 << log2_hashmap_size
        self.sizes = [min(t, (res + 1) ** n_input_dims)
                      for res in self.resolutions]
        for lv, size in enumerate(self.sizes):
            setattr(self, f"table_{lv}", uniform_param(
                (size, n_features_per_level), generator))

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            hash_grid_lookup(getattr(self, f"table_{lv}"), x, res, size)
            for lv, (res, size) in enumerate(zip(self.resolutions,
                                                 self.sizes))], dim=-1)


class SkipMLP(nn.Module):
    """ReLU MLP with optional skip connections (the input concatenated
    before the layers in `skips`) and an output activation."""

    def __init__(self, n_input_dims: int, n_output_dims: int,
                 n_layers: int = 3, n_neurons: int = 64,
                 skips: Sequence[int] = (),
                 output_activation: str = "sigmoid",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.skips = tuple(skips)
        self.output_activation = output_activation
        layers, n = [], n_input_dims
        for i in range(n_layers - 1):
            if i in self.skips:
                n += n_input_dims
            layers.append(dense(n, n_neurons, generator))
            n = n_neurons
        layers.append(dense(n, n_output_dims, generator))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inp = x
        for i, layer in enumerate(self.layers[:-1]):
            if i in self.skips:
                x = torch.cat([x, inp], dim=-1)
            x = torch.relu(layer(x))
        x = self.layers[-1](x)
        if self.output_activation == "sigmoid":
            x = torch.sigmoid(x)
        return x
