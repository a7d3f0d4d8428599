"""HexPlane spatio-temporal deformation field (4DGS).

Port of ``gsl_tpu/models/hexplane.py``: six multiplied 2D feature planes
over the coordinate pairs (x, y) (x, z) (x, t) (y, z) (y, t) (z, t)
(``itertools.combinations(range(4), 2)``) at each resolution, sampled
bilinearly with clamped corners, concatenated across resolutions and
decoded by a small MLP into (d_xyz, d_rotation, d_scaling).

The planes are parameters named as gsl_tpu's, ``plane_r{r}_p{pi}`` of
shape (res_b, res_a, F) under ``field.``, and the MLP's layers
``layers.{i}`` for ``Dense_{i}``, so ``utils/convert.state_dict_from_flax``
carries gsl_tpu's parameters across unchanged. Spatial planes start
uniform in [0, 0.2), time planes at one (a static field), the heads at
zero. The coordinates are normalised by the fixed ``bounds`` = 1.5 and
clipped to [0, 1], as gsl_tpu's are: a row outside [-1.5, 1.5] samples
the border. The lookups are plain gathers (`_bilinear`), whose backward
adds into the planes by index.
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence

import torch
from torch import nn

from .deform import deformation_heads
from .encodings import dense

PLANES = list(itertools.combinations(range(4), 2))  # 6 coordinate pairs


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip: max, then min, each splitting the gradient at a tie."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _bilinear(grid: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """grid [Rh, Rw, F], uv [N, 2] in [0, 1] -> [N, F].

    The four corners are one ``index_select`` of the flattened grid, whose
    backward is an ``index_add_``: on the card it adds by atomics. (The
    backward of ``grid[y0, x0]`` sorts the indices and walks each run of
    equal ones serially; every row of a step shares the camera's time, so
    a time plane's rows crowd onto a few cells, and at 1M rows that walk
    took 3.3 s a step on an H100.)"""
    h, w, f = grid.shape
    x = _clip(uv[:, 0] * (w - 1), 0.0, w - 1.0)
    y = _clip(uv[:, 1] * (h - 1), 0.0, h - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    g00, g01, g10, g11 = torch.index_select(
        grid.reshape(h * w, f), 0,
        torch.cat([y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1])
    ).reshape(4, -1, f)
    return (g00 * (1 - fx) * (1 - fy)
            + g01 * fx * (1 - fy)
            + g10 * (1 - fx) * fy
            + g11 * fx * fy)


class HexPlaneField(nn.Module):
    """Multiplied 6-plane field: (xyz [N, 3], t) -> [N, F * n_res]."""

    def __init__(self, resolutions: Sequence[int] = (32, 64),
                 time_resolution: int = 16, n_features: int = 16,
                 bounds: float = 1.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.resolutions = tuple(resolutions)
        self.time_resolution = time_resolution
        self.n_features = n_features
        self.bounds = bounds
        for r in self.resolutions:
            for pi, (a, b) in enumerate(PLANES):
                res_a = time_resolution if a == 3 else r
                res_b = time_resolution if b == 3 else r
                shape = (res_b, res_a, n_features)
                init = (torch.ones(shape) if 3 in (a, b)
                        else torch.rand(shape, generator=generator) * 0.2)
                setattr(self, f"plane_r{r}_p{pi}", nn.Parameter(init))

    def coordinates(self, xyz: torch.Tensor, t) -> torch.Tensor:
        """[N, 4]: xyz normalised by the bounds and clipped to [0, 1],
        then t."""
        p = _clip(xyz / self.bounds * 0.5 + 0.5, 0.0, 1.0)
        tt = torch.as_tensor(t, dtype=xyz.dtype, device=xyz.device
                             ).reshape(1).expand(xyz.shape[0])
        return torch.cat([p, tt[:, None]], dim=-1)

    def forward(self, xyz: torch.Tensor, t) -> torch.Tensor:
        coords = self.coordinates(xyz, t)
        outs = []
        for r in self.resolutions:
            feat = torch.ones((xyz.shape[0], self.n_features),
                              dtype=xyz.dtype, device=xyz.device)
            for pi, (a, b) in enumerate(PLANES):
                feat = feat * _bilinear(getattr(self, f"plane_r{r}_p{pi}"),
                                        coords[:, (a, b)])
            outs.append(feat)
        return torch.cat(outs, dim=-1)


class HexPlaneDeformation(nn.Module):
    """HexPlane features -> two ReLU layers -> the zero-initialised
    (d_xyz, d_rot, d_scale) heads."""

    def __init__(self, resolutions: Sequence[int] = (32, 64),
                 n_features: int = 16, n_neurons: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.field = HexPlaneField(resolutions=resolutions,
                                   n_features=n_features,
                                   generator=generator)
        n_in = n_features * len(tuple(resolutions))
        self.layers = nn.ModuleList(
            [dense(n_in, n_neurons, generator),
             dense(n_neurons, n_neurons, generator)]
            + deformation_heads(n_neurons))

    def forward(self, xyz: torch.Tensor, t):
        h = torch.relu(self.layers[0](self.field(xyz, t)))
        h = torch.relu(self.layers[1](h))
        return tuple(self.layers[2 + k](h) for k in range(3))
