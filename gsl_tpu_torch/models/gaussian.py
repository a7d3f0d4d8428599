"""Gaussian scene model: capacity-padded raw parameters plus an alive mask.

Port of ``gsl_tpu/models/gaussian.py``: the same raw parameterization
(scales = log(s), opacities = logit(o), rotations = wxyz), the same
activated getters, the same initialization and capacity growth, and the
same per-property optimizer settings. Rows map one to one onto the JAX
state's: densification writes children into free slots (alive False) and
pruning only clears `alive`. Dead slots get opacity 0, so they never
rasterize. `extra` holds non-trainable properties, such as
Mip-Splatting's `filter_3d`: a dict of tensors, where an entry whose first
dimension is the capacity is per Gaussian and follows every row edit. An
entry whose name starts with ``__`` is a variant's own state (a network, an
output processor and their optimizers): no row edit touches it, whatever
its shape. The optional trainable properties are
`GaussianParams.appearance_features` (the appearance models'),
`GaussianParams.metalness` (Glossy's) and PVG's `t_centers`, `t_scales`
and `velocities` (``models/pvg.py``): each follows every row edit, and
new rows start at zero.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.knn import mean_sq_dist_to_knn
from ..ops.sh import num_sh_bases, rgb_to_sh0
from ..ops.transforms import normalize_quat
from ..utils.device import resolve_device

PARAM_FIELDS = ("means", "scales", "rotations", "opacities", "shs_dc",
                "shs_rest")
OPTIONAL_FIELDS = ("appearance_features", "metalness", "t_centers",
                   "t_scales", "velocities")
DEAD_LOG_SCALE = -10.0   # raw scale and opacity of a padding slot
DEAD_LOGIT = -10.0


def inverse_sigmoid(x):
    if isinstance(x, torch.Tensor):
        return torch.log(x / (1.0 - x))
    return math.log(x / (1.0 - x))


@dataclasses.dataclass
class GaussianParams:
    means: torch.Tensor       # [N, 3]
    scales: torch.Tensor      # [N, 3] log-space
    rotations: torch.Tensor   # [N, 4] wxyz, unnormalized
    opacities: torch.Tensor   # [N, 1] logit-space
    shs_dc: torch.Tensor      # [N, 1, 3]
    shs_rest: torch.Tensor    # [N, K-1, 3]
    appearance_features: Optional[torch.Tensor] = None   # [N, D] or None
    metalness: Optional[torch.Tensor] = None   # [N] logit-space, or None
    # PVG (periodic vibration): life peak, log lifespan, velocity
    t_centers: Optional[torch.Tensor] = None    # [N, 1] or None
    t_scales: Optional[torch.Tensor] = None     # [N, 1] or None
    velocities: Optional[torch.Tensor] = None   # [N, 3] or None

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    def fields(self) -> tuple:
        """The names of the properties this state has: PARAM_FIELDS, then
        the optional ones that are not None."""
        return PARAM_FIELDS + tuple(k for k in OPTIONAL_FIELDS
                                    if getattr(self, k) is not None)

    def map(self, fn) -> "GaussianParams":
        """A new GaussianParams with fn(name, tensor) for every property."""
        return GaussianParams(**{k: fn(k, getattr(self, k))
                                 for k in self.fields()})


def is_per_gaussian(x, capacity: int) -> bool:
    """Whether an `extra` entry has one row per Gaussian."""
    return isinstance(x, torch.Tensor) and x.ndim >= 1 \
        and x.shape[0] == capacity


@dataclasses.dataclass
class GaussianState:
    params: GaussianParams
    alive: torch.Tensor       # [N] bool
    extra: Optional[Dict[str, torch.Tensor]] = None

    @property
    def capacity(self) -> int:
        return self.params.capacity

    @property
    def device(self) -> torch.device:
        return self.params.means.device

    @property
    def n_alive(self) -> int:
        return int(self.alive.sum())

    def get_means(self):
        return self.params.means

    def get_scales(self):
        return torch.exp(self.params.scales)

    def get_rotations(self):
        return normalize_quat(self.params.rotations)

    def get_opacities(self):
        """[N] activated opacity; dead slots forced to 0."""
        return torch.sigmoid(self.params.opacities[:, 0]) * self.alive

    def get_shs(self):
        return torch.cat([self.params.shs_dc, self.params.shs_rest], dim=1)


@dataclasses.dataclass
class OptimizationConfig:
    """Learning rates of the per-property Adam."""

    means_lr_init: float = 1.6e-4
    means_lr_final_factor: float = 0.01   # final = init * factor
    means_lr_max_steps: int = 30_000
    spatial_lr_scale: float = -1.0        # <0: use camera extent
    shs_dc_lr: float = 2.5e-3
    shs_rest_lr_div: float = 20.0
    opacities_lr: float = 5e-2
    scales_lr: float = 5e-3
    rotations_lr: float = 1e-3
    eps: float = 1e-15


@dataclasses.dataclass
class VanillaGaussianConfig:
    sh_degree: int = 3
    optimization: OptimizationConfig = dataclasses.field(
        default_factory=OptimizationConfig)

    def instantiate(self):
        return self  # the config doubles as the (stateless) model

    def init_from_pcd(self, xyz: np.ndarray, rgb: np.ndarray,
                      capacity: int, device=None) -> GaussianState:
        """xyz [N, 3] float, rgb [N, 3] in [0, 1]; padded to `capacity`
        slots. Scales start at the root mean squared distance to the 3
        nearest neighbours, opacity at 0.1, rotation at identity."""
        dev = resolve_device(device)
        n = xyz.shape[0]
        if capacity < n:
            raise ValueError(f"capacity {capacity} < point count {n}")
        k = num_sh_bases(self.sh_degree)
        xyz_t = torch.as_tensor(np.asarray(xyz), dtype=torch.float32).to(dev)
        rgb_t = torch.as_tensor(np.asarray(rgb), dtype=torch.float32).to(dev)
        d2 = mean_sq_dist_to_knn(xyz_t, k=3)
        scales = torch.log(torch.sqrt(torch.clamp(d2, min=1e-7)))
        rot = torch.zeros((n, 4), dtype=torch.float32, device=dev)
        rot[:, 0] = 1.0
        live = GaussianState(
            params=GaussianParams(
                means=xyz_t,
                scales=scales[:, None].repeat(1, 3),
                rotations=rot,
                opacities=torch.full((n, 1), inverse_sigmoid(0.1),
                                     dtype=torch.float32, device=dev),
                shs_dc=rgb_to_sh0(rgb_t)[:, None, :],
                shs_rest=torch.zeros((n, k - 1, 3), dtype=torch.float32,
                                     device=dev)),
            alive=torch.ones(n, dtype=torch.bool, device=dev))
        return grow_capacity(live, capacity)

    def init_random(self, generator: Optional[torch.Generator], n: int,
                    capacity: int, extent: float = 1.3,
                    device=None) -> GaussianState:
        """n uniform points in [-extent, extent]^3, gray. The draws come
        from `generator` (a CPU generator), so a seed fixes them."""
        xyz = (torch.rand((n, 3), generator=generator) * 2.0 - 1.0) * extent
        rgb = np.full((n, 3), 127.0 / 255.0, np.float32)
        return self.init_from_pcd(xyz.numpy(), rgb, capacity, device)


def active_sh_degree(step: int, max_degree: int, interval: int = 1000):
    """SH-degree warm-up: +1 every `interval` steps up to the maximum."""
    return min(step // interval, max_degree)


def grow_capacity(state: GaussianState, new_capacity: int) -> GaussianState:
    """Pad every property to `new_capacity` rows. New rows are dead:
    identity rotation, raw scale and opacity -10, everything else 0;
    per-Gaussian `extra` entries are padded with zeros."""
    cap = state.capacity
    n_new = new_capacity - cap
    if n_new <= 0:
        return state

    def pad(name, x):
        tail = torch.zeros((n_new,) + x.shape[1:], dtype=x.dtype,
                           device=x.device)
        if name == "rotations":
            tail[:, 0] = 1.0
        elif name == "scales":
            tail.fill_(DEAD_LOG_SCALE)
        elif name == "opacities":
            tail.fill_(DEAD_LOGIT)
        return torch.cat([x, tail], dim=0)

    def pad_extra(x):
        if not is_per_gaussian(x, cap):
            return x
        return torch.cat([x, x.new_zeros((n_new,) + x.shape[1:])])

    return GaussianState(
        params=state.params.map(pad),
        alive=torch.cat([state.alive, torch.zeros(
            n_new, dtype=torch.bool, device=state.alive.device)]),
        extra=map_extra(state.extra, pad_extra))


def map_extra(extra, fn):
    """`extra` with fn applied to every entry but the variants' own states,
    which pass through as they are (None stays None)."""
    if extra is None:
        return None
    return {k: (v if k.startswith("__") else fn(v))
            for k, v in extra.items()}
