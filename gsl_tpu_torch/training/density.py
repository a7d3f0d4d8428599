"""Vanilla adaptive density control on the capacity-padded state.

Port of ``gsl_tpu/training/density.py``: the vanilla controller and its
variants (static, Revising, no-culling-big-scale, H3DGS, accurate
visibility, background removal). Clone and split write into free slots,
pruning clears `alive`, and the Adam moments of touched rows are zeroed.

- accumulate ||dL/dmeans2d * 0.5 [W, H]|| and a visit counter over visible
  Gaussians; track the largest screen radius in pixels;
- every `densification_interval` steps in (densify_from_iter,
  densify_until_iter): clone small Gaussians with a high mean gradient;
  split large ones into 2 children drawn from N(0, scale), rotated, with
  scales / 1.6 (the original becomes the first child in place);
- prune opacity < cull_opacity_threshold and, after the first opacity
  reset, screen radius > 20 px or world scale > 0.1 * prune_extent;
- all statistics restart at zero after every densify;
- opacity reset to min(opacity, 0.01), zeroing the opacity moments;
- a new slot copies every property of its source row (the appearance
  features too), and the per-Gaussian `extra` entries (Mip-Splatting's
  `filter_3d`), which stay as they are until the variant recomputes them;
  a variant's own state in `extra` (``__net__`` and the like) is not a
  per-Gaussian entry whatever its shape, and passes through.

The functions build new tensors and leave their arguments as they were.
The variants, each a branch of the same pass:

- Revising (arXiv 2404.06109) gives a clone and its copy the opacity
  1 - sqrt(1 - alpha), so the pair composites to the original's. (gsl_tpu
  writes it into the original only: its copy comes from the unmodified
  row and keeps the old opacity.)
- no-culling-big-scale prunes by opacity and, after the first reset, by
  screen size, never by world scale;
- H3DGS selects by accumulated gradient * largest screen radius *
  opacity^(1/5) >= 0.015 among rows above 0.15 opacity, and prunes by
  opacity and world scale always, never by screen size;
- accurate visibility counts a Gaussian in the statistics only where its
  tap gradient is nonzero (it reached a pixel);
- background removal pushes the opacity of rows outside the train
  cameras' sphere to ~0 before a densify (`background_removal_step`);
- static does nothing; its hook skips the whole schedule.

Nothing here reads a value back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..models.gaussian import (GaussianParams, GaussianState,
                               inverse_sigmoid, is_per_gaussian, map_extra)
from ..ops.transforms import normalize_quat, quat_to_rotmat
from .optimizers import (AdamState, zero_opacity_opt_state,
                         zero_opt_state_rows)


@dataclasses.dataclass
class DensityControlState:
    grad_accum: torch.Tensor  # [CAP]
    denom: torch.Tensor       # [CAP]
    max_radii: torch.Tensor   # [CAP] float (pixels)


def init_density_state(capacity: int, device=None) -> DensityControlState:
    def z():
        return torch.zeros(capacity, dtype=torch.float32, device=device)
    return DensityControlState(grad_accum=z(), denom=z(), max_radii=z())


@dataclasses.dataclass
class VanillaDensityControllerConfig:
    percent_dense: float = 0.01
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    opacity_reset_value: float = 0.01
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 2e-4
    cull_opacity_threshold: float = 0.005
    cull_screen_size_threshold: float = 20.0
    cull_scale_factor: float = 0.1       # x prune_extent
    camera_extent_factor: float = 1.0
    scene_extent_override: float = -1.0
    absgrad: bool = False

    def instantiate(self):
        return self


@dataclasses.dataclass
class StaticDensityControllerConfig(VanillaDensityControllerConfig):
    """No densify, prune or opacity reset at all (`StaticDensityHook`)."""


@dataclasses.dataclass
class RevisingDensityControllerConfig(VanillaDensityControllerConfig):
    """A clone and its copy both get alpha_hat = 1 - sqrt(1 - alpha)."""


@dataclasses.dataclass
class NoCullingBigScaleDensityControllerConfig(
        VanillaDensityControllerConfig):
    """Never prunes by world scale (large scenes, big background
    splats)."""


@dataclasses.dataclass
class H3DGSDensityControllerConfig(VanillaDensityControllerConfig):
    """Hierarchical-3DGS selection by accumulated gradient * max radius *
    opacity^(1/5), with an opacity floor for candidates."""
    densification_interval: int = 300
    densify_grad_threshold: float = 0.015
    clone_min_opacity: float = 0.15


@dataclasses.dataclass
class AccurateVisibilityFilterDensityControllerConfig(
        VanillaDensityControllerConfig):
    """Statistics over the Gaussians that reached a pixel (nonzero tap
    gradient) rather than those with a screen radius."""


@dataclasses.dataclass
class BackgroundRemovalDensityControllerConfig(
        VanillaDensityControllerConfig):
    """Opacity ~0 outside the train cameras' bounding sphere every
    densify interval after `background_removal_from`, so the next prune
    removes those rows."""
    background_removal_from: int = 7_000
    foreground_radius_scaling: float = 1.0


def background_removal_step(gstate: GaussianState, scene_center,
                            foreground_radius: float) -> GaussianState:
    """Raw opacity -15 for the alive rows farther than `foreground_radius`
    from `scene_center` [3]."""
    center = torch.as_tensor(scene_center, dtype=torch.float32,
                             device=gstate.device)
    dist = torch.linalg.norm(gstate.params.means - center[None, :], dim=-1)
    outside = (dist > foreground_radius) & gstate.alive
    op = torch.where(outside[:, None],
                     torch.full_like(gstate.params.opacities, -15.0),
                     gstate.params.opacities)
    return GaussianState(
        params=dataclasses.replace(gstate.params, opacities=op),
        alive=gstate.alive, extra=gstate.extra)


def update_stats(dstate: DensityControlState, m2d_grad: torch.Tensor,
                 radii: torch.Tensor, grad_scale: torch.Tensor,
                 distance_factors: Optional[torch.Tensor] = None,
                 accurate_visibility: bool = False) -> DensityControlState:
    """m2d_grad [CAP, 2] = dL/dmeans2d in pixels (or the AbsGS statistic);
    radii [CAP] int; grad_scale [2] = 0.5 * [W, H]. `distance_factors`
    [CAP] (optional, `PartitionStore.distance_factors`) damps each row's
    gradient by exp(-distance) to its partition, so densification stays
    inside the cell. With `accurate_visibility` a row counts only where
    its gradient is nonzero."""
    visible = radii > 0
    if accurate_visibility:
        visible = visible & torch.any(m2d_grad != 0.0, dim=-1)
    g = torch.linalg.norm(m2d_grad * grad_scale[None, :], dim=-1)
    if distance_factors is not None:
        g = g * torch.exp(-distance_factors)
    zero = torch.zeros_like(g)
    return DensityControlState(
        grad_accum=dstate.grad_accum + torch.where(visible, g, zero),
        denom=dstate.denom + visible.to(torch.float32),
        max_radii=torch.maximum(
            dstate.max_radii,
            torch.where(visible, radii.to(torch.float32), zero)))


def _scatter_rows(dst: torch.Tensor, dest: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """dst with dst[dest[j]] = values[j]; an index equal to len(dst) is
    dropped (it lands in a scratch row that is cut off again)."""
    ext = torch.cat([dst, torch.zeros_like(dst[:1])])
    ext[dest] = values
    return ext[:-1]


def mean_grads(dstate: DensityControlState) -> torch.Tensor:
    """[CAP] the accumulated gradient norm over the visits, 0 unvisited."""
    return torch.where(dstate.denom > 0.0,
                       dstate.grad_accum / torch.clamp(dstate.denom,
                                                       min=1.0),
                       torch.zeros_like(dstate.denom))


def densify_masks(gstate: GaussianState, dstate: DensityControlState,
                  cfg: VanillaDensityControllerConfig, cameras_extent: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (clone_mask, split_mask): the alive rows whose mean view-space
    gradient (H3DGS: its score) reaches the threshold, small ones cloned,
    large ones split."""
    max_scale = torch.exp(gstate.params.scales).max(dim=-1).values
    if isinstance(cfg, H3DGSDensityControllerConfig):
        op = torch.sigmoid(gstate.params.opacities[:, 0])
        score = (dstate.grad_accum * dstate.max_radii
                 * torch.pow(torch.clamp(op, min=1e-8), 0.2))
        high_grad = ((score >= cfg.densify_grad_threshold)
                     & (op > cfg.clone_min_opacity) & gstate.alive)
    else:
        high_grad = (mean_grads(dstate) >= cfg.densify_grad_threshold) \
            & gstate.alive
    small = max_scale <= cfg.percent_dense * cameras_extent
    return high_grad & small, high_grad & ~small


def densify_and_prune(
    noise,
    gstate: GaussianState,
    opt_state: AdamState,
    dstate: DensityControlState,
    cfg: VanillaDensityControllerConfig,
    cameras_extent: float,
    prune_extent: float,
    use_size_prune,                 # bool: step > opacity_reset_interval
) -> Tuple[GaussianState, AdamState, DensityControlState, torch.Tensor]:
    """One clone/split/prune pass. `noise` is a ``torch.Generator`` on the
    state's device (or None for the default one), or the two standard
    normal draws themselves as a pair of [CAP, sdim] tensors (sdim: the
    scales' columns). Returns (state,
    opt_state, dstate, n_truncated): n_truncated > 0, a 0-d tensor, tells
    the caller to grow the capacity and redo the pass."""
    p = gstate.params
    cap = gstate.capacity
    alive = gstate.alive
    dev = alive.device

    clone_mask, split_mask = densify_masks(gstate, dstate, cfg,
                                           cameras_extent)
    scales_act = torch.exp(p.scales)

    # split offsets: std = activated scales, rotated into the world
    # sdim is 3 for Gaussians and 2 for surfels, whose offsets lie in the
    # tangent plane (the first two rotation columns)
    sdim = p.scales.shape[-1]
    if isinstance(noise, (tuple, list)):
        n1, n2 = noise
    else:
        n1 = torch.randn((cap, sdim), generator=noise, device=dev)
        n2 = torch.randn((cap, sdim), generator=noise, device=dev)
    rot = quat_to_rotmat(normalize_quat(p.rotations))[:, :, :sdim]
    off1 = (rot * (n1 * scales_act)[:, None, :]).sum(-1)
    off2 = (rot * (n2 * scales_act)[:, None, :]).sum(-1)
    log_div = math.log(0.8 * 2.0)

    # a split original becomes the first child in place
    sm = split_mask[:, None]
    opacities = p.opacities
    if isinstance(cfg, RevisingDensityControllerConfig):
        alpha = torch.sigmoid(p.opacities[:, 0])
        alpha_hat = 1.0 - torch.sqrt(torch.clamp(1.0 - alpha, min=1e-8))
        raw_hat = inverse_sigmoid(torch.clamp(alpha_hat, 1e-6, 1.0 - 1e-6))
        opacities = torch.where(clone_mask[:, None], raw_hat[:, None],
                                p.opacities)
    params = dataclasses.replace(
        p, means=torch.where(sm, p.means + off1, p.means),
        scales=torch.where(sm, p.scales - log_div, p.scales),
        opacities=opacities)

    # free slots for the clones and the second split children: dead slots
    # first, in slot order
    want = clone_mask.to(torch.int64) + split_mask.to(torch.int64)
    cum_want = torch.cumsum(want, 0)
    total_new = cum_want[-1]
    free_slots = torch.argsort(alive.to(torch.int8), stable=True)
    n_free = cap - alive.sum()

    j = torch.arange(cap, device=dev)
    src = torch.clamp(torch.searchsorted(cum_want, j, right=True),
                      max=cap - 1)
    valid_new = (j < total_new) & (j < n_free)
    dest = torch.where(valid_new, free_slots, torch.full_like(j, cap))

    # a child copies its source row as the pass left it (a Revising
    # clone's copy takes the corrected opacity), but the split offsets
    is_split_child = split_mask[src][:, None]
    child = {k: getattr(params, k)[src] for k in p.fields()}
    child["means"] = torch.where(is_split_child, p.means[src] + off2[src],
                                 p.means[src])
    child["scales"] = torch.where(is_split_child, p.scales[src] - log_div,
                                  p.scales[src])
    params = params.map(lambda k, x: _scatter_rows(x, dest, child[k]))
    born = _scatter_rows(torch.zeros_like(alive), dest,
                         torch.ones_like(alive))
    alive = alive | born
    extra = map_extra(gstate.extra, lambda x: (
        _scatter_rows(x, dest, x[src]) if is_per_gaussian(x, cap) else x))

    # prune, on the values after densification
    opacities_act = torch.sigmoid(params.opacities[:, 0])
    prune = opacities_act < cfg.cull_opacity_threshold
    screen_prune = dstate.max_radii > cfg.cull_screen_size_threshold
    world_prune = (torch.exp(params.scales).max(dim=-1).values
                   > cfg.cull_scale_factor * prune_extent)
    use_size_prune = torch.as_tensor(use_size_prune, dtype=torch.bool,
                                     device=dev)
    if isinstance(cfg, NoCullingBigScaleDensityControllerConfig):
        size_prune = screen_prune
    elif isinstance(cfg, H3DGSDensityControllerConfig):
        prune = prune | world_prune
        size_prune = torch.zeros_like(screen_prune)
    else:
        size_prune = screen_prune | world_prune
    # fresh slots have zero statistics, so the screen prune cannot hit them
    prune = prune | (use_size_prune & size_prune)
    alive = alive & ~prune

    # Adam moments start over for new slots, split originals and pruned
    # slots
    opt_state = zero_opt_state_rows(opt_state, born | split_mask | prune)

    n_truncated = torch.clamp(total_new - n_free, min=0)
    return (GaussianState(params=params, alive=alive, extra=extra),
            opt_state, init_density_state(cap, dev), n_truncated)


def reset_opacities(gstate: GaussianState, opt_state: AdamState,
                    reset_value: float = 0.01
                    ) -> Tuple[GaussianState, AdamState]:
    """opacity -> min(opacity, reset_value); zero the opacity moments."""
    p = gstate.params
    op = torch.sigmoid(p.opacities)
    new_raw = inverse_sigmoid(torch.clamp(op, max=reset_value))
    return (GaussianState(params=dataclasses.replace(p, opacities=new_raw),
                          alive=gstate.alive, extra=gstate.extra),
            zero_opacity_opt_state(opt_state))
