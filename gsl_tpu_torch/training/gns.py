"""GNS: gradient-driven natural selection for compact 3DGS.

Port of ``gsl_tpu/training/gns.py``:

- budgeted densification: the candidates pass the vanilla gradient
  threshold, and `budget_by_step - n_current` of them are drawn by an
  edge-aware importance (per-Gaussian blend weights against the views'
  edge maps, d(Sum(edges * image)) / d(bias) through the rasterizer's
  backward, K3 and K4);
- a drawn Gaussian is split along its longest axis into two children
  offset by +-3 s_max rate, the longest axis shrunk by (1 - rate) / rate_h
  and every axis scaled by rate_h = sqrt(1 - rate^2), opacity * 0.6;
- the natural-selection phase (opacity_reg_from..until): an adaptive
  opacity regulariser in the loss, whose weight follows a declining
  opacity goal, pulls redundant Gaussians toward zero opacity; they are
  pruned every `opacity_reg_interval`, and a final opacity-weighted draw
  keeps the budget. In the phase, and for a while after the final prune,
  the opacities' Adam update is scaled by `opacity_lr_factor` after Adam
  (its moments stay as Adam left them).

`GNSController` keeps the schedule's state on the host: the weight, the
opacity goal's start, whether and when the final prune ran. It rides in
``TrainState.extra["__gns__"]``, so a checkpoint carries it and a resume
continues bit for bit. (gsl_tpu keeps it on the hook and counts the alive
Gaussians from the point cloud, so after a resume past the densify its
phase test compares the budget with the initial count.)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..models.gaussian import GaussianState, inverse_sigmoid
from ..ops.transforms import normalize_quat, quat_to_rotmat
from .density import (DensityControlState, VanillaDensityControllerConfig,
                      _scatter_rows, init_density_state, mean_grads)
from .light_gaussian import bias_gradients, bias_render
from .optimizers import AdamState, zero_opt_state_rows
from .taming import draw_uniforms, normalize, top_k_by_score


@dataclasses.dataclass
class GNSDensityControllerConfig(VanillaDensityControllerConfig):
    budget: int = -1
    budget_intermediate_scale: float = 3.0
    opacity_reg_interval: int = 50
    opacity_reg_from: int = 15_000
    opacity_reg_until: int = 23_000
    opacity_reg_weight: float = 2e-4
    opacity_reg_prior_free_steps: int = 1_000
    natural_selection_min_opacity: float = 0.001
    n_sample_cameras: int = 10
    opacity_reduction: float = 0.6
    split_distance: float = 0.45
    edge_aware: bool = True
    opacity_lr_factor: float = 4.0
    opacity_reg_restore_lr_after: int = 1_000


def gns_budget_at(cfg: GNSDensityControllerConfig, step: int) -> int:
    """The square-root curve toward budget * budget_intermediate_scale."""
    start = cfg.densify_from_iter
    end = cfg.densify_until_iter - start
    rate = (step - start) / max(end - start, 1)
    peak = cfg.budget * cfg.budget_intermediate_scale
    if rate >= 1:
        return int(peak)
    return int(np.sqrt(max(rate, 0.0)) * peak)


@torch.no_grad()
def edge_weighted_blend_scores(renderer, gstate: GaussianState, cameras,
                               edge_maps, bg, sh_degree: int
                               ) -> torch.Tensor:
    """Per Gaussian, Sum_pixels(edge weight * blend weight), normalised by
    its positive median and averaged over the cameras."""
    total = torch.zeros(gstate.capacity, dtype=torch.float32,
                        device=gstate.device)
    render = bias_render(renderer, sh_degree, bg)
    for cam, edges in zip(cameras, edge_maps):
        (w,), _, _ = bias_gradients(render, gstate, cam,
                                    lambda img, out: [edges[..., None]])
        total = total + normalize(1.0, w, gstate.alive)
    return total / max(len(cameras), 1)


@torch.no_grad()
def gns_densify(noise, gstate: GaussianState, opt_state: AdamState,
                dstate: DensityControlState,
                cfg: GNSDensityControllerConfig, importance: torch.Tensor,
                step_budget):
    """Budgeted long-axis split and opacity prune. `noise` is a generator
    or the [CAP] uniforms of the draw. Returns (state, opt_state, dstate,
    n_truncated), as `densify_and_prune`."""
    p = gstate.params
    cap, alive, dev = gstate.capacity, gstate.alive, gstate.device
    cand = (mean_grads(dstate) >= cfg.densify_grad_threshold) & alive
    n_current = alive.sum()
    budget = torch.clamp(torch.as_tensor(step_budget, device=dev),
                         max=n_current + cand.sum())
    n_addable = torch.clamp(budget - n_current, min=0)
    uniforms = noise if isinstance(noise, torch.Tensor) \
        else draw_uniforms(noise, cap, dev)
    sel = top_k_by_score(
        cand, torch.log(torch.clamp(importance, min=1e-12)), uniforms,
        n_addable)

    # ---- long-axis split: child 1 in place, child 2 into a free slot ----
    scales_act = torch.exp(p.scales)
    sdim = p.scales.shape[-1]
    onehot = torch.nn.functional.one_hot(
        torch.argmax(scales_act, dim=-1), sdim).to(torch.float32)
    s_max = scales_act.max(dim=-1, keepdim=True).values
    rate = cfg.split_distance
    rate_w = 1.0 - rate
    rate_h = float(np.sqrt(1.0 - rate * rate))
    axis_local = onehot * s_max * 3.0 * rate
    rot = quat_to_rotmat(normalize_quat(p.rotations))[:, :, :sdim]
    off = (rot * axis_local[:, None, :]).sum(-1)
    new_scales = torch.log(torch.clamp(
        (scales_act * (1.0 - onehot) + onehot * s_max * rate_w / rate_h)
        * rate_h, min=1e-12))
    new_op = inverse_sigmoid(torch.clamp(
        torch.sigmoid(p.opacities) * cfg.opacity_reduction, 1e-6,
        1.0 - 1e-6))
    s1 = sel[:, None]
    params = dataclasses.replace(
        p, means=torch.where(s1, p.means + off, p.means),
        scales=torch.where(s1, new_scales, p.scales),
        opacities=torch.where(s1, new_op, p.opacities))

    cum = torch.cumsum(sel.to(torch.int64), 0)
    total_new = cum[-1]
    free_slots = torch.argsort(alive.to(torch.int8), stable=True)
    n_free = cap - n_current
    j = torch.arange(cap, device=dev)
    src = torch.clamp(torch.searchsorted(cum, j, right=True), max=cap - 1)
    dest = torch.where((j < total_new) & (j < n_free), free_slots,
                       torch.full_like(j, cap))
    child = {k: getattr(p, k)[src] for k in p.fields()}
    child.update(means=p.means[src] - off[src], scales=new_scales[src],
                 opacities=new_op[src])
    params = params.map(lambda k, x: _scatter_rows(x, dest, child[k]))
    born = _scatter_rows(torch.zeros_like(alive), dest,
                         torch.ones_like(alive))
    alive = alive | born

    prune = torch.sigmoid(params.opacities[:, 0]) < cfg.cull_opacity_threshold
    alive = alive & ~prune
    opt_state = zero_opt_state_rows(opt_state, born | sel | prune)
    n_truncated = torch.clamp(total_new - n_free, min=0)
    return (GaussianState(params=params, alive=alive, extra=gstate.extra),
            opt_state, init_density_state(cap, dev), n_truncated)


def gns_opacity_reg_loss(params, alive: torch.Tensor, weight: float,
                         prior_phase: bool) -> torch.Tensor:
    """The adaptive opacity decay. In the prior phase the mean is weighted
    by each Gaussian's opacity (the more opaque decay faster); after it, a
    uniform, stronger pull."""
    raw = params.opacities[:, 0]
    n_alive = torch.clamp(alive.to(torch.float32).sum(), min=1.0)
    zero = torch.zeros_like(raw)
    if prior_phase:
        rate_l = torch.clamp(1.0 - torch.sigmoid(raw), min=0.05)
        return weight * (torch.sum(torch.where(
            alive, (raw + 20.0) / rate_l, zero)) / n_alive) ** 2
    return 3.0 * weight * (torch.sum(torch.where(alive, raw, zero))
                           / n_alive + 20.0) ** 2


@torch.no_grad()
def prune_by_opacity(gstate: GaussianState, opt_state: AdamState,
                     threshold: float):
    """-> (state, opt_state, number pruned as a 0-d tensor)."""
    prune = (torch.sigmoid(gstate.params.opacities[:, 0]) < threshold) \
        & gstate.alive
    return (GaussianState(params=gstate.params, alive=gstate.alive & ~prune,
                          extra=gstate.extra),
            zero_opt_state_rows(opt_state, prune), prune.sum())


@torch.no_grad()
def final_budget_prune(noise, gstate: GaussianState, opt_state: AdamState,
                       budget: int):
    """Keep `budget` alive rows drawn in proportion to their opacity.
    `noise` is a generator or the [CAP] uniforms."""
    cap, dev = gstate.capacity, gstate.device
    op = torch.clamp(torch.sigmoid(gstate.params.opacities[:, 0]), min=1e-9)
    uniforms = noise if isinstance(noise, torch.Tensor) \
        else draw_uniforms(noise, cap, dev)
    keep = top_k_by_score(gstate.alive, torch.log(op), uniforms, budget)
    return (GaussianState(params=gstate.params, alive=keep,
                          extra=gstate.extra),
            zero_opt_state_rows(opt_state, gstate.alive & ~keep))


@dataclasses.dataclass
class GNSController:
    """The host-side schedule state. `as_extra` / `from_extra` carry it in
    ``TrainState.extra["__gns__"]`` (numbers only)."""
    cfg: GNSDensityControllerConfig
    reg_weight: float = math.nan
    opacity_min: Optional[float] = None
    final_pruned: bool = False
    prune_step: Optional[int] = None

    def __post_init__(self):
        if self.cfg.budget <= 0:
            raise ValueError("GNS needs an explicit Gaussian budget "
                             "(model.density.init_args.budget=N)")
        if math.isnan(self.reg_weight):
            self.reg_weight = self.cfg.opacity_reg_weight

    KEYS = ("reg_weight", "opacity_min", "final_pruned", "prune_step")

    def as_extra(self) -> dict:
        return {k: getattr(self, k) for k in self.KEYS}

    @classmethod
    def from_extra(cls, cfg, values: dict) -> "GNSController":
        return cls(cfg, **{k: values[k] for k in cls.KEYS})

    def in_reg_phase(self, step: int, n_alive: int) -> bool:
        cfg = self.cfg
        return (cfg.opacity_reg_from <= step <= cfg.opacity_reg_until
                and n_alive > cfg.budget and not self.final_pruned)

    def opacity_update_factor(self, step: int, n_alive: int) -> float:
        if self.in_reg_phase(step, n_alive):
            return self.cfg.opacity_lr_factor
        if (self.prune_step is not None and step
                < self.prune_step + self.cfg.opacity_reg_restore_lr_after):
            return self.cfg.opacity_lr_factor
        return 1.0

    def update_reg_weight(self, step: int, opacities_sorted: np.ndarray,
                          n_alive: int):
        """Every 100 steps: the weight x0.8 below 0.9 of the declining
        opacity goal, x1.2 above 1.1 of it; the first call sets the
        goal's start."""
        cfg = self.cfg
        idx = max(n_alive - cfg.budget, 0)
        value = (float(opacities_sorted[idx])
                 if idx < len(opacities_sorted) else 0.0)
        if self.opacity_min is None:
            self.opacity_min = value * 0.8
            return
        if (step - 1) % 100 != 0:
            return
        denom = max(cfg.opacity_reg_until - cfg.opacity_reg_from - 1000, 1)
        goal = max((1.0 - (step - cfg.opacity_reg_from) / denom)
                   * self.opacity_min, 0.0)
        if value < goal * 0.9:
            self.reg_weight *= 0.8
        elif value > goal * 1.1:
            self.reg_weight *= 1.2
