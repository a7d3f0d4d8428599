"""MCMC density control (3DGS as Markov chain Monte Carlo).

Port of ``gsl_tpu/training/mcmc.py``, which is plain JAX in that package,
so plain torch here:

- every 100 steps in (500, 25000): dead (opacity <= 0.005) Gaussians are
  relocated onto alive ones sampled in proportion to their opacity; then
  the population grows 5% (up to cap_max) the same way, into free slots;
- relocation correction: a target drawn k times is split into N = k + 1
  copies, o_new = 1 - (1 - o_old)^(1/N) and
  s_new = s_old * o_old / denom(N, o_new), with
    denom(N, o) = sum_{k=0}^{N-1} (-1)^k / sqrt(k+1) * C(N, k+1) * o^(k+1)
  (N clamped to 51);
- after every optimizer step the means get covariance-shaped noise
  Sigma @ eps * sigmoid(100 ((1 - op) - 0.995)) * noise_lr *
  current_means_lr, so only nearly transparent Gaussians (op below about
  0.005) move by much. This is the gate of the published 3DGS-MCMC code
  and of gsplat (`op_sigmoid(1 - opacities)`). gsl_tpu gates with
  sigmoid(-100 (op - 0.995)), which is about 1 for every Gaussian below
  0.99 opacity: at noise_lr 5e5 its fits scatter the scene, and the port
  does not copy it;
- the loss adds 0.01 mean|opacity| + 0.01 mean|scale| (`MCMCMetricsConfig`,
  computed in `Trainer.render_losses`).

The JAX package draws `cap` categorical samples a round, whatever the
need; the port draws exactly one per dead row, then one per new row. Dead
and free slots are taken in ascending slot order, as gsl_tpu's stable
sorts give them. A round on the card gives the same state twice from the
same generator state: the draws search an int64 cumulative sum of the
weights in units of 2^-24 (``torch.multinomial`` sums them in float32 in
an order that varies between runs on the card, and so do its draws), the
relocation writes distinct rows, and ``bincount`` counts exactly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.gaussian import GaussianParams, GaussianState, inverse_sigmoid
from ..ops.transforms import build_cov3d, normalize_quat
from .optimizers import AdamState, zero_opt_state_rows

N_MAX = 51


@dataclasses.dataclass
class MCMCDensityControllerConfig:
    cap_max: int = 1_000_000
    noise_lr: float = 5e5
    densify_from_iter: int = 500
    densify_until_iter: int = 25_000
    densification_interval: int = 100
    min_opacity: float = 0.005
    grow_factor: float = 1.05

    def instantiate(self):
        return self


_BINOMS = {}


def _binom_table(device) -> torch.Tensor:
    """C(N, k+1) for N in [0, N_MAX], k in [0, N_MAX-1], float32."""
    key = str(device)
    if key not in _BINOMS:
        _BINOMS[key] = torch.tensor(
            [[math.comb(n, k + 1) for k in range(N_MAX)]
             for n in range(N_MAX + 1)], dtype=torch.float32, device=device)
    return _BINOMS[key]


def relocation_correction(o_old: torch.Tensor, s_old: torch.Tensor,
                          n: torch.Tensor):
    """o_old [m], s_old [m, 3], n [m] int (clamped to [1, N_MAX]).
    Returns (o_new [m], s_new [m, 3]), float32."""
    n = torch.clamp(n, 1, N_MAX).to(torch.int64)
    nf = n.to(torch.float32)
    o_new = 1.0 - torch.pow(torch.clamp(1.0 - o_old, min=1e-12), 1.0 / nf)

    k = torch.arange(N_MAX, dtype=torch.float32, device=o_old.device)
    sign = torch.pow(-1.0, k)
    inv_sqrt = 1.0 / torch.sqrt(k + 1.0)
    powers = torch.pow(o_new[:, None], k[None, :] + 1.0)     # [m, K]
    cnk = _binom_table(o_old.device)[n]                      # C(N, k+1)
    denom = torch.sum(sign[None, :] * inv_sqrt[None, :] * cnk * powers,
                      dim=-1)
    coeff = o_old / torch.clamp(denom, min=1e-12)
    return o_new, s_old * coeff[:, None]


def dead_mask(gstate: GaussianState,
              cfg: MCMCDensityControllerConfig) -> torch.Tensor:
    """[CAP] the alive rows at or below the relocation's opacity."""
    op = torch.sigmoid(gstate.params.opacities[:, 0]) * gstate.alive
    return gstate.alive & (op <= cfg.min_opacity)


def grow_target(n_alive: int, cfg: MCMCDensityControllerConfig) -> int:
    """The alive count a round grows to: min(cap_max, grow_factor *
    n_alive), the product taken in float32 and truncated, as gsl_tpu
    computes it."""
    grown = np.float32(cfg.grow_factor) * np.float32(n_alive)
    return min(int(cfg.cap_max), int(grown))


def _draw(sample, probs: torch.Tensor, n: int, given: Optional[torch.Tensor]
          ) -> torch.Tensor:
    """n slot indices drawn in proportion to `probs` in [0, 1] (with
    replacement), or the `given` ones. The weights are rounded to units of
    2^-24 (a share of at most 1.2e-5 of an opacity above 0.005) and summed
    as integers, which is exact in any order."""
    if given is not None:
        if given.numel() != n:
            raise ValueError(f"{given.numel()} draws given, {n} needed")
        return given.to(device=probs.device, dtype=torch.int64)
    cdf = torch.cumsum(torch.round(probs * 2.0 ** 24).to(torch.int64), 0)
    u = torch.randint(int(cdf[-1]), (n,), generator=sample,
                      device=probs.device)
    return torch.searchsorted(cdf, u, right=True)


def _relocate(params: GaussianParams, dest: torch.Tensor,
              targets: torch.Tensor) -> Tuple[GaussianParams, torch.Tensor]:
    """Rows `dest` become copies of rows `targets` (disjoint from them);
    every target drawn k times, and its copies, take the opacity and
    scales corrected for N = k + 1. Returns (params, touched rows)."""
    cap = params.capacity
    counts = torch.bincount(targets, minlength=cap)
    tg = torch.nonzero(counts).squeeze(1)
    o_new, s_new = relocation_correction(
        torch.sigmoid(params.opacities[tg, 0]), torch.exp(params.scales[tg]),
        counts[tg] + 1)
    opacities = params.opacities.clone()
    opacities[tg, 0] = inverse_sigmoid(torch.clamp(o_new, 0.005, 1.0 - 1e-7))
    scales = params.scales.clone()
    scales[tg] = torch.log(torch.clamp(s_new, min=1e-12))
    corrected = dataclasses.replace(params, opacities=opacities,
                                    scales=scales)
    moved = corrected.map(lambda _, x: x.index_put((dest,), x[targets]))
    touched = torch.zeros(cap, dtype=torch.bool, device=dest.device)
    touched[dest] = True
    touched[tg] = True
    return moved, touched


def mcmc_densify(sample, gstate: GaussianState, opt_state: AdamState,
                 cfg: MCMCDensityControllerConfig
                 ) -> Tuple[GaussianState, AdamState, int]:
    """Relocate the dead rows, then grow into free slots. `sample` is a
    ``torch.Generator`` on the state's device (None: the default one), or
    the draws themselves: a pair (targets of the dead rows [n_dead], in
    ascending slot order; targets of the new rows [n_new], in the order
    the free slots fill). Growth stops at the free slots, as gsl_tpu's
    does: the fit grows the capacity before a round that needs more
    (`MCMCDensityHook`). Returns (state, opt_state, n_new). `extra` passes
    through unchanged, as gsl_tpu passes it."""
    given1, given2 = sample if isinstance(sample, (tuple, list)) \
        else (None, None)
    generator = None if isinstance(sample, (tuple, list)) else sample
    params, alive = gstate.params, gstate.alive
    touched = torch.zeros_like(alive)

    # ---- phase 1: relocate the dead rows onto alive ones ----
    op_act = torch.sigmoid(params.opacities[:, 0]) * alive
    dead = dead_mask(gstate, cfg)
    probs = torch.where(alive & ~dead, op_act, torch.zeros_like(op_act))
    dead_idx = torch.nonzero(dead).squeeze(1)
    # no alive row above the cut: nothing to relocate onto
    if dead_idx.numel() > 0 and bool(probs.sum() > 0):
        draws = _draw(generator, probs, dead_idx.numel(), given1)
        params, touched = _relocate(params, dead_idx, draws)

    # ---- phase 2: grow into free slots ----
    n_alive = int(alive.sum())
    free = torch.nonzero(~alive).squeeze(1)
    n_new = max(0, min(grow_target(n_alive, cfg) - n_alive, free.numel()))
    if n_new > 0:
        # the opacities after phase 1, over the rows alive before it
        op2 = torch.sigmoid(params.opacities[:, 0]) * alive
        probs2 = torch.where(alive, op2, torch.zeros_like(op2))
        draws = _draw(generator, probs2, n_new, given2)
        dest = free[:n_new]
        params, touched2 = _relocate(params, dest, draws)
        touched = touched | touched2
        alive = alive.clone()
        alive[dest] = True

    opt_state = zero_opt_state_rows(opt_state, touched)
    return (GaussianState(params=params, alive=alive, extra=gstate.extra),
            opt_state, n_new)


def mcmc_noise_step(sample, gstate: GaussianState, means_lr,
                    noise_lr: float = 5e5) -> GaussianState:
    """Post-step position noise: means += Sigma @ eps * sigmoid(100
    ((1 - op) - 0.995)) * noise_lr * means_lr, on alive rows. `sample`: a
    ``torch.Generator`` (None: the default one) that draws eps, or eps
    itself [CAP, 3]."""
    p = gstate.params
    op = torch.sigmoid(p.opacities[:, 0])
    gate = torch.sigmoid(100.0 * ((1.0 - op) - 0.995))
    if isinstance(sample, torch.Tensor):
        eps = sample.to(p.means)
    else:
        eps = torch.randn(p.means.shape, generator=sample,
                          dtype=p.means.dtype, device=p.means.device)
    cov = build_cov3d(torch.exp(p.scales), normalize_quat(p.rotations))
    noise = (cov * eps[:, None, :]).sum(-1)
    noise = noise * (gate * noise_lr * means_lr)[:, None]
    noise = torch.where(gstate.alive[:, None], noise,
                        torch.zeros_like(noise))
    return GaussianState(params=dataclasses.replace(p, means=p.means + noise),
                         alive=gstate.alive, extra=gstate.extra)
