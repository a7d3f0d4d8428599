"""Adam over the Gaussian parameters and over the variants' tensors.

Port of ``gsl_tpu/training/optimizers.py``. `GaussianAdam` is
``build_gaussian_optimizer``: one Adam per property (b1 0.9, b2 0.999, eps
1e-15), the means' rate decayed exponentially and scaled by the scene
extent, the appearance features' at 2e-3 and PVG's three properties at
1e-3. `TensorAdam` is ``optax.adam``
over a dict of named tensors (a network's weights, an output processor's
grids). The arithmetic is optax's:

    mu  = b1 mu + (1 - b1) g          nu = b2 nu + (1 - b2) g^2
    p  += -lr(count) * (mu / (1 - b1^(count+1)))
                     / (sqrt(nu / (1 - b2^(count+1))) + eps)

with the schedule evaluated at the count before the increment. The
moments are `[CAP, ...]` tensors per property, so optimizer-state surgery
at densification is row edits (`zero_opt_state_rows`, `grow_opt_state`,
`zero_opacity_opt_state`). Every function returns new tensors and leaves
its arguments as they were, so a caller can keep a snapshot.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Union

import torch

from ..models.gaussian import GaussianParams, OptimizationConfig
from .schedulers import exponential_decay

B1, B2 = 0.9, 0.999
# gsl_tpu's build_gaussian_optimizer takes this rate, whatever the model's
# appearance_feature_lr_init says
APPEARANCE_FEATURE_LR = 2e-3
# gsl_tpu's one Adam of PVG's properties: Trainer.setup passes no rate, so
# build_gaussian_optimizer's default, whatever PVGConfig.pvg_lr says
PVG_LR = 1e-3
PVG_FIELDS = ("t_centers", "t_scales", "velocities")


def adam_moments(g, mu, nu, t: int, lr: float, eps: float):
    """One optax Adam step of one tensor at update number `t` (1-based):
    -> (update, mu, nu)."""
    # the bias corrections in float32, as optax computes them: at t = 1,
    # 1 - 0.999 differs by 1e-5 relative between float32 and float64,
    # which the square root would hand on to the update
    c1 = float(1.0 - torch.tensor(B1, dtype=torch.float32) ** t)
    c2 = float(1.0 - torch.tensor(B2, dtype=torch.float32) ** t)
    mu = B1 * mu + (1.0 - B1) * g
    nu = B2 * nu + (1.0 - B2) * (g * g)
    return (mu / c1) / (torch.sqrt(nu / c2) + eps) * -lr, mu, nu


@dataclasses.dataclass
class AdamState:
    exp_avg: Dict[str, torch.Tensor]      # per property, [CAP, ...]
    exp_avg_sq: Dict[str, torch.Tensor]
    count: int = 0                        # updates of every property
    solo_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    """updates a property took alone, beyond `count` (the similarity
    regulariser's step on the appearance features; optax keeps one count
    per property)"""

    def count_of(self, name: str) -> int:
        return self.count + self.solo_counts.get(name, 0)


class GaussianAdam:
    def __init__(self, opt_cfg: OptimizationConfig,
                 spatial_lr_scale: float):
        scale = (opt_cfg.spatial_lr_scale
                 if opt_cfg.spatial_lr_scale > 0 else spatial_lr_scale)
        self.eps = opt_cfg.eps
        # a property's own eps where its Adam is not this one's (Glossy's
        # metalness takes optax.adam's)
        self.eps_of: Dict[str, float] = {}
        means_schedule = exponential_decay(
            lr_init=opt_cfg.means_lr_init * scale,
            lr_final=(opt_cfg.means_lr_init * opt_cfg.means_lr_final_factor
                      * scale),
            max_steps=opt_cfg.means_lr_max_steps)
        self.learning_rates = {
            "means": means_schedule,
            "scales": opt_cfg.scales_lr,
            "rotations": opt_cfg.rotations_lr,
            "opacities": opt_cfg.opacities_lr,
            "shs_dc": opt_cfg.shs_dc_lr,
            "shs_rest": opt_cfg.shs_dc_lr / opt_cfg.shs_rest_lr_div,
            "appearance_features": APPEARANCE_FEATURE_LR,
            **{k: PVG_LR for k in PVG_FIELDS},
        }

    def learning_rate(self, name: str, count: int) -> float:
        lr = self.learning_rates[name]
        return float(lr(count)) if callable(lr) else float(lr)

    def init(self, params: GaussianParams) -> AdamState:
        def zeros():
            return {k: torch.zeros_like(getattr(params, k))
                    for k in params.fields()}
        return AdamState(exp_avg=zeros(), exp_avg_sq=zeros(), count=0)

    def update(self, grads: GaussianParams, state: AdamState,
               only: Optional[Sequence[str]] = None):
        """-> (updates to add to the parameters, the new state). With
        `only`, those properties step alone: the others' updates are zero
        and their moments and counts stay as they were."""
        names = grads.fields() if only is None else tuple(only)
        exp_avg, exp_avg_sq = dict(state.exp_avg), dict(state.exp_avg_sq)
        updates = {k: torch.zeros_like(getattr(grads, k))
                   for k in grads.fields()}
        for k in names:
            n = state.count_of(k)
            updates[k], exp_avg[k], exp_avg_sq[k] = adam_moments(
                getattr(grads, k), state.exp_avg[k], state.exp_avg_sq[k],
                n + 1, self.learning_rate(k, n), self.eps_of.get(k, self.eps))
        if only is None:
            count, solo = state.count + 1, dict(state.solo_counts)
        else:
            count = state.count
            solo = {**state.solo_counts,
                    **{k: state.solo_counts.get(k, 0) + 1 for k in names}}
        return (GaussianParams(**updates),
                AdamState(exp_avg=exp_avg, exp_avg_sq=exp_avg_sq,
                          count=count, solo_counts=solo))


class TensorAdam:
    """``optax.adam`` over a dict of named tensors. `learning_rate` is a
    number, or a function of (name, count) for rates that differ between
    tensors or follow a schedule. The state is a plain dict
    {"exp_avg", "exp_avg_sq", "count"}, so it rides in `TrainState.extra`
    and in checkpoints."""

    def __init__(self, learning_rate: Union[float, Callable[[str, int],
                                                            float]],
                 eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.eps = eps

    def lr(self, name: str, count: int) -> float:
        lr = self.learning_rate
        return float(lr(name, count)) if callable(lr) else float(lr)

    @staticmethod
    def init(params: Dict[str, torch.Tensor]) -> dict:
        return {"exp_avg": {k: torch.zeros_like(v)
                            for k, v in params.items()},
                "exp_avg_sq": {k: torch.zeros_like(v)
                               for k, v in params.items()},
                "count": 0}

    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state: dict):
        """-> (the stepped parameters, the new state)."""
        n = state["count"]
        new, exp_avg, exp_avg_sq = {}, {}, {}
        for k, p in params.items():
            u, exp_avg[k], exp_avg_sq[k] = adam_moments(
                grads[k], state["exp_avg"][k], state["exp_avg_sq"][k],
                n + 1, self.lr(k, n), self.eps)
            new[k] = p + u
        return new, {"exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq,
                     "count": n + 1}


def _map_moments(state: AdamState, fn) -> AdamState:
    return AdamState(
        exp_avg={k: fn(k, v) for k, v in state.exp_avg.items()},
        exp_avg_sq={k: fn(k, v) for k, v in state.exp_avg_sq.items()},
        count=state.count, solo_counts=dict(state.solo_counts))


def zero_opt_state_rows(state: AdamState, row_mask: torch.Tensor
                        ) -> AdamState:
    """Zero both moments of every property in the rows where `row_mask`
    [CAP] is True (rows that were replaced by densification or pruned)."""
    def fix(_, leaf):
        m = row_mask.reshape((-1,) + (1,) * (leaf.ndim - 1))
        # where, not multiply: a NaN moment times 0 stays NaN
        return torch.where(m, torch.zeros_like(leaf), leaf)

    return _map_moments(state, fix)


def grow_opt_state(state: AdamState, new_capacity: int) -> AdamState:
    """Carry the moments and the count across a capacity growth: the new
    rows start at zero, the schedule goes on where it was."""
    def fix(_, leaf):
        extra = new_capacity - leaf.shape[0]
        if extra <= 0:
            return leaf
        return torch.cat([leaf, torch.zeros(
            (extra,) + leaf.shape[1:], dtype=leaf.dtype,
            device=leaf.device)])

    return _map_moments(state, fix)


def zero_opacity_opt_state(state: AdamState) -> AdamState:
    """Zero the moments of the `opacities` property only."""
    return _map_moments(
        state, lambda k, leaf: (torch.zeros_like(leaf) if k == "opacities"
                                else leaf))


def selective_adam_update(updates: GaussianParams, visible: torch.Tensor
                          ) -> GaussianParams:
    """Visibility-gated updates: zero the update rows of Gaussians that hit
    no pixel this step."""
    keep = visible.to(torch.float32)
    return updates.map(
        lambda _, u: u * keep.reshape((-1,) + (1,) * (u.ndim - 1)))
