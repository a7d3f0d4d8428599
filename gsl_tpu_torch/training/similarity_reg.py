"""Appearance-feature kNN similarity regularisation.

Port of ``gsl_tpu/training/similarity_reg.py``: every
`similarity_reg_interval` steps, sample alive Gaussians, find each one's
k nearest neighbours (`ops.knn.knn_indices`) and penalise feature
dissimilarity within each neighbourhood, weighted by
exp(-decay * distance^2). It runs as a step of its own that moves only the
appearance features and only their Adam state (their moments and their
count), as the reference's second backward does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.knn import knn_indices
from .optimizers import GaussianAdam


@dataclasses.dataclass
class SimilarityRegConfig:
    n_appearance_samples: int = 20_480
    n_appearance_nn: int = 16
    distance_weight_decay: float = 200.0
    similarity_reg_from: int = 0
    similarity_reg_lambda: float = 0.2
    similarity_reg_interval: int = 50
    similarity_type: str = "cosine"      # "cosine" | "euclidean"

    def instantiate(self):
        return self


def similarity_loss(cfg: SimilarityRegConfig, means: torch.Tensor,
                    features: torch.Tensor, alive: torch.Tensor,
                    sample: torch.Tensor) -> torch.Tensor:
    """-lambda * the weighted mean pairwise similarity over the kNN
    neighbourhoods of the rows `sample` [S] (the upper triangle, no self
    pairs). Dead rows are moved far away, each to its own place, so no
    neighbourhood reaches them; the neighbours and weights carry no
    gradient."""
    cap = means.shape[0]
    far = torch.where(alive[:, None], means.detach(),
                      1e6 + torch.arange(cap, dtype=torch.float32,
                                         device=means.device)[:, None])
    idx, d2 = knn_indices(far[sample], far, cfg.n_appearance_nn)
    w = torch.exp(-cfg.distance_weight_decay * d2)          # [S, K]
    feats = features[idx]                                   # [S, K, D]
    if cfg.similarity_type == "cosine":
        f = feats / torch.clamp(torch.linalg.norm(feats, dim=-1,
                                                  keepdim=True), min=1e-9)
        sim = torch.einsum("skd,sld->skl", f, f)
    else:
        # the diagonal distance is exactly 0: the floor keeps the square
        # root's gradient finite there
        diff = feats[:, :, None] - feats[:, None, :]
        sim = -torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1),
                                      min=1e-18))
    reg = -sim * w[:, None, :]                              # [S, K, K]
    k = cfg.n_appearance_nn
    triu = torch.triu(torch.ones((k, k), dtype=torch.bool,
                                 device=means.device), 1)
    valid = torch.where(triu[None], reg, torch.zeros_like(reg))
    n_s = sample.shape[0]
    return (torch.sum(valid) / max(int(triu.sum()) * n_s, 1)) \
        * cfg.similarity_reg_lambda


def draw_sample(cfg: SimilarityRegConfig, capacity: int,
                generator: Optional[torch.Generator], device):
    """min(n_appearance_samples, capacity) distinct rows, drawn from
    `generator` (gsl_tpu draws them with jax.random.choice)."""
    n_s = min(cfg.n_appearance_samples, capacity)
    return torch.randperm(capacity, generator=generator,
                          device=device)[:n_s]


def similarity_reg_step(cfg: SimilarityRegConfig, tx: GaussianAdam, state,
                        sample: torch.Tensor):
    """-> (state, loss): one Adam step of the appearance features on the
    regulariser's gradient; every other property, its moments and the
    shared count stay as they were."""
    feats = state.params.appearance_features.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = similarity_loss(cfg, state.params.means, feats, state.alive,
                               sample)
        (grad,) = torch.autograd.grad(loss, [feats])
    with torch.no_grad():
        grads = state.params.map(lambda k, x: (
            grad if k == "appearance_features" else torch.zeros_like(x)))
        updates, opt_state = tx.update(grads, state.opt_state,
                                       only=("appearance_features",))
        params = dataclasses.replace(
            state.params, appearance_features=(
                state.params.appearance_features
                + updates.appearance_features))
    return dataclasses.replace(state, params=params,
                               opt_state=opt_state), loss.detach()
