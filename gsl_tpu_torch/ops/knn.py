"""Chunked brute-force k-nearest-neighbour distances.

Port of ``gsl_tpu/ops/knn.py``: the mean squared distance to the 3 nearest
neighbours, used once at initialization for the initial scales, and the k
nearest rows of a point set, which the appearance-feature similarity
regulariser samples. Brute force over chunks of queries; the distance
matrix of a chunk is one matrix product.
"""
from __future__ import annotations

import torch

from ..utils.device import float32_math


def mean_sq_dist_to_knn(points: torch.Tensor, k: int = 3,
                        chunk: int = 512) -> torch.Tensor:
    """points [N, 3] -> [N] mean squared distance to the k nearest
    neighbours (excluding self)."""
    n = points.shape[0]
    if n <= 1:
        return torch.full((n,), 1e-4, dtype=points.dtype,
                          device=points.device)
    k_eff = min(k + 1, n)
    sq = torch.sum(points * points, dim=-1)
    out = []
    with float32_math():
        for q in torch.split(points, chunk):
            d2 = (torch.sum(q * q, dim=-1)[:, None] + sq[None, :]
                  - 2.0 * (q @ points.T))
            d2 = torch.clamp(d2, min=0.0)
            # the smallest entry is the point itself: take k + 1, drop it
            knn = torch.topk(d2, k_eff, dim=-1, largest=False).values[:, 1:]
            out.append(knn.mean(dim=-1))
    return torch.cat(out)


def knn_indices(queries: torch.Tensor, points: torch.Tensor, k: int,
                chunk: int = 512):
    """queries [M, 3] -> (idx [M, k], d2 [M, k]): the k nearest rows of
    `points` and their squared distances, nearest first (pytorch3d
    knn_points; port of ``knn_indices`` in ``gsl_tpu/ops/knn.py``)."""
    sq = torch.sum(points * points, dim=-1)
    idx, d2 = [], []
    with float32_math():
        for q in torch.split(queries, chunk):
            d = (torch.sum(q * q, dim=-1)[:, None] + sq[None, :]
                 - 2.0 * (q @ points.T))
            d = torch.clamp(d, min=0.0)
            top = torch.topk(d, k, dim=-1, largest=False)
            idx.append(top.indices)
            d2.append(top.values)
    return torch.cat(idx), torch.cat(d2)
