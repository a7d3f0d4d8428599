"""Feature 3DGS: per-Gaussian semantic features distilled from teacher
maps, a second stage on a frozen scene.

Port of ``gsl_tpu/training/feature3dgs.py``: a frozen trained scene gains
a feature vector per Gaussian; the rendered feature map (K1-K4 at C =
`actual_dims`: 128, or 64 with `speedup`), decoded by a 1 x 1 convolution
under `speedup`, and resized bilinearly to the teacher's size
(`ops/resize.py`), is held to the teacher map by an L1 loss. Adam (optax's
eps) at `feature_lr`, and at `feature_decoder_lr` for the decoder. Text
queries reduce to `selection_score` over embeddings encoded elsewhere.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models.gaussian import GaussianState
from ..ops.resize import resize
from ..utils.device import float32_math
from .optimizers import TensorAdam
from .segany import render_features

OPTAX_EPS = 1e-8          # optax.adam's
DECODER = ("dec_w", "dec_b")


@dataclasses.dataclass
class Feature3DGSConfig:
    n_feature_dims: int = 128          # teacher dims (SAM 256, LSeg 512)
    speedup: bool = False              # store half dims + 1x1 conv decoder
    feature_lr: float = 1e-3
    feature_decoder_lr: float = 1e-4
    isect_capacity: int = 1 << 18      # gsl_tpu's XLA buffer, ignored

    @property
    def actual_dims(self) -> int:
        return (self.n_feature_dims // 2 if self.speedup
                else self.n_feature_dims)

    def instantiate(self):
        return self


def init_feature_state(capacity: int, cfg: Feature3DGSConfig, device=None,
                       generator: Optional[torch.Generator] = None,
                       dec_w=None) -> dict:
    """{"features": zeros [capacity, actual_dims]}; under `speedup` also
    the decoder: dec_w [d, n_feature_dims] N(0, 1/d) drawn on the CPU from
    `generator` (or `dec_w` where given), dec_b zeros."""
    d = cfg.actual_dims
    params = {"features": torch.zeros((capacity, d))}
    if cfg.speedup:
        if dec_w is None:
            dec_w = torch.randn((d, cfg.n_feature_dims),
                                generator=generator) / np.sqrt(d)
        params["dec_w"] = torch.as_tensor(dec_w, dtype=torch.float32)
        params["dec_b"] = torch.zeros(cfg.n_feature_dims)
    return {k: v.to(device) for k, v in params.items()}


def decode_features(params: dict, fmap: torch.Tensor) -> torch.Tensor:
    """[..., actual_dims] -> [..., n_feature_dims] (a 1 x 1 convolution is
    a matrix product); the map itself without a decoder."""
    if "dec_w" not in params:
        return fmap
    return fmap @ params["dec_w"] + params["dec_b"]


def build_optimizer(cfg: Feature3DGSConfig) -> TensorAdam:
    """Adam at `feature_lr` for the features and, under `speedup`, at
    `feature_decoder_lr` for the decoder (optax.multi_transform of two
    adams, which step together)."""
    if not cfg.speedup:
        return TensorAdam(cfg.feature_lr, eps=OPTAX_EPS)
    return TensorAdam(
        lambda name, _: (cfg.feature_decoder_lr if name in DECODER
                         else cfg.feature_lr), eps=OPTAX_EPS)


class Feature3DGSTrainer:
    """Distils teacher feature maps into per-Gaussian features on the
    frozen scene `scene`."""

    def __init__(self, cfg: Feature3DGSConfig, scene: GaussianState):
        self.cfg = cfg
        self.scene = scene
        self.tx = build_optimizer(cfg)

    def init(self, generator: Optional[torch.Generator] = None,
             dec_w=None):
        """-> (parameters, Adam state)."""
        params = init_feature_state(self.scene.capacity, self.cfg,
                                    self.scene.device, generator, dec_w)
        return params, TensorAdam.init(params)

    def train_step(self, params: dict, opt_state: dict, camera,
                   gt_feature_map: torch.Tensor, img_height: int,
                   img_width: int):
        """One step on one view: the render [H, W, actual_dims] decoded
        and resized to `gt_feature_map` [h, w, n_feature_dims], and the
        mean absolute difference. -> (parameters, Adam state, loss)."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        h, w = gt_feature_map.shape[:2]
        with float32_math():
            fmap, _ = render_features(self.scene, leaves["features"], camera,
                                      img_height, img_width)
            fmap = decode_features(leaves, fmap)
            fmap = resize(fmap, (h, w, fmap.shape[-1]))
            loss = torch.mean(torch.abs(fmap - gt_feature_map))
            names = list(leaves)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        with torch.no_grad():
            params, opt_state = self.tx.update(params, dict(zip(names, grads)),
                                               opt_state)
        return params, opt_state, loss.detach()


def selection_score(features: torch.Tensor, query_features: torch.Tensor,
                    score_threshold: Optional[float] = None,
                    positive_ids=(0,)) -> torch.Tensor:
    """Per-Gaussian query score, float32 0 / 1. features [N, D] (decoded);
    query_features [Q, D] encoded text embeddings. One query: the cosine
    similarity mapped to [0, 1], at least `score_threshold` (0.5). More:
    a softmax over the queries, then the positives' summed share at least
    `score_threshold`, or without one, the positives' sum (put in the
    first positive's place) the largest entry."""
    f = features / torch.clamp(torch.linalg.norm(features, dim=-1,
                                                 keepdim=True), min=1e-9)
    q = query_features / torch.clamp(
        torch.linalg.norm(query_features, dim=-1, keepdim=True), min=1e-9)
    scores = f @ q.T                                       # [N, Q]
    pos = torch.as_tensor(positive_ids, dtype=torch.int64,
                          device=features.device).reshape(-1)
    if scores.shape[-1] == 1:
        s = (scores[:, 0] + 1.0) / 2.0
        thr = 0.5 if score_threshold is None else score_threshold
        return (s >= thr).to(torch.float32)
    soft = torch.softmax(scores, dim=-1)
    pos_sum = torch.sum(soft[:, pos], dim=-1)
    if score_threshold is not None:
        return (pos_sum >= score_threshold).to(torch.float32)
    amended = soft.clone()
    amended[:, pos[0]] = pos_sum
    return torch.isin(torch.argmax(amended, dim=-1), pos).to(torch.float32)


def query_edit_mask(params: dict, query_features: torch.Tensor,
                    **kw) -> torch.Tensor:
    """Per-Gaussian keep-mask for text-driven extraction or deletion: the
    decoded per-Gaussian features scored against the query."""
    return selection_score(decode_features(params, params["features"]),
                           query_features, **kw)
