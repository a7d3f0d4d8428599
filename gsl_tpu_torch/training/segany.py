"""Segment-Anything feature distillation (SegAny splatting), a second
stage on a frozen scene.

Port of ``gsl_tpu/training/segany.py``: each Gaussian gains a feature
vector; feature maps rendered with the scene's geometry frozen are
trained so that sampled pixel pairs under a common SAM mask agree (cosine
similarity -> 1) and pairs under different masks do not (similarity
pushed below 0.5), each pair weighted by its pixels' mean mask size, with
a smooth scale gate over the feature dimensions.

The feature maps go through K1-K4 (`ops/rasterize.py`) at C =
`feature_dims` (32 by default), which the backward kernels take in
channel groups. `render_features` accepts gsl_tpu's `isect_capacity`,
`max_per_tile` and `chunk` and ignores them: those are the XLA path's
static buffer sizes, and at ~2.6M slots (1M Gaussians, 1080p) gsl_tpu's
defaults of 2^18 slots and 1024 a tile would drop most intersections;
the port sizes its slot buffers per call. `correspondence_loss` reads
neither `mask_scales` (as gsl_tpu's does not) nor a key: it takes the
sampled pixels, which `sample_pixels` draws from a generator.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..data.cameras import Cameras
from ..models.gaussian import GaussianState
from ..ops.projection import project_gaussians
from ..ops.rasterize import rasterize
from ..utils.device import float32_math
from .optimizers import TensorAdam

OPTAX_EPS = 1e-8          # optax.adam's


@dataclasses.dataclass
class SegAnyConfig:
    feature_dims: int = 32
    scale_aware: bool = True
    n_sampled_pixels: int = 1024
    feature_lr: float = 5e-3
    smooth_k: int = 16

    def instantiate(self):
        return self


def init_features(capacity: int, dims: int, device=None,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """[capacity, dims] N(0, 0.02^2) drawn on the CPU from `generator`."""
    return (torch.randn((capacity, dims), generator=generator) * 0.02).to(
        device)


def scale_gate(features: torch.Tensor, scale) -> torch.Tensor:
    """Larger query scales enable higher feature dimensions: dimension i
    of D is weighted by sigmoid(16 (scale - i / D))."""
    d = features.shape[-1]
    idx = torch.arange(d, dtype=torch.float32, device=features.device) / d
    return features * torch.sigmoid((scale - idx) * 16.0)


def render_features(gstate: GaussianState, features: torch.Tensor,
                    camera: Cameras, img_height: int, img_width: int,
                    tile_size: int = 16, isect_capacity: int = 1 << 18,
                    max_per_tile: int = 1024, chunk: int = 64
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel features [H, W, D] and alpha [H, W] with the geometry
    frozen: the projection and the opacities (times the compensations)
    carry no gradient, the features do; no background. `isect_capacity`,
    `max_per_tile` and `chunk` are gsl_tpu's XLA buffer sizes, accepted and
    ignored."""
    del isect_capacity, max_per_tile, chunk
    with torch.no_grad(), float32_math():
        proj = project_gaussians(
            gstate.get_means(), gstate.get_scales(), gstate.get_rotations(),
            camera.world_to_camera, camera.fx, camera.fy, camera.cx,
            camera.cy, img_width, img_height)
        op = gstate.get_opacities() * proj.compensations
    fmap, alpha, _ = rasterize(proj, op, features, img_height, img_width,
                               tile_size)
    return fmap, alpha


def sample_pixels(n: int, img_height: int, img_width: int, device=None,
                  generator: Optional[torch.Generator] = None):
    """(ys, xs) [n] int64, uniform over the rows and the columns."""
    ys = torch.randint(0, img_height, (n,), generator=generator,
                       device=device)
    xs = torch.randint(0, img_width, (n,), generator=generator,
                       device=device)
    return ys, xs


def correspondence_loss(feature_map: torch.Tensor, sam_masks: torch.Tensor,
                        mask_scales: torch.Tensor, ys: torch.Tensor,
                        xs: torch.Tensor, scale=None) -> torch.Tensor:
    """feature_map [H, W, D]; sam_masks [M, H, W] bool; mask_scales [M]
    (not read, as in gsl_tpu); ys, xs [S] the sampled pixels. Pulls the
    normalised features of pixel pairs that share a mask together and
    pushes the others below a similarity of 0.5, each pair weighted by
    1 / sqrt(mean mask size) of both its pixels, pairs with an unmasked
    pixel left out. The masks are read at the samples and summed as bool:
    no float copy of all M masks."""
    del mask_scales
    feats = feature_map[ys, xs]                            # [S, D]
    if scale is not None:
        feats = scale_gate(feats, scale)
    # eps inside the square root: the norm's gradient at zero features
    # stays finite
    feats = feats * torch.rsqrt(torch.sum(feats * feats, -1, keepdim=True)
                                + 1e-8)
    pix_masks = sam_masks[:, ys, xs].T.to(torch.float32)   # [S, M]
    masked_at_all = pix_masks.sum(-1) > 0
    share = (pix_masks @ pix_masks.T) > 0                  # [S, S]
    sim = feats @ feats.T
    mask_sizes = sam_masks.sum(dim=(1, 2)).to(torch.float32)   # [M]
    per_pix_mean_size = (pix_masks @ mask_sizes) / torch.clamp(
        pix_masks.sum(-1), min=1e-9)
    wgt = 1.0 / torch.sqrt(torch.clamp(per_pix_mean_size, min=1.0))
    pair_w = (wgt[:, None] * wgt[None, :]
              * (masked_at_all[:, None] & masked_at_all[None, :]))
    pull = (1.0 - sim) * share
    push = torch.clamp(sim - 0.5, min=0.0) * (~share)
    return torch.sum((pull + push) * pair_w) / torch.clamp(pair_w.sum(),
                                                          min=1e-8)


class SegAnyTrainer:
    """Distils per-Gaussian features on the frozen scene `gstate`, with
    Adam (optax's eps) at `feature_lr`."""

    def __init__(self, config: SegAnyConfig, gstate: GaussianState):
        self.config = config
        self.gstate = gstate
        self.tx = TensorAdam(config.feature_lr, eps=OPTAX_EPS)

    def init(self, generator: Optional[torch.Generator] = None,
             features: Optional[torch.Tensor] = None):
        """-> (features, Adam state); `features` where given (gsl_tpu's
        draws), else drawn from `generator`."""
        if features is None:
            features = init_features(self.gstate.capacity,
                                     self.config.feature_dims,
                                     generator=generator)
        features = torch.as_tensor(features, dtype=torch.float32).to(
            self.gstate.device)
        return features, TensorAdam.init({"features": features})

    def train_step(self, features, opt_state, camera, sam_masks,
                   mask_scales, query_scale, img_height: int,
                   img_width: int, generator=None, pixels=None,
                   **render_kwargs):
        """One Adam step of the features on one view: -> (features, Adam
        state, loss). `pixels` (ys, xs), or `n_sampled_pixels` drawn from
        `generator`."""
        cfg = self.config
        if pixels is None:
            pixels = sample_pixels(cfg.n_sampled_pixels, img_height,
                                   img_width, features.device, generator)
        leaf = features.detach().requires_grad_(True)
        with float32_math():
            fmap, _ = render_features(self.gstate, leaf, camera, img_height,
                                      img_width, **render_kwargs)
            loss = correspondence_loss(
                fmap, sam_masks, mask_scales, *pixels,
                scale=query_scale if cfg.scale_aware else None)
            (grad,) = torch.autograd.grad(loss, [leaf])
        with torch.no_grad():
            new, opt_state = self.tx.update({"features": features},
                                            {"features": grad}, opt_state)
        return new["features"], opt_state, loss.detach()
