"""Appearance embeddings with learned per-pixel visibility maps (Ha-NeRF).

Port of ``gsl_tpu/training/visibility_map_trainer.py``: per image, the
pixel's (u, v) through a multi-level grid encoding, with a transient
embedding of the image, feed a small MLP that predicts the pixel's
visibility in [0, 1]. The photometric loss runs on (vis * render,
vis * gt), plus 0.2 * mean((1 - vis)^2), so the map discounts only
pixels the scene cannot explain (passers-by). Two encodings:
- ``dense``: one set of 2D grids per image ([n_images, res, res, 2] for
  res 16, 32, 64, 128);
- ``hash``: one multi-resolution hash grid over (u, v, image), the
  image's index as a third coordinate, (i + 0.5) / n_images; its three
  finer tables have 2^19 rows each.

The visibility network's weights and its Adam (lr 1e-3, optax's eps
1e-8) ride in ``TrainState.extra["__vis__"]``, beside the appearance
network's ``__net__``; neither is a per-Gaussian entry, whatever its row
count, so densification and growth leave both as they are. The network
trains from the first step, through the warm-up too.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.func import functional_call

from ..data.cameras import Cameras
from ..models.encodings import (DenseGrid2DEncoding, HashGridEncoding,
                                SkipMLP, embedding)
from .appearance_trainer import (AppearanceTrainer, leaves_of,
                                 n_appearances_of, network_state,
                                 step_network)
from .metrics import train_loss
from .optimizers import TensorAdam
from .trainer import TrainState


class VisibilityNetwork(nn.Module):
    """(uv [..., 2] in [0, 1], image index) -> visibility [...]."""

    def __init__(self, n_images: int, n_transient_embedding_dims: int = 16,
                 n_levels: int = 4, base_resolution: int = 16,
                 per_level_scale: float = 2.0, n_layers: int = 3,
                 n_neurons: int = 64, grid_type: str = "dense",
                 log2_hashmap_size: int = 19, max_resolution: int = 2048,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if grid_type not in ("dense", "hash"):
            raise ValueError(f"grid_type {grid_type!r}: dense or hash")
        self.n_images, self.grid_type = n_images, grid_type
        if grid_type == "hash":
            self.encoding = HashGridEncoding(
                n_input_dims=3, n_levels=n_levels,
                base_resolution=base_resolution,
                log2_hashmap_size=log2_hashmap_size,
                max_resolution=max_resolution, generator=generator)
        else:
            self.encoding = DenseGrid2DEncoding(
                n_levels=n_levels, base_resolution=base_resolution,
                per_level_scale=per_level_scale, n_instances=n_images,
                generator=generator)
        self.embedding = embedding(n_images, n_transient_embedding_dims,
                                   generator)
        self.mlp = SkipMLP(
            self.encoding.n_output_dims + n_transient_embedding_dims, 1,
            n_layers=n_layers, n_neurons=n_neurons, generator=generator)

    def forward(self, uv: torch.Tensor, image_idx) -> torch.Tensor:
        image_idx = torch.as_tensor(image_idx, device=uv.device).to(
            torch.int64)
        if self.grid_type == "hash":
            idx_n = (image_idx.to(torch.float32) + 0.5) / self.n_images
            x3 = torch.cat([uv, idx_n.expand(uv.shape[:-1])[..., None]],
                           dim=-1)
            enc = self.encoding(x3)
        else:
            enc = self.encoding(uv, image_idx)
        emb = self.embedding(image_idx)
        emb = emb.expand(enc.shape[:-1] + emb.shape[-1:])
        return self.mlp(torch.cat([enc, emb], dim=-1))[..., 0]


def pixel_uv(height: int, width: int, device) -> torch.Tensor:
    """[H, W, 2] pixel coordinates, (x / (W - 1), y / (H - 1))."""
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device),
                            indexing="ij")
    return torch.stack([xs / max(width - 1, 1), ys / max(height - 1, 1)],
                       dim=-1).to(torch.float32)


class VisibilityMapAppearanceTrainer(AppearanceTrainer):
    """AppearanceTrainer with learned per-pixel visibility. `n_images`
    None sizes the network from the data as `n_appearances` is sized
    (gsl_tpu fixes 1024, and past it its gather clamps the index)."""

    def __init__(self, *args, vis_reg_factor: float = 0.2,
                 vis_lr: float = 1e-3, n_images: Optional[int] = None,
                 grid_type: str = "dense", **kwargs):
        super().__init__(*args, **kwargs)
        self.vis_reg_factor = vis_reg_factor
        self.n_images = n_images
        self.grid_type = grid_type
        self.vis_tx = TensorAdam(vis_lr, eps=1e-8)
        self.vis_net: Optional[VisibilityNetwork] = None

    def size_from_data(self, outputs) -> None:
        super().size_from_data(outputs)
        if self.n_images is None:
            self.n_images = n_appearances_of(outputs)

    def setup(self, gaussians, cameras_extent, prune_extent=None):
        if self.n_images is None:
            raise ValueError(
                "VisibilityMapAppearanceTrainer: n_images is not set; pass "
                "it, or call size_from_data(outputs) before setup")
        state = super().setup(gaussians, cameras_extent, prune_extent)
        self.vis_net = VisibilityNetwork(
            self.n_images, grid_type=self.grid_type,
            generator=torch.Generator().manual_seed(1))
        return dataclasses.replace(state, extra=dict(
            state.extra, __vis__=network_state(self.vis_net, self.vis_tx,
                                               gaussians.device)))

    def train_step_appearance(self, state: TrainState, camera: Cameras,
                              gt_image: torch.Tensor, img_height: int,
                              img_width: int, sh_degree: int,
                              bg_color: torch.Tensor, warm_up: bool,
                              mask: Optional[torch.Tensor] = None):
        H, W = img_height, img_width
        net, vis_state = state.extra["__net__"], state.extra["__vis__"]
        net_leaves = leaves_of(net, not warm_up)
        vis_leaves = leaves_of(vis_state, True)
        uv = pixel_uv(H, W, state.alive.device).reshape(-1, 2)

        def loss_of(gstate, tap, abstap):
            out, op_offset = self.render_appearance(
                gstate, camera, H, W, bg_color, sh_degree, tap, net_leaves,
                warm_up)
            vis = functional_call(self.vis_net, vis_leaves, (
                uv, camera.appearance_id)).reshape(H, W)
            vmask = vis if mask is None else vis * mask
            loss, scalars = train_loss(
                out.render * vmask[..., None], gt_image * vmask[..., None],
                None, lambda_dssim=self.metrics_cfg.lambda_dssim,
                rgb_diff_loss=self.metrics_cfg.rgb_diff_loss)
            vis_reg = self.vis_reg_factor * torch.mean((1.0 - vis) ** 2)
            loss = loss + vis_reg
            if op_offset is not None:
                loss = loss + 0.05 * torch.mean(op_offset)
            scalars = dict(scalars, vis_reg=vis_reg, vis_mean=torch.mean(vis))
            return loss, (scalars, out.radii, out.n_dropped)

        others = ([] if warm_up else list(net_leaves.values())) \
            + list(vis_leaves.values())
        pgrads, tap_grad, grads, _, (scalars, radii, n_dropped) = \
            self.gradients(state, loss_of, others)
        params, opt_state, density = self.apply_gradients(
            state, pgrads, tap_grad, radii, W, H)
        extra = dict(state.extra)
        if not warm_up:
            extra["__net__"] = step_network(self.net_tx, net,
                                            grads[:len(net_leaves)])
            grads = grads[len(net_leaves):]
        extra["__vis__"] = step_network(self.vis_tx, vis_state, grads)
        scalars = {k: v.detach() for k, v in scalars.items()}
        scalars["n_dropped_isects"] = n_dropped
        return TrainState(params=params, alive=state.alive,
                          opt_state=opt_state, density=density,
                          step=state.step + 1, extra=extra), scalars
