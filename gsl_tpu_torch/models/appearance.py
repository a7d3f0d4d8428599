"""Appearance-embedding model pieces (per-image appearance, Ha-NeRF style).

Port of ``gsl_tpu/models/appearance.py``:
- `AppearanceFeatureGaussianConfig`: a trainable feature per Gaussian
  (``GaussianParams.appearance_features``, [CAP, 64] by default), zero or
  N(0, 0.02) at init;
- `AppearanceNetwork`: an embedding per image and an MLP, (features,
  appearance id, view direction) -> offsets in [0, 1] (a fourth output,
  the opacity offset, with `with_opacity`);
- `positional_encoding` (sin / cos) and `network_lr_schedule`.

The network is a plain ``nn.Module``; the trainer keeps its weights in the
train state and applies it with ``torch.func.functional_call``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .encodings import SkipMLP, embedding
from .gaussian import GaussianState, VanillaGaussianConfig


@dataclasses.dataclass
class AppearanceFeatureGaussianConfig(VanillaGaussianConfig):
    appearance_feature_dims: int = 64
    appearance_feature_lr_init: float = 2e-3
    appearance_feature_init: str = "zero"  # zero | normal

    def init_from_pcd(self, xyz: np.ndarray, rgb: np.ndarray,
                      capacity: int, device=None) -> GaussianState:
        state = super().init_from_pcd(xyz, rgb, capacity, device)
        d = self.appearance_feature_dims
        if self.appearance_feature_init == "normal":
            feats = torch.from_numpy(np.random.RandomState(0).normal(
                0, 0.02, size=(capacity, d)).astype(np.float32))
        else:
            feats = torch.zeros((capacity, d), dtype=torch.float32)
        return dataclasses.replace(state, params=dataclasses.replace(
            state.params, appearance_features=feats.to(state.device)))


def positional_encoding(x: torch.Tensor, n_frequencies: int) -> torch.Tensor:
    """sin / cos encoding: [..., D] -> [..., 2 * D * n_frequencies]."""
    freqs = 2.0 ** torch.arange(n_frequencies, dtype=x.dtype,
                                device=x.device)
    ang = x[..., None, :] * freqs[:, None]          # [..., F, D]
    out = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return out.reshape(*x.shape[:-1], -1)


class AppearanceNetwork(SkipMLP):
    """Embedding + skip MLP: (features [N, F], appearance id, view dirs
    [N, 3]) -> sigmoid offsets [N, 3] (or [N, 4] with the opacity head).
    `n_input_features` is F, which flax reads off the first call."""

    def __init__(self, n_appearances: int, n_input_features: int,
                 n_appearance_embedding_dims: int = 32, n_neurons: int = 64,
                 n_layers: int = 3, with_opacity: bool = False,
                 is_view_dependent: bool = False,
                 n_view_direction_frequencies: int = 4,
                 skip_layers: Sequence[int] = (),
                 generator: Optional[torch.Generator] = None):
        n_in = n_input_features + n_appearance_embedding_dims
        if is_view_dependent:
            n_in += 6 * n_view_direction_frequencies
        super().__init__(n_in, 4 if with_opacity else 3, n_layers=n_layers,
                         n_neurons=n_neurons, skips=skip_layers,
                         generator=generator)
        self.is_view_dependent = is_view_dependent
        self.n_view_direction_frequencies = n_view_direction_frequencies
        self.embedding = embedding(n_appearances,
                                   n_appearance_embedding_dims, generator)

    def forward(self, gaussian_features: torch.Tensor,
                appearance_id: torch.Tensor,
                view_dirs: torch.Tensor) -> torch.Tensor:
        emb = self.embedding(appearance_id.to(torch.int64))
        emb = emb.expand(gaussian_features.shape[0], emb.shape[-1])
        inputs = [gaussian_features, emb]
        if self.is_view_dependent:
            inputs.append(positional_encoding(
                view_dirs, self.n_view_direction_frequencies))
        return super().forward(torch.cat(inputs, dim=-1))


def network_lr_schedule(lr_init: float, lr_final_factor: float,
                        max_steps: int, warm_up: int):
    """lr(n) = lr_init * factor ^ clip((n - warm_up) / max_steps, 0, 1), in
    float32 as gsl_tpu computes it. `n` is the optimizer's own update
    count, so the decay starts `warm_up` updates after the first one."""
    def schedule(step: int) -> float:
        t = torch.clamp((torch.tensor(step, dtype=torch.float32) - warm_up)
                        / max_steps, 0.0, 1.0)
        return float(lr_init * (lr_final_factor ** t))
    return schedule
