"""Bilinear image resize, the counterpart of ``jax.image.resize(x, shape,
"bilinear")``.

JAX's resize is a scale-and-translate with a triangle kernel on pixel
centres (sample ``(j + 0.5) / scale - 0.5`` of the input for output index
j). When it downsamples (scale < 1) the kernel is widened by 1 / scale,
which is its default antialiasing; each output's weights are divided by
their sum, so the edges renormalise, and an output whose sample lies
outside the input takes weight 0. Each resized axis is one [in, out]
weight matrix, and the resize is their products with the input, so
autograd gives the backward. ``F.interpolate(mode="bilinear",
antialias=True)`` is a different filter at the edges and is not used.
The weights are computed in float32 as JAX computes them.
"""
from __future__ import annotations

from typing import Sequence

import torch

_EPS32 = 1.1920928955078125e-07      # np.finfo(np.float32).eps


def weight_matrix(in_size: int, out_size: int, device=None
                  ) -> torch.Tensor:
    """[in_size, out_size] float32 weights of one axis
    (``jax._src.image.scale.compute_weight_mat`` with the triangle kernel,
    antialiasing and no translation)."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(out_size, dtype=torch.float32, device=device)
               + 0.5) * inv_scale - 0.5)
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32,
                                        device=device)[:, None]).abs() \
        / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`x` resized to `shape` (same rank) bilinearly, as
    ``jax.image.resize(x, shape, "bilinear")``: every axis whose size
    changes is contracted with its weight matrix, in axis order."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.ndim:
        raise ValueError(f"resize: shape {shape} for a tensor of rank "
                         f"{x.ndim}")
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        w = weight_matrix(n_in, n_out, x.device).to(x.dtype)
        x = torch.movedim(torch.movedim(x, d, -1) @ w, -1, d)
    return x
