"""LightGaussian importance pruning.

Port of ``gsl_tpu/training/light_gaussian.py``: the global importance of a
Gaussian is the sum over train cameras of its blend weights
Sum_pixels(alpha_i * T_i); v = importance * max_scale^0.1, and the lowest
`prune_percent` of the alive rows by v go (0.6, decayed per prune step,
at the fit's `lg_prune_steps`).

The blend weights need no kernel of their own: for a per-Gaussian scalar
bias added to every composited channel, d(sum image) / d(bias_i) is
C * Sum_pixels(alpha_i * T_i). One backward through the rasterizer (K3,
K4) with an all-ones cotangent gives them, from the colours handed to the
renderer as `rgbs_override`, which nothing clamps.
"""
from __future__ import annotations

import torch

from ..models.gaussian import GaussianState
from .optimizers import zero_opt_state_rows


def bias_gradients(render_fn, gstate: GaussianState, camera,
                   weights_of=None):
    """The gradients with respect to a per-Gaussian channel bias [CAP] of
    Sum(w * image), one per pixel weight w, from one forward and one
    backward each. ``render_fn(gstate, camera, bias) -> (image [H, W, C],
    aux)`` adds `bias` to every composited channel of Gaussian i;
    ``weights_of(image, aux)`` (detached image) gives the weights, each
    broadcastable to the image, None for all ones (the default: [None]).
    Returns (list of [CAP] gradients, the image, aux)."""
    bias = torch.zeros(gstate.capacity, dtype=torch.float32,
                       device=gstate.device, requires_grad=True)
    with torch.enable_grad():
        img, aux = render_fn(gstate, camera, bias)
        ws = [None] if weights_of is None else weights_of(img.detach(), aux)
        grads = []
        for i, w in enumerate(ws):
            total = img.sum() if w is None else (img * w).sum()
            grads.append(torch.autograd.grad(
                total, bias, retain_graph=i + 1 < len(ws))[0])
    return grads, img.detach(), aux


def bias_render(renderer, sh_degree: int, bg):
    """render_fn for `bias_gradients`: the view with `bias` added to the
    Gaussians' own colours; returns (image, render outputs)."""
    def render(gstate, camera, bias):
        H, W = int(camera.height), int(camera.width)
        base = renderer.get_rgbs(gstate, camera, sh_degree).detach()
        out = renderer.forward(gstate, camera, H, W, bg, sh_degree,
                               rgbs_override=base + bias[:, None])
        return out.render, out
    return render


def accumulate_blend_weights(render_fn, gstate: GaussianState,
                             cameras) -> torch.Tensor:
    """Sum over `cameras` of d(sum image)/d(bias) [CAP]: per Gaussian, the
    number of composited channels times its blend-weight total.
    ``render_fn(gstate, camera, bias) -> (image, aux)`` must add `bias`
    [CAP] to every composited channel of Gaussian i (`bias_render`)."""
    total = torch.zeros(gstate.capacity, dtype=torch.float32,
                        device=gstate.device)
    for camera in cameras:
        (g,), _, _ = bias_gradients(render_fn, gstate, camera)
        total = total + g
    return total


@torch.no_grad()
def prune_by_importance(gstate: GaussianState, opt_state,
                        importance: torch.Tensor, prune_percent: float,
                        v_pow: float = 0.1):
    """Keep the top (1 - prune_percent) of the alive rows by v = importance
    * max_scale^v_pow. The order is a stable sort, as gsl_tpu's: of rows
    with equal v (many are 0), the lower slots go first. Returns (state,
    opt_state, number pruned as a 0-d tensor)."""
    cap = gstate.capacity
    max_scale = torch.exp(gstate.params.scales).max(dim=-1).values
    v = importance * torch.pow(torch.clamp(max_scale, min=1e-12), v_pow)
    v = torch.where(gstate.alive, v, torch.full_like(v, -float("inf")))

    n_alive = gstate.alive.sum()
    n_prune = (n_alive.to(torch.float32) * prune_percent).to(torch.int64)
    order = torch.argsort(v, stable=True)    # ascending; dead (-inf) first
    rank = torch.empty_like(order)
    rank[order] = torch.arange(cap, device=order.device)
    # the lowest n_prune of the alive: ranks [n_dead, n_dead + n_prune)
    prune = gstate.alive & (rank < (cap - n_alive) + n_prune)
    if opt_state is not None:
        opt_state = zero_opt_state_rows(opt_state, prune)
    return (GaussianState(params=gstate.params, alive=gstate.alive & ~prune,
                          extra=gstate.extra), opt_state, prune.sum())
