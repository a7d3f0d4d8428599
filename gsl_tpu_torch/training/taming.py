"""Taming 3DGS: budgeted, score-driven densification.

Port of ``gsl_tpu/training/taming.py``:
- a quadratic count curve from the initial count to the budget
  (`get_count_array`, one point per densify round);
- a per-Gaussian score over sampled views: "g" terms (mean gradient,
  opacity, depth, screen radius, volume) and "p" terms (the per-pixel
  loss map and the blend weights accumulated per Gaussian), each divided
  by the median of its positive alive entries, weighted by the view's
  photometric loss;
- candidates by the vanilla gradient and size gates, of which the round's
  budget is drawn without replacement in proportion to the score (Gumbel
  top-k), then cloned or split by the vanilla pass.

The per-pixel sums need no kernel of their own: Sum_pixels(w(p) * blend_i)
is d(Sum(w * image)) / d(bias_i) for a per-Gaussian channel bias. One
forward at the view, with the bias in the colours (`rgbs_override`), and
two backward passes through it (K3, K4 with the pixel weights, then with
all ones) give both "p" terms; gsl_tpu takes them as the two rows of a
jacrev.

The normalisation divides by ``torch.median`` of the positive alive
entries, the lower middle value for an even count, as the upstream code
does. (gsl_tpu takes ``jnp.median`` of an array where NaN marks the
excluded entries, which is NaN whenever one entry is dead or not
positive, and then divides by 1: its terms enter unnormalised.)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..models.gaussian import GaussianState
from ..ops.ssim import ssim
from ..utils.device import float32_math
from .density import (DensityControlState, VanillaDensityControllerConfig,
                      densify_and_prune, densify_masks)
from .light_gaussian import bias_gradients, bias_render
from .optimizers import AdamState


@dataclasses.dataclass
class ScoreCoefficients:
    mse_importance: float = 1.0
    edge_importance: float = 50.0
    grad_importance: float = 0.2
    opac_importance: float = 0.5
    dept_importance: float = 0.2
    radii_importance: float = 0.2
    scale_importance: float = 0.2
    loss_importance: float = 1.0
    blend_importance: float = 1.0
    count_importance: float = 0.0   # needs a counting pass; off
    dist_importance: float = 0.0
    view_importance: float = 1.0


@dataclasses.dataclass
class Taming3DGSDensityControllerConfig(VanillaDensityControllerConfig):
    budget: float = 20.0            # multiplier (or final count)
    mode: str = "multiplier"        # "multiplier" | "final_count"
    densification_interval: int = 500
    n_score_cameras: int = 10
    score_coeffs: ScoreCoefficients = dataclasses.field(
        default_factory=ScoreCoefficients)

    def instantiate(self):
        return self


def get_count_array(start_count: int, multiplier: float,
                    densify_until_iter: int, densify_from_iter: int,
                    densification_interval: int, mode: str = "multiplier"):
    """The count each densify round may reach: a x^2 + k x + start over
    the rounds, k = 2 (budget - start) / rounds."""
    if mode == "multiplier":
        budget = int(start_count * float(multiplier))
    else:
        budget = int(multiplier)
    num_steps = ((densify_until_iter + densification_interval - 1)
                 // densification_interval
                 - densify_from_iter // densification_interval)
    increasable = max(budget - start_count, 0)
    slope = increasable / max(num_steps, 1)
    k = 2 * slope
    a = (increasable - k * num_steps) / max(num_steps * num_steps, 1)
    return [int(a * (x ** 2) + k * x + start_count)
            for x in range(max(num_steps, 1))]


def get_edges(image_hwc: torch.Tensor) -> torch.Tensor:
    """Edge magnitude of the grey image by central differences, min-max
    normalised, zero on the border [H, W]."""
    gray = torch.mean(image_hwc, dim=-1)
    gx = (gray[2:, :] - gray[:-2, :])[:, 1:-1]
    gy = (gray[:, 2:] - gray[:, :-2])[1:-1, :]
    mag = torch.nn.functional.pad(torch.sqrt(gx * gx + gy * gy), (1, 1, 1, 1))
    lo, hi = mag.min(), mag.max()
    return (mag - lo) / torch.clamp(hi - lo, min=1e-8)


def positive_median(v: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``torch.median(v[keep & (v > 0)])`` (the lower middle value), or 1
    where no entry qualifies; without a read back to the host."""
    pos = (v > 0) & keep
    ranked = torch.sort(torch.where(pos, v, torch.full_like(
        v, float("inf")))).values
    n = pos.sum()
    mid = ranked[torch.clamp((n - 1) // 2, min=0)]
    return torch.where(n > 0, mid, torch.ones_like(mid))


def normalize(coeff: float, v: torch.Tensor, alive: torch.Tensor):
    """coeff * v / median over the positive alive entries; 0 elsewhere."""
    v = torch.nan_to_num(v)
    pos = (v > 0) & alive
    med = positive_median(v, alive)
    return torch.where(pos, coeff * v / torch.clamp(med, min=1e-12),
                       torch.zeros_like(v))


def pixel_weights(img: torch.Tensor, gt: torch.Tensor,
                  coeffs: ScoreCoefficients) -> torch.Tensor:
    """[H, W] the loss map: mse_importance * |err| (its channel mean,
    min-max normalised) + edge_importance * the ground truth's edges."""
    l1_map = torch.mean(torch.abs(img - gt), dim=-1)
    l1n = (l1_map - l1_map.min()) / torch.clamp(
        l1_map.max() - l1_map.min(), min=1e-8)
    return (coeffs.mse_importance * l1n
            + coeffs.edge_importance * get_edges(gt))


@torch.no_grad()
def compute_gaussian_scores(renderer, gstate: GaussianState, cameras,
                            gt_images, grads: torch.Tensor, bg,
                            sh_degree: int, coeffs: ScoreCoefficients,
                            lambda_dssim: float = 0.2) -> torch.Tensor:
    """The score [CAP] summed over `cameras` (one-camera `Cameras` on the
    state's device) against `gt_images` ([H, W, 3] in [0, 1])."""
    alive = gstate.alive
    all_scales = torch.prod(torch.exp(gstate.params.scales), dim=-1)
    # the terms that do not depend on the view, summed in gsl_tpu's order
    grad_opac = (normalize(coeffs.grad_importance, grads, alive)
                 + normalize(coeffs.opac_importance, gstate.get_opacities(),
                             alive))
    scale_term = normalize(coeffs.scale_importance, all_scales, alive)
    render = bias_render(renderer, sh_degree, bg)
    total = torch.zeros(gstate.capacity, dtype=torch.float32,
                        device=gstate.device)
    for camera, gt in zip(cameras, gt_images):
        def weights_of(img, out):
            return [pixel_weights(img, gt, coeffs)[..., None], None]

        # the render with a zero bias is the plain render: one forward
        # serves the loss, the pixel weights and both sums
        with float32_math():
            (loss_accum, blend), img, out = bias_gradients(
                render, gstate, camera, weights_of)
            s = ssim(img.permute(2, 0, 1), gt.permute(2, 0, 1))
        photometric = ((1 - lambda_dssim) * torch.mean(torch.abs(img - gt))
                       + lambda_dssim * (1 - s))
        visible = out.radii > 0
        g_imp = (grad_opac
                 + normalize(coeffs.dept_importance,
                             out.projections.depths * visible, alive)
                 + normalize(coeffs.radii_importance,
                             out.radii.to(torch.float32), alive)
                 + scale_term)
        p_imp = (normalize(coeffs.loss_importance, loss_accum / 3.0, alive)
                 + normalize(coeffs.blend_importance, blend / 3.0, alive))
        total = total + (coeffs.view_importance * photometric
                         * (g_imp + p_imp) * visible)
    return total


def gumbel_keys(uniforms: torch.Tensor) -> torch.Tensor:
    """-log(-log(u)) of uniforms in [1e-9, 1)."""
    return -torch.log(-torch.log(uniforms))


def draw_uniforms(generator, cap: int, device) -> torch.Tensor:
    """[cap] uniforms in [1e-9, 1), as jax.random.uniform(minval=1e-9)
    maps its draws."""
    u = torch.rand(cap, generator=generator, device=device)
    return torch.clamp(1e-9 + u * (1.0 - 1e-9), min=1e-9)


def top_k_by_score(cand: torch.Tensor, log_score: torch.Tensor,
                   uniforms: torch.Tensor, k) -> torch.Tensor:
    """The `k` candidates with the largest log_score + Gumbel noise: a
    draw of k without replacement in proportion to exp(log_score). Ties
    go to the lower slot (a stable sort, as gsl_tpu's)."""
    keyval = torch.where(cand, log_score + gumbel_keys(uniforms),
                         torch.full_like(log_score, -float("inf")))
    order = torch.argsort(-keyval, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    return cand & (rank < k)


def taming_masks(uniforms, gstate: GaussianState, dstate: DensityControlState,
                 cfg: Taming3DGSDensityControllerConfig, scores: torch.Tensor,
                 count_budget: int, cameras_extent: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (clone_mask, split_mask): of the vanilla candidates, as many as
    the room under `count_budget` allows, shared between clones and
    splits in proportion to their candidates, drawn by score.
    `uniforms`: the (clone, split) [CAP] uniforms."""
    clone_cand, split_cand = densify_masks(gstate, dstate, cfg,
                                           cameras_extent)
    n_alive = gstate.alive.sum()
    total_c, total_s = clone_cand.sum(), split_cand.sum()
    denom = torch.clamp(total_c + total_s, min=1)
    room = torch.clamp(count_budget - n_alive, min=0)
    log_s = torch.log(torch.clamp(scores, min=1e-20))
    return (top_k_by_score(clone_cand, log_s, uniforms[0],
                           room * total_c // denom),
            top_k_by_score(split_cand, log_s, uniforms[1],
                           room * total_s // denom))


def densify_selected(noise, gstate: GaussianState, opt_state: AdamState,
                     dstate: DensityControlState, cfg, clone_mask, split_mask,
                     cameras_extent: float, prune_extent: float,
                     use_size_prune):
    """The vanilla pass with exactly `clone_mask | split_mask` selected
    (their statistics faked past the threshold; the size gate splits them
    as it selected them)."""
    fake = DensityControlState(
        grad_accum=torch.where(clone_mask | split_mask,
                               torch.full_like(dstate.grad_accum, 1e9),
                               torch.zeros_like(dstate.grad_accum)),
        denom=torch.ones_like(dstate.denom), max_radii=dstate.max_radii)
    return densify_and_prune(
        noise, gstate, opt_state, fake,
        dataclasses.replace(cfg, densify_grad_threshold=1.0),
        cameras_extent, prune_extent, use_size_prune)


@torch.no_grad()
def taming_densify(noise, gstate: GaussianState, opt_state: AdamState,
                   dstate: DensityControlState,
                   cfg: Taming3DGSDensityControllerConfig,
                   scores: torch.Tensor, count_budget: int,
                   cameras_extent: float, prune_extent: float,
                   use_size_prune):
    """Budgeted clone/split. `noise` is a generator, or the draws as
    (clone uniforms [CAP], split uniforms [CAP], (n1, n2) split normals).
    Returns what `densify_and_prune` returns."""
    cap, dev = gstate.capacity, gstate.device
    if isinstance(noise, (tuple, list)):
        u_clone, u_split, split_noise = noise
    else:
        u_clone = draw_uniforms(noise, cap, dev)
        u_split = draw_uniforms(noise, cap, dev)
        split_noise = noise
    clone_mask, split_mask = taming_masks(
        (u_clone, u_split), gstate, dstate, cfg, scores, count_budget,
        cameras_extent)
    return densify_selected(split_noise, gstate, opt_state, dstate, cfg,
                            clone_mask, split_mask, cameras_extent,
                            prune_extent, use_size_prune)
