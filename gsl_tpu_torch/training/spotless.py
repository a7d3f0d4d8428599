"""SpotLessSplats: robust masking of transient distractors.

Port of ``gsl_tpu/training/spotless.py``. A small MLP over Stable
Diffusion features and positional encodings predicts a per-pixel inlier
mask. The photometric loss is gated by a Bernoulli draw from that mask
(scheduled from all ones), and the MLP is supervised by the upper and
lower robust masks of the rendered error, thresholded at quantiles of a
running error histogram. The two losses are added and take one backward:
the mask is detached in the photometric term and the error is detached in
the MLP's, so each gradient reaches its own parameters only.

The histogram, the MLP and its Adam (optax.adam's eps) ride in
``TrainState.extra["__spotless__"]`` = {"hist", "mlp", "opt"}. The step
replaces the trainer's: it has gsl_tpu's terms (L1 and the exact SSIM of
the kept pixels, the opacity regulariser) and no other, so where
gsl_tpu's step would drop a component silently (a variant trainer's step,
plugins, an output processor, the L2 colour loss, MCMC's scale
regulariser, the AbsGS or accurate-visibility statistic, GNS's step),
`check_spotless_trainer` raises ``ValueError`` naming both.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data.cameras import Cameras
from ..ops.resize import resize
from ..ops.ssim import ssim as ssim_fn
from .density import AccurateVisibilityFilterDensityControllerConfig
from .metrics import VanillaMetricsConfig
from .optimizers import TensorAdam, _map_moments
from .trainer import Trainer, TrainState

OPTAX_EPS = 1e-8          # optax.adam's, which gsl_tpu's MLP Adam takes
N_FREQ = 20               # positional-encoding frequencies per axis


@dataclasses.dataclass
class SpotLessMetricsConfig(VanillaMetricsConfig):
    lower_bound: float = 0.5
    upper_bound: float = 0.9
    bin_size: int = 10000
    schedule: bool = True
    schedule_beta: float = -3e-3
    reset_sh: int = 8002
    robust_percentile: float = 0.7
    max_mlp_mask_size: int = 800
    densify_until_iter: int = 15_000
    n_feature_dims: int = 1280
    mlp_lr: float = 1e-3

    def instantiate(self):
        return self


def init_spotless_state(cfg: SpotLessMetricsConfig, device=None,
                        generator: Optional[torch.Generator] = None) -> dict:
    """The histogram, the MLP (F' = F + 80 -> 16 -> 1, sigmoid) and its
    Adam state: w1 ~ N(0, 1/F'), w2 ~ N(0, 1/16) drawn on the CPU from
    `generator`, zero biases."""
    f = cfg.n_feature_dims + 80
    mlp = {"w1": torch.randn((f, 16), generator=generator) / np.sqrt(f),
           "b1": torch.zeros(16),
           "w2": torch.randn((16, 1), generator=generator) / 4.0,
           "b2": torch.zeros(1)}
    mlp = {k: v.to(device) for k, v in mlp.items()}
    return {"hist": torch.zeros(cfg.bin_size, device=device),
            "mlp": mlp, "opt": TensorAdam.init(mlp)}


def _unit_range(n: int, device=None) -> torch.Tensor:
    """[n] float32 from 0 to 1, rounded as jnp.linspace(0, 1, n) is on the
    CPU (i times the float32 reciprocal of n - 1, the end exactly 1): at
    the highest frequency, 2^19 pi, one ulp of y moves the sine by 0.1."""
    if n == 1:
        return torch.zeros(1, device=device)
    step = torch.tensor(1.0 / (n - 1), dtype=torch.float32, device=device)
    t = torch.arange(n, dtype=torch.float32, device=device) * step
    t[-1] = 1.0
    return t


def positional_encodings(height: int, width: int, n_freq: int = N_FREQ,
                         device=None) -> torch.Tensor:
    """[H, W, 4 n_freq] sin / cos of y, then of x, at 2^k pi, k < n_freq,
    over y and x in [0, 1]."""
    y = _unit_range(height, device)[:, None, None]
    x = _unit_range(width, device)[None, :, None]
    freqs = (2.0 ** torch.arange(n_freq, device=device).to(torch.float32)
             ) * np.float32(np.pi)
    ye = torch.cat([torch.sin(freqs * y), torch.cos(freqs * y)], -1)
    xe = torch.cat([torch.sin(freqs * x), torch.cos(freqs * x)], -1)
    return torch.cat([ye.expand(height, width, 2 * n_freq),
                      xe.expand(height, width, 2 * n_freq)], -1)


def robust_mask(err: torch.Tensor, threshold) -> torch.Tensor:
    """err [H, W] -> {0, 1} inlier mask, dilated where more than half of a
    pixel's 3 x 3 neighbourhood (zero beyond the image) is inlier."""
    inlier = (err < threshold).to(torch.float32)
    k = torch.full((1, 1, 3, 3), 1.0 / 9.0, device=err.device)
    neigh = F.conv2d(inlier[None, None], k, padding=1)[0, 0]
    return (((neigh > 0.5).to(torch.float32) + inlier) > 1e-3).to(
        torch.float32)


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ p["w1"] + p["b1"])
    return torch.sigmoid(h @ p["w2"] + p["b2"])


def hist_quantile(hist: torch.Tensor, q: float) -> torch.Tensor:
    """The first bin whose cumulative count reaches q of the total, as a
    fraction of the bin count (0-d tensor)."""
    cum = torch.cumsum(hist, 0)
    total = torch.clamp(cum[-1], min=1e-9)
    idx = torch.argmax((cum >= total * q).to(torch.uint8))
    return idx.to(torch.float32) / hist.shape[0]


def mlp_adam(cfg: SpotLessMetricsConfig) -> TensorAdam:
    """optax.adam(mlp_lr), as gsl_tpu steps the MLP."""
    return TensorAdam(cfg.mlp_lr, eps=OPTAX_EPS)


def check_spotless_trainer(trainer: Trainer) -> None:
    """Raise ``ValueError`` for each part of `trainer` that gsl_tpu's
    SpotLess step would drop silently."""
    from .gns import GNSDensityControllerConfig
    m = trainer.metrics_cfg
    dropped = (
        (f"the {type(trainer).__name__} step",
         type(trainer) is not Trainer),
        ("plugins", bool(trainer.plugins)),
        ("an output processor", trainer.output_processor is not None),
        ("rgb_diff_loss l2", m.rgb_diff_loss != "l1"),
        ("the MCMC scale regulariser", m.scale_reg > 0.0),
        ("absgrad (the AbsGS statistic)",
         bool(getattr(trainer.density_cfg, "absgrad", False))),
        ("the accurate-visibility statistic",
         isinstance(trainer.density_cfg,
                    AccurateVisibilityFilterDensityControllerConfig)),
        # gsl_tpu ranks GNS's step above SpotLess's: there the GNS step
        # runs and drops the SpotLess terms
        ("GNS", isinstance(trainer.density_cfg,
                           GNSDensityControllerConfig)))
    for part, present in dropped:
        if present:
            raise ValueError(f"SpotLess with {part}: gsl_tpu's SpotLess "
                             "step would drop it silently")


def spotless_step(trainer: Trainer, cfg: SpotLessMetricsConfig,
                  state: TrainState, camera: Cameras,
                  gt_image: torch.Tensor, sd_feature: torch.Tensor,
                  bg_color: torch.Tensor, img_height: int, img_width: int,
                  sh_degree: int, generator: Optional[torch.Generator] = None,
                  mask: Optional[torch.Tensor] = None,
                  keep_uniform: Optional[torch.Tensor] = None):
    """One step of the Gaussians, their density statistics, the MLP and
    the histogram on one view. `sd_feature` [F, h, w] is resized to the
    MLP's mask size (at most `max_mlp_mask_size` a side), the predicted
    mask back to the image's. The Bernoulli keep-mask compares uniforms
    [H, W] with the keep probability: `keep_uniform`, or a draw from
    `generator`. `mask` [H, W] (padded pixels) leaves those pixels out of
    the histogram, the MLP's loss and the kept set. Returns (new state,
    scalars)."""
    sls = state.extra["__spotless__"]
    H, W = img_height, img_width
    dev = state.alive.device
    lower_thr = hist_quantile(sls["hist"], cfg.lower_bound)
    upper_thr = hist_quantile(sls["hist"], cfg.upper_bound)
    mh = min(H, cfg.max_mlp_mask_size)
    mw = min(W, cfg.max_mlp_mask_size)
    pe = positional_encodings(mh, mw, device=dev)
    mlp = {k: v.detach().requires_grad_(True) for k, v in sls["mlp"].items()}
    if cfg.schedule and keep_uniform is None:
        keep_uniform = torch.rand((H, W), generator=generator, device=dev)
    kept = {}

    def loss_of(gstate, tap, abstap):
        out = trainer.renderer.forward(gstate, camera, H, W, bg_color,
                                       sh_degree, means2d_tap=tap)
        render = out.render
        err3 = torch.abs(render - gt_image)
        err = torch.mean(err3, -1).detach()
        if mask is not None:
            # a padded pixel compares the render with a zero image: keep
            # it out of the histogram and the robust masks
            err = err * mask
        sf = resize(sd_feature, (sd_feature.shape[0], mh, mw))
        feats = torch.cat([sf.permute(1, 2, 0), pe], -1).reshape(mh * mw, -1)
        pred_small = mlp_apply(mlp, feats).reshape(1, mh, mw)
        pred = resize(pred_small, (1, H, W))[0]

        lower_m = robust_mask(err, lower_thr)
        upper_m = robust_mask(err, upper_thr)
        sup = torch.relu(pred - upper_m) + torch.relu(lower_m - pred)
        if mask is not None:
            mlp_loss = torch.sum(sup * mask) / torch.clamp(mask.sum(),
                                                           min=1.0)
        else:
            mlp_loss = torch.mean(sup)
        mlp_loss = mlp_loss + 0.5 * (mlp["w1"].abs().max()
                                     * mlp["w2"].abs().max())

        pred_d = pred.detach()
        if cfg.schedule:
            alpha = torch.exp(cfg.schedule_beta * torch.floor(
                torch.tensor(1.0 + state.step, device=dev) / 1.5))
            p_keep = torch.clamp(alpha + (1 - alpha) * pred_d, 0.0, 1.0)
            keep = (keep_uniform < p_keep).to(torch.float32)
        else:
            keep = pred_d
        if mask is not None:
            keep = keep * mask

        l1 = torch.mean(keep[..., None] * err3)
        sls_m = (keep * (keep > 0.5))[..., None]
        s = ssim_fn((render * sls_m).permute(2, 0, 1),
                    (gt_image * sls_m).permute(2, 0, 1))
        loss = (1.0 - cfg.lambda_dssim) * l1 + cfg.lambda_dssim * (1.0 - s)
        if cfg.opacity_reg > 0.0:
            alive = gstate.alive.to(torch.float32)
            loss = loss + cfg.opacity_reg * torch.sum(
                torch.sigmoid(gstate.params.opacities[:, 0]) * alive
            ) / torch.clamp(alive.sum(), min=1.0)
        kept["err"] = err
        scalars = {"loss": loss, "spot": mlp_loss, "l1": l1, "ssim": s,
                   "mask_mean": torch.mean(pred_d)}
        return loss + mlp_loss, (scalars, out.radii, out.n_dropped)

    names = list(mlp)
    pgrads, tap_grad, mlp_grads, _, (scalars, radii, n_dropped) = \
        trainer.gradients(state, loss_of, [mlp[k] for k in names])
    params, opt_state, density = trainer.apply_gradients(
        state, pgrads, tap_grad, radii, W, H)
    with torch.no_grad():
        new_mlp, mlp_opt = mlp_adam(cfg).update(
            {k: sls["mlp"][k] for k in names}, dict(zip(names, mlp_grads)),
            sls["opt"])
        # the running error histogram (0.95 decay, in the densify window
        # only); a padded pixel adds weight 0. Its weights are 0 or 1, so
        # the sums are exact in any order
        err = kept["err"]
        idx = torch.clamp((err * cfg.bin_size).to(torch.int32), 0,
                          cfg.bin_size - 1).reshape(-1).long()
        w = (torch.ones_like(err) if mask is None else mask).reshape(-1)
        hist_add = torch.zeros(cfg.bin_size, device=dev).index_add_(
            0, idx, w.to(torch.float32))
        hist = (0.95 * sls["hist"] + hist_add
                if state.step < cfg.densify_until_iter else sls["hist"])
    extra = dict(state.extra, __spotless__={"hist": hist, "mlp": new_mlp,
                                            "opt": mlp_opt})
    scalars = {k: v.detach() for k, v in scalars.items()}
    scalars["n_dropped_isects"] = n_dropped
    return TrainState(params=params, alive=state.alive, opt_state=opt_state,
                      density=density, step=state.step + 1,
                      extra=extra), scalars


@torch.no_grad()
def reset_shs_rest(state: TrainState, max_val: float = 0.001
                   ) -> TrainState:
    """The one-time specular reset at `reset_sh`: shs_rest clamped from
    above at `max_val` and its Adam moments zeroed (the count stays)."""
    params = dataclasses.replace(
        state.params, shs_rest=torch.clamp(state.params.shs_rest,
                                           max=max_val))
    opt_state = _map_moments(
        state.opt_state, lambda k, leaf: (torch.zeros_like(leaf)
                                          if k == "shs_rest" else leaf))
    return dataclasses.replace(state, params=params, opt_state=opt_state)
