"""Post-render image transforms with their own trainable parameters.

Port of ``gsl_tpu/training/output_processors.py``:
- bilateral grids: per image a 16 x 16 x 8 grid of 3 x 4 affine colour
  transforms, sliced trilinearly by (x, y, luminance), with a total
  variation regulariser;
- exposure: per image one 3 x 4 colour transform.

The trainer keeps the parameters, [n_images, ...], and their own Adam in
``TrainState.extra`` (``__outproc__``, ``__outproc_opt__``) and steps them
inside the train step. The slice is gathers and lerps in plain torch.
"""
from __future__ import annotations

import dataclasses

import torch

_LUMA = (0.299, 0.587, 0.114)


@dataclasses.dataclass
class BilateralGridConfig:
    grid_x: int = 16
    grid_y: int = 16
    grid_w: int = 8          # guidance (luminance) bins
    n_images: int = 1
    lr: float = 2e-3
    tv_weight: float = 10.0

    def instantiate(self):
        return self


def init_bilateral_grids(cfg: BilateralGridConfig,
                         device=None) -> torch.Tensor:
    """[n_images, gy, gx, gw, 12]: identity affine transforms."""
    ident = torch.tensor([1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0],
                         dtype=torch.float32, device=device)
    return ident.repeat(cfg.n_images, cfg.grid_y, cfg.grid_x, cfg.grid_w, 1)


def slice_bilateral_grid(grid: torch.Tensor, rgb: torch.Tensor
                         ) -> torch.Tensor:
    """Apply one image's grid [gy, gx, gw, 12] to rgb [H, W, 3]."""
    gy, gx, gw, _ = grid.shape
    H, W, _ = rgb.shape
    dev = rgb.device
    luma = (rgb[..., 0] * _LUMA[0] + rgb[..., 1] * _LUMA[1]
            + rgb[..., 2] * _LUMA[2])

    def coords(n, size):
        c = (torch.arange(size, dtype=torch.float32, device=dev) + 0.5) \
            / size * n - 0.5
        return torch.clamp(c, 0.0, n - 1.0)

    cy = coords(gy, H)[:, None]
    cx = coords(gx, W)[None, :]
    cw = torch.clamp(luma * gw - 0.5, 0.0, gw - 1.0)

    y0 = torch.floor(cy).to(torch.int64)
    x0 = torch.floor(cx).to(torch.int64)
    w0 = torch.floor(cw).to(torch.int64)
    fy, fx, fw = cy - y0, cx - x0, cw - w0
    y1 = torch.clamp(y0 + 1, max=gy - 1)
    x1 = torch.clamp(x0 + 1, max=gx - 1)
    w1 = torch.clamp(w0 + 1, max=gw - 1)

    y0b, y1b = y0.expand(H, W), y1.expand(H, W)
    x0b, x1b = x0.expand(H, W), x1.expand(H, W)
    fyb = fy.expand(H, W)[..., None]
    fxb = fx.expand(H, W)[..., None]
    fwb = fw[..., None]

    def g(yi, xi, wi):
        return grid[yi, xi, wi]          # [H, W, 12]

    a = (g(y0b, x0b, w0) * (1 - fyb) * (1 - fxb)
         + g(y1b, x0b, w0) * fyb * (1 - fxb)
         + g(y0b, x1b, w0) * (1 - fyb) * fxb
         + g(y1b, x1b, w0) * fyb * fxb) * (1 - fwb)
    b = (g(y0b, x0b, w1) * (1 - fyb) * (1 - fxb)
         + g(y1b, x0b, w1) * fyb * (1 - fxb)
         + g(y0b, x1b, w1) * (1 - fyb) * fxb
         + g(y1b, x1b, w1) * fyb * fxb) * fwb
    A = (a + b).reshape(H, W, 3, 4)
    return torch.einsum("hwij,hwj->hwi", A[..., :3], rgb) + A[..., 3]


def bilateral_grid_tv_loss(grids: torch.Tensor) -> torch.Tensor:
    """Total variation across the three grid axes of [n, gy, gx, gw, 12]."""
    loss = 0.0
    for axis in (1, 2, 3):
        d = torch.diff(grids, dim=axis)
        loss = loss + torch.mean(d * d)
    return loss


@dataclasses.dataclass
class ExposureConfig:
    n_images: int = 1
    lr: float = 1e-3

    def instantiate(self):
        return self


def init_exposures(cfg: ExposureConfig, device=None) -> torch.Tensor:
    """[n_images, 3, 4]: identity transforms."""
    ident = torch.cat([torch.eye(3, device=device),
                       torch.zeros((3, 1), device=device)], dim=1)
    return ident[None].repeat(cfg.n_images, 1, 1)


def apply_exposure(exposure: torch.Tensor, rgb: torch.Tensor
                   ) -> torch.Tensor:
    """exposure [3, 4], rgb [H, W, 3]."""
    return torch.einsum("ij,hwj->hwi", exposure[:, :3], rgb) \
        + exposure[:, 3][None, None, :]


def init_processor(cfg, device=None) -> torch.Tensor:
    """The parameters of a bilateral-grid or exposure processor."""
    if isinstance(cfg, BilateralGridConfig):
        return init_bilateral_grids(cfg, device)
    return init_exposures(cfg, device)


def apply_processor(cfg, params: torch.Tensor, image_idx, render):
    """render [H, W, 3] -> (processed, regulariser) for image `image_idx`."""
    if isinstance(cfg, BilateralGridConfig):
        g = params[image_idx]
        return (slice_bilateral_grid(g, render),
                cfg.tv_weight * bilateral_grid_tv_loss(g[None]))
    return apply_exposure(params[image_idx], render), 0.0
