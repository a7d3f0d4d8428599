"""Output visualizers (turbo depth colormap, normal maps): the functions of
``gsl_tpu/utils/visualizers.py`` on tensors. Each takes a float tensor and
returns one on the same device, so a frame rendered on the card is
visualized there and only its uint8 image goes to the host."""
from __future__ import annotations

from typing import Optional

import torch

# polynomial approximation of the Turbo colormap (Google AI blog, public)
_TURBO_R = (0.13572138, 4.61539260, -42.66032258, 132.13108234,
            -152.94239396, 59.28637943)
_TURBO_G = (0.09140261, 2.19418839, 4.84296658, -14.18503333,
            4.27729857, 2.82956604)
_TURBO_B = (0.10667330, 12.64194608, -60.58204836, 110.36276771,
            -89.90310912, 27.34824973)


def _poly(x, c):
    return (c[0] + x * (c[1] + x * (c[2] + x * (c[3] + x * (c[4]
            + x * c[5])))))


def turbo_colormap(x: torch.Tensor) -> torch.Tensor:
    """x in [0,1] [H, W] -> rgb [H, W, 3] in [0,1]."""
    x = torch.clamp(x, 0.0, 1.0)
    rgb = torch.stack([_poly(x, _TURBO_R), _poly(x, _TURBO_G),
                       _poly(x, _TURBO_B)], dim=-1)
    return torch.clamp(rgb, 0.0, 1.0)


def visualize_depth(depth: torch.Tensor,
                    max_depth: Optional[float] = None) -> torch.Tensor:
    """Depth over its largest finite positive value (1 when there is
    none), through the colormap. The maximum stays on the device."""
    d = depth.to(torch.float32)
    if max_depth is None:
        valid = torch.isfinite(d) & (d > 0)
        largest = torch.where(valid, d, torch.zeros_like(d)).max()
        scale = torch.where(valid.any(), largest, torch.ones_like(largest))
    else:
        scale = torch.as_tensor(max_depth, dtype=torch.float32,
                                device=d.device)
    return turbo_colormap(d / torch.clamp(scale, min=1e-8))


def visualize_normal(normal: torch.Tensor) -> torch.Tensor:
    """[-1,1] normals -> rgb."""
    return torch.clamp(normal * 0.5 + 0.5, 0.0, 1.0)


def visualize_output(key_type: str, img: torch.Tensor) -> torch.Tensor:
    if key_type == "gray":
        return visualize_depth(img)
    if key_type == "normal_map":
        return visualize_normal(img)
    return torch.clamp(img, 0.0, 1.0)
