"""Output visualizers (turbo depth colormap, normal maps), a copy of
``gsl_tpu/utils/visualizers.py``; numpy in, numpy out."""
from __future__ import annotations

import numpy as np

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


def turbo_colormap(x: np.ndarray) -> np.ndarray:
    """x in [0,1] [H, W] -> rgb [H, W, 3] in [0,1]."""
    x = np.clip(x, 0.0, 1.0)
    rgb = np.stack([_poly(x, _TURBO_R), _poly(x, _TURBO_G),
                    _poly(x, _TURBO_B)], axis=-1)
    return np.clip(rgb, 0.0, 1.0)


def visualize_depth(depth: np.ndarray, max_depth: float = None) -> np.ndarray:
    d = np.asarray(depth, np.float32)
    if max_depth is None:
        finite = d[np.isfinite(d) & (d > 0)]
        max_depth = float(finite.max()) if finite.size else 1.0
    return turbo_colormap(d / max(max_depth, 1e-8))


def visualize_normal(normal: np.ndarray) -> np.ndarray:
    """[-1,1] normals -> rgb."""
    return np.clip(np.asarray(normal) * 0.5 + 0.5, 0.0, 1.0)


def visualize_output(key_type: str, arr: np.ndarray) -> np.ndarray:
    if key_type == "gray":
        return visualize_depth(arr)
    if key_type == "normal_map":
        return visualize_normal(arr)
    return np.clip(np.asarray(arr), 0.0, 1.0)
