"""LPIPS (AlexNet) between two images.

Port of ``gsl_tpu/ops/lpips.py``: AlexNet's five convolution taps (each
``F.conv2d`` + ReLU, 3x3 / 2 max pooling after the first two), each tap
normalised over its channels, the squared difference weighted by the tap's
1x1 linear head and averaged over the pixels, the five summed. Computed in
float32 with TF32 off.

The weights come from a local ``.npz`` (float32, torch OIHW layout):
``features.{0,3,6,8,10}.weight`` / ``.bias`` (the convolutions) and
``lin.{0..4}.weight`` ([1, C, 1, 1] heads), as
``tools/export_lpips_weights.py`` writes them from the ``lpips`` package.
Search path: ``$GSL_LPIPS_WEIGHTS``, then ``<repo>/weights/lpips_alex.npz``.
Without the file `get_lpips_fn` gives None and validation leaves the
LPIPS column empty.
"""
from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import float32_math

# input normalisation (lpips.ScalingLayer's constants)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# AlexNet's features: (feature index, stride, padding); pooling after the
# first two
_CONVS = ((0, 4, 2), (3, 1, 2), (6, 1, 1), (8, 1, 1), (10, 1, 1))
_POOL_AFTER = (0, 1)
KEYS = ([f"features.{i}.weight" for i, _, _ in _CONVS]
        + [f"features.{i}.bias" for i, _, _ in _CONVS]
        + [f"lin.{i}.weight" for i in range(5)])


def default_weights_path() -> str:
    env = os.environ.get("GSL_LPIPS_WEIGHTS")
    if env:
        return env
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, "weights", "lpips_alex.npz")


def load_weights(path: Optional[str] = None, device=None):
    """The weights as float32 tensors on `device` (default: the CPU), or
    None when the file is absent."""
    path = path or default_weights_path()
    if not os.path.exists(path):
        return None
    z = np.load(path)
    missing = [k for k in KEYS if k not in z]
    if missing:
        raise ValueError(f"LPIPS weight file {path} is missing keys "
                         f"{missing}")
    return {k: torch.as_tensor(z[k], dtype=torch.float32, device=device)
            for k in KEYS}


def _features(x, w):
    taps = []
    for j, (i, stride, pad) in enumerate(_CONVS):
        x = F.relu(F.conv2d(x, w[f"features.{i}.weight"],
                            w[f"features.{i}.bias"], stride=stride,
                            padding=pad))
        taps.append(x)
        if j in _POOL_AFTER:
            x = F.max_pool2d(x, 3, 2)
    return taps


def lpips(img0: torch.Tensor, img1: torch.Tensor, weights) -> torch.Tensor:
    """0-d LPIPS distance of two [H, W, 3] images in [0, 1]."""
    def prep(img):
        x = img.permute(2, 0, 1)[None] * 2.0 - 1.0        # [1, 3, H, W]
        shift = torch.tensor(_SHIFT, device=img.device)[None, :, None, None]
        scale = torch.tensor(_SCALE, device=img.device)[None, :, None, None]
        return (x - shift) / scale

    with float32_math():
        t0 = _features(prep(img0), weights)
        t1 = _features(prep(img1), weights)
        total = 0.0
        for i, (a, b) in enumerate(zip(t0, t1)):
            na = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True)
                                + 1e-10)
            nb = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True)
                                + 1e-10)
            lin = weights[f"lin.{i}.weight"][:, :, 0, 0]   # [1, C]
            total = total + torch.mean(
                torch.einsum("nchw,oc->nohw", (na - nb) ** 2, lin),
                dim=(1, 2, 3))
    return total[0]


@functools.lru_cache(maxsize=1)
def get_lpips_fn(path: Optional[str] = None):
    """fn(img0, img1) -> 0-d distance on the images' device, or None when
    no weights file is found."""
    w = load_weights(path)
    if w is None:
        return None
    on_device = {}

    def fn(img0, img1):
        dev = img0.device
        if dev not in on_device:
            on_device[dev] = {k: v.to(dev) for k, v in w.items()}
        return lpips(img0, img1, on_device[dev])

    return fn
