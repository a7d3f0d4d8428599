"""What every comparison of `correct` shares: the reference's camera, the
camera extent the trainer derives, and the gap of norms by the worst
leaf. What each kind compares is in ``kinds/<kind>.py``; the comparison
runs after the window has closed and the program's state is freed."""
from __future__ import annotations

import numpy as np
import torch

from .reference import model


def reference_camera(c: dict, device) -> dict:
    return model.camera(c["R"], c["T"], c["fx"], c["fy"], c["cx"], c["cy"],
                        c["width"], c["height"], device)


def camera_extent(cams: list) -> float:
    """1.1 x the largest distance of a camera centre from their mean."""
    centres = np.stack([-np.asarray(c["R"], np.float64).T
                        @ np.asarray(c["T"], np.float64) for c in cams])
    return float(1.1 * np.linalg.norm(centres - centres.mean(0),
                                      axis=-1).max())


def norms(tensors: dict) -> dict:
    """Each tensor's L2 norm, accumulated in float64."""
    return {k: float(torch.linalg.vector_norm(v, dtype=torch.float64))
            for k, v in tensors.items()}


def leaf_gap(prog: dict, ref: dict, leaves) -> float:
    """The largest |norm(program) - norm(reference)| of `leaves`, each
    over the larger of its reference norm and the median leaf's."""
    med = float(np.median([ref[k] for k in leaves]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in leaves)
