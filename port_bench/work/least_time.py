"""The least time the card could take for a training step or a served
frame, part by part, from the counts of ``counts.py``.

Each part's least time is the larger of its operations over the card's
float32 peak and its bytes over the memory's peak (``peaks.json``),
counting each input byte once and each output byte once, whatever a
kernel reads again. The operation counts of the rasterizer's kernels
follow their notes in the program (a pair's sigma, alpha and tests: 12;
a composited pair's blend: 3 + 2C, StopThePop's 9 + 2C; a backward pair
before the stop: 18, a composited one 35 + 4C); the plain-torch parts are
counted as what their inputs and outputs must move, which bounds them.
Counted this way a share reads the same work whatever implements it.
"""
from __future__ import annotations

from . import KERNELS, PEAKS

F32 = 4
SH_FLOATS = 48          # SH degree 3: 16 bases x 3 colours
ROW_FLOATS = 3 + 3 + 4 + 1 + SH_FLOATS   # means scales rotations opacity SH
PAYLOAD = 9 * F32       # a splat as the raster kernels read it: mean2d,
                        # conic, opacity, RGB


def part(ops: float, nbytes: float) -> dict:
    t_ops = ops / PEAKS["flops_f32"]
    t_bytes = nbytes / PEAKS["bytes_per_s"]
    return {"s": max(t_ops, t_bytes),
            "bound": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}


def frame_parts(c: dict, stp: bool, channels: int = 3) -> dict:
    """A served frame: projection, SH, K1, the sort, K2 (K2s), the
    background blend and the uint8 quantisation."""
    n, px = c["rows"], c["pixels"]
    C = channels
    parts = {
        # in: means, scales, rotations, opacity; out: mean2d, depth,
        # radius, conic, opacity x compensation (+ the depth plane's slope)
        "projection": part(200.0 * n, n * F32 * (11 + 9 + (2 if stp else 0))),
        # in: SH and means; out: RGB
        "sh": part(140.0 * n, n * F32 * (SH_FLOATS + 3 + 3)),
        "K1": part(48.0 * c["valid_slots"],
                   n * (60 if stp else 52) + 12 * c["slots"]),
        "sort": part(0.0, 24 * c["slots"]),
    }
    raster = (12.0 * c["visited"]
              + ((9 if stp else 3) + 2 * C) * c["composited"])
    parts["K2s" if stp else "K2"] = part(
        raster, PAYLOAD * c["visible"] + 4 * c["valid_slots"]
        + 8 * c["tiles"] + px * F32 * (C + 1))
    parts["blend_quantise"] = part(4.0 * C * px, px * (F32 * (C + 1) + C))
    return parts


def step_parts(c: dict, stp: bool, channels: int = 3) -> dict:
    """A training step: the frame's forward parts up to the blend, the
    loss and its gradient (L1 + SSIM: five separable 11-tap blurs of C
    channels, and their backward), the rasterizer's backward, K4, the
    backward of projection and SH, and Adam over every row."""
    n, px = c["rows"], c["pixels"]
    C = channels
    fwd = frame_parts(c, stp, C)
    fwd.pop("blend_quantise")
    parts = dict(fwd)
    parts["blend"] = part(3.0 * C * px, px * F32 * (2 * C + 1))
    ssim_ops = 5 * C * 2 * 11 * 2 + 40 * C
    parts["loss"] = part(ssim_ops * px, px * F32 * 2 * C)
    parts["loss_backward"] = part(2 * ssim_ops * px, px * F32 * 3 * C)
    walk = 18.0 * c["before_stop"] if not stp else (
        12.0 * c["visited"] + (9 + 2 * C) * c["composited"])
    parts["K3s" if stp else "K3"] = part(
        walk + (35 + 4 * C) * c["composited"],
        PAYLOAD * c["visible"] + 4 * c["valid_slots"]
        + px * F32 * (C + 3) + (6 + C) * F32 * c["valid_slots"])
    parts["K4"] = part(
        (8 + C) * c["valid_slots"],
        (6 + C) * F32 * c["valid_slots"] + 8 * c["slots"]
        + (8 + C) * F32 * n)
    parts["projection_sh_backward"] = part(
        2 * 340.0 * n, n * F32 * 2 * (ROW_FLOATS + 12))
    # Adam: read parameter, gradient and both moments; write parameter
    # and moments
    parts["adam"] = part(12.0 * n * ROW_FLOATS, n * ROW_FLOATS * F32 * 7)
    return parts


def totals(parts: dict) -> dict:
    """Least seconds of the whole item and of its hand-written kernels."""
    return {"all_s": sum(p["s"] for p in parts.values()),
            "kernels_s": sum(p["s"] for k, p in parts.items()
                             if k in KERNELS["hand_written"])}
