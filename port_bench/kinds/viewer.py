"""A viewer's closed loop of frames, the kind of the mixes whose `kind` is
``viewer``: its run, its reference, what `correct` compares and the scene
its work is counted on.

`correct` takes a sample of the window's frames drawn from the seed and
renders each again with the reference at its pose: the largest gap of
any value in uint8 levels (`frame_max_gap`) and the share of values more
than one level off (`frame_share_off`), by the worst frame.
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from .. import harness, scene
from ..check import reference_camera
from ..program import (GIB, Outcome, build_trainer, host_delta, host_times,
                       launches, launches_since, peak, reset_peak, sync)
from ..reference import model

FAULTS = ()     # the reference's own faults, for calibrate.py


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_process: float) -> Outcome:
    """A viewer's closed loop: the next frame is asked for when the last
    has come back, each through `ViewerRenderer.get_outputs` (rgb, uint8
    on the host), timed on the host from the call to the frame in hand."""
    from gsl_tpu_torch.viewer.renderer import ViewerRenderer

    cfg, mix = cell.config, cell.traffic
    rend = harness.renderer(cell)
    trainer, _ = build_trainer(cfg)
    gstate = rend.program_state(rend.draw_scene(cfg, seed, device), device)
    viewer = ViewerRenderer(gstate, trainer.renderer, sh_degree=3,
                            background=tuple(mix["background"]))
    poses = scene.viewer_poses(cfg, mix, seed)
    W, H, fov = mix["width"], mix["height"], mix["fov_y_deg"]

    def frame(i):
        return viewer.get_outputs(poses[i % len(poses)], W, H, fov)

    for i in range(mix["warmup_frames"]):
        frame(i)
    sync(device)
    setup_peak = peak(device)
    reset_peak(device)
    # a sample of the window's frames, drawn from the seed (reservoir)
    rng = np.random.RandomState(scene.derived_seed(seed, 4) % (2 ** 32))
    k = mix["checked_frames"]
    kept = []
    times = []
    before, host0 = launches(), host_times()
    t_open = time.perf_counter()
    setup_s = t_open - t_process
    i = 0
    while time.perf_counter() - t_open < seconds:
        t0 = time.perf_counter()
        img = frame(i)
        times.append(time.perf_counter() - t0)
        if i < k:
            kept.append((i, img))
        else:
            j = rng.randint(0, i + 1)
            if j < k:
                kept[j] = (i, img)
        i += 1
    sync(device)
    window = time.perf_counter() - t_open
    window_peak = peak(device)
    window_launches = launches_since(before)
    spent = host_delta(host0)
    ms = [1e3 * t for t in times]
    metrics = {"setup_s": setup_s, "frame_ms": 1e3 * window / i,
               "peak_mem_gib": window_peak / GIB}
    info = {"frames": i, "frame_ms_median": statistics.median(ms),
            "frame_ms_p95": float(np.percentile(ms, 95))}
    traced, items = None, []
    if trace:
        from .. import trace as tr
        base = i
        traced = tr.profile(lambda j: frame(base + j), mix["traced_frames"])
        items = [(base + j) % len(poses) for j in range(mix["traced_frames"])]
    readings = {"frames": [(int(idx % len(poses)), img) for idx, img in
                           sorted(kept, key=lambda t: t[0])]}
    return Outcome(metrics=metrics, host={"window_s": window, "items": i,
                                          "launches": window_launches,
                                          **spent},
                   readings=readings, items=items, trace=traced,
                   attempted=i, failed=0,
                   memory_peak_bytes=max(setup_peak, window_peak), info=info)


def pose_camera(mix: dict, pose) -> dict:
    return scene.viewer_camera(pose, mix["width"], mix["height"],
                               mix["fov_y_deg"])


@torch.no_grad()
def reference(cell, seed: int, device, readings=None,
              precision: str = "float32") -> dict:
    """The reference's readings, as the program's: uint8 frames at the
    poses of the program's checked frames (without readings, the mix's
    first `checked_frames` poses)."""
    cfg, mix = cell.config, cell.traffic
    rend = harness.renderer(cell)
    prec = model.Precision(precision)
    params = rend.draw_scene(cfg, seed, device)
    poses = scene.viewer_poses(cfg, mix, seed)
    bg = torch.tensor(mix["background"], dtype=torch.float32, device=device)
    idx = ([i for i, _ in readings["frames"]] if readings is not None
           else range(mix["checked_frames"]))
    frames = []
    for i in idx:
        cam = reference_camera(pose_camera(mix, poses[i]), device)
        img = rend.render(cfg, params, cam, bg, prec)
        frames.append((i, model.quantise(img).cpu().numpy()))
    return {"frames": frames}


def numbers(readings: dict, ref: dict) -> dict:
    gap, share = 0, 0.0
    for (_, a), (_, b) in zip(readings["frames"], ref["frames"]):
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        gap = max(gap, int(d.max()))
        share = max(share, float((d > 1).mean()))
    return {"frame_max_gap": float(gap), "frame_share_off": share}


def counted_scene(cell, seed: int, device):
    """The scene and the camera of each pose, as the work is counted."""
    rend = harness.renderer(cell)
    poses = scene.viewer_poses(cell.config, cell.traffic, seed)
    return (rend.draw_scene(cell.config, seed, device),
            lambda i: pose_camera(cell.traffic, poses[i]))


def parts(cell, c: dict) -> dict:
    return harness.renderer(cell).frame_parts(cell.config, c)
