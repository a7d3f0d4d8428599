"""Smoke run of the PyTorch port's render and training paths on one CUDA
card.

    python3 chip_smoke.py

Needs one NVIDIA H100 (sm_90a) with nvcc; exits nonzero, printing no
result, when torch.cuda.is_available() is False or the gsl_tpu_torch
package is not beside this script. Phases, each fatal on failure:

1. device and build: the card's name and power limit; the four kernels
   built from gsl_tpu_torch/csrc/ with nvcc, one process per source, in
   parallel.
2. scene: the bench scene of __graft_entry__._synthetic_state (numpy seed
   0, 1,000,000 Gaussians, SH degree 3) with shs_rest ~ 0.1 N(0, 1) so the
   higher SH bands run, saved as a PLY with the port's save_gaussian_ply.
3. kernels against their plain PyTorch versions at full width (1088x1920,
   fx = fy = 1600), at the bench pose (identity) and two orbit views:
   K1 expand must equal expand_plain bit for bit (keys, ids, counts);
   K2 forward must agree with rasterize_fwd_plain on i_stop at >= 99.9% of
   pixels, and on image and alpha within |d| <= 2e-4 + 1e-3 |ref| at all
   but 1e-4 of the values. The kernel contracts multiply-adds and the
   plain version does not, so they round differently; where a splat's
   alpha sits within rounding of the 1/255 skip or the 1e-4 stop, one of
   them composites that splat and the other does not, and the pixel moves
   by up to that splat's weight. At the bench pose (C = 3) and the first
   orbit view (C = 8), with seeded normal cotangents: K3 backward must
   agree with rasterize_bwd_plain within |d| <= 1e-4 max|ref| + 1e-3 |ref|
   at all but 1e-3 of the row values (the same flips move single rows, and
   T / (1 - alpha) walked backwards rounds differently with and without
   contraction), and give the same rows when run twice; K4 reduce, on the
   kernel's rows, must agree with reduce_grads_plain (index_add_) within
   |d| <= 1e-5 max|ref| + 1e-4 |ref| everywhere (only the order of the
   float32 additions differs). A small scene through the whole renderer
   on the card must match the CPU renderer (the plain versions) on all
   but 1e-3 of the values, and so must the gradients of a scalar loss for
   all six parameter tensors.
4. main path: GaussianModelLoader.load(ply) -> ViewerRenderer -> orbit
   frames at 1088x1920 in rgb, then one frame with alpha, exp_depth,
   inverse_depth, normal and hard_inverse_depth (8 composited channels).
   Outputs must be finite, mean alpha above 0, and both kernels' launch
   counters, zeroed just before, above 0. Prints ms per frame, per-stage
   times from CUDA events, and peak memory.
5. training main path: the 1M scene -> Trainer.setup at capacity 1M ->
   targets rendered once from the unperturbed scene at three views -> 20
   train_steps from a seeded perturbation of means, colours and opacities
   (SH degree warm-up shortened so degree 3 runs from step 6), each
   followed by maybe_density_ops as the fit loop calls it; at step 20 one
   density_step (clone + split + prune; the free slots run out, so
   grow_state doubles the capacity and the pass is redone), then more
   steps at the grown capacity and one opacity_reset_step. Fatal unless
   every loss is finite, the mean loss of steps 16-20 is below that of
   steps 1-5, every parameter is finite, the alive count changed at the
   densify and all four kernels' launch counters, zeroed just before, are
   above 0. Prints ms per step, the stage split from CUDA events, the ms
   of the density step and peak memory.

Bounds in the kernels line: the larger of bytes / 3.35 TB/s and
operations / 67 TFLOP/s (H100 SXM f32 without tensor cores). K1 moves 52
bytes per Gaussian and 12 per slot, and does ~40 operations per real slot
(the tile cull). K2 reads each Gaussian's mean, conic, opacity and C
channels and each sorted id once and writes C + 2 values per pixel; it does
16 + 2C operations per (pixel, splat) pair that this run's pixels visited
before they stopped. K3 moves the forward's bytes plus one row of 6 + C
values per valid slot; it does 18 operations per (pixel, splat) pair
before the pixel's stop and 35 + 4C more per composited pair (counted in
csrc/rasterize_bwd.cu). K4 reads each valid row, 4 bytes per slot and 8
per Gaussian of indices, writes 8 + C values per Gaussian, and does one
addition per value read. K4's library_ms is one index_add_ of the rows
with the absolute columns attached.

The last line is {"ok": true, "device": {...}}.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gsl_tpu_torch.data.cameras import make_camera
from gsl_tpu_torch.ops import cuda_build
from gsl_tpu_torch.ops import rasterize as R
from gsl_tpu_torch.ops.projection import project_gaussians
from gsl_tpu_torch.ops.transforms import quat_to_rotmat
from gsl_tpu_torch.models.gaussian import (PARAM_FIELDS, GaussianParams,
                                           GaussianState,
                                           VanillaGaussianConfig)
from gsl_tpu_torch.renderers.tile_renderer import TileRendererConfig
from gsl_tpu_torch.training.density import VanillaDensityControllerConfig
from gsl_tpu_torch.training.metrics import train_loss
from gsl_tpu_torch.training.trainer import Trainer, TrainerConfig
from gsl_tpu_torch.utils.convert import state_from_raw_arrays
from gsl_tpu_torch.utils.gaussian_model_loader import GaussianModelLoader
from gsl_tpu_torch.utils.ply import save_gaussian_ply
from gsl_tpu_torch.viewer.camera_path import orbit_c2w
from gsl_tpu_torch.viewer.renderer import ViewerRenderer

H, W, FOCAL = 1088, 1920, 1600.0
N_GAUSSIANS = 1_000_000
SH_DEGREE = 3
TILE = 16
TARGET = np.array([0.0, 0.0, 5.0])    # middle of the scene's z range
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
ATOL, RTOL, STOP_SHARE, OFF_SHARE = 2e-4, 1e-3, 0.999, 1e-4
GRAD_ATOL, GRAD_RTOL, GRAD_SHARE = 1e-4, 1e-3, 0.999   # K3, of max |ref|
SUM_ATOL, SUM_RTOL = 1e-5, 1e-4                          # K4, of max |ref|
KERNELS = {"expand": R.expand, "rasterize_fwd": R.rasterize_fwd,
           "rasterize_bwd": R.rasterize_bwd, "reduce_grads": R.reduce_grads}
ALL_OUTPUTS = frozenset({"rgb", "alpha", "exp_depth", "inverse_depth",
                         "normal", "hard_inverse_depth"})


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def scene_arrays(n, seed=0):
    """__graft_entry__._synthetic_state's draws, in its order, then
    shs_rest."""
    rng = np.random.RandomState(seed)
    k_rest = (SH_DEGREE + 1) ** 2 - 1
    means = np.concatenate([rng.uniform(-2, 2, size=(n, 2)),
                            rng.uniform(2, 8, size=(n, 1))],
                           axis=-1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = rng.uniform(-6.5, -4.5, size=(n, 3)).astype(np.float32)
    opacities = rng.uniform(-1, 2, size=(n, 1)).astype(np.float32)
    shs_dc = rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.3
    shs_rest = rng.normal(size=(n, k_rest, 3)).astype(np.float32) * 0.1
    return dict(means=means, scales=scales, rotations=quats,
                opacities=opacities, shs_dc=shs_dc, shs_rest=shs_rest)


def camera(c2w, height=H, width=W, focal=FOCAL, device="cuda"):
    w2c = np.linalg.inv(c2w)
    return make_camera(R=w2c[:3, :3], T=w2c[:3, 3], fx=focal, fy=focal,
                       cx=width / 2, cy=height / 2, width=width,
                       height=height, device=device)


def views():
    return {"bench": np.eye(4),
            "orbit_yaw20": orbit_c2w(20.0, -10.0, 5.0, TARGET),
            "orbit_yaw-35": orbit_c2w(-35.0, 10.0, 5.0, TARGET)}


def cuda_ms(fn, iters, warmup=1):
    """Mean ms per call from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def channels_for(state, renderer, proj, cam, n_channels):
    """rgb (C=3), or rgb + depth + inverse depth + normal (C=8), as
    TileRenderer.forward composites them."""
    rgb = renderer.get_rgbs(state, cam, SH_DEGREE)
    if n_channels == 3:
        return rgb.contiguous()
    normals = quat_to_rotmat(state.get_rotations())[:, :, 2]
    d = proj.depths[:, None]
    return torch.cat([rgb, d, 1.0 / torch.clamp(d, min=1e-8), normals],
                     1).contiguous()


def compare_raster(name, got, want):
    """got/want: (out, T, i_stop). Returns (max abs err, stop share)."""
    share = float((got[2] == want[2]).float().mean())
    if share < STOP_SHARE:
        fail(f"{name}: i_stop agrees on {share:.5f} of pixels "
             f"< {STOP_SHARE}")
    for label, g, w in (("image", got[0], want[0]),
                        ("alpha", 1 - got[1], 1 - want[1])):
        if not bool(torch.isfinite(g).all()):
            fail(f"{name}: non-finite {label}")
        d = (g - w).abs()
        bad = d > ATOL + RTOL * w.abs()
        if float(bad.float().mean()) > OFF_SHARE:
            i = int(torch.argmax(d.flatten()))
            fail(f"{name}: {label} differs beyond tolerance at "
                 f"{int(bad.sum())} of {bad.numel()} values; worst "
                 f"{float(g.flatten()[i])} vs {float(w.flatten()[i])}")
    err = max(float((got[0] - want[0]).abs().max()),
              float((got[1] - want[1]).abs().max()))
    return err, share


def visited_pairs(i_stop, bounds, tiles_x):
    """(pixel, splat) pairs the forward visits: up to and including the
    stop, or the tile's whole range."""
    ys = torch.arange(H, device=i_stop.device)[:, None] // TILE
    xs = torch.arange(W, device=i_stop.device)[None, :] // TILE
    tile = ys * tiles_x + xs
    start, end = bounds[tile], bounds[tile + 1]
    stop = i_stop.to(torch.int64)
    last = torch.where(stop < R.NEVER_STOPPED, stop + 1, end)
    return int((last - start).sum())


def reset_launches():
    for wrapper in KERNELS.values():
        wrapper.launches = 0


def read_launches():
    return {name: w.launches for name, w in KERNELS.items()}


def check_backward(vname, C, bwd, isects, order, n, timed):
    """K3 and K4 against their plain versions; with `timed`, their times
    and bounds too. Returns a dict of what was measured."""
    gids, bounds = bwd[4], bwd[5]
    rows = R.rasterize_bwd(*bwd)
    again = R.rasterize_bwd(*bwd)
    stats = {}
    rows_p = R.rasterize_bwd_plain(*bwd, stats=stats)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(rows).all()):
        fail(f"K3 {vname}: non-finite rows")
    if not torch.equal(rows, again):
        fail(f"K3 {vname}: two runs gave different rows")
    scale = float(rows_p.abs().max())
    d = (rows - rows_p).abs()
    share = 1.0 - float((d > GRAD_ATOL * scale
                         + GRAD_RTOL * rows_p.abs()).float().mean())
    if scale <= 0.0 or share < GRAD_SHARE:
        fail(f"K3 {vname} C={C}: rows agree with rasterize_bwd_plain on "
             f"{share:.6f} of values < {GRAD_SHARE} (max |ref| {scale})")
    inv = R.invert_order(order)
    red = (rows, gids, isects.offsets, inv, bounds[-1:], n)
    summed = R.reduce_grads(*red)
    summed_p = R.reduce_grads_plain(rows, gids, n)
    torch.cuda.synchronize()
    if not torch.equal(summed, R.reduce_grads(*red)):
        fail(f"K4 {vname}: two runs gave different sums")
    sscale = float(summed_p.abs().max())
    sd = (summed - summed_p).abs()
    if bool((sd > SUM_ATOL * sscale + SUM_RTOL * summed_p.abs()).any()):
        fail(f"K4 {vname} C={C}: differs from reduce_grads_plain by up to "
             f"{float(sd.max())} (max |ref| {sscale})")
    rec = {"bwd_err": float(d.max()), "bwd_share": share,
           "bwd_scale": scale, "reduce_err": float(sd.max()),
           "reduce_scale": sscale,
           "composited_pairs": stats["composited_pairs"]}
    log(f"K3 {vname} C={C}: rows agree on {share:.6f} of values, max abs "
        f"err {rec['bwd_err']:.3e} (max |ref| {scale:.3e}); identical in "
        f"two runs. K4: max abs err {rec['reduce_err']:.3e} (max |ref| "
        f"{sscale:.3e}); composited pairs {stats['composited_pairs']}")
    if not timed:
        return rec
    gids64 = gids.long()
    full = torch.cat([rows[:, :6], rows[:, :2].abs(), rows[:, 6:]], 1)
    out = torch.empty((n, full.shape[1]), device=rows.device)
    rec.update(
        bwd_ms=cuda_ms(lambda: R.rasterize_bwd(*bwd), 20),
        bwd_plain_ms=cuda_ms(lambda: R.rasterize_bwd_plain(*bwd), 1,
                             warmup=0),
        invert_ms=cuda_ms(lambda: R.invert_order(order), 20),
        reduce_ms=cuda_ms(lambda: R.reduce_grads(*red), 20),
        reduce_plain_ms=cuda_ms(
            lambda: R.reduce_grads_plain(rows, gids, n), 5),
        reduce_library_ms=cuda_ms(
            lambda: out.zero_().index_add_(0, gids64, full), 20))
    return rec


def phase_kernels(state, renderer):
    log("== phase 3: kernels against their plain versions, full width")
    tiles_x, tiles_y = -(-W // TILE), -(-H // TILE)
    n_tiles = tiles_x * tiles_y
    n = state.capacity
    rec = {}
    for vi, (vname, c2w) in enumerate(views().items()):
        cam = camera(c2w)
        proj = project_gaussians(
            state.get_means(), state.get_scales(), state.get_rotations(),
            cam.world_to_camera, cam.fx, cam.fy, cam.cx, cam.cy, W, H)
        opac = renderer.get_opacities(state, proj).contiguous()
        C = 3 if vi == 0 else 8
        ch = channels_for(state, renderer, proj, cam, C)
        m2d, con = proj.means2d.contiguous(), proj.conics.contiguous()
        depths = proj.depths.contiguous()
        isects = R.isect_encode(proj, H, W, TILE)
        args = (isects, m2d, con, opac, depths, tiles_x, tiles_y, TILE, True)
        keys_k, gids_k = R.expand(*args)
        keys_p, gids_p = R.expand_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(keys_k, keys_p) and torch.equal(gids_k, gids_p)):
            diff = int((keys_k != keys_p).sum())
            fail(f"K1 {vname}: kernel differs from expand_plain at {diff} "
                 "slots")
        sk_k, gs_k, order = R.sort_slots(keys_k, gids_k)
        sk_p, gs_p, _ = R.sort_slots(keys_p, gids_p)
        if not (torch.equal(sk_k, sk_p) and torch.equal(gs_k, gs_p)):
            fail(f"K1 {vname}: sorted keys/ids differ from the plain "
                 "version's")
        n_valid = int((sk_k != R.INVALID_KEY).sum())
        n_valid_p = int((sk_p != R.INVALID_KEY).sum())
        if n_valid != n_valid_p:
            fail(f"K1 {vname}: valid counts {n_valid} != {n_valid_p}")
        culled = isects.n_isects - n_valid
        log(f"K1 {vname}: bit-identical; slots {isects.total} real "
            f"{isects.n_isects} valid {n_valid} culled {culled}")
        bounds = R.tile_bounds(sk_k, n_tiles)
        gids = gs_k[:n_valid].contiguous()
        fwd = (m2d, con, opac, ch, gids, bounds, H, W, TILE)
        got = R.rasterize_fwd(*fwd)
        want = R.rasterize_fwd_plain(*fwd)
        torch.cuda.synchronize()
        err, share = compare_raster(f"K2 {vname} C={C}", got, want)
        log(f"K2 {vname} C={C}: i_stop agrees on {share:.6f}, max abs err "
            f"{err:.3e}")
        rec["fwd_err"] = max(rec.get("fwd_err", 0.0), err)
        if vi == 2:
            continue
        gen = torch.Generator(device="cuda").manual_seed(vi)
        g_out = torch.randn((H, W, C), generator=gen, device="cuda")
        g_alpha = torch.randn((H, W), generator=gen, device="cuda")
        bwd = (m2d, con, opac, ch, gids, bounds, g_out, g_alpha, got[1],
               got[2], TILE)
        brec = check_backward(vname, C, bwd, isects, order, n, vi == 0)
        for key in ("bwd_err", "reduce_err"):
            rec[key] = max(rec.get(key, 0.0), brec.pop(key))
        if vi != 0:
            continue
        rec.update(brec)
        # timings and bounds at the bench pose, C = 3 (the rgb main path)
        t = {
            "expand_ms": cuda_ms(lambda: R.expand(*args), 20),
            "expand_plain_ms": cuda_ms(lambda: R.expand_plain(*args), 3),
            "sort_ms": cuda_ms(lambda: R.sort_slots(keys_k, gids_k), 20),
            "ranges_ms": cuda_ms(lambda: R.tile_bounds(sk_k, n_tiles), 20),
            "fwd_ms": cuda_ms(lambda: R.rasterize_fwd(*fwd), 20),
            "fwd_plain_ms": cuda_ms(lambda: R.rasterize_fwd_plain(*fwd), 1,
                                    warmup=0),
        }
        pairs = visited_pairs(got[2], bounds, tiles_x)
        # the backward visits the positions before each pixel's stop
        pairs_bwd = pairs - int((got[2] < R.NEVER_STOPPED).sum())
        fwd_bytes = (n * (24 + 4 * C) + 4 * n_valid + 8 * (n_tiles + 1)
                     + H * W * (4 * C + 8))
        t["bwd_bound"] = bound(
            fwd_bytes + 4 * H * W + 4 * (6 + C) * n_valid,
            18 * pairs_bwd + (35 + 4 * C) * rec["composited_pairs"])
        t["reduce_bound"] = bound(
            4 * (6 + C) * n_valid + 4 * isects.total + 8 * n
            + 4 * (8 + C) * n, (8 + C) * n_valid)
        t["pairs_bwd"] = pairs_bwd
        t["expand_bound"] = bound(52 * n + 12 * isects.total,
                                  40 * isects.n_isects)
        t["fwd_bound"] = bound(fwd_bytes, pairs * (16 + 2 * C))
        t.update(n_isects=isects.n_isects, slots=isects.total,
                 n_valid=n_valid, pairs=pairs)
        log("bench-pose timings " + json.dumps(t))
        rec.update(t)
    return rec


def phase_small_reference():
    """The whole renderer on a small scene, card vs CPU (plain versions)."""
    arrays = scene_arrays(400, seed=1)
    arrays["means"][:, 2] -= 2.0  # nearer: larger splats, longer lists
    c2w = np.eye(4)
    outs = {}
    for dev in ("cuda", "cpu"):
        state = state_from_raw_arrays(arrays, device=dev)
        renderer = TileRendererConfig().instantiate()
        cam = camera(c2w, 96, 128, 120.0, device=dev)
        bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
        outs[dev] = renderer.forward(state, cam, 96, 128, bg, SH_DEGREE,
                                     render_types=ALL_OUTPUTS)
    for key in ("render", "alpha", "exp_depth", "inverse_depth", "normal",
                "hard_inverse_depth"):
        g = getattr(outs["cuda"], key).cpu()
        w = getattr(outs["cpu"], key)
        bad = (g - w).abs() > ATOL + RTOL * w.abs()
        share = 1.0 - float(bad.float().mean())
        if not bool(torch.isfinite(g).all()) or share < STOP_SHARE:
            fail(f"small scene {key}: card matches the CPU renderer at "
                 f"{share:.5f} of values")
    log("small scene (400 Gaussians, 128x96): card renderer matches the "
        "CPU renderer on every output")
    grads = {}
    for dev in ("cuda", "cpu"):
        state = state_from_raw_arrays(arrays, device=dev)
        state.params = state.params.map(
            lambda _, x: x.requires_grad_(True))
        target = torch.rand((96, 128, 3), generator=torch.Generator(
            ).manual_seed(3)).to(dev)
        with torch.enable_grad():
            out = TileRendererConfig().instantiate().forward(
                state, camera(c2w, 96, 128, 120.0, device=dev), 96, 128,
                torch.tensor([0.1, 0.2, 0.3], device=dev), SH_DEGREE)
            loss, _ = train_loss(out.render, target)
            loss.backward()
        grads[dev] = {k: getattr(state.params, k).grad.cpu()
                      for k in PARAM_FIELDS}
    for key, g in grads["cuda"].items():
        w = grads["cpu"][key]
        scale = float(w.abs().max())
        bad = (g - w).abs() > 1e-3 * scale + 1e-2 * w.abs()
        share = 1.0 - float(bad.float().mean())
        if (not bool(torch.isfinite(g).all()) or scale <= 0.0
                or share < STOP_SHARE):
            fail(f"small scene d loss / d {key}: card matches the CPU at "
                 f"{share:.5f} of values (max |ref| {scale})")
    log("small scene: the gradients of the L1 + SSIM loss for all six "
        "parameter tensors match the CPU's")


def phase_main_path(ply):
    log("== phase 4: main path GaussianModelLoader -> ViewerRenderer -> "
        "TileRenderer at 1088x1920")
    state, renderer, sh_degree = GaussianModelLoader.load(ply,
                                                          device="cuda")
    vr = ViewerRenderer(state, renderer, sh_degree)
    fov_y = math.degrees(2.0 * math.atan(0.5 * H / FOCAL))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    frame_ms = []
    for yaw in (0.0, 10.0, 20.0, 30.0, 40.0):
        c2w = orbit_c2w(yaw, 0.0, 5.0, TARGET)
        t0 = time.perf_counter()
        img = vr.get_outputs(c2w, W, H, fov_y)   # ends in a host copy
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if img.shape != (H, W, 3) or img.dtype != np.uint8:
            fail(f"frame at yaw {yaw}: shape {img.shape} {img.dtype}")
        if int(img.max()) == 0:
            fail(f"frame at yaw {yaw} is black")
    bg = torch.zeros(3, device="cuda")
    cam = camera(np.eye(4))
    out = renderer.forward(state, cam, H, W, bg, sh_degree,
                           render_types=ALL_OUTPUTS)
    for key in ("render", "alpha", "exp_depth", "inverse_depth", "normal",
                "hard_inverse_depth"):
        v = getattr(out, key)
        if v is None or not bool(torch.isfinite(v).all()):
            fail(f"main path {key}: missing or non-finite")
    mean_alpha = float(out.alpha.mean())
    if not mean_alpha > 0.0:
        fail("main path: mean alpha is 0")
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_launches().items()
                if k in ("expand", "rasterize_fwd")}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, count in launches.items():
        if count <= 0:
            fail(f"main path never launched kernel {name}")
    log(f"main path: {len(frame_ms)} rgb frames, ms per frame "
        f"{[round(x, 3) for x in frame_ms]}; all-outputs frame at the bench "
        f"pose: n_isects {out.n_isects}, mean alpha {mean_alpha:.4f}; "
        f"launches {launches}; peak memory {peak_gb:.3f} GiB")
    stage_ms = stage_times(state, renderer, sh_degree, cam)
    rgb_ms = [1e3 * t for t in timed_frames(renderer, state, cam, bg,
                                            sh_degree)]
    log("bench-pose rgb frame, host clock ms " + json.dumps(rgb_ms))
    log("bench-pose stage ms (CUDA events, median of 5) "
        + json.dumps(stage_ms))
    return launches


def timed_frames(renderer, state, cam, bg, sh_degree, reps=5):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        renderer.forward(state, cam, H, W, bg, sh_degree)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def stage_times(state, renderer, sh_degree, cam, reps=5):
    """The rgb render's stages, as TileRenderer.forward runs them."""
    tiles_x, tiles_y = -(-W // TILE), -(-H // TILE)
    rows = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        proj = project_gaussians(
            state.get_means(), state.get_scales(), state.get_rotations(),
            cam.world_to_camera, cam.fx, cam.fy, cam.cx, cam.cy, W, H)
        opac = renderer.get_opacities(state, proj).contiguous()
        ev[1].record()
        rgb = renderer.get_rgbs(state, cam, sh_degree).contiguous()
        ev[2].record()
        isects = R.isect_encode(proj, H, W, TILE)
        m2d, con = proj.means2d.contiguous(), proj.conics.contiguous()
        keys, gids = R.expand(isects, m2d, con, opac,
                              proj.depths.contiguous(), tiles_x, tiles_y,
                              TILE, True)
        ev[3].record()
        sk, gs, _ = R.sort_slots(keys, gids)
        ev[4].record()
        bounds = R.tile_bounds(sk, tiles_x * tiles_y)
        ev[5].record()
        R.rasterize_fwd(m2d, con, opac, rgb, gs, bounds, H, W, TILE)
        ev[6].record()
        torch.cuda.synchronize()
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(6)])
    med = np.median(np.asarray(rows), axis=0)
    names = ("project", "sh", "expand", "sort", "ranges", "forward")
    return {k: float(v) for k, v in zip(names, med)}


TRAIN_STEPS, DENSIFY_AT, RESET_AT, STEPS_AFTER = 20, 20, 24, 6
TRAIN_EXTENT = 0.5   # puts percent_dense * extent inside the scene's scales


def perturbed(arrays, seed=1):
    """The scene, moved off its optimum: what training has to undo."""
    rng = np.random.RandomState(seed)
    out = dict(arrays)
    for key, std in (("means", 1e-3), ("shs_dc", 0.1), ("opacities", 0.3)):
        out[key] = (arrays[key] + std * rng.normal(
            size=arrays[key].shape)).astype(np.float32)
    return out


def train_stage_times(trainer, state, cam, target, bg, reps=3):
    """One training step's stages, as Trainer.train_step runs them."""
    rows = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        leaves = state.params.map(
            lambda _, x: x.detach().requires_grad_(True))
        tap = torch.zeros((state.params.capacity, 2), device="cuda",
                          requires_grad=True)
        ev[0].record()
        out = trainer.renderer.forward(
            GaussianState(params=leaves, alive=state.alive), cam, H, W, bg,
            SH_DEGREE, means2d_tap=tap)
        ev[1].record()
        loss, _ = train_loss(out.render, target)
        ev[2].record()
        grads = torch.autograd.grad(
            loss, [getattr(leaves, k) for k in PARAM_FIELDS] + [tap])
        ev[3].record()
        with torch.no_grad():
            updates, _ = trainer.tx.update(
                GaussianParams(**dict(zip(PARAM_FIELDS, grads))),
                state.opt_state)
            state.params.map(lambda k, x: x + getattr(updates, k))
        ev[4].record()
        torch.cuda.synchronize()
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
    med = np.median(np.asarray(rows), axis=0)
    names = ("render_forward", "loss", "backward", "adam")
    return {k: float(v) for k, v in zip(names, med)}


def phase_training(arrays, rec):
    log("== phase 5: training main path, Trainer.train_step + "
        "maybe_density_ops at 1088x1920")
    model = VanillaGaussianConfig(sh_degree=SH_DEGREE)
    trainer = Trainer(
        model=model,
        density=VanillaDensityControllerConfig(
            densify_from_iter=5, densification_interval=DENSIFY_AT,
            densify_until_iter=100, opacity_reset_interval=RESET_AT,
            cull_opacity_threshold=0.3),
        config=TrainerConfig(max_steps=TRAIN_STEPS + STEPS_AFTER,
                             sh_degree_interval=2))
    bg = torch.zeros(3, device="cuda")
    cams = [camera(c2w) for c2w in views().values()]
    truth = state_from_raw_arrays(arrays, device="cuda")
    with torch.no_grad():
        targets = [trainer.renderer.forward(truth, cam, H, W, bg,
                                            SH_DEGREE).render
                   for cam in cams]
    del truth
    state = trainer.setup(
        state_from_raw_arrays(perturbed(arrays), device="cuda"),
        cameras_extent=TRAIN_EXTENT)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stage = train_stage_times(trainer, state, cams[0], targets[0], bg)
    # the backward's kernels as phase 3 timed them at this pose; the rest
    # is autograd through projection, SH and the loss
    raster = {"rasterize_bwd": rec["bwd_ms"],
              "invert_order": rec["invert_ms"],
              "reduce_grads": rec["reduce_ms"]}
    stage["backward_split"] = dict(
        raster, autograd_rest=stage["backward"] - sum(raster.values()))
    log(f"training stage ms at capacity {state.params.capacity} (CUDA "
        "events, median of 3) " + json.dumps(stage))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, step_ms, density_ms, alive = [], [], {}, {}
    for step in range(1, TRAIN_STEPS + STEPS_AFTER + 1):
        view = step % len(cams)
        t0 = time.perf_counter()
        state, scalars = trainer.train_step(
            state, cams[view], targets[view], H, W,
            trainer.sh_degree_at(step), bg)
        losses.append(float(scalars["loss"]))       # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if step == DENSIFY_AT:
            # a tenth of the seen Gaussians above the threshold
            d = state.density
            stat = (d.grad_accum / d.denom.clamp(min=1.0))[d.denom > 0]
            k = max(int(0.9 * stat.numel()), 1)
            trainer.density_cfg.densify_grad_threshold = float(
                stat.kthvalue(k).values)
        alive[step] = state.gaussians.n_alive
        prev = state
        t0 = time.perf_counter()
        state = trainer.maybe_density_ops(state, gen, step)
        torch.cuda.synchronize()
        if step in (DENSIFY_AT, RESET_AT):
            density_ms[step] = (time.perf_counter() - t0) * 1e3
            cap = prev.params.capacity
            was, now = prev.alive, state.alive[:cap]
            # a split original stays in its slot with smaller scales
            split = (was & now & (state.params.scales[:cap]
                                  != prev.params.scales).any(-1))
            log(f"step {step}: density ops {density_ms[step]:.1f} ms; "
                f"alive {alive[step]} -> {state.gaussians.n_alive} (born "
                f"{int(state.alive.sum() - now.sum() + (~was & now).sum())}"
                f", of them second children of {int(split.sum())} splits; "
                f"pruned {int((was & ~now).sum())}), capacity {cap} -> "
                f"{state.params.capacity}; opacity max "
                f"{float(state.gaussians.get_opacities().max()):.4f}")
        del prev
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(math.isfinite(x) for x in losses):
        fail(f"training: non-finite loss in {losses}")
    first, last = (float(np.mean(losses[:5])),
                   float(np.mean(losses[TRAIN_STEPS - 5:TRAIN_STEPS])))
    if not last < first:
        fail(f"training: mean loss of steps {TRAIN_STEPS - 4}-{TRAIN_STEPS} "
             f"{last} is not below that of steps 1-5 {first}")
    for k in PARAM_FIELDS:
        if not bool(torch.isfinite(getattr(state.params, k)).all()):
            fail(f"training: non-finite {k}")
    if alive[DENSIFY_AT + 1] == alive[DENSIFY_AT]:
        fail("training: the densify changed no alive count")
    if float(state.opt_state.exp_avg["opacities"].abs().max()) == 0.0:
        fail("training: no step after the opacity reset")
    for name, count in launches.items():
        if count <= 0:
            fail(f"training path never launched kernel {name}")
    log(f"training: losses {[round(x, 5) for x in losses]}")
    log(f"training: mean loss steps 1-5 {first:.5f}, steps "
        f"{TRAIN_STEPS - 4}-{TRAIN_STEPS} {last:.5f}; SH degree 3 from step "
        f"6; launches {launches}; peak memory {peak_gb:.3f} GiB")
    log("training: ms per step (host clock, synchronised) "
        + json.dumps([round(x, 2) for x in step_ms]))
    stage = train_stage_times(trainer, state, cams[0], targets[0], bg)
    log(f"training stage ms at capacity {state.params.capacity} (CUDA "
        "events, median of 3) " + json.dumps(stage))
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        sys.exit(2)
    # float32 everywhere: no TF32 in matmuls (projection's p_cam) or
    # convolutions, so the card computes what the CPU tests check
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    log("== phase 1: device and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    log(smi[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {kind} "
        f"x{count}")
    t0 = time.perf_counter()
    logs = cuda_build.build()
    log(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Used" in line or ("spill" in line
                                  and "0 bytes spill stores" not in line):
                log(f"  {name}: {line.strip()}")

    log("== phase 2: scene")
    t0 = time.perf_counter()
    arrays = scene_arrays(N_GAUSSIANS)
    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "point_cloud.ply")
        save_gaussian_ply(ply, **arrays)
        log(f"{N_GAUSSIANS} Gaussians, SH degree {SH_DEGREE}, PLY "
            f"{os.path.getsize(ply) / 2 ** 20:.1f} MiB in "
            f"{time.perf_counter() - t0:.1f} s")
        state = state_from_raw_arrays(arrays, device="cuda")
        renderer = TileRendererConfig().instantiate()
        with torch.no_grad():
            rec = phase_kernels(state, renderer)
            phase_small_reference()
            del state
            torch.cuda.empty_cache()
            launches = phase_main_path(ply)
        torch.cuda.empty_cache()
        train_launches = phase_training(arrays, rec)

    def entry(name, line, err, key, library_ms=None):
        # launches: on the training main path, which runs all four;
        # serving_launches: on the serving main path, where it runs
        bound_ms, bound_by = rec[f"{key}_bound"]
        return {"name": name, "route": "cuda",
                "source": f"gsl_tpu_torch/csrc/{name}.cu",
                "replaces": f"gsl_tpu/ops/rasterize_pallas.py:{line}",
                "launches": train_launches[name],
                "serving_launches": launches.get(name, 0),
                "max_abs_err": err, "ms": rec[f"{key}_ms"],
                "plain_ms": rec[f"{key}_plain_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms}

    kernels = [
        entry("expand", 227, 0.0, "expand"),
        entry("rasterize_fwd", 869, rec["fwd_err"], "fwd"),
        entry("rasterize_bwd", 1069, rec["bwd_err"], "bwd"),
        entry("reduce_grads", 1379, rec["reduce_err"], "reduce",
              rec["reduce_library_ms"]),
    ]
    log(f"backward at the bench pose: invert_order {rec['invert_ms']:.4f} "
        f"ms; K3 errors are of rows up to {rec['bwd_scale']:.3e}, K4's of "
        f"sums up to {rec['reduce_scale']:.3e}")
    log(f"torch.sort of {rec['slots']} int64 keys: {rec['sort_ms']:.4f} ms;"
        f" tile ranges (searchsorted): {rec['ranges_ms']:.4f} ms")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
