"""Smoke run of the PyTorch port's render and training paths (3DGS, 2DGS
and StopThePop) and of its fit through the CLI on one CUDA card.

    python3 chip_smoke.py

Needs one NVIDIA H100 (sm_90a) with nvcc; exits nonzero, printing no
result, when torch.cuda.is_available() is False or the gsl_tpu_torch
package is not beside this script. Phases, each fatal on failure:

1. device and build: the card's name and power limit; the nine kernels
   built from gsl_tpu_torch/csrc/ with nvcc, one process per source, in
   parallel, and K3, K6, K7, K2s and K3s a second time without multiply-add
   contraction for the checks of phase 3.
2. scene: the bench scene of __graft_entry__._synthetic_state (numpy seed
   0, 1,000,000 Gaussians, SH degree 3) with shs_rest ~ 0.1 N(0, 1) so the
   higher SH bands run, saved as a PLY with the port's save_gaussian_ply.
3. kernels against their plain PyTorch versions at full width (1088x1920,
   fx = fy = 1600), at the bench pose (identity) and two orbit views:
   K1 expand must equal expand_plain bit for bit (keys, ids, counts) and
   give the same keys and ids when run twice;
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
   contraction), at all but 1e-5 of every column's values when built
   without contraction, and give the same rows when run twice; K4 reduce,
   on the kernel's rows, must give the same sums twice, equal bit for bit
   the float32 sums of each Gaussian's rows taken in slot order (the order
   K4 adds in), and agree with reduce_grads_plain (index_add_) within
   SUM_RTOL of the summed magnitudes everywhere (only the order of the
   float32 additions differs). A small scene through the whole renderer
   on the card must match the CPU renderer (the plain versions) on all
   but 1e-3 of the values, and so must the gradients of a scalar loss for
   all six parameter tensors.
   The surfel (2DGS) kernels, on the same scene with 2-column scales and
   C = 6 channels (rgb + view-space normal) at the bench pose and the first
   orbit view, and once each with C = 3 and C = 9: K5 surfel expand must
   equal surfel_expand_plain bit for bit and give the same keys and ids
   when run twice; K6 surfel forward must agree
   with rasterize_surfels_fwd_plain on i_stop at >= 99.9% of pixels and on
   the channels, T, sum w depth, distortion, A, M1 and M2 within K2's
   tolerance at all but 1e-4 of the values, and on the median depth at all
   but 1e-3 (a pair counts when alpha >= 1/255, rho3d <= rho2d picks the
   branch, depth >= 0.2, and the median is the first T crossing of 0.5:
   compares on rounded values, and a flipped crossing moves a pixel by a
   whole depth step), and built without contraction on i_stop and every
   output value at all but 1e-5; K7 surfel backward, with seeded normal
   cotangents on the channels, alpha, depth and distortion, must agree with
   rasterize_surfels_bwd_plain like K3 and give the same rows twice; K4
   with no absolute columns sums K7's 13 + C columns as it sums K3's. A
   small surfel scene through SurfelRenderer on the card must match the
   CPU on all seven outputs, and the gradients of a loss with the
   distortion and normal-consistency terms on all six parameter tensors.
   The StopThePop kernels, at the bench pose (C = 3) and the first orbit
   view (C = 8), and K1 also at the second orbit view: K1 with stp_resort
   must equal expand_plain bit for bit and give the same output twice;
   K2s must leave i_stop at NEVER_STOPPED everywhere and agree with
   rasterize_fwd_stp_plain on image and alpha within K2's tolerance at all
   but 1e-4 of the values (two slots of a window whose depths at a pixel
   differ by a rounding may swap between the contracted kernel and the
   plain version, and move the pixel by up to one weight; the share is
   printed), and at all but 1e-5 when built without contraction; K3s, on
   the forward's checkpoints with seeded cotangents, must agree with
   rasterize_bwd_stp_plain column by column like K3 (>= 0.99999 of every
   column when built without contraction) and give the same rows twice; K4
   sums K3s's rows as it sums K3's. A small scene through
   TileRenderer(stp_resort=True), card against CPU: every output and all
   six gradients. A tile of 64 near-opaque Gaussians whose T_final
   underflows to 0: image and gradients finite and equal to the CPU's.
   For K1, K4 (in both row layouts), K3, K3s and K7 (the backward
   kernels of csrc/warp_reduce.cuh's transposed sums) and K6 it also
   prints registers, local (spill) bytes, shared bytes and resident blocks
   per SM as the card's runtime reports them, and for the three backward
   kernels the count of (slot, warp)s, 32 pixels of a tile, in which some
   pixel composites the slot: where the kernels sum a row over a warp (the
   plain versions count them).
4. main path: GaussianModelLoader.load(ply) -> ViewerRenderer -> orbit
   frames at 1088x1920 in rgb, then one frame with alpha, exp_depth,
   inverse_depth, normal and hard_inverse_depth (8 composited channels).
   Outputs must be finite, mean alpha above 0, and both kernels' launch
   counters, zeroed just before, above 0. Then one viewer frame for each
   output type. Prints ms per frame, per-stage times from CUDA events,
   and peak memory.
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
6. 2DGS main path: the scene as 1M surfels (scales[:, :2]) ->
   SurfelRenderer through ViewerRenderer, one orbit frame for each of its
   seven outputs at 1088x1920; then GS2DTrainer.setup at capacity 1M and
   train_steps with the normal-consistency and distortion losses on from
   the first step, each followed by maybe_density_ops, with one densify
   that splits surfels (2-column scales; the capacity grows to 2M), and
   steps after it. Fatal unless the outputs and losses are finite, the
   loss falls, every parameter is finite, surfels were split and K5, K6
   (serving) and K5, K6, K7, K4 (training) were launched, their counters
   zeroed just before each of the two runs.
7. StopThePop main path, at full width: the loader's state and SH degree
   -> ViewerRenderer over TileRendererConfig(stp_resort=True).instantiate()
   (the renderer of gsl_tpu/configs/stp.yaml; the loader itself has no
   switch for it in either package): orbit frames in rgb, one frame with
   all outputs, one viewer frame per output type. Then Trainer.setup at
   capacity 1M over the same renderer config: 12 train_steps with
   maybe_density_ops as phase 5 runs them, a densify at step 12 that grows
   the capacity to 2M, and 3 steps after it (phase 5 takes 20 + 6 and an
   opacity reset; the cut is in depth only). Fatal unless outputs, losses
   and parameters are finite, the mean loss of steps 10-12 is below that of
   steps 1-3, and K1, K2s (serving) and K1, K2s, K3s, K4 (training) were
   launched and no kernel of another path was, the counters zeroed just
   before each run. Prints ms per frame and per step, the stage split, peak
   memory, and the same numbers of phases 4 and 5 beside them.
8. fit main path, through the CLI: 24 views of the bench scene rendered by
   the port at 1088x1920 (the bench pose, then an orbit around TARGET)
   written as images/*.png, and sparse/0/{cameras,images,points3D}.bin
   written by the port's write_model_bin, with 100,000 of the bench means
   and their DC colours as the SfM points. Then
   gsl_tpu_torch.cli.main(["fit", "--config",
   "gsl_tpu_torch/configs/colmap.yaml", ...]) for 300 steps with
   densify_from_iter=100 and densification_interval=100 (every other
   field at the preset's value), and again to 600 steps, which must resume
   at 301; then "validate", and GaussianModelLoader.load on the run, which
   must pick the step-600 checkpoint and render a frame; then 100-step fits
   of gs2d.yaml and stp.yaml on the same data. Each command runs with the
   launch counters zeroed just before: the fits must launch every kernel
   of their path (K1-K4; K5-K7 and K4; K1, K2s, K3s and K4) and no other.
   Fatal on a non-finite loss, a val PSNR at step 600 not above the
   initial cloud's, or a missing checkpoint, PLY or CSV. Prints ms per
   step in each log window (and the median over the windows after each
   run's first), the share of wall time spent waiting on next(loader), ms
   per densify and the rows it cloned, split and pruned, the Gaussian count
   per window, peak memory, the val PSNR
   of the initial cloud and at steps 300 and 600, and each fit's launches.

Bounds in the kernels line: the larger of bytes / 3.35 TB/s and
operations / 67 TFLOP/s (H100 SXM f32 without tensor cores). K1 moves 52
bytes per Gaussian and 12 per slot, and does ~40 operations per real slot
(the tile cull). K2 reads each Gaussian's mean, conic, opacity and C
channels and each sorted id once and writes C + 2 values per pixel; of the
(pixel, splat) pairs that this run's pixels visited up to their stop it
does 12 operations on each (the offsets, sigma and the compare with the
splat's cut), 5 more on each at or below the cut (the exponential, alpha
and its test; the plain version counts them) and 3 + 2C more on each
composited one (counted in csrc/rasterize_fwd.cu). K3 moves the forward's bytes plus one row of 6 + C
values per valid slot; it does 18 operations per (pixel, splat) pair
before the pixel's stop and 35 + 4C more per composited pair (counted in
csrc/rasterize_bwd.cu). K4 reads each valid row, 4 bytes per slot and 8
per Gaussian of indices, writes 8 + C values per Gaussian, and does one
addition per value read. K4's library_ms is one index_add_ of the rows
with the absolute columns attached. K5 moves 28 bytes per surfel and 12 per
slot. K6 reads 52 + 4C bytes per surfel and each sorted id once and writes
C + 8 values per pixel; it does 47 operations per visited (pixel, surfel)
pair and 26 + 2C more per composited pair. K7 moves those bytes, the
cotangents and one row of 13 + C values per valid slot, and does 48
operations per pair before the pixel's stop and 123 + 4C more per
composited pair (both counted in the kernels' sources). K1 with
stp_resort reads 8 more bytes per Gaussian. K2s and K3s have no stop, so
every pixel visits its tile's whole list: pairs = pixels x the tile's valid
slots. K2s does 12 operations per pair, 5 more per pair at or below the
cut, 9 + 2C more per composited pair and n_live^2 compares per (pixel,
window) whose n_live live entries are out of order, counted by the plain
version (csrc/rasterize_fwd_stp.cu). K3s repeats K2s's walk and is
charged what K2s is (12 + 5 at or below the cut + 9 + 2C a composited
pair), 35 + 4C more per composited pair, n_live^2 compares per such
window and 5 + 2C per live entry of it (csrc/rasterize_bwd_stp.cu), and
moves the checkpoints (64 bytes per sorted slot) on top of K3's bytes. A
kernel's `ms`, and a library call's, is the mean of 20 replays of one
wrapper call captured in a CUDA graph, between CUDA events: the host's
per-call cost would pace K1's 0.04 ms and K5's 0.03 ms kernels; the plain
versions read the device from the host and are timed by calls between
CUDA events. In the kernels line, `launches` is a kernel's count
on the training path of its own model (K1-K4: phase 5; K5-K7: phase
6; K2s, K3s: phase 7) and `serving_launches` on the serving path; K4 also
carries its surfel-layout numbers under `surfel_*` keys, and K1 its
StopThePop numbers (phase 7's counts) under `stp_*` keys. All nine
kernels (K4 with R = 9 and, under `surfel_attributes`, R = 19) carry their
`attributes` as the card's runtime reports them.

The last line is {"ok": true, "device": {...}}.
"""
import concurrent.futures
import contextlib
import csv
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from PIL import Image

from gsl_tpu_torch import cli
from gsl_tpu_torch.data.cameras import make_camera
from gsl_tpu_torch.data.colmap_io import (ColmapCamera, ColmapImage,
                                          ColmapModel, rotmat_to_qvec,
                                          write_model_bin)
from gsl_tpu_torch.ops import cuda_build
from gsl_tpu_torch.ops import rasterize as R
from gsl_tpu_torch.ops import rasterize_stp as STP
from gsl_tpu_torch.ops import surfel_rasterize as SR
from gsl_tpu_torch.ops.projection import Projections, project_gaussians
from gsl_tpu_torch.ops.sh import sh_to_rgb
from gsl_tpu_torch.ops.surfel import project_surfels
from gsl_tpu_torch.ops.transforms import quat_to_rotmat
from gsl_tpu_torch.models.gaussian import (PARAM_FIELDS, GaussianParams,
                                           GaussianState,
                                           VanillaGaussianConfig)
from gsl_tpu_torch.models.gaussian_2d import Gaussian2DConfig
from gsl_tpu_torch.renderers.surfel_renderer import SurfelRendererConfig
from gsl_tpu_torch.renderers.tile_renderer import TileRendererConfig
from gsl_tpu_torch.training.density import VanillaDensityControllerConfig
from gsl_tpu_torch.training.fit import _init_gaussians, validate
from gsl_tpu_torch.training.gs2d import GS2DMetricsConfig, GS2DTrainer
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
# K3, K7: per column, GRAD_ATOL of the column's own scale (the 99th
# percentile of the reference's nonzero magnitudes) + GRAD_RTOL |ref|
GRAD_ATOL, GRAD_RTOL, GRAD_SHARE = 1e-4, 1e-3, 0.999
# K7's solve takes hx = px Tw - Tu and the cross product hx x hy, both
# differences of products some 1e3 times their result; the kernel contracts
# them to multiply-adds and the plain version does not, so more pairs round
# apart than in K3
SURFEL_GRAD_SHARE = 0.995
# ... and K7 built without contraction rounds as the plain version does;
# so do K2, K3 and K6, whose skip, stop and keep decisions are compares on
# the same values, and K2s and K3s, where a contracted d_p can swap two
# slots of a window
UNCONTRACTED_SHARE = 0.99999
UNCONTRACTED = ("rasterize_fwd", "rasterize_bwd", "surfel_fwd",
                "surfel_bwd", "rasterize_fwd_stp", "rasterize_bwd_stp")
# K4: of the sum of the magnitudes that went into each sum
SUM_RTOL = 1e-5
K3_COLUMNS = ("dmx", "dmy", "da", "db", "dc", "dop")
K7_COLUMNS = ("Tu0", "Tu1", "Tu2", "Tv0", "Tv1", "Tv2", "Tw0", "Tw1", "Tw2",
              "zc0", "zc1", "zc2", "op")
MEDIAN_OFF_SHARE = 1e-3                                  # K6's median depth
KERNELS = {"expand": R.expand, "rasterize_fwd": R.rasterize_fwd,
           "rasterize_bwd": R.rasterize_bwd, "reduce_grads": R.reduce_grads,
           "surfel_expand": SR.surfel_expand,
           "surfel_fwd": SR.rasterize_surfels_fwd,
           "surfel_bwd": SR.rasterize_surfels_bwd,
           "rasterize_fwd_stp": STP.rasterize_fwd_stp,
           "rasterize_bwd_stp": STP.rasterize_bwd_stp}
GAUSSIAN_KERNELS = ("expand", "rasterize_fwd", "rasterize_bwd",
                    "reduce_grads")
STP_KERNELS = ("expand", "rasterize_fwd_stp", "rasterize_bwd_stp",
               "reduce_grads")
SURFEL_KERNELS = ("surfel_expand", "surfel_fwd", "surfel_bwd",
                  "reduce_grads")
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


def graph_ms(fn, iters):
    """Mean ms per call of `fn` captured once in a CUDA graph and replayed
    `iters` times between CUDA events: the kernels' time without the host's
    per-call cost, which paces a wrapper whose kernel takes tens of
    microseconds (K1, K5). Every kernel's and library call's `ms` in the
    kernels line is timed so; the plain versions, which read the device
    from the host, with `cuda_ms`."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


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
    err = max(off_share(f"{name} image", got[0], want[0], OFF_SHARE),
              off_share(f"{name} alpha", 1 - got[1], 1 - want[1],
                        OFF_SHARE))
    return err, share


def value_share(got, want):
    """The share of values within ATOL + RTOL |want|."""
    bad = (got - want).abs() > ATOL + RTOL * want.abs()
    return 1.0 - float(bad.float().mean())


def off_share(name, got, want, limit):
    """Fails unless all but `limit` of the values are finite and within
    ATOL + RTOL |want|. Returns the largest absolute difference."""
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite values")
    d = (got - want).abs()
    bad = d > ATOL + RTOL * want.abs()
    if float(bad.float().mean()) > limit:
        i = int(torch.argmax(d.flatten()))
        fail(f"{name}: differs beyond tolerance at {int(bad.sum())} of "
             f"{bad.numel()} values; worst {float(got.flatten()[i])} vs "
             f"{float(want.flatten()[i])}")
    return float(d.max())


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


def warp_steps(i_stop, bounds, tiles_x):
    """A forward kernel's warp walks its tile's list until all 32 of its
    pixels have stopped (K6). Returns the (warp, slot) steps, those in
    which some lane of the warp has already stopped (or lies outside the
    image), and the lane steps that idle in them."""
    height, width = i_stop.shape
    ys = torch.arange(height, device=i_stop.device)[:, None] // TILE
    xs = torch.arange(width, device=i_stop.device)[None, :] // TILE
    tile = ys * tiles_x + xs
    start, end = bounds[tile], bounds[tile + 1]
    stop = i_stop.to(torch.int64)
    visited = torch.where(stop < R.NEVER_STOPPED, stop + 1, end) - start
    lanes = R._image_to_tiles(visited[..., None], tiles_x,
                              -(-height // TILE), TILE)[..., 0]
    lanes = lanes.reshape(lanes.shape[0], -1, 32)
    most, least = lanes.max(-1).values, lanes.min(-1).values
    return {"warp_steps": int(most.sum()),
            "steps_with_stopped_lanes": int((most - least).sum()),
            "idle_lane_steps": int((most[..., None] - lanes).sum())}


def log_attributes(name, C, attrs):
    """A kernel's resources as the card's runtime reports them; C None for
    a kernel without channels."""
    tag = name if C is None else f"{name} C={C}"
    log(f"{tag} attributes: {attrs['registers']} registers, "
        f"{attrs['local_bytes']} local (spill) bytes per thread, "
        f"{attrs['shared_bytes']} dynamic shared bytes per block, "
        f"{attrs['blocks_per_sm']} resident blocks per SM")


def reset_launches():
    for wrapper in KERNELS.values():
        wrapper.launches = 0


def read_launches():
    return {name: w.launches for name, w in KERNELS.items()}


def column_shares(name, got, want):
    """Per column of a backward kernel's rows [n, R]: (scale, share). The
    columns have different units, and a few near-degenerate rows reach
    magnitudes far above a column's typical one, so a column's scale is
    the 99th percentile of the reference's nonzero magnitudes, and its
    share is that of its values within GRAD_ATOL scale + GRAD_RTOL |ref|."""
    d = (got - want).abs()
    pairs = []
    for c in range(want.shape[1]):
        mag = want[:, c].abs()
        nonzero = mag[mag > 0]
        if nonzero.numel() == 0:
            fail(f"{name}: the reference's column {c} is all zero")
        k = max(1, math.ceil(0.99 * nonzero.numel()))
        scale = float(nonzero.kthvalue(k).values)
        bad = d[:, c] > GRAD_ATOL * scale + GRAD_RTOL * mag
        pairs.append((scale, 1.0 - float(bad.float().mean())))
    return pairs


def check_rows(name, got, want, geometry_columns, limit):
    """A backward kernel's rows against its plain version's: every column
    must agree at `limit` of its values (a flipped keep or stop decision
    changes a whole row). Returns (largest absolute difference, smallest
    share)."""
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite rows")
    n_ch = want.shape[1] - len(geometry_columns)
    columns = tuple(geometry_columns) + tuple(f"ch{i}" for i in range(n_ch))
    pairs = column_shares(name, got, want)
    log(f"{name}: column scale/share " + ", ".join(
        f"{col} {scale:.3g}/{share:.6f}"
        for col, (scale, share) in zip(columns, pairs)))
    for col, (scale, share) in zip(columns, pairs):
        if share < limit:
            fail(f"{name}: column {col} agrees with the plain version on "
                 f"{share:.6f} of its values < {limit} (column scale "
                 f"{scale:.4g})")
    return float((got - want).abs().max()), min(s for _, s in pairs)


def check_sums(name, summed, summed_p, rows, gids, n, n_abs):
    """K4's per-Gaussian sums against reduce_grads_plain's. The two add
    the same float32 rows in different orders, so each sum may differ by a
    rounding of what went into it: SUM_RTOL of the sum of those rows'
    magnitudes, nothing more. Returns the largest absolute difference."""
    into = R.reduce_grads_plain(rows.abs(), gids, n, n_abs=n_abs)
    sd = (summed - summed_p).abs()
    bad = ~(sd <= SUM_RTOL * into)
    if bool(bad.any()):
        i = int(torch.argmax((sd - SUM_RTOL * into).flatten()))
        fail(f"{name}: {int(bad.sum())} sums differ from "
             f"reduce_grads_plain beyond {SUM_RTOL} of their summed "
             f"magnitudes; worst {float(summed.flatten()[i])} vs "
             f"{float(summed_p.flatten()[i])} (magnitudes "
             f"{float(into.flatten()[i])})")
    return float(sd.max())


def check_reduce(name, red, rows, gids, n, n_abs):
    """K4 on one layout of rows: identical in two runs, equal to the sums in
    slot order bit for bit, and within SUM_RTOL of reduce_grads_plain's.
    Returns (sums, plain sums, largest absolute difference from the
    plain)."""
    summed = R.reduce_grads(*red, n_abs=n_abs)
    summed_p = R.reduce_grads_plain(rows, gids, n, n_abs=n_abs)
    torch.cuda.synchronize()
    if not torch.equal(summed, R.reduce_grads(*red, n_abs=n_abs)):
        fail(f"{name}: two runs gave different sums")
    exact = R.reduce_grads_slot_order(rows, *red[2:6], n_abs=n_abs)
    if not torch.equal(summed, exact):
        fail(f"{name}: {int((summed != exact).sum())} sums differ from "
             "the float32 sums in slot order")
    return summed, summed_p, check_sums(name, summed, summed_p, rows, gids,
                                        n, n_abs)


def check_backward(vname, C, bwd, isects, order, n, timed):
    """K3 and K4 against their plain versions; with `timed`, their times
    and bounds too. Returns a dict of what was measured."""
    gids, bounds = bwd[4], bwd[5]
    rows = R.rasterize_bwd(*bwd)
    again = R.rasterize_bwd(*bwd)
    stats = {}
    rows_p = R.rasterize_bwd_plain(*bwd, stats=stats)
    torch.cuda.synchronize()
    if not torch.equal(rows, again):
        fail(f"K3 {vname}: two runs gave different rows")
    bwd_err, share = check_rows(f"K3 {vname} C={C}", rows, rows_p,
                                K3_COLUMNS, GRAD_SHARE)
    _, ushare = check_rows(f"K3 {vname} C={C} built without contraction",
                           R.rasterize_bwd(*bwd, contract=False), rows_p,
                           K3_COLUMNS, UNCONTRACTED_SHARE)
    inv = R.invert_order(order)
    red = (rows, gids, isects.offsets, inv, bounds[-1:], n)
    summed, summed_p, reduce_err = check_reduce(f"K4 {vname} C={C}", red,
                                                rows, gids, n, 2)
    scale, sscale = float(rows_p.abs().max()), float(summed_p.abs().max())
    rec = {"bwd_err": bwd_err, "bwd_share": share,
           "bwd_scale": scale, "reduce_err": reduce_err,
           "reduce_scale": sscale,
           "composited_pairs": stats["composited_pairs"],
           "composited_slot_warps": stats["composited_slot_warps"]}
    log(f"K3 {vname} C={C}: every column agrees on >= {share:.6f} of its "
        f"values (>= {ushare:.7f} when built without contraction), max abs "
        f"err {rec['bwd_err']:.3e} (max |ref| {scale:.3e}); identical in "
        f"two runs. K4: identical in two runs, equal to the sums in slot "
        f"order, max abs err from index_add_ {rec['reduce_err']:.3e} (max "
        f"|ref| {sscale:.3e}); composited pairs {stats['composited_pairs']}; "
        f"(slot, warp)s with a composited pixel "
        f"{stats['composited_slot_warps']}")
    if not timed:
        return rec
    rec["bwd_attributes"] = R.rasterize_bwd_attributes(C, TILE)
    log_attributes("K3", C, rec["bwd_attributes"])
    rec["reduce_attributes"] = R.reduce_grads_attributes(6 + C, 2)
    log_attributes(f"K4 R={6 + C} n_abs=2", None, rec["reduce_attributes"])
    gids64 = gids.long()
    full = torch.cat([rows[:, :6], rows[:, :2].abs(), rows[:, 6:]], 1)
    out = torch.empty((n, full.shape[1]), device=rows.device)
    rec.update(
        bwd_ms=graph_ms(lambda: R.rasterize_bwd(*bwd), 20),
        bwd_plain_ms=cuda_ms(lambda: R.rasterize_bwd_plain(*bwd), 1,
                             warmup=0),
        invert_ms=graph_ms(lambda: R.invert_order(order), 20),
        reduce_ms=graph_ms(lambda: R.reduce_grads(*red), 20),
        reduce_plain_ms=cuda_ms(
            lambda: R.reduce_grads_plain(rows, gids, n), 5),
        reduce_library_ms=graph_ms(
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
        if not all(torch.equal(a, b) for a, b in zip(
                (keys_k, gids_k), R.expand(*args))):
            fail(f"K1 {vname}: two runs gave different keys or ids")
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
        log(f"K1 {vname}: bit-identical, identical in two runs; slots "
            f"{isects.total} real {isects.n_isects} valid {n_valid} culled "
            f"{culled}")
        bounds = R.tile_bounds(sk_k, n_tiles)
        gids = gs_k[:n_valid].contiguous()
        fwd = (m2d, con, opac, ch, gids, bounds, H, W, TILE)
        got = R.rasterize_fwd(*fwd)
        again = R.rasterize_fwd(*fwd)
        fstats = {}
        want = R.rasterize_fwd_plain(*fwd, stats=fstats)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"K2 {vname}: two runs gave different outputs")
        err, share = compare_raster(f"K2 {vname} C={C}", got, want)
        # the same source built without contraction rounds as the plain
        # version
        loose = R.rasterize_fwd(*fwd, contract=False)
        ustop = float((loose[2] == want[2]).float().mean())
        if ustop < UNCONTRACTED_SHARE:
            fail(f"K2 {vname} C={C} built without contraction: i_stop "
                 f"agrees on {ustop:.6f} of pixels < {UNCONTRACTED_SHARE}")
        off_share(f"K2 {vname} C={C} image, built without contraction",
                  loose[0], want[0], 1.0 - UNCONTRACTED_SHARE)
        off_share(f"K2 {vname} C={C} alpha, built without contraction",
                  1 - loose[1], 1 - want[1], 1.0 - UNCONTRACTED_SHARE)
        ushare = min(value_share(loose[0], want[0]),
                     value_share(loose[1], want[1]))
        log(f"K2 {vname} C={C}: i_stop agrees on {share:.6f}, max abs err "
            f"{err:.3e}; identical in two runs; built without contraction: "
            f"i_stop agrees on {ustop:.7f}, image and T within tolerance at "
            f">= {ushare:.7f} of their values")
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
            "expand_ms": graph_ms(lambda: R.expand(*args), 20),
            "expand_plain_ms": cuda_ms(lambda: R.expand_plain(*args), 3),
            "sort_ms": graph_ms(lambda: R.sort_slots(keys_k, gids_k), 20),
            "ranges_ms": graph_ms(lambda: R.tile_bounds(sk_k, n_tiles), 20),
            "fwd_ms": graph_ms(lambda: R.rasterize_fwd(*fwd), 20),
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
        # 12 operations a visited pair, 5 more at or below the cut, 3 + 2C
        # more a composited one (K3's plain version counts those)
        near = fstats["near_pairs"]
        t["fwd_bound"] = bound(
            fwd_bytes,
            12 * pairs + 5 * near + (3 + 2 * C) * rec["composited_pairs"])
        t.update(n_isects=isects.n_isects, slots=isects.total,
                 n_valid=n_valid, pairs=pairs, near_pairs=near)
        log("bench-pose timings " + json.dumps(t))
        t["fwd_attributes"] = R.rasterize_fwd_attributes(C, TILE)
        log_attributes("K2", C, t["fwd_attributes"])
        t["expand_attributes"] = R.expand_attributes()
        log_attributes("K1", None, t["expand_attributes"])
        rec.update(t)
    return rec


def check_stp_kernels(vname, C, state, renderer, cam, seed, timed):
    """K1 with stp_resort, K2s, K3s and K4 on K3s's rows against their
    plain versions at one view; with `timed`, their times and bounds."""
    tiles_x, tiles_y = -(-W // TILE), -(-H // TILE)
    n_tiles = tiles_x * tiles_y
    n = state.capacity
    tag = f"{vname} C={C}"
    proj = project_gaussians(
        state.get_means(), state.get_scales(), state.get_rotations(),
        cam.world_to_camera, cam.fx, cam.fy, cam.cx, cam.cy, W, H)
    opac = renderer.get_opacities(state, proj).contiguous()
    ch = channels_for(state, renderer, proj, cam, C)
    m2d, con = proj.means2d.contiguous(), proj.conics.contiguous()
    depths, kz = proj.depths.contiguous(), proj.depth_grads.contiguous()
    isects = R.isect_encode(proj, H, W, TILE)
    args = (isects, m2d, con, opac, depths, tiles_x, tiles_y, TILE, True,
            True, kz)
    keys_k, gids_k = R.expand(*args)
    keys_p, gids_p = R.expand_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(keys_k, keys_p) and torch.equal(gids_k, gids_p)):
        fail(f"K1 stp {tag}: kernel differs from expand_plain at "
             f"{int((keys_k != keys_p).sum())} slots")
    if not all(torch.equal(a, b) for a, b in zip((keys_k, gids_k),
                                                 R.expand(*args))):
        fail(f"K1 stp {tag}: two runs gave different keys or ids")
    plain_keys, _ = R.expand(*args[:9])
    moved = int((plain_keys != keys_k).sum())
    sk, gs, order = R.sort_slots(keys_k, gids_k)
    bounds = R.tile_bounds(sk, n_tiles)
    n_valid = int(bounds[-1])
    counts = bounds[1:] - bounds[:-1]
    off16 = int(((bounds[:-1] % STP.STP_WINDOW != 0) & (counts > 0)).sum())
    n_windows = int(torch.where(
        counts > 0, (bounds[1:] - 1) // STP.STP_WINDOW
        - bounds[:-1] // STP.STP_WINDOW + 1, 0).sum())
    log(f"K1 stp {tag}: bit-identical, identical in two runs; slots "
        f"{isects.total} real "
        f"{isects.n_isects} valid {n_valid}; {moved} keys differ from the "
        f"centre-depth keys; longest tile list {int(counts.max())}, mean "
        f"{float(counts.float().mean()):.1f}; {off16} of {n_tiles} tile "
        f"ranges start off a multiple of 16; {n_windows} (tile, window)s")

    fwd = (m2d, con, opac, ch, depths, kz, gs, bounds, H, W, TILE)
    got = STP.rasterize_fwd_stp(*fwd, checkpoints=True)
    stats = {}
    t0 = time.perf_counter()
    want = STP.rasterize_fwd_stp_plain(*fwd, checkpoints=True, stats=stats)
    torch.cuda.synchronize()
    fwd_plain_ms = (time.perf_counter() - t0) * 1e3
    if not bool((got[2] == R.NEVER_STOPPED).all()):
        fail(f"K2s {tag}: i_stop is not NEVER_STOPPED everywhere")
    fwd_err = max(
        off_share(f"K2s {tag} image", got[0], want[0], OFF_SHARE),
        off_share(f"K2s {tag} alpha", 1 - got[1], 1 - want[1], OFF_SHARE))
    share = 1.0 - float(((got[0] - want[0]).abs()
                         > ATOL + RTOL * want[0].abs()).float().mean())
    loose = STP.rasterize_fwd_stp(*fwd, checkpoints=True, contract=False)
    off_share(f"K2s {tag} image, built without contraction", loose[0],
              want[0], 1.0 - UNCONTRACTED_SHARE)
    off_share(f"K2s {tag} alpha, built without contraction", 1 - loose[1],
              1 - want[1], 1.0 - UNCONTRACTED_SHARE)
    ushare = 1.0 - float(((loose[0] - want[0]).abs()
                          > ATOL + RTOL * want[0].abs()).float().mean())
    if not all(torch.equal(a, b) for a, b in zip(
            got[:3], STP.rasterize_fwd_stp(*fwd)[:3])):
        fail(f"K2s {tag}: two runs gave different outputs")
    log(f"K2s {tag}: image within tolerance at {share:.7f} of values "
        f"({ushare:.7f} when built without contraction), max abs err "
        f"{fwd_err:.3e}; identical in two runs; i_stop never stopped; "
        f"pixels with T_final == 0: {int((got[1] == 0).sum())}, "
        f"T_final < 1e-4: {int((got[1] < 1e-4).sum())}; (pixel, window) "
        f"pairs out of order {stats['unordered_windows']} of "
        f"{stats['pixel_windows']}, (window, warp)s with one "
        f"{stats['unordered_warp_windows']}; live entries "
        f"{stats['live_entries']}, {stats['unordered_live_entries']} of "
        f"them in out-of-order windows (sum of squares "
        f"{stats['unordered_live_squares']}); pairs at or below the cut "
        f"{stats['near_pairs']}")

    gen = torch.Generator(device="cuda").manual_seed(seed)
    g_out = torch.randn((H, W, C), generator=gen, device="cuda")
    g_alpha = torch.randn((H, W), generator=gen, device="cuda")
    bwd = fwd[:8] + (g_out, g_alpha, got[1], got[3], TILE)
    rows = STP.rasterize_bwd_stp(*bwd)
    again = STP.rasterize_bwd_stp(*bwd)
    t0 = time.perf_counter()
    rows_p = STP.rasterize_bwd_stp_plain(
        *fwd[:8], g_out, g_alpha, want[1], want[3], TILE, stats=stats)
    torch.cuda.synchronize()
    bwd_plain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(rows, again):
        fail(f"K3s {tag}: two runs gave different rows")
    bwd_err, gshare = check_rows(f"K3s {tag}", rows, rows_p, K3_COLUMNS,
                                 GRAD_SHARE)
    rows_u = STP.rasterize_bwd_stp(*fwd[:8], g_out, g_alpha, loose[1],
                                   loose[3], TILE, contract=False)
    _, gushare = check_rows(f"K3s {tag} built without contraction", rows_u,
                            rows_p, K3_COLUMNS, UNCONTRACTED_SHARE)
    red = (rows, gs, isects.offsets, R.invert_order(order), bounds[-1:], n)
    _, _, reduce_err = check_reduce(f"K4 on K3s's rows {tag}", red, rows, gs,
                                    n, 2)
    composited = stats["composited_pairs"]
    log(f"K3s {tag}: every column agrees on >= {gshare:.6f} of its values "
        f"(>= {gushare:.7f} when built without contraction), max abs err "
        f"{bwd_err:.3e} (max |ref| {float(rows_p.abs().max()):.3e}); "
        f"identical in two runs. K4: identical in two runs, equal to the "
        f"sums in slot order, max abs err from index_add_ {reduce_err:.3e}; "
        f"composited pairs {composited}; (slot, warp)s with a composited "
        f"pixel {stats['composited_slot_warps']}")
    rec = {"fwd_err": fwd_err, "bwd_err": bwd_err}
    if not timed:
        return rec
    attrs = STP.rasterize_bwd_stp_attributes(C, TILE)
    log_attributes("K3s", C, attrs)
    fwd_attrs = STP.rasterize_fwd_stp_attributes(C, TILE)
    log_attributes("K2s", C, fwd_attrs)
    # with no stop every pixel visits its tile's whole list
    ys = torch.arange(H, device="cuda")[:, None] // TILE
    xs = torch.arange(W, device="cuda")[None, :] // TILE
    pairs = int(counts[ys * tiles_x + xs].sum())
    unordered = stats["unordered_windows"]
    ckpt_bytes = 4 * got[3].numel()
    fwd_bytes = (n * (36 + 4 * C) + 4 * n_valid + 8 * (n_tiles + 1)
                 + H * W * (4 * C + 8))
    rec.update(
        fwd_plain_ms=fwd_plain_ms, bwd_plain_ms=bwd_plain_ms,
        expand_ms=graph_ms(lambda: R.expand(*args), 20),
        expand_plain_ms=cuda_ms(lambda: R.expand_plain(*args), 3),
        fwd_ms=graph_ms(lambda: STP.rasterize_fwd_stp(*fwd), 20),
        fwd_checkpoints_ms=graph_ms(
            lambda: STP.rasterize_fwd_stp(*fwd, checkpoints=True), 20),
        bwd_ms=graph_ms(lambda: STP.rasterize_bwd_stp(*bwd), 20),
        reduce_ms=graph_ms(lambda: R.reduce_grads(*red), 20),
        expand_bound=bound(60 * n + 12 * isects.total,
                           48 * isects.n_isects),
        fwd_bound=bound(fwd_bytes, 12 * pairs + 5 * stats["near_pairs"]
                        + (9 + 2 * C) * composited
                        + stats["unordered_live_squares"]),
        bwd_bound=bound(
            fwd_bytes + ckpt_bytes + 4 * H * W + 4 * (6 + C) * n_valid,
            12 * pairs + 5 * stats["near_pairs"] + (9 + 2 * C) * composited
            + (35 + 4 * C) * composited + stats["unordered_live_squares"]
            + (5 + 2 * C) * stats["unordered_live_entries"]),
        slots=isects.total, n_isects=isects.n_isects, n_valid=n_valid,
        pairs=pairs, composited_pairs=composited,
        unordered_windows=unordered, checkpoint_bytes=ckpt_bytes,
        composited_slot_warps=stats["composited_slot_warps"],
        unordered_warp_windows=stats["unordered_warp_windows"],
        live_entries=stats["live_entries"], near_pairs=stats["near_pairs"],
        unordered_live_squares=stats["unordered_live_squares"],
        bwd_attributes=attrs, fwd_attributes=fwd_attrs)
    log(f"stp {tag} timings " + json.dumps(
        {k: v for k, v in rec.items() if not k.endswith("_err")}))
    return rec


def phase_stp_kernels(state, renderer):
    log("== phase 3 (StopThePop): K1 with stp_resort, K2s, K3s and K4 "
        "against their plain versions, full width")
    named = views()
    rec = {}
    for seed, (vname, C, timed) in enumerate((("bench", 3, True),
                                              ("orbit_yaw20", 8, False),
                                              ("orbit_yaw-35", 3, False))):
        r = check_stp_kernels(vname, C, state, renderer,
                              camera(named[vname]), 20 + seed, timed)
        for k in ("fwd_err", "bwd_err"):
            rec[k] = max(rec.get(k, 0.0), r.pop(k))
        rec.update(r)
    return rec


def phase_stp_saturated():
    """A tile whose T_final underflows to 0, on the card: 64 Gaussians of
    opacity 0.99 on one spot. Outputs and every gradient must be finite
    and match the CPU's (the plain versions)."""
    rng = np.random.RandomState(5)
    n = 64
    arrays = dict(
        means2d=(8.0 + 0.05 * rng.randn(n, 2)), depths=rng.rand(n) * 3 + 1,
        conics=np.tile([0.05, 0.0, 0.05], (n, 1)), kz=rng.rand(n, 2) * 0.2,
        opac=np.full(n, 0.99), ch=rng.rand(n, 3))
    grads, finals = {}, {}
    for dev in ("cuda", "cpu"):
        t = {k: torch.tensor(v, dtype=torch.float32, device=dev)
             for k, v in arrays.items()}
        leaves = [t[k].requires_grad_(True)
                  for k in ("means2d", "conics", "opac", "ch")]
        proj = Projections(
            means2d=leaves[0], depths=t["depths"],
            radii=torch.full((n,), 8, dtype=torch.int32, device=dev),
            conics=leaves[1], compensations=None, mask=None,
            depth_grads=t["kz"])
        with torch.enable_grad():
            img, alpha, aux = R.rasterize(proj, leaves[2], leaves[3], 16, 16,
                                          TILE, True, stp_resort=True)
            wr = torch.rand((16, 16, 3), generator=torch.Generator(
                ).manual_seed(1)).to(dev)
            ((img * wr).sum() + alpha.sum()).backward()
        grads[dev] = [x.grad.cpu() for x in leaves]
        finals[dev] = (img.detach().cpu(), aux.t_final.cpu())
    n_zero = int((finals["cuda"][1] == 0).sum())
    if n_zero == 0:
        fail("saturated tile: T_final never reached 0 on the card")
    if not bool(torch.isfinite(finals["cuda"][0]).all()):
        fail("saturated tile: non-finite image")
    for name, g, w in zip(("means2d", "conics", "opacities", "channels"),
                          grads["cuda"], grads["cpu"]):
        scale = float(w.abs().max())
        bad = (g - w).abs() > 1e-3 * scale + 1e-2 * w.abs()
        if not bool(torch.isfinite(g).all()) or bool(bad.any()):
            fail(f"saturated tile d / d {name}: non-finite, or differs from "
                 f"the CPU's at {int(bad.sum())} values (max |ref| {scale})")
    log(f"saturated tile (64 Gaussians of opacity 0.99, 16x16): T_final is "
        f"0 at {n_zero} pixels; image and all four gradients finite and "
        "equal to the CPU's")


def phase_small_reference(stp=False):
    """The whole renderer on a small scene, card vs CPU (plain versions);
    with `stp`, the StopThePop renderer."""
    config = TileRendererConfig(stp_resort=stp)
    tag = "small STP scene" if stp else "small scene"
    arrays = scene_arrays(400, seed=1)
    arrays["means"][:, 2] -= 2.0  # nearer: larger splats, longer lists
    c2w = np.eye(4)
    outs = {}
    for dev in ("cuda", "cpu"):
        state = state_from_raw_arrays(arrays, device=dev)
        renderer = config.instantiate()
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
            fail(f"{tag} {key}: card matches the CPU renderer at "
                 f"{share:.5f} of values")
    log(f"{tag} (400 Gaussians, 128x96): card renderer matches the CPU "
        "renderer on every output")
    grads = {}
    for dev in ("cuda", "cpu"):
        state = state_from_raw_arrays(arrays, device=dev)
        state.params = state.params.map(
            lambda _, x: x.requires_grad_(True))
        target = torch.rand((96, 128, 3), generator=torch.Generator(
            ).manual_seed(3)).to(dev)
        with torch.enable_grad():
            out = config.instantiate().forward(
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
            fail(f"{tag} d loss / d {key}: card matches the CPU at "
                 f"{share:.5f} of values (max |ref| {scale})")
    log(f"{tag}: the gradients of the L1 + SSIM loss for all six "
        "parameter tensors match the CPU's")


def surfel_arrays(arrays):
    """The scene as surfels: the first two scale columns (bench.py's
    2DGS line)."""
    return dict(arrays, scales=arrays["scales"][:, :2])


def surfel_inputs(state, cam, n_channels):
    """What SurfelRenderer.forward hands the rasterizer: the projection,
    geom [N, 13] and the channels: rgb (C = 3), rgb + view-space normal
    (C = 6), or those and the surfel's depth coefficients (C = 9)."""
    proj = project_surfels(
        state.get_means(), state.get_scales(), state.get_rotations(),
        cam.world_to_camera, cam.fx, cam.fy, cam.cx, cam.cy, W, H)
    viewdirs = state.get_means() - cam.camera_center
    rgb = torch.clamp(sh_to_rgb(state.get_shs(), viewdirs, SH_DEGREE) + 0.5,
                      min=0.0)
    ch = torch.cat([rgb, proj.normals, proj.zcoef][:n_channels // 3], 1)
    geom = SR.pack_surfels(proj.Tu, proj.Tv, proj.Tw, proj.zcoef,
                           state.get_opacities())
    return proj, geom, ch.contiguous()


def check_surfel_kernels(vname, C, state, cam, seed, timed):
    """K5, K6, K7 and K4 (no absolute columns) against their plain
    versions at one view; with `timed`, their times and bounds too."""
    tiles_x, tiles_y = -(-W // TILE), -(-H // TILE)
    n_tiles = tiles_x * tiles_y
    n = state.capacity
    tag = f"{vname} C={C}"
    proj, geom, ch = surfel_inputs(state, cam, C)
    isects = SR.surfel_isect_encode(proj.means2d, proj.depths, proj.radii,
                                    H, W, TILE)
    args = (isects, proj.depths.contiguous(), tiles_x, tiles_y)
    keys_k, gids_k = SR.surfel_expand(*args)
    again = SR.surfel_expand(*args)
    keys_p, gids_p = SR.surfel_expand_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(keys_k, keys_p) and torch.equal(gids_k, gids_p)):
        fail(f"K5 {tag}: kernel differs from surfel_expand_plain at "
             f"{int((keys_k != keys_p).sum())} slots")
    if not (torch.equal(keys_k, again[0]) and torch.equal(gids_k, again[1])):
        fail(f"K5 {tag}: two runs gave different keys or ids")
    sk, gs, order = R.sort_slots(keys_k, gids_k)
    bounds = R.tile_bounds(sk, n_tiles)
    n_valid = int(bounds[-1])
    if n_valid != isects.n_isects:
        fail(f"K5 {tag}: {n_valid} valid keys for {isects.n_isects} "
             "intersections")
    counts = bounds[1:] - bounds[:-1]
    log(f"K5 {tag}: bit-identical, identical in two runs; slots "
        f"{isects.total} real "
        f"{isects.n_isects} (no cull); longest tile list "
        f"{int(counts.max())}, mean {float(counts.float().mean()):.1f}")

    fwd = (geom, ch, gs, bounds, H, W, TILE)
    out, aux, stop = SR.rasterize_surfels_fwd(*fwd)
    out_p, aux_p, stop_p = SR.rasterize_surfels_fwd_plain(*fwd)
    torch.cuda.synchronize()
    share = float((stop == stop_p).float().mean())
    if share < STOP_SHARE:
        fail(f"K6 {tag}: i_stop agrees on {share:.5f} of pixels "
             f"< {STOP_SHARE}")
    err = off_share(f"K6 {tag} channels", out, out_p, OFF_SHARE)
    names = ("T", "sum w depth", "median depth", "distortion", "A", "M1",
             "M2")
    plane_err = {}
    for i, name in enumerate(names):
        limit = MEDIAN_OFF_SHARE if i == SR.AUX_MEDIAN else OFF_SHARE
        plane_err[name] = off_share(f"K6 {tag} {name}", aux[i], aux_p[i],
                                    limit)
    fwd_err = max(err, *(v for k, v in plane_err.items()
                         if k != "median depth"))
    # the same source built without contraction rounds as the plain version
    out_u, aux_u, stop_u = SR.rasterize_surfels_fwd(*fwd, contract=False)
    ustop = float((stop_u == stop_p).float().mean())
    if ustop < UNCONTRACTED_SHARE:
        fail(f"K6 {tag} built without contraction: i_stop agrees on "
             f"{ustop:.6f} of pixels < {UNCONTRACTED_SHARE}")
    ulimit = 1.0 - UNCONTRACTED_SHARE
    off_share(f"K6 {tag} channels, built without contraction", out_u, out_p,
              ulimit)
    for i, name in enumerate(names):
        off_share(f"K6 {tag} {name}, built without contraction", aux_u[i],
                  aux_p[i], ulimit)
    ushare = min(value_share(out_u, out_p),
                 *(value_share(aux_u[i], aux_p[i]) for i in range(7)))
    log(f"K6 {tag}: i_stop agrees on {share:.6f}; max abs err channels "
        f"{err:.3e}, " + ", ".join(f"{k} {v:.3e}"
                                   for k, v in plane_err.items())
        + f"; mean alpha {float(1 - aux[0].mean()):.4f}, mean distortion "
        f"{float(aux[3].mean()):.3e}; built without contraction: i_stop "
        f"agrees on {ustop:.7f}, every output within tolerance at >= "
        f"{ushare:.7f} of its values")
    if timed:
        attrs = SR.rasterize_surfels_fwd_attributes(C, TILE)
        log_attributes("K6", C, attrs)
        expand_attrs = SR.surfel_expand_attributes()
        log_attributes("K5", None, expand_attrs)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    g_out = torch.randn((H, W, C), generator=gen, device="cuda")
    g_aux = torch.randn((3, H, W), generator=gen, device="cuda")
    bwd = (geom, ch, gs, bounds, g_out, g_aux, aux, stop, TILE)
    rows = SR.rasterize_surfels_bwd(*bwd)
    again = SR.rasterize_surfels_bwd(*bwd)
    stats = {}
    rows_p = SR.rasterize_surfels_bwd_plain(*bwd, stats=stats)
    torch.cuda.synchronize()
    if not torch.equal(rows, again):
        fail(f"K7 {tag}: two runs gave different rows")
    bwd_err, gshare = check_rows(f"K7 {tag}", rows, rows_p, K7_COLUMNS,
                                 SURFEL_GRAD_SHARE)
    uncontracted = SR.rasterize_surfels_bwd(*bwd, contract=False)
    _, ushare = check_rows(f"K7 {tag} built without contraction",
                           uncontracted, rows_p, K7_COLUMNS,
                           UNCONTRACTED_SHARE)
    if timed:
        # the tolerance must fail a wrong backward: one without the depth
        # and distortion terms
        g_alpha_only = torch.cat([g_aux[:1], torch.zeros_like(g_aux[1:])])
        partial = SR.rasterize_surfels_bwd(*bwd[:5], g_alpha_only, *bwd[6:])
        missed = [K7_COLUMNS[c] for c, (_, s) in enumerate(
            column_shares(tag, partial, rows_p)[:13])
            if s < SURFEL_GRAD_SHARE]
        log(f"K7 {tag}: without g_depth and g_dist these columns fail the "
            f"tolerance: {missed}")
        if len(missed) < 13:
            fail(f"K7 {tag}: the tolerance passes the geometry columns "
                 f"other than {missed} of a backward without the depth "
                 "and distortion terms")
    red = (rows, gs, isects.offsets, R.invert_order(order), bounds[-1:], n)
    summed, summed_p, reduce_err = check_reduce(f"K4 surfel {tag}", red,
                                                rows, gs, n, 0)
    scale, sscale = float(rows_p.abs().max()), float(summed_p.abs().max())
    composited = stats["composited_pairs"]
    log(f"K7 {tag}: every column agrees on >= {gshare:.6f} of its values "
        f"(>= {ushare:.7f} when built without contraction), "
        f"max abs err {bwd_err:.3e} (max |ref| {scale:.3e}); identical in "
        f"two runs. K4 with 13 + C columns: identical in two runs, equal "
        f"to the sums in slot order, max abs err from index_add_ "
        f"{reduce_err:.3e} "
        f"(max |ref| {sscale:.3e}); composited pairs {composited}; (slot, "
        f"warp)s with a composited pixel {stats['composited_slot_warps']}")
    rec = {"fwd_err": fwd_err, "median_err": plane_err["median depth"],
           "bwd_err": bwd_err, "reduce_err": reduce_err}
    if not timed:
        return rec
    log_attributes("K7", C, SR.rasterize_surfels_bwd_attributes(C, TILE))
    gids64 = gs.long()
    sums = torch.empty((n, rows.shape[1]), device=rows.device)
    pairs = visited_pairs(stop, bounds, tiles_x)
    pairs_bwd = pairs - int((stop < R.NEVER_STOPPED).sum())
    in_bytes = n * (52 + 4 * C) + 4 * n_valid + 8 * (n_tiles + 1)
    R_ = 13 + C
    rec.update(
        bwd_scale=scale, reduce_scale=sscale,
        expand_ms=graph_ms(lambda: SR.surfel_expand(*args), 20),
        expand_plain_ms=cuda_ms(lambda: SR.surfel_expand_plain(*args), 3),
        sort_ms=graph_ms(lambda: R.sort_slots(keys_k, gids_k), 20),
        fwd_ms=graph_ms(lambda: SR.rasterize_surfels_fwd(*fwd), 20),
        fwd_plain_ms=cuda_ms(
            lambda: SR.rasterize_surfels_fwd_plain(*fwd), 1, warmup=0),
        bwd_ms=graph_ms(lambda: SR.rasterize_surfels_bwd(*bwd), 20),
        bwd_plain_ms=cuda_ms(
            lambda: SR.rasterize_surfels_bwd_plain(*bwd), 1, warmup=0),
        reduce_ms=graph_ms(lambda: R.reduce_grads(*red, n_abs=0), 20),
        reduce_plain_ms=cuda_ms(
            lambda: R.reduce_grads_plain(rows, gs, n, n_abs=0), 5),
        reduce_library_ms=graph_ms(
            lambda: sums.zero_().index_add_(0, gids64, rows), 20),
        expand_bound=bound(28 * n + 12 * isects.total, 6 * isects.n_isects),
        fwd_bound=bound(in_bytes + H * W * (4 * C + 32),
                        47 * pairs + (26 + 2 * C) * composited),
        bwd_bound=bound(in_bytes + H * W * (4 * C + 44) + 4 * R_ * n_valid,
                        48 * pairs_bwd + (123 + 4 * C) * composited),
        reduce_bound=bound(4 * R_ * n_valid + 4 * isects.total + 8 * n
                           + 4 * R_ * n, R_ * n_valid),
        slots=isects.total, n_isects=isects.n_isects, pairs=pairs,
        pairs_bwd=pairs_bwd, composited_pairs=composited,
        composited_slot_warps=stats["composited_slot_warps"],
        bwd_attributes=SR.rasterize_surfels_bwd_attributes(C, TILE),
        fwd_attributes=attrs, expand_attributes=expand_attrs,
        reduce_attributes=R.reduce_grads_attributes(13 + C, 0))
    log_attributes(f"K4 R={13 + C} n_abs=0", None, rec["reduce_attributes"])
    log(f"surfel {tag} timings " + json.dumps(
        {k: v for k, v in rec.items() if k.endswith(("_ms", "_bound"))
         or k in ("slots", "n_isects", "pairs", "pairs_bwd",
                  "composited_pairs")}))
    return rec


def phase_surfel_kernels(state):
    log("== phase 3 (surfels): K5, K6, K7 and K4 against their plain "
        "versions, full width")
    named = views()
    cases = (("bench", 6, True), ("orbit_yaw20", 6, False),
             ("bench", 3, False), ("bench", 9, False))
    rec = {}
    for seed, (vname, C, timed) in enumerate(cases):
        r = check_surfel_kernels(vname, C, state, camera(named[vname]),
                                 10 + seed, timed)
        errs = {k: r.pop(k) for k in ("fwd_err", "median_err", "bwd_err",
                                      "reduce_err")}
        if C == 6:   # the main path's width: what the kernels line reports
            for k, v in errs.items():
                rec[k] = max(rec.get(k, 0.0), v)
        rec.update(r)
    return rec


def phase_small_surfel_reference():
    """SurfelRenderer on a small scene, card vs CPU (plain versions): the
    seven outputs, and the gradients of a loss with the distortion and
    normal-consistency terms."""
    arrays = surfel_arrays(scene_arrays(400, seed=1))
    arrays["means"][:, 2] -= 2.0  # nearer: larger surfels, longer lists
    outs, grads = {}, {}
    for dev in ("cuda", "cpu"):
        state = state_from_raw_arrays(arrays, device=dev)
        state.params = state.params.map(
            lambda _, x: x.requires_grad_(True))
        target = torch.rand((96, 128, 3), generator=torch.Generator(
            ).manual_seed(3)).to(dev)
        with torch.enable_grad():
            out = SurfelRendererConfig().instantiate().forward(
                state, camera(np.eye(4), 96, 128, 120.0, device=dev), 96,
                128, torch.tensor([0.1, 0.2, 0.3], device=dev), SH_DEGREE)
            loss, _ = train_loss(out.render, target)
            normal_err = 1.0 - (out.rend_normal * out.surf_normal).sum(-1)
            loss = (loss + 0.05 * normal_err.mean()
                    + 100.0 * out.rend_dist.mean())
            loss.backward()
        outs[dev] = out
        grads[dev] = {k: getattr(state.params, k).grad.cpu()
                      for k in PARAM_FIELDS}
    for key in ("render", "alpha", "rend_normal", "view_normal",
                "rend_dist", "surf_depth", "surf_normal"):
        g = getattr(outs["cuda"], key).detach().cpu()
        w = getattr(outs["cpu"], key).detach()
        bad = (g - w).abs() > ATOL + RTOL * w.abs()
        share = 1.0 - float(bad.float().mean())
        # a finite-difference normal reads four neighbouring depths
        floor = 0.99 if key == "surf_normal" else STOP_SHARE
        if not bool(torch.isfinite(g).all()) or share < floor:
            fail(f"small surfel scene {key}: card matches the CPU renderer "
                 f"at {share:.5f} of values")
    for key, g in grads["cuda"].items():
        w = grads["cpu"][key]
        scale = float(w.abs().max())
        bad = (g - w).abs() > 1e-3 * scale + 1e-2 * w.abs()
        share = 1.0 - float(bad.float().mean())
        if (not bool(torch.isfinite(g).all()) or scale <= 0.0
                or share < STOP_SHARE):
            fail(f"small surfel scene d loss / d {key}: card matches the "
                 f"CPU at {share:.5f} of values (max |ref| {scale})")
    log("small surfel scene (400 surfels, 128x96): the card's seven "
        "outputs and the gradients of the L1 + SSIM + normal + distortion "
        "loss for all six parameter tensors match the CPU's")


def phase_main_path(ply, stp=False):
    """The serving main path; with `stp` over the StopThePop renderer.
    Returns (launches of the path's kernels, its numbers)."""
    what = "StopThePop serving" if stp else "main path"
    fwd_kernel = "rasterize_fwd_stp" if stp else "rasterize_fwd"
    log(f"== phase {'7: StopThePop' if stp else '4:'} main path "
        "GaussianModelLoader -> ViewerRenderer -> TileRenderer"
        f"{'(stp_resort=True)' if stp else ''} at 1088x1920")
    state, renderer, sh_degree = GaussianModelLoader.load(ply,
                                                          device="cuda")
    if stp:
        # the loader builds the default renderer; stp.yaml's is this one
        renderer = TileRendererConfig(stp_resort=True).instantiate()
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
            fail(f"{what}: frame at yaw {yaw}: shape {img.shape} "
                 f"{img.dtype}")
        if int(img.max()) == 0:
            fail(f"{what}: frame at yaw {yaw} is black")
    bg = torch.zeros(3, device="cuda")
    cam = camera(np.eye(4))
    out = renderer.forward(state, cam, H, W, bg, sh_degree,
                           render_types=ALL_OUTPUTS)
    for key in ("render", "alpha", "exp_depth", "inverse_depth", "normal",
                "hard_inverse_depth"):
        v = getattr(out, key)
        if v is None or not bool(torch.isfinite(v).all()):
            fail(f"{what} {key}: missing or non-finite")
    mean_alpha = float(out.alpha.mean())
    if not mean_alpha > 0.0:
        fail(f"{what}: mean alpha is 0")
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_launches().items()
                if k in ("expand", fwd_kernel)}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, count in launches.items():
        if count <= 0:
            fail(f"{what} never launched kernel {name}")
    stray = {k: v for k, v in read_launches().items()
             if v and k not in launches}
    if stray:
        fail(f"{what} launched kernels of another path: {stray}")
    log(f"{what}: {len(frame_ms)} rgb frames, ms per frame "
        f"{[round(x, 3) for x in frame_ms]}; all-outputs frame at the bench "
        f"pose: n_isects {out.n_isects}, mean alpha {mean_alpha:.4f}; "
        f"launches {launches}; peak memory {peak_gb:.3f} GiB")
    # one frame per output type through the viewer (after the counts were
    # read): visualized and quantized on the card, one uint8 copy
    output_ms = {}
    for i, name in enumerate(renderer.get_available_outputs()):
        vr.output_type = name
        c2w = orbit_c2w(8.0 * i, 0.0, 5.0, TARGET)
        t0 = time.perf_counter()
        img = vr.get_outputs(c2w, W, H, fov_y)
        output_ms[name] = round((time.perf_counter() - t0) * 1e3, 3)
        if (img.shape != (H, W, 3) or img.dtype != np.uint8
                or int(img.max()) == 0):
            fail(f"{what}: {name} frame {img.shape} {img.dtype} is wrong "
                 "or black")
    log(f"{what}: one viewer frame per output, ms per frame {output_ms}")
    stage_ms = stage_times(state, renderer, sh_degree, cam, stp=stp)
    rgb_ms = [1e3 * t for t in timed_frames(renderer, state, cam, bg,
                                            sh_degree)]
    log(f"{what}: bench-pose rgb frame, host clock ms " + json.dumps(rgb_ms))
    log(f"{what}: bench-pose stage ms (CUDA events, median of 5) "
        + json.dumps(stage_ms))
    return launches, {"rgb_frame_ms": rgb_ms, "stage_ms": stage_ms,
                      "viewer_ms": output_ms, "peak_gib": peak_gb}


def timed_frames(renderer, state, cam, bg, sh_degree, reps=5):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        renderer.forward(state, cam, H, W, bg, sh_degree)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def stage_times(state, renderer, sh_degree, cam, reps=5, stp=False):
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
        depths, kz = proj.depths.contiguous(), proj.depth_grads.contiguous()
        keys, gids = R.expand(isects, m2d, con, opac, depths, tiles_x,
                              tiles_y, TILE, True, stp, kz)
        ev[3].record()
        sk, gs, _ = R.sort_slots(keys, gids)
        ev[4].record()
        bounds = R.tile_bounds(sk, tiles_x * tiles_y)
        ev[5].record()
        if stp:
            STP.rasterize_fwd_stp(m2d, con, opac, rgb, depths, kz, gs,
                                  bounds, H, W, TILE)
        else:
            R.rasterize_fwd(m2d, con, opac, rgb, gs, bounds, H, W, TILE)
        ev[6].record()
        torch.cuda.synchronize()
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(6)])
    med = np.median(np.asarray(rows), axis=0)
    names = ("project", "sh", "expand", "sort", "ranges", "forward")
    return {k: float(v) for k, v in zip(names, med)}


TRAIN_STEPS, DENSIFY_AT, RESET_AT, STEPS_AFTER = 20, 20, 24, 6
STP_TRAIN_STEPS, STP_STEPS_AFTER = 12, 3   # phase 7: densify at step 12
TRAIN_EXTENT = 0.5   # puts percent_dense * extent inside the scene's scales


def perturbed(arrays, seed=1):
    """The scene, moved off its optimum: what training has to undo."""
    rng = np.random.RandomState(seed)
    out = dict(arrays)
    for key, std in (("means", 1e-3), ("shs_dc", 0.1), ("opacities", 0.3)):
        out[key] = (arrays[key] + std * rng.normal(
            size=arrays[key].shape)).astype(np.float32)
    return out


def train_stage_times(trainer, state, cam, target, bg, loss_of=None,
                      reps=3):
    """One training step's stages, as Trainer.train_step runs them,
    after one repetition that is not counted (it pays for the allocator's
    first blocks). `loss_of(out)`: the loss of a render; L1 + SSIM when
    None."""
    if loss_of is None:
        def loss_of(out):
            return train_loss(out.render, target)[0]
    rows = []
    for _ in range(reps + 1):
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
        loss = loss_of(out)
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
    med = np.median(np.asarray(rows[1:]), axis=0)
    names = ("render_forward", "loss", "backward", "adam")
    return {k: float(v) for k, v in zip(names, med)}


def phase_training(arrays, raster_ms, stp=False):
    """The training main path; with `stp` over the StopThePop renderer,
    cut to STP_TRAIN_STEPS steps, a densify and STP_STEPS_AFTER more.
    `raster_ms`: the backward's kernels as phase 3 timed them. Returns
    (launches of the path's kernels, its numbers)."""
    what = "StopThePop training" if stp else "training"
    n_steps, densify_at, reset_at, after = (
        (STP_TRAIN_STEPS, STP_TRAIN_STEPS, None, STP_STEPS_AFTER) if stp
        else (TRAIN_STEPS, DENSIFY_AT, RESET_AT, STEPS_AFTER))
    n_mean = 5 if n_steps >= 15 else 3     # steps in the two loss means
    log(f"== phase {'7: StopThePop' if stp else '5:'} training main path, "
        "Trainer.train_step + maybe_density_ops at 1088x1920")
    model = VanillaGaussianConfig(sh_degree=SH_DEGREE)
    trainer = Trainer(
        model=model, renderer=TileRendererConfig(stp_resort=stp),
        density=VanillaDensityControllerConfig(
            densify_from_iter=5, densification_interval=densify_at,
            densify_until_iter=100, opacity_reset_interval=reset_at or 1000,
            cull_opacity_threshold=0.3),
        config=TrainerConfig(max_steps=n_steps + after,
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
    stage["backward_split"] = dict(
        raster_ms, autograd_rest=stage["backward"] - sum(raster_ms.values()))
    log(f"{what} stage ms at capacity {state.params.capacity} (CUDA "
        "events, median of 3) " + json.dumps(stage))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, step_ms, density_ms, alive = [], [], {}, {}
    for step in range(1, n_steps + after + 1):
        view = step % len(cams)
        t0 = time.perf_counter()
        state, scalars = trainer.train_step(
            state, cams[view], targets[view], H, W,
            trainer.sh_degree_at(step), bg)
        losses.append(float(scalars["loss"]))       # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if step == densify_at:
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
        if step in (densify_at, reset_at):
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
    counts = read_launches()
    launches = {k: counts[k] for k in (STP_KERNELS if stp
                                       else GAUSSIAN_KERNELS)}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(math.isfinite(x) for x in losses):
        fail(f"{what}: non-finite loss in {losses}")
    first, last = (float(np.mean(losses[:n_mean])),
                   float(np.mean(losses[n_steps - n_mean:n_steps])))
    if not last < first:
        fail(f"{what}: mean loss of steps {n_steps - n_mean + 1}-{n_steps} "
             f"{last} is not below that of steps 1-{n_mean} {first}")
    for k in PARAM_FIELDS:
        if not bool(torch.isfinite(getattr(state.params, k)).all()):
            fail(f"{what}: non-finite {k}")
    if alive[densify_at + 1] == alive[densify_at]:
        fail(f"{what}: the densify changed no alive count")
    if (reset_at is not None and float(
            state.opt_state.exp_avg["opacities"].abs().max()) == 0.0):
        fail(f"{what}: no step after the opacity reset")
    for name, count in launches.items():
        if count <= 0:
            fail(f"{what} path never launched kernel {name}")
    stray = {k: v for k, v in counts.items() if v and k not in launches}
    if stray:
        fail(f"{what} launched kernels of another path: {stray}")
    log(f"{what}: losses {[round(x, 5) for x in losses]}")
    log(f"{what}: mean loss steps 1-{n_mean} {first:.5f}, steps "
        f"{n_steps - n_mean + 1}-{n_steps} {last:.5f}; SH degree 3 from "
        f"step 6; launches {launches} in {len(losses)} steps; peak memory "
        f"{peak_gb:.3f} GiB")
    log(f"{what}: ms per step (host clock, synchronised) "
        + json.dumps([round(x, 2) for x in step_ms]))
    grown = train_stage_times(trainer, state, cams[0], targets[0], bg)
    log(f"{what} stage ms at capacity {state.params.capacity} (CUDA "
        "events, median of 3) " + json.dumps(grown))
    return launches, {"step_ms": step_ms, "stage_ms": stage,
                      "density_ms": density_ms, "peak_gib": peak_gb}


S2D_STEPS, S2D_DENSIFY_AT, S2D_STEPS_AFTER = 12, 12, 3
# both extra losses act when step > from_iter: -1 turns them on at step 0
S2D_METRICS = dict(lambda_normal=0.05, lambda_dist=100.0,
                   normal_from_iter=-1, dist_from_iter=-1)


def surfel_stage_times(state, cam, reps=5):
    """A surfel frame's stages, as SurfelRenderer.forward runs them."""
    tiles_x, tiles_y = -(-W // TILE), -(-H // TILE)
    rows = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        proj, geom, ch = surfel_inputs(state, cam, 6)
        ev[1].record()
        isects = SR.surfel_isect_encode(proj.means2d, proj.depths,
                                        proj.radii, H, W, TILE)
        keys, gids = SR.surfel_expand(isects, proj.depths.contiguous(),
                                      tiles_x, tiles_y)
        ev[2].record()
        sk, gs, _ = R.sort_slots(keys, gids)
        ev[3].record()
        bounds = R.tile_bounds(sk, tiles_x * tiles_y)
        ev[4].record()
        SR.rasterize_surfels_fwd(geom, ch, gs, bounds, H, W, TILE)
        ev[5].record()
        torch.cuda.synchronize()
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(5)])
    med = np.median(np.asarray(rows), axis=0)
    names = ("project_sh_pack", "expand", "sort", "ranges", "forward")
    return {k: float(v) for k, v in zip(names, med)}


def phase_surfel_main_path(arrays):
    log("== phase 6: 2DGS main path, ViewerRenderer -> SurfelRenderer and "
        "GS2DTrainer at 1088x1920")
    arrays = surfel_arrays(arrays)
    state = state_from_raw_arrays(arrays, device="cuda")
    renderer = SurfelRendererConfig().instantiate()
    vr = ViewerRenderer(state, renderer, SH_DEGREE)
    fov_y = math.degrees(2.0 * math.atan(0.5 * H / FOCAL))
    bg = torch.zeros(3, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    frame_ms = {}
    for i, name in enumerate(renderer.get_available_outputs()):
        vr.output_type = name
        c2w = orbit_c2w(8.0 * i, 0.0, 5.0, TARGET)
        t0 = time.perf_counter()
        img = vr.get_outputs(c2w, W, H, fov_y)   # ends in a host copy
        frame_ms[name] = round((time.perf_counter() - t0) * 1e3, 3)
        if img.shape != (H, W, 3) or img.dtype != np.uint8:
            fail(f"surfel frame {name}: shape {img.shape} {img.dtype}")
        if int(img.max()) == 0:
            fail(f"surfel frame {name} is black")
    if len(frame_ms) != 7:
        fail(f"SurfelRenderer offers {len(frame_ms)} outputs, not 7")
    torch.cuda.synchronize()
    serving = {k: v for k, v in read_launches().items()
               if k in ("surfel_expand", "surfel_fwd")}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, count in serving.items():
        if count <= 0:
            fail(f"2DGS serving path never launched kernel {name}")
    cam = camera(np.eye(4))
    with torch.no_grad():
        out = renderer.forward(state, cam, H, W, bg, SH_DEGREE)
    for key in ("render", "alpha", "rend_normal", "view_normal",
                "rend_dist", "surf_depth", "surf_normal"):
        if not bool(torch.isfinite(getattr(out, key)).all()):
            fail(f"2DGS main path {key}: non-finite")
    mean_alpha = float(out.alpha.mean())
    if not mean_alpha > 0.0:
        fail("2DGS main path: mean alpha is 0")
    log(f"2DGS serving: one frame per output, ms per frame {frame_ms}; "
        f"bench pose: n_isects {out.n_isects}, mean alpha {mean_alpha:.4f}, "
        f"mean distortion {float(out.rend_dist.mean()):.3e}; launches "
        f"{serving}; peak memory {peak_gb:.3f} GiB")
    with torch.no_grad():
        rgb_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            renderer.forward(state, cam, H, W, bg, SH_DEGREE)
            torch.cuda.synchronize()
            rgb_ms.append((time.perf_counter() - t0) * 1e3)
        log("2DGS bench-pose frame (all seven outputs), host clock ms "
            + json.dumps(rgb_ms))
        log("2DGS bench-pose stage ms (CUDA events, median of 5) "
            + json.dumps(surfel_stage_times(state, cam)))

    # training
    trainer = GS2DTrainer(
        model=Gaussian2DConfig(sh_degree=SH_DEGREE),
        density=VanillaDensityControllerConfig(
            densify_from_iter=5, densification_interval=S2D_DENSIFY_AT,
            densify_until_iter=100, opacity_reset_interval=1000,
            cull_opacity_threshold=0.3),
        metrics=GS2DMetricsConfig(**S2D_METRICS),
        config=TrainerConfig(max_steps=S2D_STEPS + S2D_STEPS_AFTER,
                             sh_degree_interval=2))
    cams = [camera(c2w) for c2w in views().values()]
    with torch.no_grad():
        targets = [trainer.renderer.forward(state, c, H, W, bg,
                                            SH_DEGREE).render for c in cams]
    del state, vr, out
    state = trainer.setup(
        state_from_raw_arrays(perturbed(arrays), device="cuda"),
        cameras_extent=TRAIN_EXTENT)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def loss_of(out):
        loss, _ = train_loss(out.render, targets[0])
        normal_err = 1.0 - (out.rend_normal * out.surf_normal).sum(-1)
        return (loss + S2D_METRICS["lambda_normal"] * normal_err.mean()
                + S2D_METRICS["lambda_dist"] * out.rend_dist.mean())

    stage = train_stage_times(trainer, state, cams[0], targets[0], bg,
                              loss_of)
    log(f"2DGS training stage ms at capacity {state.params.capacity} (CUDA "
        "events, median of 3) " + json.dumps(stage))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, extra, step_ms, alive = [], [], [], {}
    n_split = 0
    for step in range(1, S2D_STEPS + S2D_STEPS_AFTER + 1):
        view = step % len(cams)
        t0 = time.perf_counter()
        state, scalars = trainer.train_step(
            state, cams[view], targets[view], H, W,
            trainer.sh_degree_at(step), bg)
        losses.append(float(scalars["loss"]))       # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        extra.append((float(scalars["normal_loss"]),
                      float(scalars["dist_loss"])))
        if step == S2D_DENSIFY_AT:
            # a tenth of the seen surfels above the threshold
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
        if step == S2D_DENSIFY_AT:
            ms = (time.perf_counter() - t0) * 1e3
            cap = prev.params.capacity
            was, now = prev.alive, state.alive[:cap]
            n_split = int((was & now & (state.params.scales[:cap]
                                        != prev.params.scales).any(-1)).sum())
            log(f"step {step}: density ops {ms:.1f} ms; alive {alive[step]} "
                f"-> {state.gaussians.n_alive}, {n_split} surfels split in "
                f"place, pruned {int((was & ~now).sum())}, capacity {cap} "
                f"-> {state.params.capacity}, scales "
                f"{tuple(state.params.scales.shape)}")
        del prev
    launches = {k: v for k, v in read_launches().items()
                if k in SURFEL_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(math.isfinite(x) for x in losses):
        fail(f"2DGS training: non-finite loss in {losses}")
    first = float(np.mean(losses[:3]))
    last = float(np.mean(losses[S2D_STEPS - 3:S2D_STEPS]))
    if not last < first:
        fail(f"2DGS training: mean loss of steps {S2D_STEPS - 2}-"
             f"{S2D_STEPS} {last} is not below that of steps 1-3 {first}")
    if not all(n > 0.0 and d > 0.0 for n, d in extra):
        fail(f"2DGS training: a normal or distortion loss is 0 in {extra}")
    for k in PARAM_FIELDS:
        if not bool(torch.isfinite(getattr(state.params, k)).all()):
            fail(f"2DGS training: non-finite {k}")
    if n_split <= 0 or state.params.scales.shape[1] != 2:
        fail("2DGS training: the densify split no surfel")
    for name, count in launches.items():
        if count <= 0:
            fail(f"2DGS training path never launched kernel {name}")
    log(f"2DGS training: losses {[round(x, 5) for x in losses]}")
    log("2DGS training: (normal, distortion) loss terms "
        f"{[(round(n, 5), round(d, 5)) for n, d in extra]}")
    log(f"2DGS training: mean loss steps 1-3 {first:.5f}, steps "
        f"{S2D_STEPS - 2}-{S2D_STEPS} {last:.5f}; launches {launches} in "
        f"{len(losses)} steps; peak memory {peak_gb:.3f} GiB")
    log("2DGS training: ms per step (host clock, synchronised) "
        + json.dumps([round(x, 2) for x in step_ms]))
    return serving, launches


FIT_VIEWS, SFM_POINTS = 24, 100_000
FIT_STEPS, RESUME_STEPS, VARIANT_STEPS = 300, 600, 100
LOG_INTERVAL = 100                 # FitConfig's, which the presets keep
FIT_OVERRIDES = ("model.density.init_args.densify_from_iter=100",
                 "model.density.init_args.densification_interval=100")
PRESETS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "gsl_tpu_torch", "configs")
SH_C0 = 0.28209479177387814


class Tee(io.TextIOBase):
    """Standard output that is also kept, to read what a command said."""

    def __init__(self, out):
        self.out, self.kept = out, io.StringIO()

    def write(self, s):
        self.kept.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def write_colmap_scene(root, arrays):
    """FIT_VIEWS views of the bench scene rendered by the port at HxW (the
    bench pose, then an orbit around TARGET) as images/*.png, and
    sparse/0/{cameras,images,points3D}.bin with SFM_POINTS of the bench
    means and their DC colours as the SfM cloud."""
    state = state_from_raw_arrays(arrays, device="cuda")
    renderer = TileRendererConfig().instantiate()
    bg = torch.zeros(3, device="cuda")
    poses = [np.eye(4)] + [
        orbit_c2w(yaw, 8.0 * math.sin(i), 5.0, TARGET)
        for i, yaw in enumerate(np.linspace(-40.0, 40.0, FIT_VIEWS - 1))]
    os.makedirs(os.path.join(root, "images"))
    images = {}
    for i, c2w in enumerate(poses):
        with torch.no_grad():
            out = renderer.forward(state, camera(c2w), H, W, bg, SH_DEGREE)
        img = (out.render.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
        name = f"view_{i:03d}.png"
        Image.fromarray(img).save(os.path.join(root, "images", name),
                                  compress_level=1)
        w2c = np.linalg.inv(c2w)
        images[i + 1] = ColmapImage(i + 1, rotmat_to_qvec(w2c[:3, :3]),
                                    w2c[:3, 3], 1, name)
    pick = np.random.RandomState(3).choice(N_GAUSSIANS, SFM_POINTS,
                                           replace=False)
    rgb = np.clip(0.5 + SH_C0 * arrays["shs_dc"][pick, 0], 0.0, 1.0)
    write_model_bin(ColmapModel(
        cameras={1: ColmapCamera(1, "PINHOLE", W, H,
                                 np.array([FOCAL, FOCAL, W / 2, H / 2]))},
        images=images, points_xyz=arrays["means"][pick].astype(np.float64),
        points_rgb=(rgb * 255 + 0.5).astype(np.uint8),
        points_err=np.zeros(SFM_POINTS)), os.path.join(root, "sparse", "0"))


def run_cli(argv, kernels):
    """cli.main(argv), the launch counters zeroed just before and read just
    after; fails unless every kernel in `kernels` was launched. Returns a
    dict: results, launches, peak_gib, said (standard output) and, for a
    fit, timing (its fit_timing.json) and rows (train_log.csv)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        _, results = cli.main(argv)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_launches().items() if v}
    for name in kernels:
        if launches.get(name, 0) <= 0:
            fail(f"{' '.join(argv)}: kernel {name} was never launched")
    if set(launches) - set(kernels):
        fail(f"{' '.join(argv)}: launched {launches}, a kernel of another "
             "path among them")
    out = {"results": results, "launches": launches, "said":
           tee.kept.getvalue(),
           "peak_gib": round(torch.cuda.max_memory_allocated() / 2 ** 30, 3)}
    if argv[0] == "fit":
        run = os.path.join(argv[argv.index("--output") + 1],
                           argv[argv.index("-n") + 1])
        with open(os.path.join(run, "fit_timing.json")) as f:
            out["timing"] = json.load(f)
        with open(os.path.join(run, "train_log.csv")) as f:
            out["rows"] = list(csv.reader(f))[1:]
        if not all(math.isfinite(float(r[1])) for r in out["rows"]):
            fail(f"{run}: a non-finite loss in {out['rows']}")
    return out


def log_fit(tag, fits, warm=()):
    """A fit's numbers: ms per step in each log window (the median over
    the windows `warm` after warm-up), Gaussians and loss per window, the
    share of wall time waiting on next(loader), ms per densify and its
    counts (alive before, cloned, split, pruned, alive after), peak memory
    and launches, for each run in `fits`."""
    rows = fits[-1]["rows"]
    ms = {int(r[0]): round(1e3 / float(r[3]), 2) for r in rows}
    log(f"{tag}: ms per step in each log window {ms}" + (
        f"; median over the windows ending {list(warm)} "
        f"{float(np.median([ms[s] for s in warm])):.2f}" if warm else ""))
    log(f"{tag}: Gaussians per log window "
        f"{ {int(r[0]): int(r[2]) for r in rows} }; loss "
        f"{ {int(r[0]): round(float(r[1]), 5) for r in rows} }")
    for f in fits:
        t = f["timing"]
        n = t["end_step"] - t["start_step"] + 1
        log(f"{tag}: steps {t['start_step']}-{t['end_step']}: "
            f"{1e3 * t['wall_s'] / n:.2f} ms per step over the loop; "
            f"waiting on next(loader) {t['loader_wait_s']:.3f} of "
            f"{t['wall_s']:.2f} s "
            f"({100 * t['loader_wait_s'] / t['wall_s']:.2f}%); ms per "
            f"densify {[round(x, 2) for x in t['densify_ms']]}; peak "
            f"memory {f['peak_gib']} GiB; launches {f['launches']}")
        for d in t["densify"]:
            log(f"{tag}: densify at step {d['step']}: {d['before']} alive, "
                f"{d['clone']} cloned, {d['split']} split, {d['pruned']} "
                f"pruned -> {d['after']}")


def phase_fit(arrays):
    log("== phase 8: a synthesised COLMAP scene fitted through "
        "gsl_tpu_torch.cli at 1088x1920")
    colmap = os.path.join(PRESETS, "colmap.yaml")
    with tempfile.TemporaryDirectory() as tmp:
        data, runs = os.path.join(tmp, "scene"), os.path.join(tmp, "runs")
        t0 = time.perf_counter()
        write_colmap_scene(data, arrays)
        log(f"fit: {FIT_VIEWS} views at {H}x{W} and {SFM_POINTS} SfM points "
            f"written in {time.perf_counter() - t0:.1f} s")

        def argv(sub, name, steps, preset=colmap, extra=FIT_OVERRIDES):
            return [sub, "--config", preset, "--data.path", data,
                    "--output", runs, "-n", name, "--max_steps",
                    str(steps), *extra]

        # the initial cloud, initialised as the fit initialises it
        trainer, dp_cfg, fit_cfg = cli.build_components(cli.load_config(
            [colmap], cli.parse_overrides(FIT_OVERRIDES
                                          + (f"data.path={data}",))))
        outputs = dp_cfg.instantiate().get_outputs()
        fit_cfg.output_dir = os.path.join(tmp, "initial")
        with contextlib.redirect_stdout(io.StringIO()):
            psnr0 = validate(trainer, trainer.setup(
                _init_gaussians(trainer, outputs, fit_cfg, "cuda"),
                outputs.camera_extent), outputs, fit_cfg)["psnr"]
        del trainer

        first = run_cli(argv("fit", "colmap", FIT_STEPS), GAUSSIAN_KERNELS)
        second = run_cli(argv("fit", "colmap", RESUME_STEPS),
                         GAUSSIAN_KERNELS)
        if f"-> continuing at {FIT_STEPS + 1}" not in second["said"]:
            fail(f"the second fit did not continue at {FIT_STEPS + 1}")
        run = os.path.join(runs, "colmap")
        for rel in [f"checkpoints/step_{s}/{f}"
                    for s in (FIT_STEPS, RESUME_STEPS)
                    for f in ("state.pt", "fit_meta.json")] + [
                f"point_cloud/iteration_{s}/point_cloud.ply"
                for s in (FIT_STEPS, RESUME_STEPS)] + [
                "train_log.csv", "metrics/val.csv", "config.yaml"]:
            if not os.path.isfile(os.path.join(run, rel)):
                fail(f"the fit wrote no {rel}")
        if [int(r[0]) for r in second["rows"]] != list(
                range(LOG_INTERVAL, RESUME_STEPS + 1, LOG_INTERVAL)) \
                or second["rows"][:len(first["rows"])] != first["rows"]:
            fail(f"train_log.csv holds {second['rows']}, not the first "
                 f"run's {first['rows']} and then the resumed run's")
        val = run_cli(["validate", "--output", runs, "-n", "colmap"],
                      ("expand", "rasterize_fwd"))
        psnr = val["results"]["psnr"]
        if not psnr > psnr0:
            fail(f"val PSNR at step {RESUME_STEPS}, {psnr:.3f} dB, is not "
                 f"above the initial cloud's {psnr0:.3f}")
        picked = GaussianModelLoader.search_load_file(run)
        if picked != os.path.join(run, "checkpoints", f"step_{RESUME_STEPS}"):
            fail(f"GaussianModelLoader picked {picked}")
        loaded, renderer, sh_degree = GaussianModelLoader.load(run)
        with torch.no_grad():
            frame = renderer.forward(loaded, camera(np.eye(4)), H, W,
                                     torch.zeros(3, device="cuda"),
                                     sh_degree).render
        if not (bool(torch.isfinite(frame).all())
                and float(frame.mean()) > 0.0):
            fail("the loaded model renders no finite frame")
        log(f"fit: val PSNR of the initial cloud {psnr0:.3f} dB, at step "
            f"{FIT_STEPS} {first['results']['psnr']:.3f}, at step "
            f"{RESUME_STEPS} {second['results']['psnr']:.3f} (validate "
            f"command {psnr:.3f}, SSIM {val['results']['ssim']:.4f}); the "
            f"loader took step_{RESUME_STEPS}, {loaded.capacity} Gaussians, "
            f"frame mean {float(frame.mean()):.4f}")
        del loaded, frame
        # a run's first window holds its warm-up and first image decodes
        warm = [s for s in range(LOG_INTERVAL, RESUME_STEPS + 1,
                                 LOG_INTERVAL)
                if s not in (LOG_INTERVAL, FIT_STEPS + LOG_INTERVAL)]
        log_fit("fit colmap.yaml", [first, second], warm)

        for preset, kernels in (("gs2d.yaml", SURFEL_KERNELS),
                                ("stp.yaml", STP_KERNELS)):
            name = preset.split(".")[0]
            f = run_cli(argv("fit", name, VARIANT_STEPS,
                             preset=os.path.join(PRESETS, preset), extra=()),
                        kernels)
            log(f"fit {preset}: val PSNR {f['results']['psnr']:.3f} dB at "
                f"step {VARIANT_STEPS}")
            log_fit(f"fit {preset}", [f])


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
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        usual = pool.submit(cuda_build.build)
        loose = pool.submit(cuda_build.build, UNCONTRACTED,
                            cuda_build.NO_CONTRACTION)
        logs = usual.result()
        loose.result()
    log(f"built {sorted(logs)}, and {sorted(UNCONTRACTED)} a second time "
        f"without contraction, in {time.perf_counter() - t0:.1f} s")
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
            trec = phase_stp_kernels(state, renderer)
            phase_small_reference(stp=True)
            del state
            torch.cuda.empty_cache()
            srec = phase_surfel_kernels(state_from_raw_arrays(
                surfel_arrays(arrays), device="cuda"))
            phase_small_surfel_reference()
            torch.cuda.empty_cache()
            launches, serving = phase_main_path(ply)
        phase_stp_saturated()
        torch.cuda.empty_cache()
        train_launches, training = phase_training(
            arrays, {"rasterize_bwd": rec["bwd_ms"],
                     "invert_order": rec["invert_ms"],
                     "reduce_grads": rec["reduce_ms"]})
        torch.cuda.empty_cache()
        surfel_serving, surfel_launches = phase_surfel_main_path(arrays)
        torch.cuda.empty_cache()
        with torch.no_grad():
            stp_serving_launches, stp_serving = phase_main_path(ply,
                                                                stp=True)
        torch.cuda.empty_cache()
        stp_launches, stp_training = phase_training(
            arrays, {"rasterize_bwd_stp": trec["bwd_ms"],
                     "invert_order": rec["invert_ms"],
                     "reduce_grads": trec["reduce_ms"]}, stp=True)
    torch.cuda.empty_cache()
    phase_fit(arrays)
    # StopThePop beside plain 3DGS, phases 7 and 4/5 of this run
    log("StopThePop over plain 3DGS, this run: bench-pose rgb frame ms "
        f"{[round(x, 2) for x in stp_serving['rgb_frame_ms']]} vs "
        f"{[round(x, 2) for x in serving['rgb_frame_ms']]}; stage ms "
        f"{json.dumps(stp_serving['stage_ms'])} vs "
        f"{json.dumps(serving['stage_ms'])}; viewer frames "
        f"{stp_serving['viewer_ms']} vs {serving['viewer_ms']}; serving peak "
        f"{stp_serving['peak_gib']:.3f} vs {serving['peak_gib']:.3f} GiB")
    log("StopThePop over plain 3DGS, this run: ms per step at capacity 1M, "
        f"steps 6-{STP_TRAIN_STEPS}, median "
        f"{float(np.median(stp_training['step_ms'][5:STP_TRAIN_STEPS])):.2f}"
        f" vs {float(np.median(training['step_ms'][5:TRAIN_STEPS])):.2f} "
        f"(steps 6-{TRAIN_STEPS}); stage ms "
        f"{json.dumps(stp_training['stage_ms'])} vs "
        f"{json.dumps(training['stage_ms'])}; densify ms "
        f"{stp_training['density_ms']} vs {training['density_ms']}; "
        f"training peak {stp_training['peak_gib']:.3f} vs "
        f"{training['peak_gib']:.3f} GiB")

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

    def surfel_entry(name, line, err, key):
        bound_ms, bound_by = srec[f"{key}_bound"]
        return {"name": name, "route": "cuda",
                "source": f"gsl_tpu_torch/csrc/{name}.cu",
                "replaces": f"gsl_tpu/ops/surfel_pallas.py:{line}",
                "launches": surfel_launches[name],
                "serving_launches": surfel_serving.get(name, 0),
                "max_abs_err": err, "ms": srec[f"{key}_ms"],
                "plain_ms": srec[f"{key}_plain_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}

    reduce_entry = entry("reduce_grads", 1379, rec["reduce_err"], "reduce",
                         rec["reduce_library_ms"])
    reduce_entry.update(
        surfel_launches=surfel_launches["reduce_grads"],
        surfel_max_abs_err=srec["reduce_err"], surfel_ms=srec["reduce_ms"],
        surfel_plain_ms=srec["reduce_plain_ms"],
        surfel_bound_ms=srec["reduce_bound"][0],
        surfel_bound_by=srec["reduce_bound"][1],
        surfel_library_ms=srec["reduce_library_ms"])
    def stp_entry(name, line, err, key):
        bound_ms, bound_by = trec[f"{key}_bound"]
        return {"name": name, "route": "cuda",
                "source": f"gsl_tpu_torch/csrc/{name}.cu",
                "replaces": f"gsl_tpu/ops/rasterize_pallas.py:{line}",
                "branch": "stp_resort",
                "launches": stp_launches[name],
                "serving_launches": stp_serving_launches.get(name, 0),
                "max_abs_err": err, "ms": trec[f"{key}_ms"],
                "plain_ms": trec[f"{key}_plain_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}

    expand_entry = entry("expand", 227, 0.0, "expand")
    expand_entry.update(
        stp_launches=stp_launches["expand"],
        stp_serving_launches=stp_serving_launches["expand"],
        stp_max_abs_err=0.0, stp_ms=trec["expand_ms"],
        stp_plain_ms=trec["expand_plain_ms"],
        stp_bound_ms=trec["expand_bound"][0],
        stp_bound_by=trec["expand_bound"][1], stp_library_ms=None)
    reduce_entry.update(stp_launches=stp_launches["reduce_grads"],
                        stp_ms=trec["reduce_ms"],
                        attributes=rec["reduce_attributes"],
                        surfel_attributes=srec["reduce_attributes"])
    expand_entry.update(attributes=rec["expand_attributes"])
    surfel_expand_entry = surfel_entry("surfel_expand", 61, 0.0, "expand")
    surfel_expand_entry.update(attributes=srec["expand_attributes"])
    kernels = [
        expand_entry,
        entry("rasterize_fwd", 869, rec["fwd_err"], "fwd"),
        entry("rasterize_bwd", 1069, rec["bwd_err"], "bwd"),
        reduce_entry,
        surfel_expand_entry,
        surfel_entry("surfel_fwd", 253, srec["fwd_err"], "fwd"),
        surfel_entry("surfel_bwd", 428, srec["bwd_err"], "bwd"),
        stp_entry("rasterize_fwd_stp", 869, trec["fwd_err"], "fwd"),
        stp_entry("rasterize_bwd_stp", 1069, trec["bwd_err"], "bwd"),
    ]
    for e, r in ((kernels[2], rec), (kernels[6], srec), (kernels[8], trec)):
        e.update(composited_slot_warps=r["composited_slot_warps"],
                 attributes=r["bwd_attributes"])
    for e, r in ((kernels[1], rec), (kernels[5], srec), (kernels[7], trec)):
        e.update(attributes=r["fwd_attributes"])
    for e, r in ((kernels[1], rec), (kernels[7], trec)):
        e.update(near_pairs=r["near_pairs"])
    log(f"surfel backward at the bench pose: K6's median depth differs by "
        f"up to {srec['median_err']:.3e} (a flipped crossing); K7 errors "
        f"are of rows up to {srec['bwd_scale']:.3e}, K4's of sums up to "
        f"{srec['reduce_scale']:.3e}; torch.sort of {srec['slots']} int64 "
        f"keys: {srec['sort_ms']:.4f} ms")
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
