"""Distributed fit: the sharded step driven through the training schedule
on every rank of a (dp, mp) world.

Port of ``gsl_tpu/parallel/fit_distributed.py``. Each rank runs
`fit_distributed` with its own mesh; per step it renders one image
(n_devices images a step in all), and the statistics, Adam and schedule
work on its shard. The features, as in gsl_tpu:

- capacity max(n x multiplier, min_capacity, n_devices x 1024), rounded as
  the single-device fit rounds it, split evenly over mp;
- resume from the newest checkpoint (``resume: auto``): capacity,
  ``compact_k`` and the mesh in ``fit_meta.json``; the generator that draws
  the densify noise in ``state.pt``, as the single-device fit keeps it;
- batch order: one ``RandomState(seed)`` permutation of the train images,
  n_devices consecutive entries a step; the rank at flat index
  dp_index x mp + mp_index takes entry j of them, and its prefetch thread
  reads only that image;
- mixed image sizes and masks: every image padded to the largest train
  image (gsl_tpu pads to a multiple of ``size_bucket``, a TPU-only field),
  the loss masked over the padding and the image's own mask;
- the adaptive top-K ``compact_k``: probed from the first n_devices
  cameras (x1.3, 512-aligned), doubled when a tenth step overflowed;
- densify, capacity growth and re-balancing on the state gathered from the
  mp shards: every rank runs the single-device `Trainer.density_step` and
  `grow_state` on the same whole state with one identically seeded
  generator (the draws agree with no broadcast) and keeps its own slice;
  the opacity reset, elementwise, runs on each shard;
- the sharded step's own settings: anti-aliasing on, the 2D filter 0.3,
  lambda_dssim 0.2 and the SH degree raised every 1000 steps, whatever the
  renderer, metrics and trainer configs say (gsl_tpu's
  ``make_mp_train_step`` defaults, ROADMAP §3);
- ``mp_log.csv`` (step, loss, n_alive, shard_min, shard_max, compact_k,
  exchange_bytes, overflow, it_per_s) every ``log_interval`` steps;
- rank 0 gathers the state for checkpoints in the single-device fit's
  format (so ``cli validate``, the loader and the viewer read them), the
  PLY at the end and the end-of-run validation; the other ranks wait.

Rank 0 also writes ``fit_timing.json``: the loop's wall and start time,
its loader wait, each densify's milliseconds and counts, and every rank's
kernel launches and exchange cost (the mesh's `stats`).

`run` starts the world for the CLI: ranks spawned on this host, or, under a
launcher (``RANK`` and ``WORLD_SIZE`` set), this process joining by
``env://``; a world of one rank runs in this process with no process
group.
"""
from __future__ import annotations

import csv
import dataclasses
import json
import os
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.dataparsers.dataparser import DataParserOutputs
from ..data.dataset import CachedDataset, image_to_float
from ..models.gaussian import GaussianState, VanillaGaussianConfig
from ..ops.projection import project_gaussians
from ..renderers.tile_renderer import viewspace_grad_scale
from ..training.density import (DensityControlState, reset_opacities,
                                update_stats)
from ..training.fit import (FitConfig, _kernel_launches, _round_capacity,
                            validate)
from ..training.metrics import VanillaMetricsConfig
from ..training.trainer import Trainer, TrainState
from ..utils.checkpoint import (find_latest_checkpoint, load_checkpoint,
                                load_checkpoint_meta, save_checkpoint)
from ..utils.device import resolve_device
from ..utils.ply import save_state_ply
from . import launch
from .gaussian_sharded import (Mesh, apply_permutation,
                               exchange_bytes_per_step, gather_params,
                               gather_rows, make_mesh, make_mp_train_step,
                               rebalance_permutation, shard_alive_counts,
                               shard_params, shard_rows)

OVERFLOW_CHECK_INTERVAL = 10       # steps between the overflow checks


def _round512(n: int) -> int:
    return max(512, -(-int(n) // 512) * 512)


@torch.no_grad()
def max_visible_per_shard(gstate: GaussianState, cameras, img_height: int,
                          img_width: int, n_mp: int,
                          filter_2d: float = 0.3) -> int:
    """The most visible rows (radius > 0, dead rows too, as gsl_tpu counts
    them) that one of the n_mp shards holds for one of `cameras`: the
    least top-K budget with which no splat is dropped."""
    best = 0
    for cam in cameras:
        proj = project_gaussians(
            gstate.get_means(), gstate.get_scales(), gstate.get_rotations(),
            cam.world_to_camera, cam.fx, cam.fy, cam.cx, cam.cy, img_width,
            img_height, filter_2d=filter_2d)
        vis = (proj.radii > 0).to(torch.int64).reshape(n_mp, -1)
        best = max(best, int(vis.sum(dim=1).max()))
    return best


def auto_compact_k(gstate: GaussianState, cameras, img_height: int,
                   img_width: int, n_mp: int, filter_2d: float = 0.3) -> int:
    """The fit's initial top-K budget (``compact_k: auto``): 1.3 x
    `max_visible_per_shard` over `cameras`, 512-aligned, at most a
    shard."""
    best = max_visible_per_shard(gstate, cameras, img_height, img_width,
                                 n_mp, filter_2d)
    return min(_round512(1.3 * max(best, 1)), gstate.capacity // n_mp)


def sh_degree_at(step: int, max_degree: int) -> int:
    """gsl_tpu's distributed schedule: one more band every 1000 steps,
    whatever the trainer's ``sh_degree_interval``."""
    return min(max_degree, step // 1000) if max_degree > 0 else 0


def next_compact_k(k_eff: int, cap_local: int, step: int,
                   n_overflow) -> int:
    """The adaptive budget after `step`: doubled (512-aligned, at most a
    shard) when the step dropped splats, checked on every tenth step only,
    as gsl_tpu checks it (the other steps' drops go uncounted).
    `n_overflow` (an int or the step's 0-d tensor) is read only then."""
    if step % OVERFLOW_CHECK_INTERVAL == 0 and int(n_overflow) > 0:
        return min(_round512(k_eff * 2), cap_local)
    return k_eff


class _BatchPrefetcher:
    """One-batch lookahead thread of one rank: its camera, its ground truth
    padded to [Hp, Wp, 3] and its mask [Hp, Wp] (1 = keep; None without
    masks) for each step. An error reading an image is raised from
    `next`."""

    def __init__(self, dataset, cams, order, n_dev, j, Hp, Wp, with_masks,
                 start_pos=0):
        self.dataset, self.cams, self.order = dataset, cams, order
        self.n_dev, self.j = n_dev, j
        self.Hp, self.Wp, self.with_masks = Hp, Wp, with_masks
        self.pos = start_pos
        self.q = queue.Queue(maxsize=2)
        self.stop = threading.Event()
        self.t = threading.Thread(target=self._worker, daemon=True)
        self.t.start()

    def _build(self):
        i = int(self.order[(self.pos + self.j) % len(self.order)])
        self.pos += self.n_dev
        _, _, img_u8, img_mask = self.dataset.get(i)
        img = image_to_float(img_u8)
        h, w = img.shape[:2]
        gt = torch.zeros((self.Hp, self.Wp, 3), dtype=torch.float32)
        gt[:h, :w] = img
        mask = None
        if self.with_masks:
            mask = torch.zeros((self.Hp, self.Wp), dtype=torch.float32)
            mask[:h, :w] = 1.0 if img_mask is None else img_mask
        return self.cams[i], gt, mask

    def _worker(self):
        while not self.stop.is_set():
            try:
                item = (self._build(), None)
            except BaseException as e:       # raised again from next()
                item = (None, e)
            while not self.stop.is_set():
                try:
                    self.q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if item[1] is not None:
                return

    def next(self):
        item, error = self.q.get()
        if error is not None:
            raise error
        return item

    def close(self):
        self.stop.set()
        try:
            self.q.get_nowait()
        except queue.Empty:
            pass
        self.t.join()


def check_trainer(trainer: Trainer):
    """The sharded step is the vanilla 3DGS step: a trainer, model,
    renderer, metrics or component it would drop raises, naming it (gsl_tpu
    trains vanilla 3DGS in their place)."""
    dropped = []
    if type(trainer) is not Trainer:
        dropped.append(f"the trainer {type(trainer).__name__}")
    if type(trainer.model) is not VanillaGaussianConfig:
        dropped.append(f"the model {type(trainer.model).__name__}")
    if type(trainer.renderer).__name__ != "TileRenderer" \
            or getattr(trainer.renderer_cfg, "stp_resort", False):
        dropped.append(f"the renderer {trainer.renderer_cfg}")
    m = trainer.metrics_cfg
    if type(m) is not VanillaMetricsConfig or m.rgb_diff_loss != "l1" \
            or m.opacity_reg or m.scale_reg:
        dropped.append(f"the metrics {m}")
    if trainer.output_processor is not None:
        dropped.append("an output processor")
    if trainer.plugins:
        dropped.append("plugins")
    if getattr(trainer.density_cfg, "absgrad", False):
        dropped.append("the AbsGS statistic")
    if dropped:
        raise ValueError(
            f"distributed fit with {dropped[0]}: the sharded step is the "
            "vanilla 3DGS step and would drop it (gsl_tpu drops it "
            "silently)")


def _say(mesh: Mesh, msg: str):
    if mesh.rank == 0:
        print(msg, flush=True)


def _gather_density(mesh: Mesh, d: DensityControlState):
    return DensityControlState(**{
        f.name: gather_rows(mesh, getattr(d, f.name))
        for f in dataclasses.fields(d)})


def _shard_density(mesh: Mesh, d: DensityControlState):
    return DensityControlState(**{
        f.name: shard_rows(mesh, getattr(d, f.name))
        for f in dataclasses.fields(d)})


def _all_ranks(mesh: Mesh, obj) -> list:
    """Every rank's `obj`, in rank order."""
    if mesh.size == 1:
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj)
    return out


def _barrier(mesh: Mesh):
    if mesh.size > 1:
        dist.barrier()


def fit_distributed(trainer: Trainer, outputs: DataParserOutputs,
                    cfg: FitConfig, mesh: Optional[Mesh] = None,
                    compact_k="auto", backend: str = "auto",
                    rebalance_ratio: float = 1.1, val_at_end: bool = True):
    """Train this rank's part of the distributed fit. `mesh` defaults to
    ``make_mesh()`` on the card. `backend` is gsl_tpu's renderer switch,
    accepted and ignored (the port has one). Returns (the final state
    gathered from the shards, the validation results on rank 0 or None)."""
    check_trainer(trainer)
    mesh = mesh or make_mesh()
    dev = mesh.device
    n_dev, n_mp = mesh.size, mesh.mp
    os.makedirs(cfg.output_dir, exist_ok=True)
    generator = torch.Generator(device=dev)
    generator.manual_seed(cfg.seed)

    pc = outputs.point_cloud
    capacity = _round_capacity(max(int(pc.xyz.shape[0]
                                       * cfg.capacity_multiplier),
                                   cfg.min_capacity, n_dev * 1024))
    state = trainer.setup(
        trainer.model.init_from_pcd(pc.xyz, pc.rgb, capacity, dev),
        outputs.camera_extent, outputs.prune_extent)

    start_step = 1
    resume_path = None
    if cfg.resume == "auto":
        resume_path = find_latest_checkpoint(
            os.path.join(cfg.output_dir, "checkpoints"))
    elif cfg.resume not in ("never", "", None):
        resume_path = cfg.resume
    saved_compact_k = None
    if resume_path is not None:
        meta = load_checkpoint_meta(resume_path) or {}
        state = load_checkpoint(resume_path, state, generator=generator)
        capacity = state.params.capacity
        start_step = state.step + 1
        saved_compact_k = meta.get("compact_k")
        _say(mesh, f"[fit_mp] resumed {resume_path} -> continuing at "
             f"{start_step}")
    if capacity % n_mp:
        raise ValueError(f"capacity {capacity} does not split over mp "
                         f"{n_mp}")

    d0 = trainer.model.sh_degree
    cams = outputs.train_set.cameras
    n_train = len(outputs.train_set)
    background = np.asarray(trainer.config.background_color, np.float32)
    dataset = CachedDataset(outputs.train_set, background=background)
    bg = torch.from_numpy(background).to(dev)

    heights = [int(h) for h in cams.height]
    widths = [int(w) for w in cams.width]
    H, W = max(heights), max(widths)
    uniform = min(heights) == H and min(widths) == W
    has_masks = getattr(outputs.train_set, "mask_paths", None) is not None
    with_masks = (not uniform) or has_masks

    d_cfg = trainer.density_cfg
    gscale = viewspace_grad_scale(
        W, H, trainer.renderer_cfg.max_viewspace_grad_scale, dev)

    cap_local = capacity // n_mp
    if compact_k == "auto":
        if saved_compact_k is not None:
            k_eff = min(int(saved_compact_k), cap_local)
        else:
            k_eff = auto_compact_k(
                state.gaussians,
                [cams[i].to(dev) for i in range(min(n_dev, n_train))], H, W,
                n_mp, trainer.renderer_cfg.filter_2d_kernel_size)
        adaptive = True
    elif compact_k is None:
        k_eff, adaptive = cap_local, False
    else:
        k_eff, adaptive = min(int(compact_k), cap_local), False
    _say(mesh, f"[fit_mp] mesh={mesh.shape} capacity={capacity} "
         f"compact_k={k_eff} ({'auto' if adaptive else 'fixed'})")

    params, alive, opt_state = shard_params(mesh, state.params, state.alive,
                                            state.opt_state)
    density = _shard_density(mesh, state.density)
    del state

    steps = {}

    def step_for(sh_degree):
        key = (sh_degree, k_eff, capacity)
        if key not in steps:
            steps.clear()
            steps[key] = make_mp_train_step(
                mesh, trainer.tx, H, W, sh_degree=sh_degree,
                tile_size=trainer.renderer_cfg.tile_size,
                compact_k=None if k_eff >= cap_local else k_eff,
                with_masks=with_masks)
        return steps[key]

    def gathered(step_i) -> TrainState:
        p, a, o = gather_params(mesh, params, alive, opt_state)
        return TrainState(params=p, alive=a, opt_state=o,
                          density=_gather_density(mesh, density),
                          step=step_i)

    def save_at(step_i):
        st = gathered(step_i)
        if mesh.rank == 0:
            save_checkpoint(
                os.path.join(cfg.output_dir, "checkpoints"), st, step_i,
                meta={"capacity": int(capacity), "compact_k": int(k_eff),
                      "mesh": mesh.shape}, generator=generator)
        _barrier(mesh)
        return st

    order = np.random.RandomState(cfg.seed).permutation(n_train)
    loader = _BatchPrefetcher(
        dataset, cams, order, n_dev, mesh.dp_index * n_mp + mesh.mp_index,
        H, W, with_masks, start_pos=(start_step - 1) * n_dev)

    mp_log_f = mp_log = None
    if mesh.rank == 0:
        mp_log_f = open(os.path.join(cfg.output_dir, "mp_log.csv"),
                        "a" if start_step > 1 else "w", newline="")
        mp_log = csv.writer(mp_log_f)
        if start_step == 1:
            mp_log.writerow(["step", "loss", "n_alive", "shard_min",
                             "shard_max", "compact_k", "exchange_bytes",
                             "overflow", "it_per_s"])

    mesh.stats.reset()
    launches = _kernel_launches()
    loop_start_time = time.time()
    t_start = t0 = time.perf_counter()
    loader_wait, densify_ms, densify_counts = 0.0, [], []
    try:
        for step_i in range(start_step, cfg.max_steps + 1):
            tw = time.perf_counter()
            cam, gt, mask = loader.next()
            loader_wait += time.perf_counter() - tw
            cam = cam.to(dev)
            gt = gt.to(dev)
            extra = () if mask is None else (mask.to(dev),)

            params, opt_state, loss, tap_grad, radii, n_ovf = step_for(
                sh_degree_at(step_i, d0))(params, alive, opt_state, cam, gt,
                                          *extra, bg)
            density = update_stats(density, tap_grad, radii, gscale)

            k_new = next_compact_k(k_eff, cap_local, step_i, n_ovf)
            if adaptive and k_new != k_eff:
                k_eff = k_new
                _say(mesh, f"[fit_mp] exchange overflow ({int(n_ovf)}) -> "
                     f"compact_k {k_eff}")

            if trainer.densifies_at(step_i):
                td = time.perf_counter()
                st = gathered(step_i)
                before = st.gaussians.n_alive
                use_size = step_i > d_cfg.opacity_reset_interval
                snap = st
                st, n_trunc = trainer.density_step(snap, generator,
                                                   use_size)
                tries = 0
                while int(n_trunc) > 0 and tries < 3:
                    # out of free slots: grow 2x from the snapshot before
                    # the densify and redo it
                    capacity *= 2
                    cap_local = capacity // n_mp
                    snap = trainer.grow_state(snap, capacity)
                    st, n_trunc = trainer.density_step(snap, generator,
                                                       use_size)
                    tries += 1
                    _say(mesh, f"[fit_mp] capacity -> {capacity} at step "
                         f"{step_i}")
                if int(n_trunc) > 0:
                    _say(mesh, f"[fit_mp] densify at step {step_i} still "
                         f"truncating {int(n_trunc)} after {tries} "
                         "growths")
                counts = shard_alive_counts(st.alive, n_mp)
                rebalanced = None
                if counts.max() > rebalance_ratio * max(counts.min(), 1):
                    p, a, o, d = apply_permutation(
                        rebalance_permutation(st.alive, n_mp), st.params,
                        st.alive, st.opt_state, st.density)
                    st = TrainState(params=p, alive=a, opt_state=o,
                                    density=d, step=step_i)
                    rebalanced = shard_alive_counts(st.alive, n_mp).tolist()
                    _say(mesh, f"[fit_mp] rebalanced shards "
                         f"{counts.tolist()} -> {rebalanced}")
                params, alive, opt_state = shard_params(
                    mesh, st.params, st.alive, st.opt_state)
                density = _shard_density(mesh, st.density)
                densify_counts.append({
                    "step": step_i, "before": before,
                    "after": st.gaussians.n_alive, "capacity": capacity,
                    "shards": counts.tolist(), "rebalanced": rebalanced})
                del st, snap
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                densify_ms.append((time.perf_counter() - td) * 1e3)
                _say(mesh, f"[fit_mp] densify at step {step_i}: {before} -> "
                     f"{densify_counts[-1]['after']} alive, "
                     f"{densify_ms[-1]:.1f} ms")

            if step_i < d_cfg.densify_until_iter \
                    and step_i % d_cfg.opacity_reset_interval == 0:
                gstate, opt_state = reset_opacities(
                    GaussianState(params=params, alive=alive), opt_state,
                    d_cfg.opacity_reset_value)
                params = gstate.params

            if step_i in cfg.save_iterations:
                save_at(step_i)

            if step_i % cfg.log_interval == 0:
                n_ovf = int(n_ovf)
                counts = shard_alive_counts(gather_rows(mesh, alive), n_mp)
                xbytes = exchange_bytes_per_step(n_dev, n_mp, k_eff)
                it_s = cfg.log_interval / (time.perf_counter() - t0)
                _say(mesh, f"[fit_mp] step {step_i} loss={float(loss):.5f} "
                     f"n={int(counts.sum())} shards=[{counts.min()},"
                     f"{counts.max()}] K={k_eff} "
                     f"xchg={xbytes / 1e6:.2f}MB/step overflow={n_ovf} "
                     f"({it_s:.1f} it/s)")
                if mp_log is not None:
                    mp_log.writerow([step_i, float(loss), int(counts.sum()),
                                     int(counts.min()), int(counts.max()),
                                     k_eff, xbytes, n_ovf, round(it_s, 2)])
                    mp_log_f.flush()
                t0 = time.perf_counter()
    finally:
        loader.close()
        if mp_log_f is not None:
            mp_log_f.close()

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t_start
    rank_launches = {k: v - launches[k] for k, v in _kernel_launches().items()
                     if v > launches[k]}
    per_rank = _all_ranks(mesh, {"launches": rank_launches,
                                 "exchange": mesh.stats.snapshot(),
                                 "loader_wait_s": loader_wait,
                                 "peak_bytes": (
                                     torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else 0)})
    if cfg.max_steps not in cfg.save_iterations \
            and start_step <= cfg.max_steps:
        final = save_at(cfg.max_steps)
    else:
        final = gathered(cfg.max_steps)
    results = None
    if mesh.rank == 0:
        timing = {"start_step": start_step, "end_step": cfg.max_steps,
                  "loop_start_time": loop_start_time, "wall_s": wall,
                  "loader_wait_s": loader_wait, "densify_ms": densify_ms,
                  "densify": densify_counts, "mesh": mesh.shape,
                  "backend": mesh.backend, "launches": rank_launches,
                  "ranks": per_rank}
        with open(os.path.join(cfg.output_dir, "fit_timing.json"),
                  "w") as f:
            json.dump(timing, f)
        if cfg.save_ply:
            save_state_ply(os.path.join(
                cfg.output_dir, "point_cloud", f"iteration_{cfg.max_steps}",
                "point_cloud.ply"), final.gaussians)
        if val_at_end and outputs.val_set is not None \
                and len(outputs.val_set) > 0:
            results = validate(trainer, final, outputs, cfg)
            print(f"[fit_mp] val: psnr={results['psnr']:.3f} "
                  f"ssim={results['ssim']:.4f}", flush=True)
    _barrier(mesh)
    return final, results


# ---- the CLI's entry --------------------------------------------------------

def mesh_spec(spec) -> dict:
    """``distributed:`` true or a mapping {n_devices, dp, mp, compact_k,
    backend} -> the mapping."""
    return dict(spec) if isinstance(spec, dict) else {}


def world_size_of(spec: dict, device) -> int:
    """The world a distributed fit runs on: the launcher's; else
    ``n_devices``; else dp x mp when both are given; else the CUDA
    devices (1 on the CPU)."""
    if launch.under_launcher():
        return int(os.environ["WORLD_SIZE"])
    if spec.get("n_devices"):
        return int(spec["n_devices"])
    if spec.get("dp") and spec.get("mp"):
        return int(spec["dp"]) * int(spec["mp"])
    dev = torch.device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def run_rank(cfg: dict, device: str, spec: dict):
    """One rank of the CLI's distributed fit: components and data from the
    resolved config, the mesh, `fit_distributed`. Returns rank 0's
    validation results (None elsewhere)."""
    from ..cli import build_components      # the CLI imports this module

    trainer, dataparser_cfg, fit_cfg = build_components(cfg)
    outputs = dataparser_cfg.instantiate().get_outputs()
    n = world_size_of(spec, device)
    mesh = make_mesh(n, dp=spec.get("dp"), mp=spec.get("mp"), device=device)
    _, results = fit_distributed(
        trainer, outputs, fit_cfg, mesh=mesh,
        compact_k=spec.get("compact_k", "auto"),
        backend=spec.get("backend", "auto"))
    return results if mesh.rank == 0 else None


def run(cfg: dict, device="cuda"):
    """The CLI's ``fit`` with ``distributed:``: rank 0's validation
    results. Under a launcher this process is one rank; otherwise a world
    of more than one rank is spawned on this host (a rank that fails fails
    the run, naming it), and a world of one runs here."""
    dev = resolve_device(device)
    spec = mesh_spec(cfg.get("distributed"))
    if launch.under_launcher():
        world = launch.join_env(dev)
        dp, mp = spec.get("dp"), spec.get("mp")
        if dp and mp and int(dp) * int(mp) != world:
            raise ValueError(f"WORLD_SIZE {world} != dp {dp} x mp {mp}")
        try:
            return run_rank(cfg, str(dev), spec)
        finally:
            dist.destroy_process_group()
    world = world_size_of(spec, dev)
    if world == 1:
        print("[fit_mp] a world of 1 rank: no process group", flush=True)
        return run_rank(cfg, str(dev), spec)
    results = launch.spawn(run_rank, world, str(dev),
                           args=(cfg, str(dev), spec),
                           workdir=cfg["fit"]["output_dir"])
    return results[0]
