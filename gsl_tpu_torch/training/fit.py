"""The fit and validate loops behind ``python -m gsl_tpu_torch.cli fit``.

Port of ``gsl_tpu/training/fit.py``:
- setup from DataParserOutputs (point-cloud init, or a trained artifact
  with ``init_from``, optionally with a background sphere; camera-extent
  learning-rate scaling; Mip-Splatting's 3D filter over the train
  cameras, which on resume comes from the checkpoint; the appearance
  networks sized from the data; an output processor's parameters, one
  set per train image; the step hook's `init_state`),
- the per-step order: step hook -> the plugins' `after_step` ->
  pre-density hooks -> density hook ->
  post-density hooks -> a ``train_log.csv`` row every ``log_interval``
  steps -> a checkpoint (and PLY) at ``save_iterations`` and at the end,
- resume from the newest checkpoint (``resume: auto``), bit-exact on the
  CPU: the checkpoint holds the generator that draws the densify noise, and
  the loader fast-forwards its index stream,
- validation with per-image PSNR, exact float32 SSIM and LPIPS (when its
  weights are found, ``ops/lpips.py``), written to
  ``metrics/<split>.csv`` with a MEAN row,
- with ``viewer``, the in-training web viewer: between the pre-density
  hooks and the density hook of every `pump_interval`-th step the loop
  renders the page's pending camera with the current parameters, under
  ``no_grad`` and without drawing from the fit's generator, so the fit's
  losses are those of the same fit without it. A failed viewer render
  fails the fit (the JAX package catches and prints a failed warm-up
  render).

The JAX package's loop also grows a tile-intersection slot capacity and
pads images to a size bucket, both for the TPU's static shapes; the port
sizes its slot buffers per call and renders images at their own size.
Each fit also writes ``fit_timing.json`` beside ``train_log.csv``: the
loop's wall time and its start (``time.time()``), time spent waiting on
the loader, the milliseconds and counts of each densify (alive before
and after; cloned, split and pruned rows, or for MCMC the dead rows
relocated and the rows added), and the CUDA kernels the loop launched,
with their counts (a fit run as a subprocess, as train_partitions
runs them, shows its kernels there).
"""
from __future__ import annotations

import csv
import dataclasses
import json
import os
import time
from typing import Sequence

import numpy as np
import torch

from ..data.cameras import make_camera
from ..data.dataparsers.dataparser import DataParserOutputs, camera_centers
from ..data.dataset import (CachedDataset, DataLoader, add_background_sphere,
                            image_to_float)
from ..models.gaussian import GaussianState, grow_capacity
from ..models.gaussian_2d import Gaussian2DConfig
from ..models.mip_splatting import MipSplattingConfig, compute_3d_filter
from ..ops.lpips import get_lpips_fn
from ..ops.sh import num_sh_bases
from ..ops.ssim import ssim as ssim_fn
from ..utils.checkpoint import (find_latest_checkpoint, load_checkpoint,
                                save_checkpoint)
from ..utils.device import resolve_device
from ..utils.gaussian_model_loader import GaussianModelLoader
from ..utils.ply import save_state_ply
from ..viewer.camera_path import orbit_c2w
from ..viewer.training_viewer import TrainingViewer
from .hooks import FitContext, build_hooks
from .loggers import make_logger
from .trainer import Trainer, TrainState


@dataclasses.dataclass
class FitConfig:
    """The JAX package's FitConfig without its TPU-only fields
    (``min_isect_capacity``, ``matmul_precision``: the port computes in
    float32 always; ``size_bucket``: no padding)."""

    max_steps: int = 30_000
    save_iterations: Sequence[int] = (7_000, 30_000)
    log_interval: int = 100
    capacity_multiplier: float = 4.0
    min_capacity: int = 1 << 15
    seed: int = 42
    output_dir: str = "outputs/run"
    save_ply: bool = True
    add_background_sphere: bool = False
    background_sphere_distance: float = 2.2
    background_sphere_points: int = 204_800
    tensorboard: bool = False
    logger: str = "none"
    """experiment logger: 'none' | 'tensorboard' | 'wandb'; the metrics CSV
    is always written. `tensorboard: true` is an alias for
    logger=tensorboard."""
    log_val_images: int = 4
    """log up to this many GT|render validation panels per split to the
    chosen logger"""
    resume: str = "auto"
    """'auto': resume from the newest checkpoint under output_dir; 'never':
    always start fresh; anything else: a checkpoint directory."""
    init_from: str = ""
    """initialize the Gaussians from a trained artifact (run dir, PLY or
    checkpoint of this package) instead of the point cloud; the optimizer
    state starts fresh."""
    lg_prune_steps: Sequence[int] = ()
    """LightGaussian importance pruning at these steps (after the density
    hook)"""
    lg_prune_percent: float = 0.6
    lg_prune_decay: float = 0.6
    lg_n_cameras: int = 8
    viewer: bool = False
    """serve the in-training web viewer (``viewer/training_viewer.py``);
    the loop pumps its render requests"""
    viewer_port: int = 8080


def _round_capacity(n: int) -> int:
    cap = 1 << 14
    while cap < n:
        cap <<= 1
    return cap


def _init_gaussians(trainer: Trainer, outputs: DataParserOutputs,
                    cfg: FitConfig, device=None) -> GaussianState:
    """Point-cloud (or `init_from` artifact) initialization, with the
    background sphere when asked for, padded to the run's capacity, and
    for Mip-Splatting the 3D filter over the train cameras."""
    gaussians = _init_rows(trainer, outputs, cfg, device)
    if isinstance(trainer.model, MipSplattingConfig):
        f3d = compute_3d_filter(gaussians.params.means, gaussians.alive,
                                outputs.train_set.cameras)
        gaussians = dataclasses.replace(gaussians, extra={"filter_3d": f3d})
    return gaussians


def _init_rows(trainer: Trainer, outputs: DataParserOutputs,
               cfg: FitConfig, device=None) -> GaussianState:
    pc = outputs.point_cloud
    if cfg.add_background_sphere:
        pc = add_background_sphere(pc, camera_centers(
            outputs.train_set.cameras), cfg.background_sphere_distance,
            cfg.background_sphere_points)
    if not cfg.init_from:
        capacity = _round_capacity(max(
            int(pc.xyz.shape[0] * cfg.capacity_multiplier),
            cfg.min_capacity))
        return trainer.model.init_from_pcd(pc.xyz, pc.rgb, capacity, device)

    loaded, _, _ = GaussianModelLoader.load(cfg.init_from, device)
    n_loaded = loaded.capacity       # loaded models hold alive rows only
    want = {"scales": (2 if isinstance(trainer.model, Gaussian2DConfig)
                       else 3,),
            "shs_rest": (num_sh_bases(trainer.model.sh_degree) - 1, 3)}
    for k, tail in want.items():
        got = tuple(getattr(loaded.params, k).shape[1:])
        if got != tail:
            raise ValueError(f"init_from artifact field {k} shape {got} != "
                             f"model template {tail}")
    capacity = _round_capacity(max(int(n_loaded * cfg.capacity_multiplier),
                                   cfg.min_capacity))
    print(f"[fit] init_from {cfg.init_from}: {n_loaded} gaussians, "
          f"capacity {capacity}")
    return grow_capacity(loaded, capacity)


def setup_state(trainer: Trainer, outputs: DataParserOutputs,
                gaussians: GaussianState) -> TrainState:
    """`trainer.setup` with what the data sizes first (the appearance
    networks) and, after it, the output processor of every train image."""
    trainer.size_from_data(outputs)
    state = trainer.setup(gaussians, outputs.camera_extent,
                          outputs.prune_extent)
    if trainer.output_processor is not None:
        state = trainer.init_output_processor(state,
                                              len(outputs.train_set))
    return state


def _make_viewer(trainer: Trainer, outputs: DataParserOutputs,
                 cfg: FitConfig, bg: torch.Tensor, dev: torch.device):
    """The started in-training viewer and its render closure: an orbit
    around the mean train camera centre, 60° field of view."""
    viewer = TrainingViewer(port=cfg.viewer_port).start()
    target = camera_centers(outputs.train_set.cameras).mean(0)

    def render_fn(state: TrainState, sh_degree: int):
        @torch.no_grad()
        def render(yaw, pitch, dist):
            S = viewer.image_size
            w2c = np.linalg.inv(orbit_c2w(yaw, pitch, dist, target))
            f = 0.5 * S / np.tan(np.deg2rad(30.0))
            cam = make_camera(R=w2c[:3, :3], T=w2c[:3, 3], fx=f, fy=f,
                              cx=S / 2, cy=S / 2, width=S, height=S,
                              device=dev)
            out = trainer.renderer.forward(state.gaussians, cam, S, S, bg,
                                           sh_degree)
            return (torch.clamp(out.render, 0.0, 1.0) * 255).to(
                torch.uint8).cpu().numpy()
        return render

    return viewer, render_fn


def _kernel_launches() -> dict:
    """Each CUDA kernel wrapper's launch count, by its source's name."""
    from ..ops import rasterize as R
    from ..ops import rasterize_stp as STP
    from ..ops import surfel_rasterize as SR
    return {"expand": R.expand.launches,
            "rasterize_fwd": R.rasterize_fwd.launches,
            "rasterize_bwd": R.rasterize_bwd.launches,
            "reduce_grads": R.reduce_grads.launches,
            "surfel_expand": SR.surfel_expand.launches,
            "surfel_fwd": SR.rasterize_surfels_fwd.launches,
            "surfel_bwd": SR.rasterize_surfels_bwd.launches,
            "rasterize_fwd_stp": STP.rasterize_fwd_stp.launches,
            "rasterize_bwd_stp": STP.rasterize_bwd_stp.launches}


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def fit(trainer: Trainer, outputs: DataParserOutputs, cfg: FitConfig,
        val_at_end: bool = True, device=None):
    """Train on `outputs.train_set` up to `cfg.max_steps` on `device`
    (default cuda). Returns (state, validation results or None)."""
    if cfg.resume not in ("auto", "never", "", None) \
            and not os.path.isdir(cfg.resume):
        raise FileNotFoundError(
            f"fit.resume checkpoint not found: {cfg.resume}")
    dev = resolve_device(device)
    os.makedirs(cfg.output_dir, exist_ok=True)
    generator = torch.Generator(device=dev)
    generator.manual_seed(cfg.seed)

    state = setup_state(trainer, outputs,
                        _init_gaussians(trainer, outputs, cfg, dev))
    template_capacity = state.params.capacity

    background = np.asarray(trainer.config.background_color, np.float32)
    bg = torch.from_numpy(background).to(dev)
    dataset = CachedDataset(outputs.train_set, background=background)
    ctx = FitContext(trainer=trainer, outputs=outputs, dataset=dataset,
                     cfg=cfg, bg=bg, name_to_idx={
                         n: i for i, n in
                         enumerate(outputs.train_set.image_names)})
    step_hook, density_hook, pre_density, post_density = build_hooks(
        ctx, state.gaussians.n_alive)
    state = step_hook.init_state(state, generator)

    start_step = 1
    resume_path = None
    if cfg.resume == "auto":
        resume_path = find_latest_checkpoint(
            os.path.join(cfg.output_dir, "checkpoints"))
    elif cfg.resume not in ("never", "", None):
        resume_path = cfg.resume
    if resume_path is not None:
        state = load_checkpoint(resume_path, state, generator=generator)
        if state.params.capacity < template_capacity:
            # the checkpoint predates a raised min_capacity
            state = trainer.grow_state(state, template_capacity)
            state = step_hook.init_state(state, generator)
        start_step = state.step + 1
        print(f"[fit] resumed {resume_path} -> continuing at {start_step}")
    if start_step > cfg.max_steps:
        print("[fit] checkpoint already at max_steps; nothing to train")

    loader = iter(DataLoader(dataset, seed=cfg.seed, skip=start_step - 1))
    exp_logger = make_logger(
        "tensorboard" if cfg.tensorboard and cfg.logger in ("none", "")
        else cfg.logger, cfg.output_dir)

    def save_at(step):
        save_checkpoint(os.path.join(cfg.output_dir, "checkpoints"), state,
                        step, meta={"capacity": state.params.capacity},
                        generator=generator)
        if cfg.save_ply:
            save_state_ply(os.path.join(
                cfg.output_dir, "point_cloud", f"iteration_{step}",
                "point_cloud.ply"), state.gaussians)

    log_path = os.path.join(cfg.output_dir, "train_log.csv")
    log_f = open(log_path, "a" if start_step > 1 else "w", newline="")
    logger = csv.writer(log_f)
    if start_step == 1:
        logger.writerow(["step", "loss", "n_gaussians", "steps_per_s"])
    training_viewer = None
    cameras = {}              # per image name, on the device
    loader_wait, densify_ms, densify_counts = 0.0, [], []

    try:
        if cfg.viewer:
            training_viewer, tv_render_fn = _make_viewer(
                trainer, outputs, cfg, bg, dev)
            # a first render, so a viewer that cannot render fails here
            tv_render_fn(state, trainer.sh_degree_at(start_step))(
                0.0, -15.0, 6.0)
        launches = _kernel_launches()
        loop_start_time = time.time()
        t_start = t_last = time.perf_counter()
        for step in range(start_step, cfg.max_steps + 1):
            t0 = time.perf_counter()
            cam, name, img_u8, img_mask = next(loader)
            loader_wait += time.perf_counter() - t0
            if name not in cameras:
                cameras[name] = cam.to(dev)
            img = image_to_float(img_u8.to(dev))
            mask = None if img_mask is None else img_mask.to(dev)
            H, W = img.shape[:2]
            sh_degree = trainer.sh_degree_at(step)

            state, scalars = step_hook(state, generator, step, sh_degree,
                                       cameras[name], name, img, mask, H, W)
            for plugin in trainer.plugins:
                state = plugin.after_step(state, step)
            for hook in pre_density:
                state = hook.periodic(state, generator, step)
            if training_viewer is not None \
                    and step % training_viewer.pump_interval == 0:
                # reading the scalars syncs the device: pump steps only
                training_viewer.pump(
                    step, tv_render_fn(state, sh_degree),
                    {"loss": float(scalars["loss"]),
                     "n_gaussians": state.gaussians.n_alive})
            timed = density_hook.densifies_at(step)
            if timed:
                counts = {"step": step, "before": state.gaussians.n_alive,
                          **density_hook.counts_before(state)}
                t0 = time.perf_counter()
            state = density_hook(state, generator, step)
            if timed:
                _sync(dev)
                densify_ms.append((time.perf_counter() - t0) * 1e3)
                counts["after"] = state.gaussians.n_alive
                densify_counts.append(density_hook.counts_after(counts))
            for hook in post_density:
                state = hook.periodic(state, generator, step)

            if step % cfg.log_interval == 0:
                loss = float(scalars["loss"])
                dt = time.perf_counter() - t_last
                t_last = time.perf_counter()
                n_g = state.gaussians.n_alive
                logger.writerow([step, loss, n_g,
                                 round(cfg.log_interval / dt, 2)])
                log_f.flush()
                exp_logger.log_scalars({"train/loss": loss,
                                        "train/n_gaussians": n_g}, step)

            if step in cfg.save_iterations:
                save_at(step)

        if cfg.max_steps not in cfg.save_iterations \
                and start_step <= cfg.max_steps:
            save_at(cfg.max_steps)
    finally:
        loader.close()
        log_f.close()
        if training_viewer is not None:
            training_viewer.stop()
    _sync(dev)
    timing = {"start_step": start_step, "end_step": cfg.max_steps,
              "loop_start_time": loop_start_time,
              "wall_s": time.perf_counter() - t_start,
              "loader_wait_s": loader_wait, "densify_ms": densify_ms,
              "densify": densify_counts,
              "launches": {k: v - launches[k]
                           for k, v in _kernel_launches().items()
                           if v > launches[k]}}
    with open(os.path.join(cfg.output_dir, "fit_timing.json"), "w") as f:
        json.dump(timing, f)
    n_steps = cfg.max_steps - start_step + 1
    if n_steps > 0:
        print(f"[fit] steps {start_step}-{cfg.max_steps} in "
              f"{timing['wall_s']:.1f} s, "
              f"{100 * loader_wait / timing['wall_s']:.1f}% waiting on the "
              f"loader, {len(densify_ms)} densify")

    results = None
    if val_at_end and len(outputs.val_set) > 0:
        results = validate(trainer, state, outputs, cfg,
                           exp_logger=exp_logger)
        exp_logger.log_scalars(
            {f"val/{k}": v for k, v in results.items()
             if isinstance(v, float) and v == v}, state.step)
    exp_logger.finish()
    return state, results


@torch.no_grad()
def validate(trainer: Trainer, state: TrainState,
             outputs: DataParserOutputs, cfg: FitConfig,
             split: str = "val", save_images: bool = False,
             exp_logger=None):
    """Per-image PSNR / SSIM / LPIPS and ``metrics/<split>.csv`` with a
    MEAN row, on the state's device. With `save_images`, GT|render PNGs go
    to ``<output_dir>/<split>/``; with an `exp_logger`, the first
    `cfg.log_val_images` of them are logged. The renders are the
    trainer's `eval_step`: SH colours, without an appearance network or an
    output processor, as gsl_tpu validates. Without LPIPS weights
    (``ops/lpips.py``) the column is headed ``lpips(unavailable)`` and left
    empty, and the returned lpips is NaN, as in the JAX package."""
    image_set = outputs.val_set if split == "val" else outputs.test_set
    dev = state.alive.device
    background = np.asarray(trainer.config.background_color, np.float32)
    bg = torch.from_numpy(background).to(dev)
    dataset = CachedDataset(image_set, background=background)
    sh_degree = trainer.model.sh_degree

    rows = []
    img_dir = os.path.join(cfg.output_dir, split)
    if save_images:
        os.makedirs(img_dir, exist_ok=True)
    lpips_fn = get_lpips_fn()
    if lpips_fn is None:
        print("[validate] lpips unavailable (no exported weights); "
              "lpips column will be empty")
    for i in range(len(dataset)):
        cam, name, img_u8, img_mask = dataset.get(i)
        img = image_to_float(img_u8.to(dev))
        H, W = img.shape[:2]
        render, m = trainer.eval_step(state, cam.to(dev), img, H, W,
                                      sh_degree, bg)
        gt = img
        if img_mask is not None:
            # masked pixels are excluded from all metrics
            mk = img_mask.to(dev)[..., None]
            gt = gt * mk
            render = render * mk
            mse = torch.sum((render - gt) ** 2) / torch.clamp(
                torch.sum(mk) * 3.0, min=1.0)
            psnr = float(-10.0 * torch.log10(torch.clamp(mse, min=1e-12)))
        else:
            psnr = float(m["psnr"])
        s = float(ssim_fn(gt.permute(2, 0, 1), render.permute(2, 0, 1)))
        lp = float(lpips_fn(render, gt)) if lpips_fn is not None else ""
        rows.append([name, psnr, s, lp])
        log_this = exp_logger is not None and i < cfg.log_val_images
        if save_images or log_this:
            side = torch.cat([img, render], dim=1).cpu().numpy()
            side = (np.clip(side, 0, 1) * 255).astype(np.uint8)
            if save_images:
                from PIL import Image
                Image.fromarray(side).save(
                    os.path.join(img_dir, name.replace("/", "_") + ".png"))
            if log_this:
                exp_logger.log_image(f"{split}/{name}", side, state.step)

    metrics_dir = os.path.join(cfg.output_dir, "metrics")
    os.makedirs(metrics_dir, exist_ok=True)
    csv_path = os.path.join(metrics_dir, f"{split}.csv")
    mean_psnr = float(np.mean([r[1] for r in rows]))
    mean_ssim = float(np.mean([r[2] for r in rows]))
    have_lpips = lpips_fn is not None
    mean_lpips = (float(np.mean([r[3] for r in rows])) if have_lpips
                  else float("nan"))
    with open(csv_path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["name", "psnr", "ssim",
                     "lpips" if have_lpips else "lpips(unavailable)"])
        wr.writerows(rows)
        wr.writerow(["MEAN", mean_psnr, mean_ssim,
                     mean_lpips if have_lpips else ""])
    return {"psnr": mean_psnr, "ssim": mean_ssim, "lpips": mean_lpips,
            "csv": csv_path}
