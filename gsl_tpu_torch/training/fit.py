"""The fit and validate loops behind ``python -m gsl_tpu_torch.cli fit``.

Port of ``gsl_tpu/training/fit.py``:
- setup from DataParserOutputs (point-cloud init, or a trained artifact
  with ``init_from``, optionally with a background sphere; camera-extent
  learning-rate scaling),
- the per-step order: step hook -> pre-density hooks -> density hook ->
  post-density hooks -> a ``train_log.csv`` row every ``log_interval``
  steps -> a checkpoint (and PLY) at ``save_iterations`` and at the end,
- resume from the newest checkpoint (``resume: auto``), bit-exact on the
  CPU: the checkpoint holds the generator that draws the densify noise, and
  the loader fast-forwards its index stream,
- validation with per-image PSNR and exact float32 SSIM, written to
  ``metrics/<split>.csv`` with a MEAN row.

The JAX package's loop also grows a tile-intersection slot capacity and
pads images to a size bucket, both for the TPU's static shapes; the port
sizes its slot buffers per call and renders images at their own size.
Each fit also writes ``fit_timing.json`` beside ``train_log.csv``: wall
time, time spent waiting on the loader, and the milliseconds and counts
(alive before, cloned, split, pruned, alive after) of each densify.
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

from ..data.dataparsers.dataparser import DataParserOutputs, camera_centers
from ..data.dataset import (CachedDataset, DataLoader, add_background_sphere,
                            image_to_float)
from ..models.gaussian import GaussianState, grow_capacity
from ..models.gaussian_2d import Gaussian2DConfig
from ..ops.sh import num_sh_bases
from ..ops.ssim import ssim as ssim_fn
from ..utils.checkpoint import (find_latest_checkpoint, load_checkpoint,
                                save_checkpoint)
from ..utils.device import resolve_device
from ..utils.gaussian_model_loader import GaussianModelLoader
from ..utils.ply import save_state_ply
from .density import densify_masks
from .hooks import FitContext, build_hooks
from .loggers import make_logger
from .trainer import Trainer, TrainState


@dataclasses.dataclass
class FitConfig:
    """The JAX package's FitConfig without its TPU-only fields
    (``min_isect_capacity``, ``matmul_precision``: the port computes in
    float32 always; ``size_bucket``: no padding). ``viewer`` /
    ``viewer_port`` (ROADMAP item 14) and the LightGaussian ``lg_*``
    fields (item 12) are not ported; the CLI raises for them."""

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


def _round_capacity(n: int) -> int:
    cap = 1 << 14
    while cap < n:
        cap <<= 1
    return cap


def _init_gaussians(trainer: Trainer, outputs: DataParserOutputs,
                    cfg: FitConfig, device=None) -> GaussianState:
    """Point-cloud (or `init_from` artifact) initialization, with the
    background sphere when asked for, padded to the run's capacity."""
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

    state = trainer.setup(_init_gaussians(trainer, outputs, cfg, dev),
                          outputs.camera_extent, outputs.prune_extent)
    template_capacity = state.params.capacity

    background = np.asarray(trainer.config.background_color, np.float32)
    bg = torch.from_numpy(background).to(dev)
    dataset = CachedDataset(outputs.train_set, background=background)
    ctx = FitContext(trainer=trainer, outputs=outputs, dataset=dataset,
                     cfg=cfg, bg=bg)
    step_hook, density_hook, pre_density, post_density = build_hooks(ctx)

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
    cameras = {}              # per image name, on the device
    loader_wait, densify_ms, densify_counts = 0.0, [], []
    t_start = t_last = time.perf_counter()

    try:
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
            for hook in pre_density:
                state = hook.periodic(state, generator, step)
            timed = density_hook.densifies_at(step)
            if timed:
                clone, split = densify_masks(
                    state.gaussians, state.density, trainer.density_cfg,
                    trainer.cameras_extent)
                counts = {"step": step, "before": state.gaussians.n_alive,
                          "clone": int(clone.sum()),
                          "split": int(split.sum())}
                t0 = time.perf_counter()
            state = density_hook(state, generator, step)
            if timed:
                _sync(dev)
                densify_ms.append((time.perf_counter() - t0) * 1e3)
                counts["after"] = state.gaussians.n_alive
                counts["pruned"] = (counts["before"] + counts["clone"]
                                    + counts["split"] - counts["after"])
                densify_counts.append(counts)
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
    _sync(dev)
    timing = {"start_step": start_step, "end_step": cfg.max_steps,
              "wall_s": time.perf_counter() - t_start,
              "loader_wait_s": loader_wait, "densify_ms": densify_ms,
              "densify": densify_counts}
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
    """Per-image PSNR / SSIM and ``metrics/<split>.csv`` with a MEAN row,
    on the state's device. With `save_images`, GT|render PNGs go to
    ``<output_dir>/<split>/``; with an `exp_logger`, the first
    `cfg.log_val_images` of them are logged. LPIPS is not ported (ROADMAP
    item 14): its column is written empty, as the JAX package writes it
    when its weights are missing."""
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
    print("[validate] lpips is not ported (ROADMAP item 14); "
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
        rows.append([name, psnr, s])
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
    with open(csv_path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["name", "psnr", "ssim", "lpips(unavailable)"])
        wr.writerows([r + [""] for r in rows])
        wr.writerow(["MEAN", mean_psnr, mean_ssim, ""])
    return {"psnr": mean_psnr, "ssim": mean_ssim, "lpips": float("nan"),
            "csv": csv_path}
