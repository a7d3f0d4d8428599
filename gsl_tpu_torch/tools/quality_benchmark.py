"""Converged-scale quality protocol: a student trained from a random cloud
to reproduce the views of a dense teacher.

    python -m gsl_tpu_torch.tools.quality_benchmark [--device cuda|cpu]
        [--views 64] [--res 512] [--steps 30000] [--teacher-n 1000000]
        [--fast-steps 1500] [--variant-steps 2000] [--gs2d-steps 0]
        [--gs2d-res 0] [--workdir DIR] [--out PATH] [--round 4]

Counterpart of ``tools/quality_benchmark.py``, with the same flags,
defaults and protocol. Ground truth is rendered by the port's
`TileRenderer` from a teacher of ``--teacher-n`` anisotropic SH-3
Gaussians (clustered blobs with fine structure, `make_teacher`) at
``--views`` orbit views of ``--res`` squared (`orbit_cameras`); every 8th
view is held out for validation. A student starts from 20,000 random
points (numpy seed 7) and trains through the vanilla schedule
(`protocol_trainer`, `protocol_fit_config`): ``--steps`` steps, densify
every 100 in [500, min(steps / 2, 15000)], opacity reset every 3000. The
target is exactly representable, so the final PSNR measures the renderer
and optimiser at scale. A short run of ``--fast-steps`` steps and the
``stp.yaml`` (``--variant-steps``) and ``gs2d.yaml`` (``--gs2d-steps`` at
``--gs2d-res``, its own teacher views) presets follow, each through the
port's `cli.load_config` and `build_components`, each with the preset's own
density schedule (the root tool passes its schedule only to the trainer it
builds).

Every phase is resumable: the teacher views are cached as PNGs under
``--workdir`` (default ``gsl_tpu_torch_quality`` in the temporary
directory), a finished phase as ``result_<tag>.json``, and a phase that
was cut resumes from its newest checkpoint (``resume: auto``); the minutes
of a resumed phase are rebuilt from its ``train_log.csv``. Each cache
records what made it (the package, views, resolution, teacher size,
steps, seed and cloud size: ``manifest.json`` beside the PNGs,
``protocol.json`` beside the checkpoints, ``protocol`` in the record), and
a cache made otherwise, or that records nothing, raises. The report goes
to ``--out`` (default ``<workdir>/QUALITY.md``, never the repo's
QUALITY.md), ``quality.json`` beside it; it names the card by
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.

Left out of the root tool:
- the fast-against-exact rows and the packed-key sort diff at bench scale.
  The port has one mode, the root tool's exact one (f32 payloads, exact
  (tile, depth) order), so the short run is its "short, exact mode" row,
  run once; ``--skip-sort-diff`` is accepted and ignored.
- the two environment variables that pre-size the slot and model
  capacities: they work around TPU worker crashes at retraces, and the
  port sizes its slot buffers per call.
A difference on purpose: where the root tool catches a failed variant
run, prints it and writes its report without that row, this tool raises,
naming the variant, and writes no report.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch
from PIL import Image

from ..cli import build_components, load_config
from ..data.cameras import make_camera, stack_cameras
from ..data.dataparsers.dataparser import (DataParserOutputs, ImageSet,
                                           PointCloud)
from ..models.gaussian import GaussianState, VanillaGaussianConfig
from ..ops.sh import num_sh_bases
from ..renderers.tile_renderer import TileRendererConfig
from ..training.density import VanillaDensityControllerConfig
from ..training.fit import FitConfig, fit
from ..training.trainer import Trainer, TrainerConfig
from ..utils.checkpoint import find_latest_checkpoint
from ..utils.convert import state_from_raw_arrays
from ..utils.device import resolve_device

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
REPO_QUALITY = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "QUALITY.md")
N_POINTS, POINT_SEED, CAMERA_EXTENT = 20_000, 7, 4.5
TEACHER_SEED, CAMERA_SEED = 0, 1
PACKAGE = __name__.split(".")[0]


def make_teacher(n: int, seed: int = TEACHER_SEED, device=None) -> GaussianState:
    """n clustered, fine-scaled SH-3 Gaussians: the root tool's numpy draws
    in its order, every row alive."""
    rng = np.random.RandomState(seed)
    k = num_sh_bases(3)
    centers = rng.uniform(-1.5, 1.5, (60, 3))
    which = rng.randint(0, 60, n)
    means = centers[which] + rng.normal(0, 0.15, (n, 3))
    scales = rng.uniform(-6.5, -4.0, (n, 3))
    quats = rng.normal(size=(n, 4))
    shs_dc = rng.normal(size=(n, 1, 3)) * 0.8
    shs_rest = rng.normal(size=(n, k - 1, 3)) * 0.15
    opac = rng.uniform(-2.0, 2.0, (n, 1))
    return state_from_raw_arrays(dict(
        means=means, scales=scales, rotations=quats, opacities=opac,
        shs_dc=shs_dc, shs_rest=shs_rest), device)


def orbit_cameras(n_views: int, res: int, radius: float = 4.5,
                  seed: int = CAMERA_SEED) -> list:
    """n_views cameras on the CPU around the origin, yaw evenly spaced and
    jittered, pitch looking down by 0.05-0.55 rad; res x res, fx = fy =
    0.9 res."""
    rng = np.random.RandomState(seed)
    cams = []
    for i in range(n_views):
        yaw = 2 * np.pi * i / n_views + rng.uniform(-0.1, 0.1)
        pitch = rng.uniform(-0.55, -0.05)
        c = radius * np.array([np.cos(pitch) * np.sin(yaw),
                               np.sin(pitch),
                               np.cos(pitch) * np.cos(yaw)])
        fwd = -c / np.linalg.norm(c)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        upv = np.cross(fwd, right)
        R = np.stack([right, upv, fwd])
        cams.append(make_camera(R=R, T=-R @ c, fx=0.9 * res, fy=0.9 * res,
                                cx=res / 2, cy=res / 2, width=res,
                                height=res, device="cpu"))
    return cams


def views_manifest(args, res: int) -> dict:
    """What the teacher's views at `res` and the student's cloud are made
    from."""
    return {"package": PACKAGE, "views": args.views, "res": res,
            "teacher_n": args.teacher_n, "teacher_seed": TEACHER_SEED,
            "camera_seed": CAMERA_SEED, "points": N_POINTS,
            "point_seed": POINT_SEED}


def check_made_with(path: str, got, want: dict) -> None:
    """Raise unless the cache at `path` records `want` (`got`: what it
    records, None for nothing)."""
    if got != want:
        diff = ("records nothing" if not isinstance(got, dict) else
                "was made with " + ", ".join(
                    f"{k}={got.get(k)!r}, not {v!r}"
                    for k, v in want.items() if got.get(k) != v))
        raise ValueError(f"{path} {diff}; give another --workdir or "
                         "remove it")


def build_outputs(args, res: int) -> DataParserOutputs:
    """The teacher's views at `res` and the student's random cloud. A view
    whose PNG exists is not rendered again (``images/`` at ``--res``,
    ``images<res>/`` otherwise), once the folder's ``manifest.json`` shows
    it was made with these arguments; the teacher is built only when a
    view is missing."""
    dev = resolve_device(args.device)
    cams = orbit_cameras(args.views, res)
    img_dir = os.path.join(
        args.workdir, "images" if res == args.res else f"images{res}")
    os.makedirs(img_dir, exist_ok=True)
    manifest, want = (os.path.join(img_dir, "manifest.json"),
                      views_manifest(args, res))
    if os.path.exists(manifest):
        with open(manifest) as f:
            check_made_with(manifest, json.load(f), want)
    elif os.listdir(img_dir):
        check_made_with(img_dir, None, want)
    else:
        with open(manifest, "w") as f:
            json.dump(want, f)
    print(f"rendering {args.views} teacher views at {res} "
          f"({args.teacher_n} gaussians)...", flush=True)
    bg = torch.zeros(3, device=dev)
    names, paths = [], []
    teacher = renderer = None
    for i, cam in enumerate(cams):
        name = f"v{i:03d}.png"
        path = os.path.join(img_dir, name)
        if not os.path.exists(path):
            if teacher is None:
                teacher = make_teacher(args.teacher_n, device=dev)
                renderer = TileRendererConfig().instantiate()
            with torch.no_grad():
                img = renderer.forward(teacher, cam.to(dev), res, res, bg,
                                       3).render
            img = (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
            Image.fromarray(img).save(path + ".part", format="PNG")
            os.replace(path + ".part", path)   # a cut run leaves no stub
        names.append(name)
        paths.append(path)
    del teacher

    batch = stack_cameras(cams)
    val_idx = list(range(0, args.views, 8))
    train_idx = [i for i in range(args.views) if i not in val_idx]

    def subset(idx):
        return ImageSet(image_names=[names[i] for i in idx],
                        image_paths=[paths[i] for i in idx],
                        cameras=batch[np.asarray(idx)])

    rng = np.random.RandomState(POINT_SEED)
    pc = PointCloud(
        xyz=rng.uniform(-2, 2, (N_POINTS, 3)).astype(np.float32),
        rgb=rng.rand(N_POINTS, 3).astype(np.float32))
    return DataParserOutputs(
        train_set=subset(train_idx), val_set=subset(val_idx),
        test_set=subset(val_idx), point_cloud=pc,
        camera_extent=CAMERA_EXTENT)


def protocol_trainer(steps: int, densify_until=None) -> Trainer:
    """SH-3 vanilla Gaussians densified every 100 steps from 500 until
    `densify_until` (default min(steps / 2, 15000)), opacity reset every
    3000."""
    return Trainer(
        model=VanillaGaussianConfig(sh_degree=3),
        renderer=TileRendererConfig(),
        density=VanillaDensityControllerConfig(
            densify_until_iter=(densify_until
                                or min(int(steps * 0.5), 15000)),
            opacity_reset_interval=3000),
        config=TrainerConfig())


def protocol_fit_config(steps: int, out_dir: str, seed: int = 42
                        ) -> FitConfig:
    """A checkpoint every 1000 steps up to 9000 and every 2000 from 10000
    (and at the end), so a cut phase loses little; no PLY."""
    saves = (list(range(1000, min(steps, 10000), 1000))
             + list(range(10000, steps, 2000)))
    return FitConfig(max_steps=steps, output_dir=out_dir,
                     save_iterations=saves, save_ply=False,
                     min_capacity=1 << 15, log_interval=500, resume="auto",
                     seed=seed)


def log_minutes(out_dir: str, log_interval: int) -> float:
    """The training minutes that ``train_log.csv`` records, over every
    attempt of a phase."""
    with open(os.path.join(out_dir, "train_log.csv")) as f:
        rows = list(csv.reader(f))[1:]
    secs = sum(float(log_interval) / max(float(r[3]), 1e-6)
               for r in rows if len(r) >= 4)
    return secs / 60.0


def run(tag: str, steps: int, outputs: DataParserOutputs, workdir: str,
        device, views: dict, trainer=None, seed: int = 42) -> dict:
    """One phase: fit `steps` steps into ``<workdir>/<tag>`` with
    `trainer` (default `protocol_trainer(steps)`) and validate; `views`
    is the `views_manifest` of `outputs`. Returns its record; a phase with
    ``result_<tag>.json`` is read from it and not fitted, and a phase with
    checkpoints resumes, each once it shows the same protocol."""
    protocol = dict(views, tag=tag, steps=steps, seed=seed)
    cache = os.path.join(workdir, f"result_{tag}.json")
    if os.path.exists(cache):
        with open(cache) as f:
            cached = json.load(f)
        check_made_with(cache, cached.get("protocol"), protocol)
        print(f"[cache] {tag}: {cached}", flush=True)
        return cached
    trainer = trainer or protocol_trainer(steps)
    out_dir = os.path.join(workdir, tag)
    cfg = protocol_fit_config(steps, out_dir, seed)
    made = os.path.join(out_dir, "protocol.json")
    resumed = find_latest_checkpoint(
        os.path.join(out_dir, "checkpoints")) is not None
    if resumed:
        got = None
        if os.path.exists(made):
            with open(made) as f:
                got = json.load(f)
        check_made_with(out_dir, got, protocol)
    else:
        os.makedirs(out_dir, exist_ok=True)
        with open(made, "w") as f:
            json.dump(protocol, f)
    t0 = time.time()
    state, results = fit(trainer, outputs, cfg, val_at_end=True,
                         device=device)
    minutes = (time.time() - t0) / 60.0
    if resumed:      # earlier attempts trained most of it
        minutes = log_minutes(out_dir, cfg.log_interval)
    rec = {"psnr": results["psnr"], "ssim": results["ssim"],
           "lpips": results["lpips"],
           "n_gaussians": state.gaussians.n_alive, "minutes": minutes,
           "protocol": protocol}
    with open(cache, "w") as f:
        json.dump(rec, f, default=float)
    return rec


def card_name(device) -> str:
    """``name, power limit`` of the card from nvidia-smi, or ``cpu``."""
    if resolve_device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--views", type=int, default=64)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--steps", type=int, default=30000)
    ap.add_argument("--teacher-n", type=int, default=1_000_000)
    ap.add_argument("--fast-steps", type=int, default=1500,
                    help="steps of the short run")
    ap.add_argument("--variant-steps", type=int, default=2000,
                    help="short STP / 2DGS runs (0 = skip)")
    ap.add_argument("--gs2d-steps", type=int, default=0,
                    help="steps for the gs2d variant (0 = --variant-steps)")
    ap.add_argument("--gs2d-res", type=int, default=0,
                    help="resolution for the gs2d variant (0 = --res), "
                         "with its own teacher views of the same teacher")
    ap.add_argument("--skip-sort-diff", action="store_true",
                    help="accepted and ignored: the port has one sort")
    ap.add_argument("--out", default=None,
                    help="the report (default <workdir>/QUALITY.md)")
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "gsl_tpu_torch_quality"))
    ap.add_argument("--round", default="4")
    args = ap.parse_args(argv)
    args.out = args.out or os.path.join(args.workdir, "QUALITY.md")
    if os.path.realpath(args.out) == os.path.realpath(REPO_QUALITY):
        raise SystemExit("QUALITY.md holds gsl_tpu's measurements; give "
                         "another --out")
    return args


def report(args, card, total_min, full, short, variants, gs2d_res) -> str:
    lp = f"{full['lpips']:.4f}" if full["lpips"] == full["lpips"] else "-"
    md = f"""# QUALITY — measured evidence (round {args.round})

The hard synthetic protocol below, run by gsl_tpu_torch on {card}. All
numbers measured, not projected. Generated by
gsl_tpu_torch.tools.quality_benchmark on {time.strftime('%Y-%m-%d %H:%M')}
in {total_min:.1f} min.

## Protocol

Ground truth: {args.views} views at {args.res}x{args.res} rendered from a
dense high-frequency teacher ({args.teacher_n} anisotropic SH-3
gaussians, clustered + fine structure). Student trains from a 20k random
point init with the FULL reference schedule: {args.steps} steps, densify
every 100 in [500, {min(int(args.steps * 0.5), 15000)}], opacity reset
every 3k (vanilla_density_controller.py:14-27). The target is exactly
representable, so final PSNR isolates renderer+optimizer fidelity at
scale.

## Results

| Experiment | steps | PSNR | SSIM | final gaussians | minutes |
|---|---|---|---|---|---|
| full | {args.steps} | {full['psnr']:.2f} | {full['ssim']:.4f} | {full['n_gaussians']} | {full['minutes']:.1f} |
| short, exact mode | {args.fast_steps} | {short['psnr']:.2f} | {short['ssim']:.4f} | {short['n_gaussians']} | {short['minutes']:.1f} |
"""
    labels = {
        "stp": f"STP (stp.yaml: culling + per-pixel resort, {args.res}²)",
        "gs2d": f"2DGS (gs2d.yaml: CUDA surfel kernels, {gs2d_res}²)",
    }
    for tag, v in variants.items():
        md += (f"| {labels[tag]} | {v['steps']} | {v['psnr']:.2f} | "
               f"{v['ssim']:.4f} | {v['n_gaussians']} | "
               f"{v['minutes']:.1f} |\n")
    md += f"""
LPIPS (full run): {lp} (empty when no exported weights are found).
"""
    return md


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    card = card_name(dev)
    os.makedirs(args.workdir, exist_ok=True)
    t_start = time.time()
    outputs = build_outputs(args, args.res)

    print(f"== full run: {args.steps} steps ==", flush=True)
    views = views_manifest(args, args.res)
    full = run("full", args.steps, outputs, args.workdir, dev, views)
    print(full, flush=True)
    print(f"== short run: {args.fast_steps} steps ==", flush=True)
    short = run("exact", args.fast_steps, outputs, args.workdir, dev, views)
    print(short, flush=True)

    variants = {}
    gs2d_res = args.gs2d_res or args.res
    if args.variant_steps:
        for preset, tag in (("stp.yaml", "stp"), ("gs2d.yaml", "gs2d")):
            print(f"== variant run: {preset} ==", flush=True)
            steps = ((args.gs2d_steps or args.variant_steps)
                     if tag == "gs2d" else args.variant_steps)
            try:
                trainer, _, _ = build_components(load_config(
                    [os.path.join(CONFIGS, preset)], {}))
                res = gs2d_res if tag == "gs2d" else args.res
                v_outputs = (build_outputs(args, res) if res != args.res
                             else outputs)
                variants[tag] = run(tag, steps, v_outputs, args.workdir,
                                    dev, views_manifest(args, res),
                                    trainer=trainer)
            except Exception as e:
                raise RuntimeError(
                    f"variant {tag} ({preset}) failed: "
                    f"{type(e).__name__}: {e}") from e
            variants[tag]["steps"] = steps
            print(tag, variants[tag], flush=True)

    total_min = (time.time() - t_start) / 60
    md = report(args, card, total_min, full, short, variants, gs2d_res)
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as f:
        f.write(md)
    result = {"full": full, "exact_short": short, "variants": variants,
              "device": card}
    with open(os.path.join(out_dir, "quality.json"), "w") as f:
        json.dump(result, f, default=float)
    print(f"wrote {args.out}", flush=True)
    return result


if __name__ == "__main__":
    main()
