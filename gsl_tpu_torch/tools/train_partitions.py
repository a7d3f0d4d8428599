"""Train a partitioned scene: one ``cli fit`` process per partition.

    python -m gsl_tpu_torch.tools.train_partitions <colmap_scene> \\
        -o runs/parts --config gsl_tpu_torch/configs/colmap.yaml \\
        [--n-partitions 4] [--max-steps 30000] [--scale-mode linear] \\
        [--retries 1] [--hosts H --host-id I] [--dry-run] [--device cpu]

Port of ``tools/train_partitions.py``. It partitions the scene's train
cameras (``utils/partitioning.build_partitions`` over the SfM points,
with point-projection visibility) into ``<output>/partitions.npz``
unless that file exists, then fits each partition as ``python -m
gsl_tpu_torch.cli fit`` in a subprocess on `--device` (cuda by default),
with the partition's images in ``partition_NNN/image_list.txt`` and the
schedule scaled by its image count (``auto_hyper_parameter``). A fit that
exits 0 leaves a ``TRAINED`` marker, and a partition with one is skipped.
Host `--host-id` of `--hosts` takes the partitions whose index modulo
`--hosts` is its id. A partition still failing after `--retries` makes
the tool exit nonzero, naming it (gsl_tpu's exits 0).
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from ..utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def fit_env() -> dict:
    """The environment of a fit process: this one's, with the package
    beside this one importable, whatever the working directory (the fit
    runs in the caller's, where relative paths are valid)."""
    return {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p])}


def fit_command(args, pi: int, list_path: str, scaled: dict) -> list:
    """The ``cli fit`` command line of partition `pi`."""
    cmd = [sys.executable, "-m", "gsl_tpu_torch.cli", "fit",
           "--data.path", args.dataset_path,
           "--output", args.output, "-n", f"partition_{pi:03d}",
           "--device", args.device,
           f"data.parser.init_args.image_list={list_path}",
           f"fit.max_steps={scaled['max_steps']}",
           f"trainer.max_steps={scaled['max_steps']}",
           "model.density.densification_interval="
           f"{scaled['densification_interval']}",
           "model.density.opacity_reset_interval="
           f"{scaled['opacity_reset_interval']}",
           "model.density.densify_from_iter="
           f"{scaled['densify_from_iter']}",
           "model.density.densify_until_iter="
           f"{scaled['densify_until_iter']}",
           ]
    for c in args.config:
        cmd += ["--config", c]
    return cmd


def _before_loop(run_dir: str, launched: float) -> str:
    """How long the fit took from its launch to its first step, as its
    fit_timing.json gives the loop's start."""
    try:
        with open(os.path.join(run_dir, "fit_timing.json")) as f:
            start = json.load(f)["loop_start_time"]
    except (OSError, KeyError, ValueError):
        return ""
    return f", {start - launched:.1f} s of it before the first step"


def main(argv=None):
    ap = argparse.ArgumentParser("gsl_tpu_torch.tools.train_partitions")
    ap.add_argument("dataset_path")
    ap.add_argument("--output", "-o", default="outputs/partitions")
    ap.add_argument("--config", action="append", default=[])
    ap.add_argument("--n-partitions", type=int, default=4)
    ap.add_argument("--max-steps", type=int, default=30000)
    ap.add_argument("--scale-mode", default="linear",
                    choices=["linear", "sqrt", "none"])
    ap.add_argument("--retries", type=int, default=1)
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--hosts", type=int, default=1,
                    help="hosts sharing the partitions: host i trains "
                         "those whose index %% hosts == i")
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the device of every partition's fit")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    from ..data.dataparsers.colmap import ColmapDataParserConfig
    from ..data.dataparsers.dataparser import camera_centers
    from ..utils.partitioning import (PartitionedScene,
                                      auto_hyper_parameter,
                                      build_partitions)

    outputs = ColmapDataParserConfig(
        path=args.dataset_path).instantiate().get_outputs()
    cams = outputs.train_set.cameras
    centers = camera_centers(cams)

    part_file = os.path.join(args.output, "partitions.npz")
    if os.path.exists(part_file):
        scene = PartitionedScene.load(part_file)
    else:
        scene = build_partitions(centers, outputs.point_cloud.xyz,
                                 n_partitions_hint=args.n_partitions,
                                 cameras=cams)
        scene.save(part_file)
    print(f"{len(scene.partitions)} partitions")

    names = outputs.train_set.image_names
    failed = []
    for pi, part in enumerate(scene.partitions):
        if pi % args.hosts != args.host_id:
            continue
        run_dir = os.path.join(args.output, f"partition_{pi:03d}")
        done_marker = os.path.join(run_dir, "TRAINED")
        if os.path.exists(done_marker):
            print(f"partition {pi}: already trained, skip")
            continue
        image_list = [names[i] for i in np.nonzero(part.camera_mask)[0]]
        if len(image_list) < 3:
            print(f"partition {pi}: too few cameras ({len(image_list)})")
            continue
        os.makedirs(run_dir, exist_ok=True)
        list_path = os.path.join(run_dir, "image_list.txt")
        with open(list_path, "w") as f:
            f.write("\n".join(image_list))

        scaled, scale_up = auto_hyper_parameter(
            len(image_list), scale_mode=args.scale_mode,
            max_steps=args.max_steps)
        cmd = fit_command(args, pi, list_path, scaled)
        print(f"partition {pi}: {len(image_list)} images, "
              f"scale_up={scale_up}")
        if args.dry_run:
            print(" ", " ".join(cmd))
            continue
        ok = False
        for attempt in range(args.retries + 1):
            t0 = time.time()
            r = subprocess.run(cmd, env=fit_env())
            if r.returncode == 0:
                ok = True
                break
            print(f"partition {pi} attempt {attempt} failed "
                  f"(rc={r.returncode})")
        if ok:
            with open(done_marker, "w") as f:
                f.write("ok")
            print(f"partition {pi}: TRAINED in {time.time() - t0:.1f} s"
                  + _before_loop(run_dir, t0))
        else:
            failed.append(pi)
    if failed:
        raise SystemExit(f"partitions {failed} failed after "
                         f"{args.retries + 1} attempts")


if __name__ == "__main__":
    main()
