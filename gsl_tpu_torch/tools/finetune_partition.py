"""Fine-tune one partition from a pruned level of detail.

    python -m gsl_tpu_torch.tools.finetune_partition runs/parts 0 \\
        [--src lod1] [--base .] [--steps 2000] [--device cpu] \\
        [--extra key=value ...]

Port of ``tools/finetune_partition.py``: ``python -m gsl_tpu_torch.cli
fit`` with the partition's own ``config.yaml`` snapshot (under `--base`),
initialised from the artifact under `--src` (``fit.init_from``, a fresh
optimizer), ``fit.resume=never`` and no intermediate saves, for `--steps`
steps on `--device` (cuda by default). The run goes to
``<partitions_dir>/<src>_ft/partition_NNN``; gsl_tpu's goes into the
base run's directory, which its snapshot names as ``fit.output_dir``.
Exits with the fit's code when that is not 0.
"""
import argparse
import os
import subprocess
import sys

from ..utils.device import resolve_device
from .train_partitions import fit_env


def fit_command(args) -> list:
    pname = f"partition_{args.partition:03d}"
    src_dir = os.path.join(args.partitions_dir, args.src, pname)
    snap = os.path.join(args.partitions_dir, args.base, pname,
                        "config.yaml")
    if not os.path.isfile(snap):
        raise SystemExit(f"no config snapshot at {snap}")
    out_dir = os.path.join(args.partitions_dir, args.src + "_ft")
    # the snapshot holds the base run's fit.output_dir, which the CLI's
    # --output and -n do not replace: name the fine-tune's own
    return [sys.executable, "-u", "-m", "gsl_tpu_torch.cli",
            "fit", "--config", snap,
            "--output", out_dir, "-n", pname,
            "--max_steps", str(args.steps), "--device", args.device,
            f"fit.init_from={src_dir}",
            "fit.resume=never",
            "fit.save_iterations=[]",
            f"fit.output_dir={os.path.join(out_dir, pname)}"] \
        + list(args.extra)


def main(argv=None):
    ap = argparse.ArgumentParser("gsl_tpu_torch.tools.finetune_partition")
    ap.add_argument("partitions_dir")
    ap.add_argument("partition", type=int)
    ap.add_argument("--src", default="lod1",
                    help="the level whose artifact is fine-tuned")
    ap.add_argument("--base", default=".",
                    help="the level holding the partition's own run "
                         "(config.yaml)")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--extra", nargs="*", default=[])
    args = ap.parse_args(argv)
    resolve_device(args.device)

    cmd = fit_command(args)
    print(" ".join(cmd))
    rc = subprocess.call(cmd, env=fit_env())
    if rc:
        raise SystemExit(rc)
    return rc


if __name__ == "__main__":
    main()
