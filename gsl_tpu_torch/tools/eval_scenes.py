"""Score a list of trained runs and summarise them in one table.

    python -m gsl_tpu_torch.tools.eval_scenes --output outputs \\
        --scenes lego chair [--split val|test] [--out summary.csv] \\
        [--skip-validate] [--device cpu]

Port of ``tools/eval_scenes.py``: each scene is a run ``<output>/<scene>``
of ``python -m gsl_tpu_torch.cli fit``. Unless `--skip-validate`, the
CLI's ``validate`` (or ``test``) runs on it on `--device` (cuda by
default), from the run's own config snapshot and newest checkpoint,
writing ``metrics/<split>.csv``; the MEAN row of each such file then goes
into a Markdown table on standard output and into
``<output>/eval_summary.csv`` (scene, psnr, ssim, lpips, and a MEAN row).
"""
import argparse
import csv
import os

import numpy as np

from ..utils.device import resolve_device


def read_mean_row(csv_path):
    """(psnr, ssim, lpips) of a metrics CSV's MEAN row; lpips NaN where
    its cell is empty."""
    with open(csv_path) as f:
        rows = list(csv.reader(f))
    for r in rows:
        if r and r[0] == "MEAN":
            psnr = float(r[1])
            ssim = float(r[2])
            lpips = float(r[3]) if len(r) > 3 and r[3] not in ("", None) \
                else float("nan")
            return psnr, ssim, lpips
    raise ValueError(f"no MEAN row in {csv_path}")


def main(argv=None):
    ap = argparse.ArgumentParser("gsl_tpu_torch.tools.eval_scenes")
    ap.add_argument("--output", default="outputs",
                    help="the runs' root (each scene is a run dir in it)")
    ap.add_argument("--scenes", nargs="+", required=True)
    ap.add_argument("--split", default="val", choices=["val", "test"])
    ap.add_argument("--out", default=None,
                    help="summary CSV (default <output>/eval_summary.csv)")
    ap.add_argument("--skip-validate", action="store_true",
                    help="only gather the metrics CSVs already written")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    from ..cli import main as cli_main

    sub = "validate" if args.split == "val" else "test"
    results = []
    for scene in args.scenes:
        run_dir = os.path.join(args.output, scene)
        csv_path = os.path.join(run_dir, "metrics", f"{args.split}.csv")
        if not args.skip_validate:
            cli_main([sub, "-n", scene, "--output", args.output,
                      "--device", args.device])
        results.append((scene,) + read_mean_row(csv_path))

    print("\n| scene | PSNR | SSIM | LPIPS |")
    print("|---|---|---|---|")
    for scene, p, s, lp in results:
        ls = f"{lp:.4f}" if lp == lp else "-"
        print(f"| {scene} | {p:.2f} | {s:.4f} | {ls} |")
    mp = float(np.mean([r[1] for r in results]))
    ms = float(np.mean([r[2] for r in results]))
    lv = [r[3] for r in results if r[3] == r[3]]
    ml = float(np.mean(lv)) if lv else float("nan")
    print(f"| MEAN | {mp:.2f} | {ms:.4f} | "
          f"{(f'{ml:.4f}' if ml == ml else '-')} |")

    out = args.out or os.path.join(args.output, "eval_summary.csv")
    with open(out, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["scene", "psnr", "ssim", "lpips"])
        wr.writerows(results)
        wr.writerow(["MEAN", mp, ms, ml])
    print(f"wrote {out}")
    return results


if __name__ == "__main__":
    main()
