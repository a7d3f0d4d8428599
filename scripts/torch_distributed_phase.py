"""chip_smoke.py's phase 17 alone (distributed training: the sharded step
on 4 ranks sharing the card, and colmap.yaml + distributed.yaml through
`cli fit`) on one CUDA card.

    python3 scripts/torch_distributed_phase.py [--skip-fit]

It writes phase 8's COLMAP scene first and scores its initial cloud as
phase 8 does (the PSNR the distributed fit must beat). `--skip-fit` runs
(a) alone.
"""
import argparse
import contextlib
import io
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as CS  # noqa: E402


def initial_psnr(data, tmp):
    """Phase 8's val PSNR of colmap.yaml's initial cloud."""
    colmap = os.path.join(CS.PRESETS, "colmap.yaml")
    trainer, dp_cfg, fit_cfg = CS.cli.build_components(CS.cli.load_config(
        [colmap], CS.cli.parse_overrides(CS.FIT_OVERRIDES
                                         + (f"data.path={data}",))))
    outputs = dp_cfg.instantiate().get_outputs()
    fit_cfg.output_dir = os.path.join(tmp, "initial")
    with contextlib.redirect_stdout(io.StringIO()):
        return CS.validate(trainer, trainer.setup(
            CS._init_gaussians(trainer, outputs, fit_cfg, "cuda"),
            outputs.camera_extent), outputs, fit_cfg)["psnr"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-fit", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CS.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(CS.CARD, flush=True)
    t0 = time.perf_counter()
    CS.cuda_build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    if args.skip_fit:
        CS.phase_distributed_step()
        return
    arrays = CS.scene_arrays(CS.N_GAUSSIANS)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "scene")
        t0 = time.perf_counter()
        CS.write_colmap_scene(data, arrays)
        psnr0 = initial_psnr(data, tmp)
        print(f"phase 8's scene written and its initial cloud scored "
              f"({psnr0:.3f} dB) in {time.perf_counter() - t0:.1f} s",
              flush=True)
        torch.cuda.empty_cache()
        CS.phase_distributed(tmp, {"psnr0": psnr0})


if __name__ == "__main__":
    main()
