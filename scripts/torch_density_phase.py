"""chip_smoke.py's phase 12 alone (the density variants and Glossy: the
blend weights and K3, K4 on Taming's pixel weights, Taming's scores and
round, one densify of each of the six controllers, GNS's steps, densify
and final prune, a LightGaussian prune and Glossy's steps at 1M
Gaussians, and the five presets and five controllers through the CLI) on
one CUDA card.

    python3 scripts/torch_density_phase.py

Phase 12 (b) needs phase 8's scene and its colmap.yaml numbers: this
script writes the scene as phase 8 does, validates its initial cloud and
fits colmap.yaml on it for 300 steps, then runs phase 12 (a) and (b) and
prints their lines. The plain 3DGS step that phase 12 (a) prints beside
its steps is phase 5's, which this script does not run: it prints 25.0 ms
in its place (phase 5's median at capacity 1M on an NVIDIA H100 80GB
HBM3 at 700 W, PERF.md).
"""
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as CS  # noqa: E402

PLAIN_STEP_MS = 25.0


def main():
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
    CS.cuda_build.build(CS.UNCONTRACTED, CS.cuda_build.NO_CONTRACTION)
    arrays = CS.scene_arrays(CS.N_GAUSSIANS)
    CS.phase_density_variants(arrays, PLAIN_STEP_MS)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        data, runs = os.path.join(tmp, "scene"), os.path.join(tmp, "runs")
        CS.write_colmap_scene(data, arrays)
        colmap = os.path.join(CS.PRESETS, "colmap.yaml")
        psnr0, _ = CS.initial_psnr([colmap], CS.FIT_OVERRIDES + (
            f"data.path={data}",), tmp, "colmap")
        f = CS.run_cli(["fit", "--config", colmap, "--data.path", data,
                        "--output", runs, "-n", "colmap", "--max_steps",
                        str(CS.FIT_STEPS), *CS.FIT_OVERRIDES],
                       CS.GAUSSIAN_KERNELS)
        ms = [1e3 / float(r[3]) for r in f["rows"]][1:]
        colmap_fit = {"psnr0": psnr0, "psnr": f["results"]["psnr"],
                      "ms": float(np.median(ms)),
                      "loader_share": f["timing"]["loader_wait_s"]
                      / f["timing"]["wall_s"]}
        del f
        CS.phase_density_fits(tmp, colmap_fit)
    print(f"phase 12 in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
