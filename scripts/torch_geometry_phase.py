"""chip_smoke.py's phase 10 alone (the geometry slice: K1-K4 at C = 1, 4
and 7, the depth, normal and ground regularisers at 1M Gaussians, the
depth-scale tool and the four geometry presets through the CLI, and a 2DGS
mesh at resolution 256) on one CUDA card.

    python3 scripts/torch_geometry_phase.py

Phase 10 needs phase 8's scene and its gs2d.yaml run: this script writes
the scene as phase 8 does and fits gs2d.yaml on it for 100 steps, then runs
phase 10 (a), (b) and (c) and prints their lines. The plain 3DGS step that
phase 10 (a) prints beside its steps is phase 5's, which this script does
not run: it prints 25.0 ms in its place (phase 5's median at capacity 1M
on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md).
"""
import os
import subprocess
import sys
import tempfile
import time

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
    with torch.no_grad():
        CS.phase_geometry_kernels(
            CS.state_from_raw_arrays(arrays, device="cuda"),
            CS.TileRendererConfig().instantiate())
    torch.cuda.empty_cache()
    CS.phase_geometry_training(arrays, PLAIN_STEP_MS)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "scene")
        CS.write_colmap_scene(data, arrays)
        CS.run_cli(["fit", "--config", os.path.join(CS.PRESETS,
                                                    "gs2d.yaml"),
                    "--data.path", data, "--output",
                    os.path.join(tmp, "runs"), "-n", "gs2d",
                    "--max_steps", str(CS.VARIANT_STEPS)],
                   CS.SURFEL_KERNELS)
        CS.phase_depth_fits(arrays, tmp)
        torch.cuda.empty_cache()
        CS.phase_mesh(tmp)
    print(f"phase 10 in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
