"""chip_smoke.py's phase 13 alone (dynamic scenes: DeformTrainer with the
MLP and the HexPlane field and PVG at 1M Gaussians, K1-K4 held against
their plain versions on each path's deformed or modulated inputs, and
deformable.yaml, gs4d.yaml and pvg.yaml fitted and resumed through the
CLI on a synthesised Nerfies capture) on one CUDA card.

    python3 scripts/torch_dynamic_phase.py

The plain 3DGS step that phase 13 (a) prints beside its steps is phase
5's, which this script does not run: it prints 25.0 ms in its place
(phase 5's median at capacity 1M on an NVIDIA H100 80GB HBM3 at 700 W,
PERF.md). Phase 13 (b) writes its own scene.
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
    CS.phase_dynamic_training(CS.scene_arrays(CS.N_GAUSSIANS),
                              PLAIN_STEP_MS)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        CS.phase_dynamic_fits(tmp)
    print(f"phase 13 in {time.perf_counter() - t0:.1f} s ((a) "
          f"{t1 - t0:.1f} s with the build, (b) "
          f"{time.perf_counter() - t1:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
