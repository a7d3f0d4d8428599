"""chip_smoke.py's phase 14 alone (the backward kernels past their channel
ceilings at C = 32, 64 and 128 with K3's time per channel group, K3s and
K7 past theirs; the SpotLess step at 1M and spotless.yaml fitted and
resumed through the CLI; Feature3DGS and SegAny steps at 1M and their
entry points on a colmap.yaml run) on one CUDA card.

    python3 scripts/torch_distill_phase.py

The plain 3DGS step that phase 14 (b) prints beside its steps is phase
5's, which this script does not run: it prints 25.0 ms in its place
(phase 5's median at capacity 1M on an NVIDIA H100 80GB HBM3 at 700 W,
PERF.md). Phase 14 (b) and (c) need phase 8's scene and colmap.yaml run,
which this script makes first with phase 8 itself.
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
        CS.phase_wide_kernels(arrays)
    torch.cuda.empty_cache()
    CS.phase_spotless_training(arrays, PLAIN_STEP_MS)
    torch.cuda.empty_cache()
    CS.phase_distill(arrays)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        CS.phase_fit(arrays, tmp)
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        CS.phase_spotless_fit(tmp)
        torch.cuda.empty_cache()
        CS.phase_distill_entry_points(tmp)
    print(f"phase 14 in {time.perf_counter() - t0 - (t2 - t1):.1f} s "
          f"without phase 8 ({t2 - t1:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
