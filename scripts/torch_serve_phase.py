"""chip_smoke.py's phase 15 alone (serve and edit: the web viewer over
HTTP on the bench scene's 1M-Gaussian PLY and on a gs2d.yaml run, the
in-training viewer beside the same fit without it, the NSVF, NGP,
MatrixCity and SiLVR parsers fitted through the CLI, LPIPS, and the PLY
and checkpoint tools) on one CUDA card.

    python3 scripts/torch_serve_phase.py

Phase 15 needs phase 8's scene and its colmap.yaml and gs2d.yaml runs,
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
    CS.cuda_build.build()
    arrays = CS.scene_arrays(CS.N_GAUSSIANS)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        CS.phase_fit(arrays, tmp)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        CS.phase_serve_and_edit(tmp, arrays)
    print(f"phase 15 in {time.perf_counter() - t1:.1f} s after phase 8 "
          f"({t1 - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
