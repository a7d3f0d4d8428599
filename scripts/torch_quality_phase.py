"""chip_smoke.py's phase 18 alone (gsl_tpu_torch.tools.profile_stages at
the bench scene, then gsl_tpu_torch.tools.quality_benchmark in process,
cut in views and steps) on one CUDA card.

    python3 scripts/torch_quality_phase.py

Phase 18 (a) prints each stage beside phase 4's stage_times, which this
script takes itself on the bench scene at the bench pose; phase 3's kernel
times are not taken.
"""
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as CS  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CS.CARD = CS.quality_benchmark.card_name("cuda")
    print(CS.CARD, flush=True)
    t0 = time.perf_counter()
    CS.cuda_build.build()
    state = CS.state_from_raw_arrays(CS.scene_arrays(CS.N_GAUSSIANS),
                                     device="cuda")
    with torch.no_grad():
        stage_ms = CS.stage_times(
            state, CS.TileRendererConfig().instantiate(), CS.SH_DEGREE,
            CS.camera(np.eye(4)))
    del state
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        CS.phase_quality_tools(tmp, stage_ms, None)
    print(f"phase 18 in {time.perf_counter() - t0:.1f} s with the build",
          flush=True)


if __name__ == "__main__":
    main()
