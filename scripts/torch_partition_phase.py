"""chip_smoke.py's phase 16 alone (the city-scale slice: a 4M-row city
served through PartitionLoDRenderer, and the partition pipeline through
the tools, sfm_outlier_detection to meganerf2colmap) on one CUDA card.

    python3 scripts/torch_partition_phase.py [--steps N]

Phase 16 writes its own scenes from the bench scene; it needs no earlier
phase. `--steps` sets the steps of each partition's fit (chip_smoke.py's
CITY_STEPS by default).
"""
import argparse
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
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=CS.CITY_STEPS)
    CS.CITY_STEPS = ap.parse_args().steps
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
    arrays = CS.scene_arrays(CS.N_GAUSSIANS)
    with tempfile.TemporaryDirectory() as tmp:
        CS.phase_partitions(arrays, tmp)


if __name__ == "__main__":
    main()
