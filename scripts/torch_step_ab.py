"""Training-step times of the StopThePop and 2DGS paths of the PyTorch port
for two checkouts of the repository, alternated on one CUDA card: A, B, B,
A.

    python3 scripts/torch_step_ab.py DIR_A DIR_B

Each run is a process started in that checkout that builds its kernels and
runs its own chip_smoke.py's phase 7 training (StopThePop: 12 steps at
capacity 1M, a densify to 2M, 3 steps) and phase 6 (2DGS: serving, then 12
steps at 1M, a densify, 3 steps) on the bench scene. Host-clock step times
differ between hosts by more than a kernel's share of a step, so two
versions are compared only inside one run of this script. Prints, per
run, the median ms per step of steps 6-12 (capacity 1M) of each path, then
one JSON line with every run's step times.
"""
import json
import os
import statistics
import subprocess
import sys

CHILD = """
import sys
import torch
sys.path.insert(0, ".")
import chip_smoke as CS
from gsl_tpu_torch.ops import cuda_build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cuda_build.build()
arrays = CS.scene_arrays(CS.N_GAUSSIANS)
CS.phase_training(arrays, {"rasterize_bwd_stp": 0.0, "invert_order": 0.0,
                           "reduce_grads": 0.0}, stp=True)
torch.cuda.empty_cache()
CS.phase_surfel_main_path(arrays)
"""
LINES = {"stp": "StopThePop training: ms per step (host clock, synchronised) ",
         "2dgs": "2DGS training: ms per step (host clock, synchronised) "}


def run(checkout):
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=checkout,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{checkout}: exit {proc.returncode}\n"
                         f"{proc.stderr[-3000:]}")
    steps = {}
    for line in proc.stdout.splitlines():
        for path, prefix in LINES.items():
            if line.startswith(prefix):
                steps[path] = json.loads(line[len(prefix):])
    if sorted(steps) != sorted(LINES):
        raise SystemExit(f"{checkout}: no step times in its output")
    return steps


def main():
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    a, b = (os.path.abspath(d) for d in sys.argv[1:])
    runs = []
    for label, checkout in (("A", a), ("B", b), ("B", b), ("A", a)):
        steps = run(checkout)
        medians = {p: statistics.median(s[5:12]) for p, s in steps.items()}
        print(f"{label} {checkout}: median ms per step, steps 6-12: "
              + ", ".join(f"{p} {m:.2f}" for p, m in medians.items()),
              flush=True)
        runs.append({"label": label, "checkout": checkout, "steps": steps,
                     "median_steps_6_12": medians})
    print(json.dumps(runs))


if __name__ == "__main__":
    main()
