"""Training-step and frame times of the PyTorch port's paths for two
checkouts of the repository, alternated on one CUDA card: A, B, B, A.

    python3 scripts/torch_step_ab.py DIR_A DIR_B

Each run is a process started in that checkout that builds its kernels,
times the stages of the bench-pose rgb frame of plain 3DGS and of
StopThePop (median of 21 frames each, CUDA events, its own chip_smoke.py's
stage_times), and runs its own chip_smoke.py's phase 5 training (plain 3DGS: 20 steps at
capacity 1M, a densify to 2M, 6 steps), phase 7 training (StopThePop: 12
steps at capacity 1M, a densify to 2M, 3 steps) and phase 6 (2DGS: serving,
five bench-pose frames with all seven outputs, then 12 steps at 1M, a
densify, 3 steps) on the bench scene. Host-clock step times differ between
hosts by more than a kernel's share of a step, so two versions are compared
only inside one run of this script. Prints, per run, the median ms per step
of steps 6 to the densify (capacity 1M) of each training path, the median
ms of the 2DGS frames and the frames' "forward" stages (K2, K2s), then one
JSON line with every run's times.
"""
import json
import os
import statistics
import subprocess
import sys

CHILD = """
import json
import sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as CS
from gsl_tpu_torch.ops import cuda_build
from gsl_tpu_torch.renderers.tile_renderer import TileRendererConfig
from gsl_tpu_torch.utils.convert import state_from_raw_arrays
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cuda_build.build()
arrays = CS.scene_arrays(CS.N_GAUSSIANS)
state = state_from_raw_arrays(arrays, device="cuda")
with torch.no_grad():
    for tag, stp in (("3dgs", False), ("stp", True)):
        stages = CS.stage_times(
            state, TileRendererConfig(stp_resort=stp).instantiate(),
            CS.SH_DEGREE, CS.camera(np.eye(4)), reps=21, stp=stp)
        print(f"frame stage ms {tag} " + json.dumps(stages), flush=True)
del state
torch.cuda.empty_cache()
CS.phase_training(arrays, {"rasterize_bwd": 0.0, "invert_order": 0.0,
                           "reduce_grads": 0.0})
torch.cuda.empty_cache()
CS.phase_training(arrays, {"rasterize_bwd_stp": 0.0, "invert_order": 0.0,
                           "reduce_grads": 0.0}, stp=True)
torch.cuda.empty_cache()
CS.phase_surfel_main_path(arrays)
"""
# path -> (the line's prefix, the times that are read: steps 6 to the
# densify, or every frame)
LINES = {
    "3dgs": ("training: ms per step (host clock, synchronised) ",
             slice(5, 20)),
    "stp": ("StopThePop training: ms per step (host clock, synchronised) ",
            slice(5, 12)),
    "2dgs": ("2DGS training: ms per step (host clock, synchronised) ",
             slice(5, 12)),
    "2dgs_frame": ("2DGS bench-pose frame (all seven outputs), host clock "
                   "ms ", slice(None)),
}
# path -> the line of its frame's stage ms, whose "forward" is read
FRAMES = {"3dgs_forward": "frame stage ms 3dgs ",
          "stp_forward": "frame stage ms stp "}


def run(checkout):
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=checkout,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{checkout}: exit {proc.returncode}\n"
                         f"{proc.stderr[-3000:]}")
    times = {}
    for line in proc.stdout.splitlines():
        for path, (prefix, _) in LINES.items():
            if line.startswith(prefix):
                times[path] = json.loads(line[len(prefix):])
        for path, prefix in FRAMES.items():
            if line.startswith(prefix):
                times[path] = [json.loads(line[len(prefix):])["forward"]]
    if sorted(times) != sorted([*LINES, *FRAMES]):
        raise SystemExit(f"{checkout}: no step or frame times in its output")
    return times


def main():
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    a, b = (os.path.abspath(d) for d in sys.argv[1:])
    runs = []
    for label, checkout in (("A", a), ("B", b), ("B", b), ("A", a)):
        times = run(checkout)
        medians = {p: statistics.median(
            t[LINES[p][1]] if p in LINES else t) for p, t in times.items()}
        print(f"{label} {checkout}: median ms, training steps 6 to the "
              "densify, 2DGS frames and the frames' forward stages: "
              + ", ".join(f"{p} {m:.2f}" for p, m in medians.items()),
              flush=True)
        runs.append({"label": label, "checkout": checkout, "times": times,
                     "medians": medians})
    print(json.dumps(runs))


if __name__ == "__main__":
    main()
