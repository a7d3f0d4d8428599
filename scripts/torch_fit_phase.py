"""chip_smoke.py's phase 8 alone (the CLI fits of a synthesised COLMAP
scene at 1088x1920), once for each checkout given, in the order given, each
in a process of its own on one CUDA card.

    python3 scripts/torch_fit_phase.py DIR [DIR ...]

Each DIR is a checkout of the repository (a `git archive` unpacked under
`.scratch/`, say); the run uses that checkout's chip_smoke.py and
gsl_tpu_torch/, builds its kernels, and prints that chip_smoke.py's phase-8
lines: ms per step in each log window, the share of each loop spent waiting
on the loader, ms per densify (and, where that checkout records them, the
rows each densify cloned, split and pruned), peak memory and launches.
Host-clock times differ between hosts, so compare two checkouts only inside
one run of this script (A, B, B, A).
"""
import os
import subprocess
import sys
import time

CHILD = """
import sys
import torch
sys.path.insert(0, ".")
import chip_smoke as CS
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
CS.cuda_build.build()
CS.phase_fit(CS.scene_arrays(CS.N_GAUSSIANS))
"""


def main():
    dirs = sys.argv[1:]
    if not dirs:
        sys.exit(__doc__)
    for d in dirs:
        t0 = time.perf_counter()
        print(f"== {d}", flush=True)
        rc = subprocess.run([sys.executable, "-c", CHILD],
                            cwd=os.path.abspath(d), timeout=600).returncode
        print(f"== {d}: rc {rc} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        if rc != 0:
            sys.exit(rc)


if __name__ == "__main__":
    main()
