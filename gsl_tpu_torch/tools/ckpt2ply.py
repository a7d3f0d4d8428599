"""Export a trained run (its newest checkpoint or PLY) as an Inria-layout
PLY.

    python -m gsl_tpu_torch.tools.ckpt2ply <run dir | .ply> [-o out.ply]
        [--device cpu]

Port of ``tools/ckpt2ply.py``: the alive rows of the model
``GaussianModelLoader`` finds, written to ``<run>/exported.ply`` unless
``-o`` is given. Loads on cuda unless ``--device cpu`` is given.
"""
import argparse
import os

from ..utils.gaussian_model_loader import GaussianModelLoader
from ..utils.ply import save_state_ply


def main(argv=None):
    ap = argparse.ArgumentParser("gsl_tpu_torch.tools.ckpt2ply")
    ap.add_argument("model_path", help="run dir or checkpoint dir")
    ap.add_argument("--output", "-o", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    state, _, _ = GaussianModelLoader.load(args.model_path, args.device)
    out = args.output or os.path.join(args.model_path, "exported.ply")
    n = save_state_ply(out, state)
    print(f"wrote {n} gaussians to {out}")
    return out


if __name__ == "__main__":
    main()
