"""Rotate, scale and translate a trained model, its SH bands with it.

    python -m gsl_tpu_torch.tools.gaussian_transform <in.ply | run dir>
        <out.ply> [--rotate-euler RX RY RZ] [--translate TX TY TZ]
        [--scale S] [--device cpu]

Port of ``tools/gaussian_transform.py``: scale first, then the rotation
(degrees, R = Rz Ry Rx in float32), then the translation, by
``utils/gaussian_transforms.py`` on `--device` (cuda by default).
"""
import argparse

import numpy as np

from ..utils.gaussian_model_loader import GaussianModelLoader
from ..utils.gaussian_transforms import (rotate_state, scale_state,
                                         translate_state)
from ..utils.ply import save_state_ply
from ..viewer.panels import euler_to_rotmat


def main(argv=None):
    ap = argparse.ArgumentParser("gsl_tpu_torch.tools.gaussian_transform")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--rotate-euler", type=float, nargs=3, default=None,
                    metavar=("RX", "RY", "RZ"))
    ap.add_argument("--translate", type=float, nargs=3, default=None,
                    metavar=("TX", "TY", "TZ"))
    ap.add_argument("--scale", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    state, _, _ = GaussianModelLoader.load(args.input, args.device)
    if args.scale is not None and args.scale != 1.0:
        state = scale_state(state, args.scale)
    if args.rotate_euler is not None:
        state = rotate_state(state, euler_to_rotmat(
            *args.rotate_euler).astype(np.float32))
    if args.translate is not None:
        state = translate_state(state, np.asarray(args.translate,
                                                  np.float32))
    n = save_state_ply(args.output, state)
    print(f"wrote {args.output} ({n} gaussians)")


if __name__ == "__main__":
    main()
