"""Bake Mip-Splatting's 3D filter into the scales and opacities, so a
plain 3DGS renderer shows the model as the Mip renderer does.

    python -m gsl_tpu_torch.tools.fuse_mip_filter <run dir | .ply>
        --dataset_path <COLMAP scene> [-o fused.ply] [--device cpu]

Port of ``tools/fuse_mip_filter.py``: the filter is recomputed from the
scene's train cameras (``models/mip_splatting.compute_3d_filter``), applied
with opacity compensation, and written as raw scales and opacities
(opacity clipped to [1e-6, 1 - 1e-6]) to ``<run>/fused.ply`` unless ``-o``
is given. Runs on `--device` (cuda by default).
"""
import argparse
import dataclasses
import os

import torch

from ..data.dataparsers.colmap import ColmapDataParserConfig
from ..models.gaussian import GaussianState, inverse_sigmoid
from ..models.mip_splatting import apply_3d_filter, compute_3d_filter
from ..utils.gaussian_model_loader import GaussianModelLoader
from ..utils.ply import save_state_ply


def main(argv=None):
    ap = argparse.ArgumentParser("gsl_tpu_torch.tools.fuse_mip_filter")
    ap.add_argument("model_path")
    ap.add_argument("--dataset_path", required=True,
                    help="to recompute the 3D filter from train cameras")
    ap.add_argument("--output", "-o", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    state, _, _ = GaussianModelLoader.load(args.model_path, args.device)
    outputs = ColmapDataParserConfig(
        path=args.dataset_path).instantiate().get_outputs()
    p = state.params
    f3d = compute_3d_filter(p.means, state.alive, outputs.train_set.cameras)
    op, scales = apply_3d_filter(torch.exp(p.scales),
                                 torch.sigmoid(p.opacities[:, 0]), f3d)
    fused = GaussianState(params=dataclasses.replace(
        p, scales=torch.log(torch.clamp(scales, min=1e-12)),
        opacities=inverse_sigmoid(
            torch.clamp(op, 1e-6, 1.0 - 1e-6))[:, None]), alive=state.alive)
    out = args.output or os.path.join(args.model_path, "fused.ply")
    n = save_state_ply(out, fused)
    print(f"fused {n} gaussians -> {out}")
    return out


if __name__ == "__main__":
    main()
