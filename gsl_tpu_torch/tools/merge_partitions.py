"""Merge the trained partitions into one PLY.

    python -m gsl_tpu_torch.tools.merge_partitions runs/parts \\
        [-o merged.ply] [--device cpu]

Port of ``tools/merge_partitions.py``: each partition run keeps the alive
Gaussians whose centres lie inside its own cell in the ground plane
(``utils/partitioning.gaussians_in_partition``, ownership by position),
and the partitions' rows are written in order to one PLY
(``<partitions_dir>/merged.ply`` unless ``-o``). The runs load on
`--device` (cuda by default); the ownership test runs on the host. As in
gsl_tpu, the six core properties are written and optional ones
(appearance features, a Mip filter) are not, so both tools write the
same bytes.
"""
import argparse
import os

import numpy as np

from ..utils.device import resolve_device

FIELDS = ("means", "scales", "rotations", "opacities", "shs_dc", "shs_rest")


def main(argv=None):
    ap = argparse.ArgumentParser("gsl_tpu_torch.tools.merge_partitions")
    ap.add_argument("partitions_dir")
    ap.add_argument("--output", "-o", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from ..utils.gaussian_model_loader import GaussianModelLoader
    from ..utils.partitioning import (PartitionedScene,
                                      gaussians_in_partition)
    from ..utils.ply import save_gaussian_ply

    scene = PartitionedScene.load(
        os.path.join(args.partitions_dir, "partitions.npz"))
    merged = {k: [] for k in FIELDS}
    for pi, part in enumerate(scene.partitions):
        run_dir = os.path.join(args.partitions_dir, f"partition_{pi:03d}")
        if not os.path.isdir(run_dir):
            continue
        try:
            state, _, _ = GaussianModelLoader.load(run_dir, dev)
        except FileNotFoundError:
            print(f"partition {pi}: no artifact, skip")
            continue
        alive = state.alive
        means = state.params.means[alive].cpu().numpy()
        own = gaussians_in_partition(means, part, scene.rotation,
                                     scene.up_axis)
        print(f"partition {pi}: {own.sum()}/{int(alive.sum())} owned")
        for k in FIELDS:
            merged[k].append(
                getattr(state.params, k)[alive].cpu().numpy()[own])

    if not merged["means"]:
        raise SystemExit("nothing to merge")
    cat = {k: np.concatenate(v) for k, v in merged.items()}
    out = args.output or os.path.join(args.partitions_dir, "merged.ply")
    save_gaussian_ply(out, *(cat[k] for k in FIELDS))
    print(f"wrote {cat['means'].shape[0]} gaussians to {out}")
    return out


if __name__ == "__main__":
    main()
