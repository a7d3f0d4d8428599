"""Score a partitioned scene through the level-of-detail renderer.

    python -m gsl_tpu_torch.tools.val_partition_lod runs/parts \\
        --names . lod1 --lod-distances 2 --config scene.yaml \\
        [--split val|train|test] [--visibility-filter] [--output x.csv] \\
        [--device cpu]

Port of ``tools/val_partition_lod.py``: every camera of the split of the
dataset that `--config` names is rendered through
``renderers/partition_lod.PartitionLoDRenderer`` (K1 + K2 on the card) on
a black background, and its PSNR, SSIM (``ops/ssim.py``), assembled rows
and per-partition levels are printed and written to
``<partitions_dir>/lod_<split>.csv`` with a MEAN row. On `--device`
(cuda by default).
"""
import argparse
import csv
import os

import numpy as np
import torch

from ..utils.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser("gsl_tpu_torch.tools.val_partition_lod")
    ap.add_argument("partitions_dir")
    ap.add_argument("--names", nargs="+", required=True,
                    help="the levels' subdirectories, finest first ('.' = "
                         "train_partitions' runs)")
    ap.add_argument("--lod-distances", nargs="*", type=float, default=[])
    ap.add_argument("--config", required=True,
                    help="a config (e.g. a run's config.yaml snapshot) "
                         "naming the dataset")
    ap.add_argument("--split", default="val",
                    choices=["val", "train", "test"])
    ap.add_argument("--visibility-filter", action="store_true")
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from ..cli import build_components, load_config
    from ..data.dataset import CachedDataset, image_to_float
    from ..ops.ssim import ssim as ssim_fn
    from ..renderers.partition_lod import PartitionLoDConfig

    cfg = load_config([args.config], {})
    _, dataparser_cfg, _ = build_components(cfg)
    outputs = dataparser_cfg.instantiate().get_outputs()
    image_set = {"val": outputs.val_set, "train": outputs.train_set,
                 "test": outputs.test_set}[args.split]

    lod = PartitionLoDConfig(
        data=args.partitions_dir, names=args.names,
        lod_distances=args.lod_distances,
        visibility_filter=args.visibility_filter,
    ).instantiate().setup(dev)

    bg = torch.zeros(3, dtype=torch.float32, device=dev)
    dataset = CachedDataset(image_set, background=np.zeros(3, np.float32))
    rows = []
    with torch.no_grad():
        for i in range(len(dataset)):
            cam, name, img_u8, _ = dataset.get(i)
            img = image_to_float(img_u8.to(dev))
            H, W = img.shape[:2]
            out, stats = lod.forward(cam.to(dev), H, W, bg)
            render = out.render
            mse = float(torch.mean((render - img) ** 2))
            psnr = -10.0 * np.log10(max(mse, 1e-12))
            s = float(ssim_fn(img.permute(2, 0, 1), render.permute(2, 0, 1)))
            levels = ";".join(str(int(x)) for x in stats["partition_lods"])
            rows.append([name, psnr, s, stats["n_gaussians"], levels])
            print(f"{name}: psnr={psnr:.2f} ssim={s:.4f} "
                  f"n={stats['n_gaussians']} lods=[{levels}]")

    out_path = args.output or os.path.join(args.partitions_dir,
                                           f"lod_{args.split}.csv")
    with open(out_path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["name", "psnr", "ssim", "n_gaussians", "lods"])
        wr.writerows(rows)
        wr.writerow(["MEAN", float(np.mean([r[1] for r in rows])),
                     float(np.mean([r[2] for r in rows])), "", ""])
    print(f"wrote {out_path}")
    return rows


if __name__ == "__main__":
    main()
