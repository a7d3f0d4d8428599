"""Second-stage semantic feature distillation (Feature 3DGS) on a frozen
scene.

    python -m gsl_tpu_torch.feature3dgs fit <run_dir_or_ply>
        --data.path SCENE [--feature_dir semantic/sam_features]
        [--n_feature_dims 128] [--speedup] [--max_steps 10000]
        [--output outputs/feature3dgs] [--device cuda]

Port of the repo-root ``feature3dgs.py``: the scene comes through the
port's `GaussianModelLoader`, each image's teacher map
(`<scene>/<feature_dir>/<name>.npy`, [h, w, D], or [D, h, w], which is
transposed only when its first axis is `n_feature_dims`, as the root
script does) through the Feature3DGS COLMAP parser; step k trains on
train image (k - 1) mod n, skipping an image without a map. Writes
`<output>/features.npz` with the keys `features` (and `dec_w`, `dec_b`
with `--speedup`). Runs on cuda unless ``--device cpu`` is given.
"""
import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser("feature3dgs")
    ap.add_argument("subcommand", choices=["fit"])
    ap.add_argument("model_path", help="trained scene (run dir or ply)")
    ap.add_argument("--data.path", dest="data_path", required=True)
    ap.add_argument("--feature_dir", default="semantic/sam_features")
    ap.add_argument("--n_feature_dims", type=int, default=128)
    ap.add_argument("--speedup", action="store_true")
    ap.add_argument("--max_steps", type=int, default=10000)
    ap.add_argument("--output", default="outputs/feature3dgs")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch "
                         "versions of the kernels")
    args = ap.parse_args(argv)

    import torch

    from gsl_tpu_torch.data.dataparsers.feature_3dgs import (
        Feature3DGSColmapDataParserConfig)
    from gsl_tpu_torch.data.dataset import CachedDataset
    from gsl_tpu_torch.training.feature3dgs import (Feature3DGSConfig,
                                                    Feature3DGSTrainer)
    from gsl_tpu_torch.utils.device import resolve_device
    from gsl_tpu_torch.utils.gaussian_model_loader import GaussianModelLoader

    dev = resolve_device(args.device)
    state, _, _ = GaussianModelLoader.load(args.model_path, dev)
    outputs = Feature3DGSColmapDataParserConfig(
        path=args.data_path,
        feature_dir=args.feature_dir).instantiate().get_outputs()
    dataset = CachedDataset(outputs.train_set)
    feat_paths = outputs.train_set.extra_data["feature_map_paths"]

    cfg = Feature3DGSConfig(n_feature_dims=args.n_feature_dims,
                            speedup=args.speedup)
    trainer = Feature3DGSTrainer(cfg, state)
    params, opt_state = trainer.init(torch.Generator().manual_seed(0))

    os.makedirs(args.output, exist_ok=True)
    n = len(dataset)
    losses = {}
    for step in range(1, args.max_steps + 1):
        i = (step - 1) % n
        if not os.path.isfile(feat_paths[i]):
            continue
        cam, _, img, _ = dataset.get(i)
        H, W = img.shape[:2]
        gt_map = np.load(feat_paths[i]).astype(np.float32)
        if (gt_map.shape[-1] != cfg.n_feature_dims
                and gt_map.shape[0] == cfg.n_feature_dims):
            gt_map = np.transpose(gt_map, (1, 2, 0))      # CHW -> HWC
        params, opt_state, loss = trainer.train_step(
            params, opt_state, cam.to(dev),
            torch.from_numpy(np.ascontiguousarray(gt_map)).to(dev), H, W)
        losses[step] = loss
        if step % 100 == 0:
            print(f"step {step}: l1={float(loss):.5f}")

    np.savez(os.path.join(args.output, "features.npz"),
             **{k: v.cpu().numpy() for k, v in params.items()})
    print(f"saved {args.output}/features.npz")
    return params, {k: float(v) for k, v in losses.items()}


if __name__ == "__main__":
    main()
