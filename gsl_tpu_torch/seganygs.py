"""Second-stage SegAny feature distillation on a frozen scene.

    python -m gsl_tpu_torch.seganygs fit <run_dir_or_ply> --data.path SCENE
        [--max_steps 10000] [--output outputs/segany] [--feature_dims 32]
        [--device cuda]

Port of the repo-root ``seganygs.py``: the scene comes through the port's
`GaussianModelLoader`, the SAM masks (`<scene>/semantic/masks/<stem>.npz`,
key `masks` [M, H, W] bool) through the SegAny COLMAP parser; step k
trains on train image k mod n, skipping an image without masks, at a
query scale of 1.0 (as the root script passes it). Writes
`<output>/scene_features.npy` [capacity, feature_dims]. Runs on cuda
unless ``--device cpu`` is given.
"""
import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser("seganygs")
    ap.add_argument("subcommand", choices=["fit"])
    ap.add_argument("model_path", help="trained scene (run dir or ply)")
    ap.add_argument("--data.path", dest="data_path", required=True)
    ap.add_argument("--max_steps", type=int, default=10000)
    ap.add_argument("--output", default="outputs/segany")
    ap.add_argument("--feature_dims", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch "
                         "versions of the kernels")
    args = ap.parse_args(argv)

    import torch

    from gsl_tpu_torch.data.dataparsers.segany_colmap import (
        SegAnyColmapDataParserConfig)
    from gsl_tpu_torch.data.dataset import CachedDataset
    from gsl_tpu_torch.training.segany import SegAnyConfig, SegAnyTrainer
    from gsl_tpu_torch.utils.device import resolve_device
    from gsl_tpu_torch.utils.gaussian_model_loader import GaussianModelLoader

    dev = resolve_device(args.device)
    state, _, _ = GaussianModelLoader.load(args.model_path, dev)
    outputs = SegAnyColmapDataParserConfig(
        path=args.data_path).instantiate().get_outputs()
    dataset = CachedDataset(outputs.train_set)

    trainer = SegAnyTrainer(SegAnyConfig(feature_dims=args.feature_dims),
                            state)
    features, opt_state = trainer.init(torch.Generator().manual_seed(0))
    generator = torch.Generator(device=dev).manual_seed(0)

    mask_paths = outputs.train_set.extra_data["sam_masks"]
    scale_paths = outputs.train_set.extra_data["mask_scales"]
    os.makedirs(args.output, exist_ok=True)
    n = len(dataset)
    losses = {}
    for step in range(args.max_steps):
        i = step % n
        if mask_paths[i] is None:
            continue
        cam, _, img, _ = dataset.get(i)
        H, W = img.shape[:2]
        masks = np.load(mask_paths[i])["masks"]
        scales = (np.load(scale_paths[i])
                  if scale_paths[i] else np.ones(masks.shape[0]))
        features, opt_state, loss = trainer.train_step(
            features, opt_state, cam.to(dev),
            torch.from_numpy(masks.astype(bool)).to(dev),
            torch.from_numpy(np.asarray(scales, np.float32)).to(dev), 1.0,
            H, W, generator=generator)
        losses[step] = loss
        if step % 100 == 0:
            print(f"step {step}: loss {float(loss):.4f}")
    np.save(os.path.join(args.output, "scene_features.npy"),
            features.cpu().numpy())
    print("saved features to", args.output)
    return features, {k: float(v) for k, v in losses.items()}


if __name__ == "__main__":
    main()
