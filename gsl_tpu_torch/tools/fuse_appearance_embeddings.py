"""Bake an appearance run's per-image colour offsets into plain SH DC
coefficients, so a plain SH renderer shows the scene's average
appearance without the network.

    python -m gsl_tpu_torch.tools.fuse_appearance_embeddings <run dir>
        [--n-average-cameras 32] [--max-cameras 64] [--output fused.ply]
        [--device cpu]

Port of ``tools/fuse_appearance_embeddings.py``: the run is rebuilt from
its ``config.yaml`` snapshot and newest checkpoint; each Gaussian's blend
weight in up to `max-cameras` train views (evenly spaced) is the gradient
of the image sum with respect to a colour bias (``training/light_gaussian``);
its `n-average-cameras` views of largest weight, weighted by their share,
average the network's rgb offsets, which are added to ``shs_dc`` (offset /
C0). Runs on `--device` (cuda by default); writes the alive rows to
``<run>/fused.ply`` unless ``--output`` is given.
"""
import argparse
import dataclasses
import os

import numpy as np
import torch
from torch.func import functional_call

C0 = 0.28209479177387814


def main(argv=None):
    ap = argparse.ArgumentParser(
        "gsl_tpu_torch.tools.fuse_appearance_embeddings")
    ap.add_argument("run_dir")
    ap.add_argument("--n-average-cameras", type=int, default=32)
    ap.add_argument("--max-cameras", type=int, default=64,
                    help="visibility-score sample size over train cameras")
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..cli import build_components, load_config
    from ..training.appearance_trainer import AppearanceTrainer
    from ..training.fit import _round_capacity, setup_state
    from ..training.light_gaussian import bias_gradients, bias_render
    from ..utils.checkpoint import find_latest_checkpoint, load_checkpoint
    from ..utils.device import resolve_device
    from ..utils.ply import save_state_ply

    dev = resolve_device(args.device)
    cfg = load_config([os.path.join(args.run_dir, "config.yaml")], {})
    trainer, dataparser_cfg, fit_cfg = build_components(cfg)
    if not isinstance(trainer, AppearanceTrainer):
        raise SystemExit(f"{args.run_dir} was not trained with an "
                         "appearance preset")
    outputs = dataparser_cfg.instantiate().get_outputs()
    ckpt = find_latest_checkpoint(os.path.join(args.run_dir, "checkpoints"))
    if ckpt is None:
        raise SystemExit(f"no checkpoint under {args.run_dir}")
    pc = outputs.point_cloud
    capacity = _round_capacity(max(
        int(pc.xyz.shape[0] * fit_cfg.capacity_multiplier),
        fit_cfg.min_capacity))
    state = load_checkpoint(ckpt, setup_state(
        trainer, outputs,
        trainer.model.init_from_pcd(pc.xyz, pc.rgb, capacity, dev)))

    gstate = state.gaussians
    net_params = state.extra["__net__"]["params"]
    bg = torch.zeros(3, dtype=torch.float32, device=dev)
    sh_degree = trainer.model.sh_degree
    cams = outputs.train_set.cameras
    n_cams = min(args.max_cameras, len(outputs.train_set))
    sel = np.linspace(0, len(outputs.train_set) - 1, n_cams).astype(int)

    print(f"scoring {n_cams} cameras...")
    render = bias_render(trainer.renderer, sh_degree, bg)
    scores = torch.stack([
        bias_gradients(render, gstate, cams[int(i)].to(dev))[0][0]
        for i in sel], dim=1)                            # [CAP, n_cams]

    # each Gaussian's top-K cameras, weighted by their share of its score
    k = min(args.n_average_cameras, n_cams)
    keep = torch.zeros_like(scores, dtype=torch.bool).scatter_(
        1, torch.topk(scores, k, dim=1).indices, True)
    w = torch.where(keep, scores, torch.zeros_like(scores))
    w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-12)

    print("fusing offsets...")
    offset = torch.zeros((gstate.capacity, 3), dtype=torch.float32,
                         device=dev)
    feats = gstate.params.appearance_features
    with torch.no_grad():
        for j, i in enumerate(sel):
            if not bool((w[:, j] > 0).any()):
                continue
            cam = cams[int(i)].to(dev)
            viewdirs = gstate.get_means() - cam.camera_center
            viewdirs = viewdirs / torch.clamp(
                torch.linalg.norm(viewdirs, dim=-1, keepdim=True), min=1e-12)
            pred = functional_call(trainer.net, net_params,
                                   (feats, cam.appearance_id, viewdirs))
            offset += w[:, j:j + 1] * (pred[:, :3] * 2.0 - 1.0)

    shs_dc = gstate.params.shs_dc.clone()
    shs_dc[:, 0, :] += offset / C0
    fused = dataclasses.replace(gstate, params=dataclasses.replace(
        gstate.params, shs_dc=shs_dc))
    out = args.output or os.path.join(args.run_dir, "fused.ply")
    n = save_state_ply(out, fused)
    print(f"wrote {n} fused gaussians to {out}")
    return out


if __name__ == "__main__":
    main()
