"""Build a coarser level of detail by pruning each trained partition.

    python -m gsl_tpu_torch.tools.prune_partitions runs/parts --dst lod1 \\
        [--src .] [--percent 0.6] [--mode blend|opacity] [--n-cameras 8] \\
        [--v-pow 0.1] [--device cpu]

Port of ``tools/prune_partitions.py``: LightGaussian's importance prune
applied to each partition. With ``--mode blend`` (the default) the
importance of a Gaussian is its blend weight summed over up to
`--n-cameras` of the partition's cameras, spread evenly over them: the
gradient of a per-Gaussian colour bias through the renderer
(``training/light_gaussian.accumulate_blend_weights``, K1-K4 on the
card). The cameras come from the run's ``config.yaml`` snapshot; without
a usable one the tool raises, naming it (gsl_tpu's falls back to
``--mode opacity`` silently). ``--mode opacity`` takes the opacity alone.
Either way v = importance * max_scale^v_pow, and the lowest `--percent`
of each partition's rows by v go.

Layout, which ``renderers/partition_lod.py`` reads (`--src` "." is
train_partitions' runs)::

    <dir>/partitions.npz
    <dir>/<src>/partition_NNN/...
    <dir>/<dst>/partition_NNN/point_cloud/iteration_1/point_cloud.ply
"""
import argparse
import os

import numpy as np
import torch

from ..utils.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser("gsl_tpu_torch.tools.prune_partitions")
    ap.add_argument("partitions_dir")
    ap.add_argument("--src", default=".")
    ap.add_argument("--dst", required=True)
    ap.add_argument("--percent", type=float, default=0.6)
    ap.add_argument("--mode", choices=["blend", "opacity"], default="blend")
    ap.add_argument("--n-cameras", type=int, default=8)
    ap.add_argument("--v-pow", type=float, default=0.1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from ..training.light_gaussian import (accumulate_blend_weights,
                                           bias_render, prune_by_importance)
    from ..utils.gaussian_model_loader import GaussianModelLoader
    from ..utils.partitioning import PartitionedScene
    from ..utils.ply import save_state_ply

    scene = PartitionedScene.load(
        os.path.join(args.partitions_dir, "partitions.npz"))

    cameras = None
    if args.mode == "blend":
        cameras = load_cameras(args.partitions_dir, args.src, scene)

    for pi in range(len(scene.partitions)):
        run = os.path.join(args.partitions_dir, args.src,
                           f"partition_{pi:03d}")
        if not os.path.isdir(run):
            continue
        try:
            state, renderer, sh_degree = GaussianModelLoader.load(run, dev)
        except FileNotFoundError:
            continue

        if args.mode == "blend":
            idxs = np.nonzero(scene.partitions[pi].camera_mask)[0]
            if idxs.size == 0:
                idxs = np.arange(len(cameras))
            sel = idxs[np.linspace(0, idxs.size - 1,
                                   min(args.n_cameras,
                                       idxs.size)).astype(int)]
            bg = torch.zeros(3, dtype=torch.float32, device=dev)
            imp = accumulate_blend_weights(
                bias_render(renderer, sh_degree, bg), state,
                [cameras[int(i)].to(dev) for i in sel])
        else:
            imp = (torch.sigmoid(state.params.opacities[:, 0])
                   * state.alive.to(torch.float32))

        pruned, _, n_pruned = prune_by_importance(
            state, None, imp, args.percent, v_pow=args.v_pow)
        kept = save_state_ply(os.path.join(
            args.partitions_dir, args.dst, f"partition_{pi:03d}",
            "point_cloud", "iteration_1", "point_cloud.ply"), pruned)
        print(f"partition {pi}: pruned {int(n_pruned)} -> {kept} kept")


def load_cameras(partitions_dir, src, scene):
    """The scene's training cameras, from the first partition run under
    `src` that has a ``config.yaml`` snapshot, without the snapshot's
    ``image_list`` (gsl_tpu keeps it, and so indexes the partition's own
    cameras with the scene's camera mask). Raises if there is no snapshot
    or it cannot be built."""
    from ..cli import build_components, load_config

    for pi in range(len(scene.partitions)):
        snap = os.path.join(partitions_dir, src, f"partition_{pi:03d}",
                            "config.yaml")
        if os.path.isfile(snap):
            try:
                cfg = load_config([snap], {})
                # the scene's cameras, which camera_mask indexes, not the
                # partition's own list that its fit trained on
                parser = cfg.get("data", {}).get("parser")
                if isinstance(parser, dict):
                    (parser.get("init_args") or {}).pop("image_list", None)
                _, dataparser_cfg, _ = build_components(cfg)
                outputs = dataparser_cfg.instantiate().get_outputs()
            except Exception as e:
                raise RuntimeError(
                    f"the config snapshot {snap} gives no cameras for "
                    f"--mode blend: {e!r}") from e
            return outputs.train_set.cameras
    raise FileNotFoundError(
        f"no config.yaml snapshot under {os.path.join(partitions_dir, src)}"
        "/partition_NNN: --mode blend needs the training cameras (use "
        "--mode opacity to prune without them)")


if __name__ == "__main__":
    main()
