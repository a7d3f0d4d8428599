"""A triangle mesh from a fitted 2DGS (surfel) run, by TSDF fusion.

    python -m gsl_tpu_torch.tools.gs2d_mesh_extraction <run_dir>
        [--resolution 256] [--voxel-size V] [--sdf-trunc S]
        [--depth-trunc D] [--alpha-thres 0.5] [--split train]
        [--expected-depth] [--output mesh.ply] [--device cpu]

Port of ``tools/gs2d_mesh_extraction.py``. The run's ``config.yaml``
snapshot gives the scene; the run's newest checkpoint (or PLY) is loaded
by `GaussianModelLoader` and each view of the split is rendered by the
`SurfelRenderer` (median depth, or expected depth with
`--expected-depth`), then fused into a `TSDFVolume` over the cameras'
bounding sphere: centred on the mean camera centre, its radius the
farthest centre's distance; by default the voxel is 2 x radius /
resolution, the truncation 5 voxels and the depth cut 2 x radius. The
surface comes out by marching tetrahedra and is written as a binary PLY
(``<run_dir>/mesh.ply`` by default). Runs on cuda unless ``--device cpu``
is given.
"""
import argparse
import os
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir")
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--voxel-size", type=float, default=None)
    ap.add_argument("--sdf-trunc", type=float, default=None)
    ap.add_argument("--depth-trunc", type=float, default=None)
    ap.add_argument("--alpha-thres", type=float, default=0.5)
    ap.add_argument("--split", default="train")
    ap.add_argument("--expected-depth", action="store_true",
                    help="use expected depth instead of median depth")
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch "
                         "versions of the kernels")
    args = ap.parse_args(argv)

    from ..cli import build_components, load_config
    from ..data.dataparsers.dataparser import camera_centers
    from ..renderers.surfel_renderer import SurfelRendererConfig
    from ..utils.device import resolve_device
    from ..utils.gaussian_model_loader import GaussianModelLoader
    from ..utils.mesh import TSDFVolume, save_mesh_ply

    dev = resolve_device(args.device)
    cfg = load_config([os.path.join(args.run_dir, "config.yaml")], {})
    _, dataparser_cfg, _ = build_components(cfg)
    outputs = dataparser_cfg.instantiate().get_outputs()
    image_set = (outputs.train_set if args.split == "train"
                 else outputs.val_set)

    state, _, sh_degree = GaussianModelLoader.load(args.run_dir, dev)
    renderer = SurfelRendererConfig(
        depth_ratio=0.0 if args.expected_depth else 1.0).instantiate()
    bg = torch.zeros(3, dtype=torch.float32, device=dev)

    centers = camera_centers(image_set.cameras)
    focus = centers.mean(0)
    radius = float(np.linalg.norm(centers - focus, axis=-1).max())
    depth_trunc = args.depth_trunc or 2.0 * radius
    voxel_size = args.voxel_size or (2.0 * radius / args.resolution)
    sdf_trunc = args.sdf_trunc or 5.0 * voxel_size
    print(f"radius={radius:.3f} voxel={voxel_size:.4f} "
          f"sdf_trunc={sdf_trunc:.4f} depth_trunc={depth_trunc:.3f}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    vol = TSDFVolume(origin=focus - radius,
                     resolution=(args.resolution,) * 3,
                     voxel_size=voxel_size, sdf_trunc=sdf_trunc, device=dev)
    render_ms, integrate_ms = [], []
    for i in range(len(image_set)):
        cam = image_set.cameras[i].to(dev)
        H, W = int(cam.height), int(cam.width)
        sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = renderer.forward(state, cam, H, W, bg, sh_degree)
        sync()
        t1 = time.perf_counter()
        vol.integrate(out.surf_depth, cam.world_to_camera, cam.get_K(),
                      alpha=out.alpha, depth_trunc=depth_trunc,
                      alpha_thres=args.alpha_thres)
        sync()
        render_ms.append((t1 - t0) * 1e3)
        integrate_ms.append((time.perf_counter() - t1) * 1e3)
        if (i + 1) % 20 == 0:
            print(f"integrated {i + 1}/{len(image_set)}")

    t0 = time.perf_counter()
    verts, faces = vol.extract_mesh()
    sync()
    extract_ms = (time.perf_counter() - t0) * 1e3
    out_path = args.output or os.path.join(args.run_dir, "mesh.ply")
    save_mesh_ply(out_path, verts, faces)
    print(f"wrote {out_path}: {len(verts)} verts, {len(faces)} faces; ms "
          f"per view: render {np.median(render_ms):.2f}, integrate "
          f"{np.median(integrate_ms):.2f} (medians of {len(render_ms)}); "
          f"extract {extract_ms:.2f}")
    return {"path": out_path, "verts": verts, "faces": faces,
            "render_ms": render_ms, "integrate_ms": integrate_ms,
            "extract_ms": extract_ms}


if __name__ == "__main__":
    main()
