"""Per-image scale and offset that align estimated inverse-depth maps to a
COLMAP reconstruction.

    python -m gsl_tpu_torch.tools.get_depth_scales <dataset>
        [--depth-dir estimated_depths] [--min-points 10] [--device cpu]

Port of ``tools/get_depth_scales.py``. For each image with a map
`<dataset>/<depth-dir>/<stem>.npy`, the SfM points in front of its camera
are projected into the map, and `1/z ~ a * d + b` is solved by least
squares over the samples; the 20% with the largest residuals (points
occluded in this view: the model keeps no tracks) are dropped and the
solve is repeated. Writes `<dataset>/estimated_depth_scales.json`
({image name: {"scale": a, "offset": b}}), which the EstimatedDepthColmap
dataparser reads. Runs in float64 on the card unless `--device cpu` is
given.
"""
import argparse
import json
import os

import numpy as np
import torch

from ..data.colmap_io import qvec_to_rotmat, read_model
from ..utils.device import resolve_device


def _lstsq(A, y):
    return torch.linalg.lstsq(A, y[:, None]).solution[:, 0]


def solve_scale(xyz, R, t, cam, d_est, min_points):
    """-> (a, b) for one image, or None with fewer than `min_points` SfM
    points inside its map. `xyz` [N, 3], `R`, `t` and the map are float64
    tensors on one device; `cam` is the image's ColmapCamera."""
    p_cam = xyz @ R.T + t
    z = p_cam[:, 2]
    ok = z > 0.01
    p_cam, z = p_cam[ok], z[ok]
    u = float(cam.fx) * p_cam[:, 0] / z + float(cam.cx)
    v = float(cam.fy) * p_cam[:, 1] / z + float(cam.cy)
    H, W = d_est.shape[:2]
    ui = torch.round(u * (W / cam.width)).long()
    vi = torch.round(v * (H / cam.height)).long()
    inb = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    if int(inb.sum()) < min_points:
        return None
    d = d_est[vi[inb], ui[inb]]
    inv_z = 1.0 / z[inb]
    A = torch.stack([d, torch.ones_like(d)], 1)
    ab = _lstsq(A, inv_z)
    resid = torch.abs(A @ ab - inv_z)
    keep = resid <= torch.quantile(resid, 0.8)
    if int(keep.sum()) >= min_points:
        ab = _lstsq(A[keep], inv_z[keep])
    return float(ab[0]), float(ab[1])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--depth-dir", default="estimated_depths")
    ap.add_argument("--min-points", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    sparse = None
    for cand in ("sparse/0", "sparse"):
        if os.path.isdir(os.path.join(args.path, cand)):
            sparse = os.path.join(args.path, cand)
            break
    if sparse is None:
        raise SystemExit(f"no COLMAP sparse model under {args.path}")
    model = read_model(sparse)

    def f64(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=dev)

    xyz = f64(model.points_xyz)
    scales = {}
    for im in model.images.values():
        stem = im.name[:im.name.rfind(".")] if "." in im.name else im.name
        dpath = os.path.join(args.path, args.depth_dir, stem + ".npy")
        if not os.path.isfile(dpath):
            continue
        ab = solve_scale(xyz, f64(qvec_to_rotmat(im.qvec)), f64(im.tvec),
                         model.cameras[im.camera_id], f64(np.load(dpath)),
                         args.min_points)
        if ab is not None:
            scales[im.name] = {"scale": ab[0], "offset": ab[1]}

    out = os.path.join(args.path, "estimated_depth_scales.json")
    with open(out, "w") as f:
        json.dump(scales, f, indent=2)
    print(f"wrote {out}: {len(scales)} images")
    return scales


if __name__ == "__main__":
    main()
