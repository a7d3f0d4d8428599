"""Flag mis-registered cameras of a COLMAP model.

    python -m gsl_tpu_torch.tools.sfm_outlier_detection <scene> \\
        [--min-point-fraction 0.02] [--position-mads 8] \\
        [--gps-priors poses.json --gps-threshold 3]

Port of ``tools/sfm_outlier_detection.py`` (numpy on the host; no device).
An image is flagged when:

1. its frustum sees fewer sparse points than `--min-point-fraction` of
   the median image's (point support);
2. its camera centre lies more than `--position-mads` median absolute
   deviations from the median centre on some axis;
3. with `--gps-priors` ({image name: [x, y, z]} in any metric frame, for
   three images or more), its residual after the least-squares similarity
   transform from camera centres to priors (Umeyama) exceeds
   `--gps-threshold` times the median residual.

The names go to ``<scene>/sfm_outliers.txt``, one a line, sorted.
"""
import argparse
import json
import os

import numpy as np


def umeyama(src, dst):
    """Least-squares similarity transform src -> dst ([N, 3] each):
    (s, R, t) with dst ~ s R src + t."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var = (sc ** 2).sum() / len(src)
    s = np.trace(np.diag(D) @ S) / max(var, 1e-12)
    t = mu_d - s * R @ mu_s
    return s, R, t


def main(argv=None):
    ap = argparse.ArgumentParser("gsl_tpu_torch.tools.sfm_outlier_detection")
    ap.add_argument("path")
    ap.add_argument("--min-point-fraction", type=float, default=0.02,
                    help="flag images seeing under this fraction of the "
                         "median in-frustum point count")
    ap.add_argument("--position-mads", type=float, default=8.0)
    ap.add_argument("--gps-priors", default=None)
    ap.add_argument("--gps-threshold", type=float, default=3.0,
                    help="x median residual")
    args = ap.parse_args(argv)

    from ..data.colmap_io import qvec_to_rotmat, read_model

    sparse = None
    for cand in ("sparse/0", "sparse"):
        if os.path.isdir(os.path.join(args.path, cand)):
            sparse = os.path.join(args.path, cand)
            break
    if sparse is None:
        raise SystemExit(f"no COLMAP sparse model under {args.path}")
    model = read_model(sparse)
    xyz = model.points_xyz

    names, centers, support = [], [], []
    for im in model.images.values():
        R = qvec_to_rotmat(im.qvec)
        t = im.tvec
        cam = model.cameras[im.camera_id]
        p_cam = xyz @ R.T + t
        z = p_cam[:, 2]
        ok = z > 0.01
        u = cam.fx * p_cam[ok, 0] / z[ok] + cam.cx
        v = cam.fy * p_cam[ok, 1] / z[ok] + cam.cy
        inb = ((u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height))
        names.append(im.name)
        centers.append(-R.T @ t)
        support.append(int(inb.sum()))
    centers = np.stack(centers)
    support = np.asarray(support, np.float64)

    outliers = {}

    med_support = max(np.median(support), 1.0)
    for n, s in zip(names, support):
        if s < args.min_point_fraction * med_support:
            outliers.setdefault(n, []).append(
                f"point support {int(s)} << median {int(med_support)}")

    med = np.median(centers, axis=0)
    mad = np.median(np.abs(centers - med), axis=0) + 1e-9
    dev = np.max(np.abs(centers - med) / mad, axis=-1)
    for n, d in zip(names, dev):
        if d > args.position_mads:
            outliers.setdefault(n, []).append(
                f"position {d:.1f} MADs from cluster")

    if args.gps_priors:
        with open(args.gps_priors) as f:
            priors = json.load(f)
        both = [i for i, n in enumerate(names) if n in priors]
        if len(both) >= 3:
            gps = np.asarray([priors[names[i]] for i in both], np.float64)
            s_, R_, t_ = umeyama(centers[both], gps)
            resid = np.linalg.norm(
                (s_ * centers[both] @ R_.T + t_) - gps, axis=-1)
            thr = args.gps_threshold * max(np.median(resid), 1e-9)
            for i, r in zip(both, resid):
                if r > thr:
                    outliers.setdefault(names[i], []).append(
                        f"gps residual {r:.2f} > {thr:.2f}")

    out = os.path.join(args.path, "sfm_outliers.txt")
    with open(out, "w") as f:
        for n in sorted(outliers):
            f.write(n + "\n")
    for n in sorted(outliers):
        print(f"{n}: " + "; ".join(outliers[n]))
    print(f"{len(outliers)}/{len(names)} flagged -> {out}")
    return sorted(outliers)


if __name__ == "__main__":
    main()
