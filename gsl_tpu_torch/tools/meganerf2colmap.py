"""Convert a Mega-NeRF capture (rubble, building) into a COLMAP model.

    python -m gsl_tpu_torch.tools.meganerf2colmap <dataset> [--out colmap] \\
        [--down-sample N] [--seed-points 100000]

Port of ``tools/meganerf2colmap.py`` (numpy on the host; no device). It
reads ``<dataset>/coordinates.pt`` (``pose_scale_factor``,
``origin_drb``) and ``<dataset>/{train,val}/metadata/*.pt`` (``c2w``
[3, 4], ``intrinsics`` [fx, fy, cx, cy], ``W``, ``H``) with
``torch.load``, turns each pose from Mega-NeRF's convention (RDF camera
axes in a DRB world, scaled and shifted) into COLMAP's (RDF in an RDF
world), and writes the known poses and intrinsics as
``<dataset>/<out>/sparse/0/{cameras,images,points3D}.bin`` (one PINHOLE
camera per distinct intrinsics and size) by
``data/colmap_io.write_model_bin``, with ``images/`` symlinks to the
``rgbs/`` files. There is no matching or triangulation: the sparse cloud
is `--seed-points` uniform points over the camera centres' box enlarged
by 20% a side, from ``RandomState(0)``.
"""
import argparse
import os

import numpy as np

from ..data.colmap_io import (ColmapCamera, ColmapImage, ColmapModel,
                              rotmat_to_qvec, write_model_bin)

# Mega-NeRF's camera axes are RDF stored in a DRB world; COLMAP wants RDF
# in an RDF world
C2W_TRANSFORM = np.array([[0, -1, 0, 0],
                          [1, 0, 0, 0],
                          [0, 0, 1, 0],
                          [0, 0, 0, 1]], np.float64).T
RDF_TO_DRB = np.array([[0, 1, 0, 0],
                       [1, 0, 0, 0],
                       [0, 0, -1, 0],
                       [0, 0, 0, 1]], np.float64)


def convert_pose(c2w34, pose_scale_factor, origin_drb):
    """Mega-NeRF's c2w [3, 4] -> (COLMAP qvec, tvec, camera centre)."""
    c2w = np.eye(4)
    c2w[:3, :] = np.asarray(c2w34, np.float64)
    c2w[:3, 3] *= pose_scale_factor
    c2w[:3, 3] += np.asarray(origin_drb, np.float64)
    c2w = np.linalg.inv(RDF_TO_DRB) @ c2w @ C2W_TRANSFORM @ RDF_TO_DRB
    w2c = np.linalg.inv(c2w)
    return rotmat_to_qvec(w2c[:3, :3]), w2c[:3, 3], c2w[:3, 3]


def main(argv=None):
    ap = argparse.ArgumentParser("gsl_tpu_torch.tools.meganerf2colmap")
    ap.add_argument("path")
    ap.add_argument("--out", default="colmap",
                    help="output dir (under <path>)")
    ap.add_argument("--down-sample", type=int, default=None)
    ap.add_argument("--seed-points", type=int, default=100_000,
                    help="random seed points inside the camera volume")
    args = ap.parse_args(argv)

    import torch
    coords = torch.load(os.path.join(args.path, "coordinates.pt"),
                        map_location="cpu")
    scale = float(coords["pose_scale_factor"])
    origin = np.asarray(coords["origin_drb"], np.float64)

    colmap_dir = os.path.join(args.path, args.out)
    if args.down_sample:
        colmap_dir += f"_{args.down_sample}"
    sparse_dir = os.path.join(colmap_dir, "sparse", "0")
    image_dir = os.path.join(colmap_dir, "images")
    os.makedirs(sparse_dir, exist_ok=True)
    os.makedirs(image_dir, exist_ok=True)

    cameras, images = {}, {}
    intr_to_cam = {}
    centers = []
    image_id = 0
    for split in ("train", "val"):
        meta_dir = os.path.join(args.path, split, "metadata")
        if not os.path.isdir(meta_dir):
            continue
        for name in sorted(os.listdir(meta_dir)):
            if not name.endswith(".pt"):
                continue
            md = torch.load(os.path.join(meta_dir, name),
                            map_location="cpu")
            W, H = int(md["W"]), int(md["H"])
            intr = np.asarray(md["intrinsics"], np.float64)
            if args.down_sample:
                W //= args.down_sample
                H //= args.down_sample
                intr = intr / args.down_sample
            key = (round(intr[0], 4), round(intr[1], 4),
                   round(intr[2], 4), round(intr[3], 4), W, H)
            cam_id = intr_to_cam.setdefault(key, len(intr_to_cam) + 1)
            if cam_id not in cameras:
                cameras[cam_id] = ColmapCamera(
                    camera_id=cam_id, model="PINHOLE", width=W, height=H,
                    params=intr)
            qvec, tvec, center = convert_pose(md["c2w"], scale, origin)
            centers.append(center)
            image_id += 1
            img_name = name[:-3] + ".jpg"
            rgb = os.path.join(args.path, split, "rgbs", img_name)
            if not os.path.exists(rgb):
                img_name = name[:-3] + ".png"
                rgb = os.path.join(args.path, split, "rgbs", img_name)
            images[image_id] = ColmapImage(
                image_id=image_id, qvec=qvec, tvec=tvec, camera_id=cam_id,
                name=img_name)
            link = os.path.join(image_dir, img_name)
            if os.path.exists(rgb) and not os.path.exists(link):
                os.symlink(os.path.relpath(rgb, image_dir), link)

    centers = np.stack(centers)
    lo, hi = centers.min(0), centers.max(0)
    span = np.maximum(hi - lo, 1e-3)
    rng = np.random.RandomState(0)
    xyz = rng.rand(args.seed_points, 3) * (span * 1.4) \
        + (lo - 0.2 * span)
    rgbs = (rng.rand(args.seed_points, 3) * 255).astype(np.uint8)
    model = ColmapModel(cameras=cameras, images=images,
                        points_xyz=xyz.astype(np.float64),
                        points_rgb=rgbs,
                        points_err=np.zeros(args.seed_points))
    write_model_bin(model, sparse_dir)
    print(f"wrote {len(images)} images / {len(cameras)} cameras / "
          f"{args.seed_points} seed points -> {sparse_dir}")
    return sparse_dir


if __name__ == "__main__":
    main()
