"""Offline video / image-sequence rendering from a trained model.

    python -m gsl_tpu_torch.render <model_path> [--device cpu]
        [--size 512] [--n_frames 120] [--keyframes camera_path.json] ...

Port of the repo-root ``render.py``: renders an orbit path (or
interpolated keyframes) to PNG frames, plus an mp4 when imageio can write
one. Runs on cuda unless ``--device cpu`` is given.
"""
import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("model_path")
    ap.add_argument("--output", default=None)
    ap.add_argument("--n_frames", type=int, default=120)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--distance", type=float, default=6.0)
    ap.add_argument("--pitch", type=float, default=-15.0)
    ap.add_argument("--fps", type=int, default=30)
    ap.add_argument("--keyframes", default=None,
                    help="camera_path.json saved from the viewer's "
                         "camera-path panel (interpolated orbit keyframes)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch "
                         "versions of the kernels")
    args = ap.parse_args(argv)

    from PIL import Image

    from gsl_tpu_torch.utils.gaussian_model_loader import GaussianModelLoader
    from gsl_tpu_torch.viewer.camera_path import CameraPath, orbit_c2w
    from gsl_tpu_torch.viewer.renderer import ViewerRenderer

    state, renderer, sh_degree = GaussianModelLoader.load(
        args.model_path, device=args.device)
    vr = ViewerRenderer(state, renderer, sh_degree)
    target = state.params.means[state.alive].mean(0).cpu().numpy()

    out_dir = args.output or os.path.join(
        os.path.dirname(args.model_path.rstrip("/")) or ".", "video_frames")
    os.makedirs(out_dir, exist_ok=True)
    if args.keyframes:
        cp = CameraPath()
        with open(args.keyframes) as f:
            cp.keyframes = [tuple(k) for k in json.load(f)["keyframes"]]
        poses = cp.interpolate(args.n_frames)
    else:
        poses = [(360.0 * i / args.n_frames, args.pitch, args.distance)
                 for i in range(args.n_frames)]

    frames = []
    for i, (yaw, pitch, dist) in enumerate(poses):
        c2w = orbit_c2w(yaw, pitch, dist, target)
        img = vr.get_outputs(c2w, args.size, args.size)
        Image.fromarray(img).save(os.path.join(out_dir, f"{i:05d}.png"))
        frames.append(img)
        if i % 10 == 0:
            print(f"frame {i}/{args.n_frames}")

    try:
        import imageio.v2 as imageio

        mp4 = os.path.join(out_dir, "orbit.mp4")
        imageio.mimsave(mp4, frames, fps=args.fps)
        print("wrote", mp4)
    except (ImportError, ValueError, RuntimeError, OSError) as e:
        # imageio and its ffmpeg plugin are optional
        print(f"frames only (no mp4: {e})")
    print("frames in", out_dir)


if __name__ == "__main__":
    main()
