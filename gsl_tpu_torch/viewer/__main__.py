"""``python -m gsl_tpu_torch.viewer <model_path>``: serve a trained run or
PLY over HTTP, the port's counterpart of the repo-root ``viewer.py``.
Renders on cuda unless ``--device cpu`` is given; ``--port 0`` binds a
free port and prints it."""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser("gsl_tpu_torch.viewer")
    ap.add_argument("model_path")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--background_color", nargs=3, type=float,
                    default=(0.0, 0.0, 0.0))
    ap.add_argument("--image_size", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch "
                         "versions of the kernels")
    args = ap.parse_args(argv)

    from gsl_tpu_torch.viewer.viewer import Viewer
    Viewer(args.model_path, host=args.host, port=args.port,
           background=tuple(args.background_color),
           image_size=args.image_size, device=args.device).start()


if __name__ == "__main__":
    main()
