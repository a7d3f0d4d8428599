"""Merge Gaussian PLY files into one.

    python -m gsl_tpu_torch.tools.merge_ply <out.ply> <in1.ply> <in2.ply>
        [...] [--device cpu]

Port of ``tools/merge_ply.py``: the rows of every input in order; a file
of a lower SH degree is zero-padded to the most bands present. The files
are joined by ``MultipleGaussianModelEditor.merged`` on `--device` (cuda
by default), as the viewer's editor joins models.
"""
import argparse

from ..utils.convert import state_from_raw_arrays
from ..utils.gaussian_model_editor import MultipleGaussianModelEditor
from ..utils.ply import load_gaussian_ply


def main(argv=None):
    ap = argparse.ArgumentParser("gsl_tpu_torch.tools.merge_ply")
    ap.add_argument("output")
    ap.add_argument("inputs", nargs="+")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    editor = MultipleGaussianModelEditor([
        state_from_raw_arrays(load_gaussian_ply(p), args.device)
        for p in args.inputs])
    n = editor.save_ply(args.output)
    print(f"merged {len(args.inputs)} plys -> {args.output} ({n} "
          "gaussians)")


if __name__ == "__main__":
    main()
