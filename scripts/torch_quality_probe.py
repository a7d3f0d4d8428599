"""The quality protocol's full run up to its last densify, with the
port's arithmetic changed where the JAX package's TPU run computed
otherwise: how far each change moves the final Gaussian count.

    python3 scripts/torch_quality_probe.py [--variants exact ...]
        [--steps 15000] [--seed 42] [--workdir DIR] [--out DIR]
    python3 scripts/torch_quality_probe.py --one VARIANT [...]

`gsl_tpu_torch.tools.quality_benchmark`'s full run (30,000 steps,
densify every 100 in (500, 15000), opacity reset every 3000) stops
densifying at step 15,000, so the count there is its final count; each
variant runs that far (``--steps``), all variants at once, one process
each, on one card (``--one`` runs one variant in this process; the views
must be there). The teacher views (64 at 512^2) are rendered once into
``--workdir`` (default ``gsl_tpu_torch_probe`` in the temporary
directory) first, checked against their manifest as the tool checks them.
Variants:

- ``exact``: the port as it is;
- ``tpu_ssim``: the training loss's SSIM computed as
  ``gsl_tpu/ops/ssim.py``'s ``fast=True`` path, which its ``train_loss``
  always takes, runs on a TPU: each of the two blur passes a matrix
  product whose image operand the matrix unit rounds to bfloat16 at
  default precision, the cotangent likewise in the backward (the band
  itself is taken exact here: gsl_tpu splits it into two bfloat16 parts,
  good to ~2^-17, far below the operand's 2^-9), then the fast path's
  clamps (variances >= 0, |sigma12| <= sqrt(sigma1^2 sigma2^2) + 1e-6
  with the bound outside the gradient, the mean capped at 1); rounding
  to nearest even, as XLA converts float32 to bfloat16;
- ``tpu_ssim_trunc``: the same with the operands truncated to bfloat16;
- ``tpu_clamps``: the fast path's clamps and cap alone, its blurs exact
  float32 (no rounding);
- ``fast_rows``: the rasterizer's per-slot gradient rows rounded to
  bfloat16 before the per-Gaussian sum (K4), as the JAX package's fast
  mode packs them through its sort (``rasterize_pallas.py:1457-1478``);
- ``fast_payload``: the forward and backward kernels (K2, K3) fed
  conics, opacities and colours rounded to bfloat16, as the fast mode's
  payloads ride its sort (``rasterize_pallas.py:389-400``; the means stay
  float32 here);
- ``a+b``: several at once, e.g. ``tpu_ssim+fast_rows``.

``variant@seed`` runs a variant with another seed (``exact@43``: the
spread between two seeds of the same code). Each variant prints its
count every 500 steps and writes ``<out>/probe_<variant>.json`` (the
counts, every densify's clone, split and prune counts, and the val PSNR
and SSIM at its last step).
"""
import argparse
import csv
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from gsl_tpu_torch.ops import rasterize as R  # noqa: E402
from gsl_tpu_torch.ops import ssim as S  # noqa: E402
from gsl_tpu_torch.tools import quality_benchmark as Q  # noqa: E402
from gsl_tpu_torch.training import metrics as M  # noqa: E402
from gsl_tpu_torch.training.fit import fit  # noqa: E402

VARIANTS = ("exact", "tpu_ssim", "tpu_ssim_trunc", "fast_rows",
            "tpu_ssim+fast_rows")
SSIM_ROUNDING = {"tpu_ssim": "nearest", "tpu_ssim_trunc": "trunc",
                 "tpu_clamps": None}


def to_bf16(x, trunc=False):
    """x rounded to bfloat16 (to nearest, or toward zero), as float32."""
    if trunc:
        return (x.contiguous().view(torch.int32) & -65536).view(
            torch.float32)
    return x.bfloat16().float()


def rounding(mode):
    """-> (round the value, round the cotangent): identity the other way;
    `mode` "nearest", "trunc", or None for no rounding."""
    if mode is None:
        return (lambda x: x), (lambda x: x)
    trunc = mode == "trunc"

    class Value(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return to_bf16(x, trunc)

        @staticmethod
        def backward(ctx, g):
            return g

    class Cotangent(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return to_bf16(g, trunc)

    return Value.apply, Cotangent.apply


def tpu_ssim(mode):
    """`gsl_tpu/ops/ssim.py::ssim(fast=True)` as a TPU computes it, its
    blur operands rounded to bfloat16 by `rounding(mode)`."""
    value, cotangent = rounding(mode)

    def blur(img, win):
        # along W, then along H, each one matrix product of the rounded
        # operand with the band
        c, size = img.shape[0], win.shape[0]
        pad = size // 2
        x = torch.nn.functional.conv2d(
            value(img)[None], win.reshape(1, 1, 1, size).expand(
                c, 1, 1, size), padding=(0, pad), groups=c)
        x = cotangent(x)
        x = torch.nn.functional.conv2d(
            value(x), win.reshape(1, 1, size, 1).expand(c, 1, size, 1),
            padding=(pad, 0), groups=c)
        return cotangent(x)[0]

    def ssim(img1, img2, window_size=11, sigma=1.5):
        win = S._gaussian_window(window_size, sigma, img1)
        with S.float32_math():
            mu1, mu2 = blur(img1, win), blur(img2, win)
            mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
            s1 = torch.clamp(blur(img1 * img1, win) - mu1_sq, min=0.0)
            s2 = torch.clamp(blur(img2 * img2, win) - mu2_sq, min=0.0)
            bound = torch.sqrt(s1 * s2).detach() + 1e-6
            s12 = torch.maximum(torch.minimum(
                blur(img1 * img2, win) - mu12, bound), -bound)
        m = (((2.0 * mu12 + S._C1) * (2.0 * s12 + S._C2))
             / ((mu1_sq + mu2_sq + S._C1) * (s1 + s2 + S._C2))).mean()
        return torch.where(m > 1.0, torch.ones_like(m), m)

    return ssim


class Replacement:
    """`call` in place of the kernel wrapper `kernel`. Its launch count is
    the kernel's: the wrapper adds to it through its module's name, which
    now means this object, and the fit reads it there."""

    def __init__(self, kernel, call):
        self.kernel, self.call = kernel, call

    def __call__(self, *args, **kwargs):
        return self.call(*args, **kwargs)

    launches = property(lambda self: self.kernel.launches,
                        lambda self, n: setattr(self.kernel, "launches", n))


def rounded_rows(bwd):
    return Replacement(bwd, lambda *a, **k: to_bf16(bwd(*a, **k)))


def rounded_payload(kernel):
    """The kernel fed conics, opacities and channels rounded to bfloat16
    (the means stay float32)."""
    def call(means2d, conics, opacities, channels, *rest, **k):
        return kernel(means2d, to_bf16(conics), to_bf16(opacities),
                      to_bf16(channels), *rest, **k)
    return Replacement(kernel, call)


def apply_variant(variant):
    """Patch the port for `variant` (its name, without the seed)."""
    for part in variant.split("+"):
        if part == "exact":
            continue
        if part in SSIM_ROUNDING:
            # the training loss's SSIM only: validation keeps the exact one
            M.ssim = tpu_ssim(SSIM_ROUNDING[part])
        elif part == "fast_rows":
            R.rasterize_bwd = rounded_rows(R.rasterize_bwd)
        elif part == "fast_payload":
            R.rasterize_fwd = rounded_payload(R.rasterize_fwd)
            R.rasterize_bwd = rounded_payload(R.rasterize_bwd)
        else:
            raise SystemExit(f"unknown variant {part}")


def run_variant(name, args):
    """`name`: a variant, or ``variant@seed`` for another seed."""
    variant, _, seed = name.partition("@")
    seed = int(seed) if seed else args.seed
    apply_variant(variant)
    qargs = Q.parse_args(["--workdir", args.workdir])
    outputs = Q.build_outputs(qargs, qargs.res)
    trainer = Q.protocol_trainer(30000)
    work = os.path.join(args.workdir, "probe_" + name)
    cfg = Q.protocol_fit_config(30000, work, seed)
    cfg.max_steps, cfg.save_iterations, cfg.resume = args.steps, (), "never"
    t0 = time.time()
    _, results = fit(trainer, outputs, cfg, device="cuda")
    with open(os.path.join(work, "train_log.csv")) as f:
        counts = {int(r[0]): int(r[2]) for r in list(csv.reader(f))[1:]}
    with open(os.path.join(work, "fit_timing.json")) as f:
        densify = json.load(f)["densify"]
    rec = {"variant": variant, "seed": seed, "steps": args.steps,
           "final": counts[args.steps], "counts": counts,
           "densify": densify, "psnr": results["psnr"],
           "ssim": results["ssim"], "seconds": time.time() - t0}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"probe_{name}.json"), "w") as f:
        json.dump(rec, f)
    print(f"[{name}] final {rec['final']} at {args.steps}; counts "
          f"{counts}; val PSNR {rec['psnr']:.3f} SSIM {rec['ssim']:.4f}; "
          f"{rec['seconds']:.0f} s", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    ap.add_argument("--steps", type=int, default=15000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "gsl_tpu_torch_probe"))
    ap.add_argument("--out", default="outputs/probe")
    ap.add_argument("--one", default=None, metavar="VARIANT",
                    help="run this one variant in this process")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.one:
        torch.set_num_threads(1)
        return run_variant(args.one, args)
    print(Q.card_name("cuda"), flush=True)
    Q.build_outputs(Q.parse_args(["--workdir", args.workdir]), 512)
    base = [sys.executable, os.path.abspath(__file__), "--steps",
            str(args.steps), "--seed", str(args.seed), "--workdir",
            args.workdir, "--out", args.out, "--one"]
    procs = [subprocess.Popen(base + [v]) for v in args.variants]
    codes = [p.wait() for p in procs]
    if any(codes):
        sys.exit(f"variants failed: {dict(zip(args.variants, codes))}")


if __name__ == "__main__":
    main()
