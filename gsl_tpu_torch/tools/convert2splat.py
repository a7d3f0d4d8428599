"""Convert a Gaussian PLY or a trained run to the antimatter15 ``.splat``
format.

    python -m gsl_tpu_torch.tools.convert2splat <in.ply | run dir>
        <out.splat> [--device cpu]

Port of ``tools/convert2splat.py``: 32 bytes per Gaussian, position 3 x
f32, activated scale 3 x f32, colour 4 x u8 (SH DC through C0, then the
sigmoid of the opacity), rotation 4 x u8 (the normalised quaternion mapped
from [-1, 1] to [0, 255]), sorted by descending sigmoid(opacity) x the
product of the scales, which web splat viewers expect. The conversion is
the JAX tool's numpy code on the host, so both write the same bytes; a run
is loaded on `--device` (cuda by default) and its alive rows copied once.
"""
import argparse

import numpy as np

SH_C0 = 0.28209479177387814


def state_to_splat_bytes(means, scales_log, rotations, opacities_raw,
                         shs_dc) -> bytes:
    n = means.shape[0]
    scales = np.exp(scales_log)
    opac = 1.0 / (1.0 + np.exp(-opacities_raw.reshape(n)))
    rgb = np.clip(shs_dc.reshape(n, -1)[:, :3] * SH_C0 + 0.5, 0.0, 1.0)
    q = rotations / np.maximum(
        np.linalg.norm(rotations, axis=-1, keepdims=True), 1e-12)

    importance = opac * scales.prod(axis=-1)
    order = np.argsort(-importance)

    buf = np.zeros((n, 32), np.uint8)
    buf[:, 0:12] = means[order].astype(np.float32).view(np.uint8).reshape(
        n, 12)
    buf[:, 12:24] = scales[order].astype(np.float32).view(
        np.uint8).reshape(n, 12)
    buf[:, 24:27] = (rgb[order] * 255).astype(np.uint8)
    buf[:, 27] = (opac[order] * 255).astype(np.uint8)
    buf[:, 28:32] = np.clip(q[order] * 128 + 128, 0, 255).astype(np.uint8)
    return buf.tobytes()


def main(argv=None):
    ap = argparse.ArgumentParser("gsl_tpu_torch.tools.convert2splat")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.input.endswith(".ply"):
        from ..utils.ply import load_gaussian_ply
        raw = load_gaussian_ply(args.input)
    else:
        from ..utils.gaussian_model_loader import GaussianModelLoader
        state, _, _ = GaussianModelLoader.load(args.input, args.device)
        p = state.params
        raw = {k: getattr(p, k)[state.alive].cpu().numpy()
               for k in ("means", "scales", "rotations", "opacities",
                         "shs_dc")}

    data = state_to_splat_bytes(raw["means"], raw["scales"],
                                raw["rotations"], raw["opacities"],
                                raw["shs_dc"])
    with open(args.output, "wb") as f:
        f.write(data)
    print(f"wrote {args.output} ({len(data) // 32} gaussians, "
          f"{len(data)} bytes)")


if __name__ == "__main__":
    main()
