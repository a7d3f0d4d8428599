"""Per-stage times of the tile rasterizer on the bench scene.

    python -m gsl_tpu_torch.tools.profile_stages [--device cuda|cpu]
        [--n 1000000] [--height 1088] [--width 1920] [--tile-size 16]
        [--iters 5]

Counterpart of ``tools/profile_stages.py``. The scene is
``__graft_entry__._synthetic_state``'s (numpy seed 0, SH degree 3, padded
with dead rows to the next power of two) seen from the bench pose (the
identity, fx = fy = 1600). The stages, each fed the previous ones'
outputs: ``project``, ``sh_colors``, ``isect_encode``, ``expand`` (kernel
K1), ``sort``, ``tile ranges``, ``raster_fwd`` (K2), ``raster_bwd`` (K3,
unit cotangents on every channel and alpha), ``reduce`` (K4), and the
whole rasterizer forward and backward through its autograd Function
(``e2e raster fwd+bwd``: the gradient of sum(image) + sum(alpha) in the
projected means, conics, opacities and colours), with the pixels per
second that gives.

On the card each stage is timed by CUDA events around ``--iters`` calls
after one warm-up; on the CPU (``--device cpu``) each stage runs its plain
version, timed by the host clock. The root tool's chained-bias scan and
its null floor serialise the calls of a remote TPU and measure the cost of
reaching it; a CUDA stream needs neither, so neither is ported.
``--chunk`` and ``--isect-cap`` are accepted and ignored: the kernels
take no slot chunk, and the slot buffers are sized per call.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..data.cameras import make_camera
from ..ops import rasterize as R
from ..ops.projection import project_gaussians
from ..ops.sh import sh_to_rgb
from ..utils.device import float32_math, resolve_device
from .mp_scaling_table import capacity_of, synthetic_arrays

STAGES = ("project", "sh_colors", "isect_encode", "expand", "sort",
          "tile ranges", "raster_fwd", "raster_bwd", "reduce")
E2E = "e2e raster fwd+bwd"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--tile-size", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=128,
                    help="accepted and ignored")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--isect-cap", type=int, default=0,
                    help="accepted and ignored")
    return ap.parse_args(argv)


def stage_timer(dev: torch.device, iters: int, results: dict):
    """-> timeit(name, fn): fn once to warm up, then `iters` timed calls;
    the mean ms goes to `results[name]` and is printed; returns fn's last
    output."""
    def timeit(name, fn):
        out = fn()
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                out = fn()
            end.record()
            torch.cuda.synchronize(dev)
            ms = start.elapsed_time(end) / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn()
            ms = (time.perf_counter() - t0) / iters * 1e3
        results[name] = ms
        print("%-22s %8.2f ms" % (name, ms), flush=True)
        return out
    return timeit


def e2e_gradients(proj, opac, colors, H: int, W: int, ts: int):
    """Gradients of sum(image) + sum(alpha) in (means2d, conics,
    opacities, colours), through `rasterize`'s autograd Function."""
    wrt = [proj.means2d.detach().requires_grad_(True),
           proj.conics.detach().requires_grad_(True),
           opac.detach().requires_grad_(True),
           colors.detach().requires_grad_(True)]
    img, alpha, _ = R.rasterize(proj._replace(means2d=wrt[0], conics=wrt[1]),
                                wrt[2], wrt[3], H, W, ts)
    return torch.autograd.grad(img.sum() + alpha.sum(), wrt)


def main(argv=None) -> dict:
    """Prints the table; returns {"ms": {stage: ms}, "e2e_grads": the
    last e2e call's gradients, "n_isects", "slots", "pixels_per_s"}."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    H, W, n, ts = args.height, args.width, args.n, args.tile_size
    a = synthetic_arrays(n, capacity_of(n, 1), sh_degree=3)["params"]
    p = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
    cam = make_camera(R=np.eye(3), T=np.zeros(3), fx=1600.0, fy=1600.0,
                      cx=W / 2, cy=H / 2, width=W, height=H, device=dev)
    tiles_x, tiles_y = -(-W // ts), -(-H // ts)
    results = {}
    timeit = stage_timer(dev, args.iters, results)

    with torch.no_grad(), float32_math():
        proj = timeit("project", lambda: project_gaussians(
            p["means"], torch.exp(p["scales"]), p["rotations"],
            cam.world_to_camera, cam.fx, cam.fy, cam.cx, cam.cy, W, H))
        opac = torch.sigmoid(p["opacities"][:, 0]).contiguous()
        dirs = p["means"] - cam.camera_center
        shs = torch.cat([p["shs_dc"], p["shs_rest"]], 1)
        colors = timeit("sh_colors", lambda: sh_to_rgb(
            shs, dirs, 3).contiguous())
        isects = timeit("isect_encode",
                        lambda: R.isect_encode(proj, H, W, ts))
        print(f"  n_isects={isects.n_isects} slots={isects.total}",
              flush=True)
        m2d, con = proj.means2d.contiguous(), proj.conics.contiguous()
        depths = proj.depths.contiguous()
        keys, gids = timeit("expand", lambda: R.expand(
            isects, m2d, con, opac, depths, tiles_x, tiles_y, ts))
        sk, gs, order = timeit("sort", lambda: R.sort_slots(keys, gids))
        bounds = timeit("tile ranges", lambda: R.tile_bounds(
            sk, tiles_x * tiles_y))
        _, t_fin, i_stop = timeit("raster_fwd", lambda: R.rasterize_fwd(
            m2d, con, opac, colors, gs, bounds, H, W, ts))
        g_out = torch.ones((H, W, 3), device=dev)
        g_alpha = torch.ones((H, W), device=dev)
        rows = timeit("raster_bwd", lambda: R.rasterize_bwd(
            m2d, con, opac, colors, gs, bounds, g_out, g_alpha, t_fin,
            i_stop, ts))
        inv = R.invert_order(order)
        timeit("reduce", lambda: R.reduce_grads(
            rows, gs, isects.offsets, inv, bounds[-1:], m2d.shape[0]))
    with float32_math():
        grads = timeit(E2E, lambda: e2e_gradients(proj, opac, colors, H, W,
                                                  ts))

    total = sum(results[s] for s in STAGES)
    px_per_s = H * W / (results[E2E] / 1e3)
    print("-" * 34)
    print("%-22s %8.2f ms" % ("sum of stages", total))
    print("e2e fwd+bwd: %.2f ms  ->  %.2fM pixels/s"
          % (results[E2E], px_per_s / 1e6), flush=True)
    return {"ms": results, "e2e_grads": grads, "n_isects": isects.n_isects,
            "slots": isects.total, "pixels_per_s": px_per_s}


if __name__ == "__main__":
    main()
