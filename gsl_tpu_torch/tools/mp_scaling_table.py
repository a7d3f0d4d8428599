"""Step time against world size for the sharded training step.

    python -m gsl_tpu_torch.tools.mp_scaling_table [--device cuda|cpu]
        [--worlds 1 2 4] [--n 20000] [--height 128] [--width 128]
        [--iters 5] [--out PATH]

Counterpart of ``tools/mp_scaling_table.py``. For each world size it runs
`gaussian_sharded.make_mp_train_step` on that many ranks (spawned on this
host; a world of one in this process) over a synthetic scene (numpy seed
0, ``__graft_entry__._synthetic_state``'s draws, SH degree 3) with one
narrow camera a rank, twice: the full-capacity exchange and the top-K
exchange at the fit's ``compact_k: auto`` budget. mp is 4, 2 or 1, the
largest that divides the world. Each row: ms per step (CUDA events on the
card, the host clock on the CPU; the mean over `--iters` steps after one
warm-up), pixels per second (world x H x W a step), the exchange's bytes
(`exchange_bytes_per_step`) and its measured forward and backward ms
(CUDA events on the card, staging included), the overflow and the loss.

Ranks that share one card talk over gloo and stage through the host, so
a world of several ranks on one H100 measures the exchange's overhead,
not what several cards would gain. The table goes to standard output,
and to `--out` when given.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..data.cameras import make_camera
from ..models.gaussian import OptimizationConfig
from ..parallel.gaussian_sharded import (StageTimer,
                                         exchange_bytes_per_step, make_mesh,
                                         make_mp_train_step, shard_params)
from ..parallel.fit_distributed import auto_compact_k
from ..parallel.launch import spawn
from ..training.optimizers import GaussianAdam
from ..utils.convert import train_state_from_jax_arrays


def mp_of(world: int) -> int:
    return 4 if world % 4 == 0 else (2 if world % 2 == 0 else 1)


def capacity_of(n: int, mp: int) -> int:
    cap = 1
    while cap < n:
        cap <<= 1
    return max(cap, 256 * mp)


def synthetic_arrays(n: int, capacity: int, sh_degree: int = 3,
                     seed: int = 0) -> dict:
    """``__graft_entry__._synthetic_state``'s rows, padded to `capacity`
    with dead rows, as {"params", "alive", "opt"} numpy arrays (zero Adam
    moments)."""
    rng = np.random.RandomState(seed)
    k = (sh_degree + 1) ** 2

    def pad(x, fill=0.0):
        out = np.full((capacity,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return out

    means = np.concatenate([rng.uniform(-2, 2, size=(n, 2)),
                            rng.uniform(2, 8, size=(n, 1))], axis=-1)
    quats = rng.normal(size=(n, 4))
    rotations = pad(quats)
    rotations[n:, 0] = 1.0
    params = dict(
        means=pad(means),
        scales=pad(rng.uniform(-6.5, -4.5, size=(n, 3)), fill=-10.0),
        rotations=rotations,
        opacities=pad(rng.uniform(-1, 2, size=(n, 1)), fill=-10.0),
        shs_dc=pad(rng.normal(size=(n, 1, 3)) * 0.3),
        shs_rest=pad(np.zeros((n, k - 1, 3))))
    opt = {key: {"mu": np.zeros_like(v), "nu": np.zeros_like(v),
                 "count": 0} for key, v in params.items()}
    return {"params": params, "alive": np.arange(capacity) < n, "opt": opt}


def rank_camera(i: int, world: int, H: int, W: int, device):
    """Rank i's camera: narrow (fx = 4 H), so each sees part of the scene,
    as the JAX tool places them."""
    return make_camera(R=np.eye(3), T=[0.8 * i - 0.4 * world, 0.0, 0.0],
                       fx=H * 4.0, fy=H * 4.0, cx=W / 2, cy=H / 2, width=W,
                       height=H, device=device)


def step_rank(n: int, H: int, W: int, iters: int, compact_k, device: str,
              sh_degree: int = 3) -> dict:
    """The sharded step on this rank, `iters` times after one warm-up.
    `compact_k`: None (full exchange), "auto" (the fit's probe) or an
    int. Returns its ms per step, per-stage ms, exchange cost, loss and
    overflow."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = make_mesh(mp=mp_of(world), device=device)
    mp = mesh.mp
    dev = mesh.device
    cap = capacity_of(n, mp)
    state = train_state_from_jax_arrays(
        **synthetic_arrays(n, cap, sh_degree),
        density={k: np.zeros(cap, np.float32)
                 for k in ("grad_accum", "denom", "max_radii")},
        step=0, device=dev)
    cams = [rank_camera(i, world, H, W, dev) for i in range(world)]
    if compact_k == "auto":
        compact_k = auto_compact_k(state.gaussians, cams, H, W, mp)
    tx = GaussianAdam(OptimizationConfig(), 1.0)
    params, alive, opt = shard_params(mesh, state.params, state.alive,
                                      state.opt_state)
    step = make_mp_train_step(mesh, tx, H, W, sh_degree,
                              compact_k=compact_k)
    gt = torch.full((H, W, 3), 0.5, device=dev)
    bg = torch.zeros(3, device=dev)
    cam = cams[mesh.rank]
    out = step(params, alive, opt, cam, gt, bg)           # warm-up
    mesh.stats.reset()
    ms, stages = [], []
    for _ in range(iters):
        timer = StageTimer(dev)
        t0 = time.perf_counter()
        out = step(out[0], alive, out[1], cam, gt, bg, timer=timer)
        st = timer.ms()          # synchronises the device on the card
        wall = 1e3 * (time.perf_counter() - t0)
        stages.append(st)
        ms.append(sum(st.values()) if dev.type == "cuda" else wall)
    k_eff = compact_k if compact_k else cap // mp
    return {"world": world, "mesh": mesh.shape, "backend": mesh.backend,
            "ms": float(np.mean(ms)),
            "stage_ms": {k: float(np.mean([s[k] for s in stages]))
                         for k in stages[0]},
            "exchange": mesh.stats.snapshot(), "iters": iters,
            "loss": float(out[2]), "overflow": int(out[5]), "compact_k": k_eff,
            "exchange_bytes": exchange_bytes_per_step(world, mp, k_eff)}


def run_world(world: int, n: int, H: int, W: int, iters: int, compact_k,
              device: str) -> list:
    """`step_rank` on every rank of a world of `world` ranks."""
    args = (n, H, W, iters, compact_k, device)
    if world == 1:
        return [step_rank(*args)]
    return spawn(step_rank, world, device, args=args)


def parse_args(argv, doc, worlds):
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worlds", type=int, nargs="+", default=worlds)
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=None,
                    help="also write the table here")
    args = ap.parse_args(argv)
    if args.out and os.path.basename(args.out) == "MULTICHIP_SCALING.md":
        raise SystemExit("MULTICHIP_SCALING.md holds gsl_tpu's table; "
                         "give another --out")
    return args


def emit(lines, out):
    text = "\n".join(lines) + "\n"
    print(text, end="", flush=True)
    if out:
        with open(out, "w") as f:
            f.write(text)


def main(argv=None):
    args = parse_args(argv, __doc__, [1, 2, 4])
    from ..utils.device import resolve_device
    resolve_device(args.device)
    H, W = args.height, args.width
    rows = []
    for world in args.worlds:
        for mode in (None, "auto"):
            r = run_world(world, args.n, H, W, args.iters, mode,
                          args.device)[0]
            rows.append((mode, r))
    lines = [f"# sharded step against world size: {args.n} Gaussians, "
             f"{H}x{W}, {args.iters} steps a row, {args.device}", "",
             "| world | mesh | backend | exchange | K | exchange MB/step "
             "| xchg fwd ms | xchg bwd ms | overflow | step ms | pixels/s "
             "| loss |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for mode, r in rows:
        ex = r["exchange"]
        px = r["world"] * H * W / (r["ms"] / 1e3)
        lines.append(
            f"| {r['world']} | {r['mesh']} | {r['backend'] or 'none'} | "
            f"{'full' if mode is None else 'top-K auto'} | "
            f"{r['compact_k']} | {r['exchange_bytes'] / 1e6:.3f} | "
            f"{1e3 * ex['fwd_s'] / r['iters']:.3f} | "
            f"{1e3 * ex['bwd_s'] / r['iters']:.3f} | {r['overflow']} | "
            f"{r['ms']:.3f} | {px:,.0f} | {r['loss']:.5f} |")
    emit(lines, args.out)
    return rows


if __name__ == "__main__":
    main()
