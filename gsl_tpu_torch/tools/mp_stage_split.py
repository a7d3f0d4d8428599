"""Where the sharded step's time goes, stage by stage, against world size.

    python -m gsl_tpu_torch.tools.mp_stage_split [--device cuda|cpu]
        [--worlds 2 4] [--n 20000] [--height 128] [--width 128]
        [--iters 5] [--out PATH]

Counterpart of ``tools/mp_stage_split.py``, which times cumulative cuts of
the jitted step. Here the step itself is marked between its stages
(`gaussian_sharded.StageTimer`: CUDA events on the card, the host clock on
the CPU), on rank 0, for the full-capacity exchange and a top-K exchange
of 2048, on the scene of `mp_scaling_table`:

  proj           the mp cameras gathered, the shard projected and
                 coloured for each
  compact        the visible-first top-K (a no-op for the full exchange)
  exchange       the payload and radii all_to_all (host staging included)
  fwd            the port's rasterize (K1, sort, ranges, K2) and the loss
  bwd            autograd (K3, K4, the exchange's reverse all_to_all)
  reduce_update  the dp gradient sum, the loss mean, Adam on the shard

The table goes to standard output, and to `--out` when given.
"""
from __future__ import annotations

from ..parallel.gaussian_sharded import STAGES
from .mp_scaling_table import emit, parse_args, run_world

TOP_K = 2048


def main(argv=None):
    args = parse_args(argv, __doc__, [2, 4])
    from ..utils.device import resolve_device
    resolve_device(args.device)
    H, W = args.height, args.width
    lines = [f"# stage split of the sharded step: {args.n} Gaussians, "
             f"{H}x{W}, mean ms of {args.iters} steps on rank 0, "
             f"{args.device}", "",
             "| world | mesh | mode | " + " | ".join(STAGES)
             + " | step |", "|" + "---|" * (len(STAGES) + 4)]
    rows = []
    for world in args.worlds:
        for mode, k in (("full", None), (f"top-K {TOP_K}", TOP_K)):
            r = run_world(world, args.n, H, W, args.iters, k,
                          args.device)[0]
            rows.append((mode, r))
            st = r["stage_ms"]
            lines.append(f"| {r['world']} | {r['mesh']} | {mode} | "
                         + " | ".join(f"{st[s]:.3f}" for s in STAGES)
                         + f" | {sum(st.values()):.3f} |")
    emit(lines, args.out)
    return rows


if __name__ == "__main__":
    main()
