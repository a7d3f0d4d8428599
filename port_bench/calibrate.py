"""The readings that the limits of `correct` are set from, on the card.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds 2] [--out FILE]

For every seed of `--seeds`: the program's numbers (its timed path
through a short window, as a run drives it, against the reference). For
every seed of `--control-seeds`, the same numbers of the control, the
reference in TF32 put in the program's place, and of each fault that the
cell's kind plants in the reference (``FAULTS``: a training cell's loss
over half of the image's rows). A state left unchanged reads 1 by the
gradient's and the change's measure and needs no run. Each seed's
readings are one JSON line on stdout (and in `--out`); the first seed's
has the kind's description of its work (a training cell's first view's
depth-complexity counts). The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import harness  # noqa: E402


def _ints(s):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.keep_caches_in_checkout()
    cell = harness.resolve(harness.load_benchmark(), args.workload)
    import torch
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    from port_bench import program
    dev = torch.device("cuda:0")
    kind = harness.kind(cell)
    out = open(args.out, "a") if args.out else None
    seeds = sorted(set(args.seeds) | set(args.control_seeds))
    for seed in seeds:
        row = {"workload": cell.name, "seed": seed}
        t0 = time.perf_counter()
        prog = None
        if seed in args.seeds:
            prog = kind.run(cell, seed, args.seconds, False, dev,
                            t0).readings
            program.free()
        ref = kind.reference(cell, seed, dev, prog)
        if prog is not None:
            row["program"] = kind.numbers(prog, ref)
        if seed in args.control_seeds:
            row["control"] = kind.numbers(
                kind.reference(cell, seed, dev, prog, "tf32"), ref)
            for fault in kind.FAULTS:
                row[fault] = kind.numbers(
                    kind.reference(cell, seed, dev, prog, fault=fault), ref)
        if seed == seeds[0] and hasattr(kind, "describe"):
            row["described"] = kind.describe(cell, seed, dev)
        del ref
        program.free()
        row["seconds"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
