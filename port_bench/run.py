"""Run one cell of the port's benchmark once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, traffic mix, limits and metrics are found by
the names in ``BENCHMARK.json`` (``harness.py``). The run makes every
input from the seed, sets up the port (``gsl_tpu_torch``) through its own
entry points, warms up, measures for ``--seconds`` and, with
``--trace 1``, traces a short window after it for the per-layer metrics.
Then it checks what the timed path produced against the plain reference
and prints one JSON line: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, ``breakdown`` (traced runs) and ``checks``
(each compared number with its limit). Without a CUDA card, or with fewer
cards than the cell asks for, it exits with 2 and prints no result; if
JAX or the JAX package was loaded, with 3.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.keep_caches_in_checkout()
    cell = harness.resolve(harness.load_benchmark(), args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    # one host thread of torch's own beside the loader's: steadier runs
    torch.set_num_threads(1)
    from port_bench import execute
    result, checks = execute.execute(cell, args.seed, args.seconds,
                                     bool(args.trace),
                                     torch.device("cuda:0"), T_PROCESS)
    if result is None:
        return 3
    harness.print_result(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
