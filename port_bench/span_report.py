"""One traced run of a cell with the port's own spans read out
(``spans.py``).

    python3 port_bench/span_report.py --workload <cell> --seed <n> \
        --seconds <s> [--json PATH]

It runs the cell as ``run.py --trace 1`` does and prints the same result
line, whose metrics also hold the cell's entries of ``span_metrics.json``
(each span metric's ``per_layer`` entry, read by its file in
``layer_metrics/``), then one line ``spans {...}``: per item, each span's
calls and its host, self-host, wait, device, kernel and idle ms; the
window's device, kernel and idle ms; the shares of device time launched
in no span and of idle time under none; the host-blocking calls made in a
span but in no ``wait.*`` span, and those made in no span; and, for a
training cell, the device and kernel ms of the step's five top spans
(``train.forward``, ``train.backward``, ``train.adam``,
``train.density_stats``, ``data.to_float``). ``--json`` writes that
line's object to a file too.

``run.py`` reads these metrics once ``trace.parse`` returns
``spans.attribute``'s reading as ``spans`` and ``BENCHMARK.json`` lists
the entries; here ``trace.parse`` is wrapped so, in this process only.
Without a CUDA card it exits with 2.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import harness, spans, trace  # noqa: E402

STEP_SPANS = ("train.forward", "train.backward", "train.adam",
              "train.density_stats", "data.to_float")


def span_metrics(cell: str) -> list:
    """The ``per_layer`` entries of ``span_metrics.json`` that `cell`
    reports."""
    with open(harness.BENCH / "span_metrics.json") as f:
        return [m for m in json.load(f) if cell in m["workloads"]]


def with_spans(parse, into: dict):
    """`parse` that also returns the spans' reading as ``spans`` (and
    keeps it in `into`); every key of `parse` as it was."""
    def parse_with_spans(events):
        out = parse(events)
        into.update(spans.attribute(events, trace.STEP_MARK))
        return dict(out, spans=dict(into))
    return parse_with_spans


def summary(sp: dict, kind: str) -> dict:
    """The reading of `attribute` per item, in ms."""
    n = max(sp["items"], 1)

    def ms(s):
        return 1e3 * s / n

    out = {"items": sp["items"], "device_ms": ms(sp["device_s"]),
           "kernel_ms": ms(sp["kernel_s"]), "idle_ms": ms(sp["idle_s"]),
           "device_outside_share": (sp["device_outside_s"] / sp["device_s"]
                                    if sp["device_s"] else None),
           "idle_outside_share": (sp["idle_outside_s"] / sp["idle_s"]
                                  if sp["idle_s"] else None),
           "blocking_outside": sp["blocking_outside"],
           "blocking_unspanned": sp["blocking_unspanned"],
           "by_span": {
               name: {"calls": v["calls"] / n,
                      **{k[:-2] + "_ms": ms(v[k]) for k in
                         ("host_s", "self_host_s", "wait_host_s",
                          "device_s", "kernel_s", "idle_s")}}
               for name, v in sorted(sp["by_span"].items())}}
    if kind == "train":
        by = sp["by_span"]
        out["step_spans_device_ms"] = ms(sum(
            by[k]["device_s"] for k in STEP_SPANS if k in by))
        out["step_spans_kernel_ms"] = ms(sum(
            by[k]["kernel_s"] for k in STEP_SPANS if k in by))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    harness.keep_caches_in_checkout()
    cell = harness.resolve(harness.load_benchmark(), args.workload)
    cell.per_layer = cell.per_layer + span_metrics(cell.name)

    import torch
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from port_bench import execute
    reading = {}
    trace.parse = with_spans(trace.parse, reading)
    result, checks = execute.execute(cell, args.seed, args.seconds, True,
                                     torch.device("cuda:0"), T_PROCESS)
    if result is None:
        return 3
    harness.print_result(result, checks)
    line = summary(reading, cell.traffic["kind"])
    if args.json:
        with open(args.json, "w") as f:
            json.dump(line, f, indent=1)
    print("spans " + json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
