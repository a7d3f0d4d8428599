"""Each cell once on the card, as the benchmark's command runs it, with a
short window: the result line has every key and metric it owes, and
`correct` is true. Skips (inside the test) on a host without a CUDA card.

    python -m pytest port_bench/tests -m cuda
"""
import json
import subprocess
import sys

import pytest

from port_bench import harness

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 3), "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, timeout=1200, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checks"
    c = harness.resolve(BENCH, cell)
    want = c.per_layer if trace else c.end_to_end
    assert set(line["metrics"]) == {m["name"] for m in want}
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        for m in line["metrics"]:
            if m.startswith(("raster_roofline", "mfu")):
                assert 0 < line["metrics"][m]["value"] <= 100
