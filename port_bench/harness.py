"""What every cell shares: finding a cell's files by the names in
``BENCHMARK.json``, the environment a run keeps to, and the result line.

A cell is one entry of ``workloads``. Its configuration is the file the
``configs`` entry names, whose ``renderer`` picks ``renderers/<renderer>.py``;
its traffic mix is ``traffic/<traffic>.json``, whose ``kind`` picks
``kinds/<kind>.py`` and whose parameters the one generator, ``scene.py``,
reads; its limits for `correct` are ``limits/<workload>.json``; each
per-layer metric is read by ``layer_metrics/<metric>.py``. A later cell,
mix, kind, renderer or metric is added as files and entries; nothing
here names one.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gsl_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    limits: dict
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(bench: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell named `workload`, with its files read."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {', '.join(sorted(cells))})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    c = configs[w["config"]]
    return Cell(
        name=workload, config_name=c["name"],
        config=_json(root / c["file"]), traffic_name=w["traffic"],
        traffic=_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        chips=int(w["chips"]),
        limits=_json(BENCH / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"]
                    if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)])


def kind(cell: Cell):
    """``kinds/<kind>.py`` of the cell's traffic mix."""
    return importlib.import_module(
        f"port_bench.kinds.{cell.traffic['kind']}")


def renderer(cell: Cell):
    """``renderers/<renderer>.py`` of the cell's configuration."""
    return importlib.import_module(
        f"port_bench.renderers.{cell.config['renderer']}")


def reader(metric: str):
    """The `read(ctx)` of ``layer_metrics/<metric>.py``."""
    path = BENCH / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench_layer_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the port must not
    load (compared whole: ``gsl_tpu_torch`` is not ``gsl_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def keep_caches_in_checkout(root: Path = ROOT) -> None:
    """Kernel caches at fixed paths inside the checkout. The port's nvcc
    builds go to ``gsl_tpu_torch/build/`` by its own rule."""
    cache = root / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def card() -> dict:
    """The card's name, power limit and clocks from nvidia-smi, where it
    answers."""
    import subprocess
    q = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    line = out.strip().splitlines()[0] if out.strip() else ""
    return dict(zip(q.split(","), (s.strip() for s in line.split(","))))


def check_numbers(numbers: dict, limits: dict) -> tuple:
    """-> (correct, {name: {"value", "limit"}}). A number passes when it
    is finite and at most its limit; a limit missing fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        passed = (limit is not None and value is not None
                  and math.isfinite(value) and value <= limit)
        ok = ok and passed
        checks[name] = {"value": value, "limit": limit}
    return ok and bool(numbers), checks


def print_result(result: dict, checks: dict) -> None:
    """The compared numbers as the last lines on stderr, then the result
    as the last line on stdout, with the checks as its last key."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    line = dict(result, checks=checks)
    print(json.dumps(line), flush=True)
