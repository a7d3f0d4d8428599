"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port. Module names are compared by their
top-level name, whole: ``gsl_tpu_torch`` is not ``gsl_tpu``."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import harness

BENCH = harness.BENCH
YARDSTICK = ("reference", "work", "scene.py", "check.py")


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


def test_the_yardstick_imports_nothing_of_the_port():
    files = [p for y in YARDSTICK for p in
             ((BENCH / y).rglob("*.py") if (BENCH / y).is_dir()
              else [BENCH / y])]
    assert len(files) >= 6
    for p in files:
        assert "gsl_tpu_torch" not in top_level_imports(p), p


def test_the_forbidden_names_are_compared_whole():
    assert "gsl_tpu_torch" not in harness.FORBIDDEN
    assert "gsl_tpu" in harness.FORBIDDEN and "jax" in harness.FORBIDDEN


def test_a_tiny_run_loads_no_forbidden_module():
    """A CPU run of every cell in a fresh interpreter, then the names of
    `sys.modules`."""
    code = f"""
import copy, dataclasses, json, sys, time
sys.path.insert(0, {str(harness.ROOT)!r})
import torch
from port_bench import execute, harness
b = harness.load_benchmark()
for w in b["workloads"]:
    cell = harness.resolve(b, w["name"])
    cfg, mix = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    cfg.update(n_gaussians=500, width=40, height=24, views=9)
    mix.update(width=40, height=24, stations=4, warmup_frames=1,
               warmup_steps=1, traced_frames=1, traced_steps=1)
    cell = dataclasses.replace(cell, config=cfg, traffic=mix)
    execute.execute(cell, 3, 0.2, True, torch.device("cpu"),
                    time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "gsl_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)
