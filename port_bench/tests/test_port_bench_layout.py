"""BENCHMARK.json against the format its readers take, and every name in it
resolved to its files."""
import json
import re

import pytest

from port_bench import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_entries_have_only_their_keys_and_valid_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source",
                           "workloads"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}}
    for group, allowed in keys.items():
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        for e in BENCH[group]:
            assert set(e) <= allowed, (group, e["name"])
            assert NAME.match(e["name"]), e["name"]
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
            if "unit" in e:
                assert UNIT.match(e["unit"])
                assert e["better"] in ("lower", "higher")


def test_bounds_and_sources():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in names
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    c = harness.resolve(BENCH, cell)
    kind, rend = harness.kind(c), harness.renderer(c)
    for fn in ("run", "reference", "numbers", "counted_scene", "parts"):
        assert callable(getattr(kind, fn)), fn
    assert isinstance(kind.FAULTS, tuple)
    for fn in ("draw_scene", "program_state", "render", "train_step",
               "view_counts", "frame_parts", "step_parts"):
        assert callable(getattr(rend, fn)), fn
    assert c.chips == 1
    assert c.config["name"] == c.config_name
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert set(c.config["kernels"][c.traffic["kind"]])
    assert c.limits and all(isinstance(v, (int, float))
                            for v in c.limits.values())
    # every per-layer metric of the cell moves one it reports
    reported = {m["name"] for m in c.end_to_end}
    assert all(m["moves"] in reported for m in c.per_layer)


@pytest.mark.parametrize("metric", METRICS)
def test_every_per_layer_metric_has_a_reader_that_reads_nothing_from_nothing(
        metric):
    read = harness.reader(metric)
    kind = "train" if metric.endswith(".train") else "viewer"
    empty = {"kind": kind, "host": {}, "trace": None, "least": {}}
    assert read(empty) is None


def test_configs_name_their_published_sizes_and_cuts():
    for c in BENCH["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert c["file"].startswith("port_bench/")
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert cfg["n_gaussians"] and cfg["width"] and cfg["height"]
        assert cfg["sh_degree"] == 3 and cfg["tile_size"] == 16
        assert "n_gaussians" in cfg["assumed"]
        assert cfg["views"] - len(range(0, cfg["views"],
                                        cfg["holdout_every"])) \
            == cfg["train_views"]
