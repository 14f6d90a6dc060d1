"""BENCHMARK.json and the files the harness finds by name: every
configuration, traffic mix, cell and metric reader loads, and what the
files say agrees with BENCHMARK.json."""
import json
import re
from pathlib import Path

import pytest

from bench import harness

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    assert BENCH["command"][1].startswith("bench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.fullmatch(n) for n in names)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"gpts_per_s", "chunk_ms_p95", "setup_s"}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_loads_by_name(entry):
    config = harness.load("configs", entry["name"])
    assert entry["file"] == f"bench/configs/{entry['name']}.json"
    assert config["name"] == entry["name"]
    assert sorted(config["reduced"]) == sorted(entry["reduced"])
    assert len(config["grid"]) == len(config["radii"])
    assert config["dtype"] in ("float32", "bfloat16")


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads_by_name(entry):
    cell = harness.load_cell(entry["name"])
    assert cell.spec["config"] == entry["config"]
    assert cell.spec["traffic"] == entry["traffic"]
    assert cell.spec["chips"] == entry["chips"] == 1
    assert set(cell.spec["limits"]) == {"chunk_err", "receiver_diffs"}
    assert len(entry["why"]) <= 200
    # the metrics a cell's file names are those BENCHMARK.json lists for it
    listed = {m["name"] for m in BENCH["per_layer"]
              if entry["name"] in m["workloads"]}
    assert set(cell.spec["per_layer"]) == listed
    assert harness.op_of(cell.config).__name__ == cell.config["op"]["function"]


@pytest.mark.parametrize("entry", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_loads_by_name(entry):
    mod = harness.load_metric(entry["name"])
    assert mod.UNIT == entry["unit"]
    assert callable(mod.read)
    assert entry["moves"] == "gpts_per_s"
    assert set(entry["workloads"]) <= set(CELLS)


def test_layer_names_one_per_layer():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert {m["layer"] for m in BENCH["per_layer"]
            if m["name"].endswith("_roofline_frac")} == {"CUDA kernels"}
    assert all(1 <= len(x) <= 200 and "\n" not in x for x in layers)


def test_unknown_names_are_refused():
    with pytest.raises(ValueError):
        harness.load_cell("no-such-config.no-such-traffic")
    with pytest.raises(ValueError):
        harness.load_metric("no_such_metric")
