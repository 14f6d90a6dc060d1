"""On the card: a short run of each cell at its own size is correct and
reports every metric it names; the traced run's shares stay under 100%.
Skips on a host without a card; on the card:

    PYTHONPATH=src python -m pytest -q -m cuda bench/
"""
import gc
import json
from pathlib import Path

import pytest
import torch

from bench import harness

CELLS = [w["name"] for w in json.loads(
    (Path(__file__).resolve().parents[1] / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    yield torch.device("cuda")
    # a run of a cell fills most of the card; the next cell in this process
    # needs the allocator's cached blocks back (a benchmark run is a process
    # of its own)
    gc.collect()
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(card, name, trace):
    cell = harness.load_cell(name)
    r = harness.run(cell, 2**31 + 17, 1.0, trace, card)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    if trace:
        assert set(r["metrics"]) == set(cell.spec["per_layer"])
        for name_, m in r["metrics"].items():
            if m["unit"] == "%":
                assert 0 < m["value"] <= 100, name_
        assert r["metrics"]["launches_per_step"]["value"] == 1.0
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    else:
        assert set(r["metrics"]) == {"gpts_per_s", "chunk_ms_p95", "setup_s"}
