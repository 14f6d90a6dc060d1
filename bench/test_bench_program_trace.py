"""The program's spans and counters in a traced run (bench/program_trace.py)
and the readers of the per-layer metrics they give, on the CPU at small
sizes: a traced run reports them where the program records them and
leaves them out where it does not; the readers on readings made by hand;
each idle gap named by the innermost program range in flight."""
import json
import math

import pytest
import torch

import repro_torch.telemetry
from bench import harness, program_trace
from repro_torch.kernels import _build
from repro_torch.kernels.stencil2d import kernel as k3
from repro_torch.telemetry import host, validate_trace

CPU = torch.device("cpu")
SMALL = {"seismic2d-r12.shots16384-t1": ((40, 56), 2),
         "star3d-r2.grids52-t1": ((14, 16, 18), 1)}
D2 = "seismic2d-r12.shots16384-t1"
SEED = 2**31 + 4242
NEW = set(program_trace.METRICS)


def small_cell(name):
    grid, batch = SMALL[name]
    return harness.load_cell(name, grid=grid, batch=batch)


@pytest.mark.parametrize("name", SMALL)
def test_a_traced_run_reports_the_program_spans(name, tmp_path):
    """On the CPU the op runs the plain version: its root, plan and wrapper
    spans are read; no allocation, launch or clock, so those readers find
    nothing.  The run is correct; its trace file validates."""
    r = program_trace.run(small_cell(name), SEED, 0.3, CPU, out_dir=tmp_path)
    assert r["correct"] and list(r)[-1] == "checks"
    op = "stencil2d" if name == D2 else "stencil3d"
    got = set(r["metrics"]) & NEW
    assert got == {"plan_us_per_call", "wrapper_us_per_call"}
    assert all(r["metrics"][m]["value"] > 0 for m in got)
    assert "host_us_per_call" in r["metrics"]
    t = r["traced"]
    assert set(t["span_us_per_call"]) == {op, f"{op}.plan", f"{op}.kernel"}
    assert t["work"] == {} and t["clocks"] == {}
    assert list(t["root_us"]) == [op] and len(t["root_us"][op]) == t["calls"]
    assert set(t["span_us_median"]) == set(t["span_us_max"]) == \
        set(t["span_us_per_call"])
    assert all(t["span_us_median"][k] <= t["span_us_max"][k]
               for k in t["span_us_max"])
    own = t["self_us_per_call"]
    assert own[op] == pytest.approx(t["span_us_per_call"][op]
                                    - t["span_us_per_call"][f"{op}.plan"]
                                    - t["span_us_per_call"][f"{op}.kernel"])
    obj = json.loads(open(t["trace"]).read())
    assert validate_trace(obj) == t["calls"] * 3
    assert {e["args"]["name"] for e in obj["traceEvents"]
            if e["name"] == "process_name"} == {"host"}


def test_a_program_without_recording_gives_none_of_them(monkeypatch, tmp_path):
    """The parent of the program that records spans: the run is the
    harness's own, with no reading of its new metrics and nothing raised."""
    monkeypatch.delattr(repro_torch.telemetry, "recording")
    r = program_trace.run(small_cell(D2), SEED, 0.3, CPU, out_dir=tmp_path)
    assert r["correct"] and not set(r["metrics"]) & NEW
    assert "traced" not in r and list(tmp_path.iterdir()) == []


def test_the_traced_pass_reads_work_and_clocks(monkeypatch):
    """A launch's work and a clocked kernel's buffer, as the card's path
    records them, reach the pass's tally and the readers: the work counted
    over the pass alone, the buffer read once at its end."""
    cell = small_cell(D2)
    module = __import__(cell.config["op"]["module"], fromlist=["_"])
    op = getattr(module, cell.config["op"]["function"])
    laps = torch.tensor([1, 2, 3, 4, 1, 100])

    def card_like(x, *taps, timesteps):
        with host.span("stencil2d"):
            with host.span("stencil2d.alloc"):
                y = op(x, *taps, timesteps=timesteps)
            buf = host.clock_buffer("stencil2d_clocked", x.device,
                                    k3.CLOCK_FIELDS, k3.CLOCK_SLOTS)
            buf[7] += laps
            _build._tally(_build.WORK, "stencil2d_clocked", 10, 1000)
        return y

    monkeypatch.setattr(module, cell.config["op"]["function"], card_like)
    monkeypatch.setitem(_build.WORK, "stencil2d_clocked", [5, 50, 5000])
    taps = harness.inputs.star_taps(cell.config["grid"], cell.config["radii"],
                                    cell.config["spectral_radius"],
                                    cell.config["taps_seed"])
    loop = harness.Loop(cell, taps, torch.randn(cell.shape))
    t = program_trace.traced_pass(loop, 3, out_dir=None)
    n = t.calls
    assert n == 3 * cell.calls and t.path is None
    assert t.work == {"stencil2d_clocked": [n, 10 * n, 1000 * n]}
    assert t.clocks == {"stencil2d_clocked": dict(
        zip(k3.CLOCK_FIELDS, (n * v for v in laps.tolist())))}
    r = harness.Reading(cell, 0.0, None, None)
    r.traced = t
    read = {m: harness.load_metric(m).read(r) for m in NEW}
    assert read["k3_load_wait_frac"] == pytest.approx(30.0)
    assert read["kernel_bytes_ratio"] == pytest.approx(
        1000 / (2 * math.prod(cell.shape) * 4))
    # the op's own spans nest inside the allocation span here
    assert read["alloc_us_per_call"] > read["plan_us_per_call"] > 0


def traced() -> program_trace.Traced:
    """32 calls of the 2D cell: 40 us of planning a call, 160 of wrapper
    (20 of it allocation), K3 at 1.2156x the bytes, 45% loading."""
    need = 2 * 16384 * 449 * 960 * 4
    return program_trace.Traced(
        calls=32, wall_s=1.0,
        spans={"stencil2d": [230e-6] * 32, "stencil2d.plan": [40e-6] * 32,
               "stencil2d.kernel": [150e-6, 170e-6] * 16,
               "stencil2d.alloc": [20e-6] * 32,
               "launch.stencil2d_clocked": [100e-6] * 32},
        self_s={},
        work={"stencil2d_clocked": [32, 0, round(32 * 1.2156 * need)]},
        clocks={"stencil2d_clocked": {"issue": 15, "wait": 30, "sum": 50,
                                      "store": 5, "blocks": 1, "bytes": 0}})


@pytest.mark.parametrize("name,want", [
    ("plan_us_per_call", 40.0), ("wrapper_us_per_call", 160.0),
    ("alloc_us_per_call", 20.0), ("kernel_bytes_ratio", 1.2156),
    ("k3_load_wait_frac", 45.0)])
def test_readers(name, want):
    r = harness.Reading(harness.load_cell(D2), 0.0, None, None)
    r.traced = traced()
    mod = harness.load_metric(name)
    assert mod.read(r) == pytest.approx(want, rel=1e-6)
    assert mod.UNIT == {"kernel_bytes_ratio": "x",
                        "k3_load_wait_frac": "%"}.get(name, "us")


@pytest.mark.parametrize("name", sorted(NEW))
def test_readers_find_nothing_without_a_traced_pass(name):
    mod = harness.load_metric(name)
    r = harness.Reading(harness.load_cell(D2), 0.0, None, None)
    assert mod.read(r) is None
    r.traced = None
    assert mod.read(r) is None
    r.traced = program_trace.Traced(0, 0.0, {}, {}, {}, {})
    assert mod.read(r) is None


def test_gaps_are_named_by_the_innermost_program_range():
    intervals = [(0.0, 1.0), (1.2, 2.0), (2.5, 3.0), (3.1, 4.0), (6.0, 7.0)]
    bench = [("bench.issue", 0.5, 3.2), ("bench.receiver", 3.3, 6.5)]
    program = [("stencil2d", 0.9, 2.9), ("stencil2d.kernel", 2.0, 2.8),
               ("launch.stencil2d", 2.1, 2.6)]
    gaps = program_trace.label_gaps(intervals, bench, program)
    assert gaps == [["bench.receiver", 2.0],
                    ["bench.issue>launch.stencil2d", 0.5],
                    ["bench.issue>stencil2d", pytest.approx(0.2)],
                    ["bench.issue", pytest.approx(0.1)]]
    assert program_trace.label_gaps([(0.0, 1.0), (2.0, 3.0)], [], program) == \
        [["between spans", 1.0]]


def test_span_times_whole_and_own():
    spans = [{"name": "stencil3d", "dur": 10.0, "parent": None, "call": 1},
             {"name": "stencil3d.plan", "dur": 2.0, "parent": 0, "call": 1},
             {"name": "stencil3d.kernel", "dur": 3.0, "parent": 0, "call": 1},
             {"name": "stencil3d.kernel", "dur": 4.0, "parent": 0, "call": 1},
             {"name": "launch.stencil3d", "dur": 1.0, "parent": 3, "call": 1},
             {"name": "eval", "dur": 99.0, "track": "search/ideal"}]
    whole, own = program_trace.span_times(spans)
    assert whole == {"stencil3d": [10.0], "stencil3d.plan": [2.0],
                     "stencil3d.kernel": [3.0, 4.0], "launch.stencil3d": [1.0]}
    assert own == {"stencil3d": 1.0, "stencil3d.plan": 2.0,
                   "stencil3d.kernel": 6.0, "launch.stencil3d": 1.0}
