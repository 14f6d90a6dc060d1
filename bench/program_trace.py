"""The program's own spans and counters in a traced run of a cell.

The port records spans at its layer boundaries and counts each launch's
work (``repro_torch.telemetry.recording``, ``_build.WORK``), and K3 has a
clocked instance that splits a block's time.  A traced run reads them in two
passes after the window:

1. ``traced_pass``: the traffic's ``profile_chunks`` chunks outside the
   profiler, inside ``recording(clocks=True)`` after a chunk of warm-up:
   each call's span tree, the work its launches did and the clocked K3's
   phases.  Its sink is written
   as a Perfetto trace under ``build/bench/``.
2. ``profiled``: the harness's profiled chunks, inside
   ``recording(ranges=True)``, so the program's spans sit on the
   profiler's clock (the main-path kernels run there); each idle gap is
   labelled by the innermost program range in flight inside the
   benchmark's own range, e.g. ``bench.issue>launch.stencil2d``.

``run`` is ``harness.run`` with these two in place of its profiled chunks
and the readers of :data:`METRICS` added to the result.  ``harness.run``
does not call this module yet: the edit that wires it is named in
PERF.md §7.  Against a program without these spans and counters every
function here returns nothing and raises nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import statistics
import sys
from pathlib import Path

import torch

from bench import harness, yardstick

# the per-layer metrics that read a traced pass (metrics/<name>.py)
METRICS = ("plan_us_per_call", "wrapper_us_per_call", "alloc_us_per_call",
           "kernel_bytes_ratio", "k3_load_wait_frac")
TRACE_DIR = harness.HERE.parent / "build" / "bench"


@dataclasses.dataclass
class Traced:
    """One traced pass: its calls and wall time, each host span's
    durations in seconds by name (``spans``) and the seconds no child span
    covers (``self_s``), the work tally's change by kernel ([launches,
    operations, bytes]), the clocked kernels' sums, and the trace file
    written."""
    calls: int
    wall_s: float
    spans: dict[str, list[float]]
    self_s: dict[str, float]
    work: dict[str, list[int]]
    clocks: dict[str, dict[str, int]]
    path: str | None = None

    def seconds(self, suffix: str) -> float | None:
        """Seconds summed over the spans whose names end in ``suffix``;
        None where there are none."""
        durs = [d for k, v in self.spans.items() if k.endswith(suffix)
                for d in v]
        return sum(durs) if durs else None


def program_telemetry():
    """(Telemetry, recording) of the program, or None where it has none."""
    try:
        from repro_torch.telemetry import Telemetry, recording
    except ImportError:
        return None
    return Telemetry, recording


def work_tally() -> dict[str, list[int]]:
    """A copy of the program's per-launch work tally (empty where it has
    none)."""
    from repro_torch.kernels import _build
    return {k: list(v) for k, v in getattr(_build, "WORK", {}).items()}


def span_times(spans: list[dict]) -> tuple[dict[str, list[float]],
                                           dict[str, float]]:
    """The host spans' (those with a call id) durations by name, and their
    seconds by name less what their child spans cover."""
    whole: dict[str, list[float]] = {}
    own: dict[str, float] = {}
    for sp in spans:
        if "call" in sp:
            whole.setdefault(sp["name"], []).append(sp["dur"])
            own[sp["name"]] = own.get(sp["name"], 0.0) + sp["dur"]
            if sp["parent"] is not None:
                parent = spans[sp["parent"]]["name"]
                own[parent] = own.get(parent, 0.0) - sp["dur"]
    return whole, own


def traced_pass(loop: harness.Loop, chunks: int,
                out_dir: Path | None = TRACE_DIR) -> Traced | None:
    """``chunks`` chunks of the loop inside ``recording(clocks=True)``,
    after one chunk inside a recording of its own (the warm-up: a clock
    buffer's first allocation and a clocked kernel's first load); None
    where the program has no recording.  The sink is written to
    ``out_dir/<cell>.host.trace.json`` (path on stderr) unless ``out_dir``
    is None."""
    tools = program_telemetry()
    if tools is None:
        return None
    telemetry, recording = tools
    with recording(telemetry(), clocks=True):
        loop.run(chunks=1)
    tel = telemetry()
    before = work_tally()
    with recording(tel, clocks=True) as rec:
        win = loop.run(chunks=chunks)
    after = work_tally()
    work = {k: [a - b for a, b in zip(v, before.get(k, [0, 0, 0]))]
            for k, v in after.items() if v != before.get(k)}
    whole, own = span_times(tel.spans)
    path = None
    if out_dir is not None:
        from repro_torch.telemetry import write_trace
        out_dir.mkdir(parents=True, exist_ok=True)
        path = str(out_dir / f"{loop.cell.name}.host.trace.json")
        write_trace(tel, path)
        print(f"bench: host spans of the traced pass in {path}",
              file=sys.stderr)
    return Traced(win.calls, win.wall_s, whole, own, work, dict(rec.clocks),
                  path)


def label_gaps(intervals, bench_spans, program_spans,
               top: int = 10) -> list[list]:
    """The ``top`` longest gaps between device operations, each labelled by
    the benchmark's span (name, start, end in seconds) in flight at its
    middle, and by the innermost program span in flight there, if any:
    ``bench.issue>launch.stencil2d``."""
    gaps = []
    for (_, a), (b, _) in zip(intervals, intervals[1:]):
        mid = (a + b) / 2
        label = next((n for n, s, e in bench_spans if s <= mid <= e), None)
        if label is None:
            label = "between spans"
        else:
            inner = [(s, -e, n) for n, s, e in program_spans if s <= mid <= e]
            if inner:
                label += ">" + max(inner)[2]
        gaps.append([label, b - a])
    return sorted(gaps, key=lambda g: -g[1])[:top]


def profiled(loop: harness.Loop, chunks: int) -> harness.Profile:
    """The harness's profiled chunks with the program's ranges on: the same
    device operations and idle share (the ranges' own device-side copies
    left out), each gap labelled by :func:`label_gaps`."""
    from torch.profiler import ProfilerActivity, profile
    on_card = loop.x.device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                           else [])
    tools = program_telemetry()
    tel = tools[0]() if tools else None
    ranges = (tools[1](tel, ranges=True) if tools
              else contextlib.nullcontext())
    if on_card:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with ranges:
            win = loop.run(chunks=chunks, annotate=True)
    names = {sp["name"] for sp in tel.spans} if tel else set()
    events = [e for e in prof.events()
              if not (e.device_type.name == "CUDA" and e.name in names)]
    kernels = yardstick.device_ops(events)
    intervals = yardstick.device_intervals(events)
    host = [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
            for e in events if e.device_type.name == "CPU"]
    bench = [h for h in host if h[0] in ("bench.issue", "bench.receiver")]
    program = [h for h in host if h[0] in names]
    gaps = label_gaps(intervals, bench, program)
    busy = sum(e - s for s, e in intervals)
    return harness.Profile(win.wall_s, win.calls, kernels, busy, gaps)


def summary(t: Traced) -> dict:
    """The traced pass in the result line: µs a call by span, whole and
    own, each span's median and largest µs, each root span's µs in call
    order, the work tally, the clocks and the trace file."""
    per = 1e6 / t.calls if t.calls else 0.0
    roots = [k for k in t.spans if "." not in k]
    return {"calls": t.calls, "wall_s": t.wall_s,
            "root_us": {k: [round(1e6 * d, 1) for d in t.spans[k]]
                        for k in roots},
            "span_us_per_call": {k: sum(v) * per for k, v in t.spans.items()},
            "self_us_per_call": {k: v * per for k, v in t.self_s.items()},
            "span_us_median": {k: 1e6 * statistics.median(v)
                               for k, v in t.spans.items()},
            "span_us_max": {k: 1e6 * max(v) for k, v in t.spans.items()},
            "work": t.work, "clocks": t.clocks, "trace": t.path}


def run(cell: harness.Cell, seed: int, seconds: float, device: torch.device,
        out_dir: Path | None = TRACE_DIR) -> dict:
    """``harness.run(..., trace=True)`` with :func:`traced_pass` and
    :func:`profiled` in place of its profiled chunks; the result line gains
    the readers of :data:`METRICS` that find something to read and, under
    ``"traced"``, :func:`summary`."""
    kept: list[Traced | None] = []

    def both(loop: harness.Loop, chunks: int) -> harness.Profile:
        kept.append(traced_pass(loop, chunks, out_dir))
        return profiled(loop, chunks)

    plain, harness.profiled = harness.profiled, both
    try:
        result = harness.run(cell, seed, seconds, True, device)
    finally:
        harness.profiled = plain
    traced = kept[0] if kept else None
    reading = harness.Reading(cell, 0.0, None, None)
    reading.traced = traced
    checks = result.pop("checks")
    for name in METRICS:
        mod = harness.load_metric(name)
        value = mod.read(reading)
        if value is not None:
            result["metrics"][name] = {"value": value, "unit": mod.UNIT}
    if traced is not None:
        result["traced"] = summary(traced)
    result["checks"] = checks
    return result
