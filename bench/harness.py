"""One run of one cell of the port's benchmark.

A cell (``workloads/<name>.json``) names a configuration
(``configs/<name>.json``: the grid, the radii, the type, the port's public
op) and a traffic mix (``traffic/<name>.json``: the fields propagated
together, the steps a call, the calls a chunk, what is compared), the
per-layer metrics it reports (``metrics/<name>.py``, one reader each) and
the limits of its comparison.  The harness finds each by name; a new cell
or metric is new files.

The loop is one closed stream: the op is called on the cell's fields, each
output the next call's input.  After every call the receiver line of every
field (the shallowest plane a call writes along the first grid axis, at
depth ``r * timesteps``) is gathered into a buffer on the device; after
every chunk of calls that buffer is copied to the host, and the copy ends
in a synchronise, which the host waits on once it has issued the next
chunk.  A chunk is the system's request; its latency runs on the card's
timeline from its first call's start to the end of its copy.  The window
runs from the first call's issue to the end of the last chunk's copy.

Correctness: the first chunk, whose input the benchmark made, and chunks
drawn from the seed at shares of the window are compared on a sample of
their fields drawn from the seed, whose inputs and outputs are copied
aside as the chunk runs.  After the window the plain reference
(:mod:`bench.reference`, in float64) works each sampled field through the
chunk's calls again from its input; the program's output and every
receiver line recorded for it in the chunk are judged by the widest gap.
The last line a chunk recorded must equal the plane of the output it was
copied from, and the line recorded by the chunk before must equal the
plane of the held chunk's input, which links the held chunk to the stream.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import torch

from bench import inputs, reference, yardstick

HERE = Path(__file__).resolve().parent
FOREIGN = ("jax", "jaxlib", "flax", "repro")
_IMPORTED = time.perf_counter()


def load(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise ValueError(f"no file for {name!r} in {kind}/ ({path})")
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    spec: dict        # the cell's own file

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.traffic["batch"], *self.config["grid"])

    @property
    def timesteps(self) -> int:
        return self.traffic["timesteps"]

    @property
    def calls(self) -> int:
        """Calls in a chunk."""
        return self.traffic["calls_per_chunk"]

    @property
    def receiver(self) -> tuple[int, int]:
        """(axis, index) of the receiver plane: the first grid axis, at the
        shallowest depth a call writes."""
        nd = len(self.config["grid"])
        return -nd, self.config["radii"][0] * self.timesteps


def load_cell(name: str, grid=None, batch: int | None = None) -> Cell:
    """The cell ``name`` with its configuration and traffic; ``grid`` and
    ``batch`` replace the sizes (the tests' small runs)."""
    spec = load("workloads", name)
    config, traffic = load("configs", spec["config"]), load("traffic", spec["traffic"])
    if grid is not None:
        config = {**config, "grid": list(grid)}
    if batch is not None:
        traffic = {**traffic, "batch": batch}
    return Cell(name, config, traffic, spec)


def load_metric(name: str):
    """The reader module ``metrics/<name>.py``: ``UNIT`` and ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + "".join(c if c.isalnum() else "_" for c in name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def op_of(config: dict):
    """The port's public op that the configuration names, looked up when a
    run starts."""
    mod = importlib.import_module(config["op"]["module"])
    return getattr(mod, config["op"]["function"])


def launch_count() -> int:
    """Launches the program has counted (``_build.LAUNCHES``), all kernels."""
    from repro_torch.kernels import _build
    return sum(_build.LAUNCHES.values())


def process_age() -> float:
    """Seconds since this process started."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


def foreign_modules() -> list[str]:
    """Loaded modules of jax, jaxlib, flax or the JAX package, compared by
    whole top-level names."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)


class EventClock:
    """Marks on the card's own timeline (CUDA events)."""

    def mark(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wait(self, mark) -> None:
        mark.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b)


class HostClock:
    """Marks on the host's clock, for a run on the CPU (the tests)."""

    def mark(self):
        return time.perf_counter()

    def wait(self, mark) -> None:
        pass

    def ms(self, a, b) -> float:
        return (b - a) * 1e3


@dataclasses.dataclass
class Held:
    """The sampled fields of a chunk held for the comparison."""
    fields: list[int]                  # their places in the batch
    x_in: torch.Tensor
    x_out: torch.Tensor
    line_before: torch.Tensor | None   # the last line the chunk before recorded
    lines: torch.Tensor                # every line this chunk recorded


@dataclasses.dataclass
class Window:
    wall_s: float
    calls: int
    chunk_ms: list[float]
    call_s: list[float]        # host span of each call, where recorded
    launches: int
    held: list[Held]


class Loop:
    """The cell's stream of calls on one device.  The loop holds the
    stream's field (``x``) and no one else does, so that only a call's
    input and output are alive on the device at once."""

    def __init__(self, cell: Cell, taps, x: torch.Tensor):
        self.cell, self.taps, self.x = cell, taps, x
        self.op = op_of(cell.config)
        on_card = x.device.type == "cuda"
        self.clock = EventClock() if on_card else HostClock()
        self.axis, self.index = cell.receiver
        plane = x.select(self.axis, self.index)
        shape = (cell.calls, *plane.shape)
        self.record = torch.empty(shape, dtype=x.dtype, device=x.device)
        # three, so that a chunk's lines and the last of the one before are
        # whole while the next chunk's copy is in flight
        self.lines = [torch.empty(shape, dtype=x.dtype, pin_memory=on_card)
                      for _ in range(3)]
        self.spare: list[tuple] = []

    def reserve(self, sample: list[list[int]]) -> None:
        """Room on the device for the inputs and outputs of the fields
        ``sample`` names, one entry a held chunk, taken before the window
        so that holding them allocates nothing inside it."""
        x = self.x
        self.spare = [(fields, torch.tensor(fields, device=x.device),
                       x.new_empty((len(fields), *x.shape[1:])),
                       x.new_empty((len(fields), *x.shape[1:])))
                      for fields in sample]

    def call(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x, *self.taps, timesteps=self.cell.timesteps)

    def chunk(self, k: int, call_s: list | None, annotate: bool):
        """Issue one chunk of calls on the stream's field, each call's
        receiver line gathered, then the copy of the lines to the host;
        its start and end marks.  Nothing here waits for the card."""
        span = (torch.profiler.record_function if annotate
                else lambda _: contextlib.nullcontext())
        start = self.clock.mark()
        with span("bench.issue"):
            for i in range(self.cell.calls):
                if call_s is None:
                    self.x = self.call(self.x)
                else:
                    h = time.perf_counter()
                    self.x = self.call(self.x)
                    call_s.append(time.perf_counter() - h)
                self.record[i].copy_(self.x.select(self.axis, self.index))
            self.lines[k % 3].copy_(self.record, non_blocking=True)
        return start, self.clock.mark()

    def run(self, *, seconds: float | None = None, chunks: int | None = None,
            hold_at: list[float] | None = None, call_s: list | None = None,
            annotate: bool = False) -> Window:
        """Chunks until ``chunks`` are issued or ``seconds`` have passed, then
        until the last is done.  The host issues each chunk while the card
        runs the one before, then waits for that one's copy: so the card
        does not wait for the host, and each copy ends in a synchronise.
        With ``hold_at`` (seconds into the window) the first chunk and the
        first chunk to start at or after each time are held, the fields and
        the room :meth:`reserve` took for each in turn."""
        span = (torch.profiler.record_function if annotate
                else lambda _: contextlib.nullcontext())
        pending = list(hold_at or ())
        marks, held, holds = [], [], {}
        launches = launch_count()
        t0 = time.perf_counter()

        def finish(j: int) -> None:
            with span("bench.receiver"):
                self.clock.wait(marks[j][1])
            if j in holds:
                fields, x_in, x_out = holds.pop(j)
                before = self.lines[(j - 1) % 3][-1, fields].clone() if j else None
                held.append(Held(fields, x_in, x_out, before,
                                 self.lines[j % 3][:, fields].clone()))

        k = 0
        while True:
            late = time.perf_counter() - t0
            hold = (hold_at is not None and len(holds) + len(held) < len(self.spare)
                    and (k == 0 or bool(pending and late >= pending[0])))
            while pending and late >= pending[0]:
                pending.pop(0)
            if hold:
                fields, where, x_in, x_out = self.spare[len(holds) + len(held)]
                torch.index_select(self.x, 0, where, out=x_in)
            marks.append(self.chunk(k, call_s, annotate))
            if hold:
                torch.index_select(self.x, 0, where, out=x_out)
                holds[k] = (fields, x_in, x_out)
            if k:
                finish(k - 1)
            k += 1
            if ((chunks is not None and k >= chunks)
                    or (seconds is not None and time.perf_counter() - t0 >= seconds)):
                break
        finish(k - 1)
        wall = time.perf_counter() - t0
        return Window(wall, k * self.cell.calls,
                      [self.clock.ms(s, e) for s, e in marks],
                      call_s if call_s is not None else [],
                      launch_count() - launches, held)


@dataclasses.dataclass
class Profile:
    """The traced chunks: their wall time, calls and device operations."""
    wall_s: float
    calls: int
    kernels: dict[str, list]          # name -> [device seconds, count]
    busy_s: float
    gaps: list[list]

    def kernel_s(self, word: str) -> float:
        return sum(s for name, (s, _) in self.kernels.items() if word in name)


def profiled(loop: Loop, chunks: int) -> Profile:
    """``chunks`` chunks under ``torch.profiler``, each chunk's issue and
    receiver copy in a range of its own."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        win = loop.run(chunks=chunks, annotate=True)
    events = prof.events()
    kernels = yardstick.device_ops(events)
    intervals = yardstick.device_intervals(events)
    spans = [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
             for e in events if e.name in ("bench.issue", "bench.receiver")
             and e.device_type.name == "CPU"]
    gaps = yardstick.idle_gaps(intervals, spans)
    busy = sum(e - s for s, e in intervals)
    return Profile(win.wall_s, win.calls, kernels, busy, gaps)


@dataclasses.dataclass
class Reading:
    """What a per-layer reader reads: the cell, the least time of one call,
    the window outside the profiler and the traced chunks."""
    cell: Cell
    least_call_s: float
    window: Window
    profile: Profile | None


def roofline_share(r: Reading, kernel: str) -> float | None:
    """Percent of the least time the traced calls could take that the
    kernels named ``kernel`` took on the device; None where none ran."""
    if r.profile is None:
        return None
    took = r.profile.kernel_s(kernel)
    if took <= 0:
        return None
    return 100.0 * r.least_call_s * r.profile.calls / took


def p95(values: list[float]) -> float:
    """The 95th percentile by nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def compare(cell: Cell, taps, held: list[Held],
            limits: dict) -> tuple[dict[str, float], int]:
    """The widest gap of the held fields' outputs and receiver lines from
    the reference's, the receiver values that differ from the planes they
    were copied from, and how many held chunks fail a limit."""
    worst, diffs, failed = 0.0, 0, 0
    axis, index = cell.receiver
    for h in held:
        want, planes = reference.star_chunk(h.x_in.double(), taps, cell.timesteps,
                                            cell.calls, axis, index)
        g = max(reference.gap(h.x_out, want),
                reference.gap(h.lines.to(want.device), planes))
        del want, planes
        pairs = [(h.lines[-1], h.x_out)] + ([(h.line_before, h.x_in)]
                                            if h.line_before is not None else [])
        d = sum(int((line != field.select(axis, index).cpu()).sum())
                for line, field in pairs)
        failed += int(g > limits["chunk_err"] or d > limits["receiver_diffs"])
        worst, diffs = max(worst, g), diffs + d
    return {"chunk_err": worst, "receiver_diffs": float(diffs)}, failed


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, dtype: str | None = None) -> dict:
    """One run: set-up, the window, the traced chunks where ``trace``, then
    the comparison.  Returns the result line; its last key, ``checks``,
    holds each number compared beside its limit."""
    dtype = dtype or cell.config["dtype"]
    taps = inputs.star_taps(cell.config["grid"], cell.config["radii"],
                            cell.config["spectral_radius"],
                            cell.config["taps_seed"])
    traffic = cell.traffic

    def make() -> torch.Tensor:
        return inputs.fields(cell.shape, getattr(torch, dtype), seed, device)

    loop = Loop(cell, taps, make())
    loop.reserve(inputs.check_sample(seed, cell.shape[0], traffic["check_chunks"],
                                     traffic["check_fields"]))
    # warm-up holds its first chunk too, so that the window's holds find
    # their kernels loaded
    loop.run(chunks=traffic["warmup_chunks"], hold_at=[])
    # the window starts again from the fields the benchmark made
    loop.x = None
    loop.x = make()
    setup_s = process_age()

    hold_at = [f * seconds for f in
               inputs.check_fractions(seed, traffic["check_chunks"] - 1)]
    win = loop.run(seconds=seconds, hold_at=hold_at,
                   call_s=[] if trace else None)
    prof = profiled(loop, traffic["profile_chunks"]) if trace else None
    loop.x = None
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"

    limits = cell.spec["limits"]
    t_check = time.perf_counter()
    checks, failed = compare(cell, taps, win.held, limits)
    check_s = time.perf_counter() - t_check
    points = math.prod(cell.shape)
    if trace:
        least, _ = yardstick.least_call(cell.shape, dtype, taps, cell.timesteps,
                                        yardstick.part_of(kind))
        reading = Reading(cell, least, win, prof)
        metrics = {}
        for name in cell.spec["per_layer"]:
            mod = load_metric(name)
            value = mod.read(reading)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
    else:
        metrics = {
            "gpts_per_s": {"value": points * win.calls * cell.timesteps
                           / win.wall_s / 1e9, "unit": "Gpts/s"},
            "chunk_ms_p95": {"value": p95(win.chunk_ms), "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": peak}
    result = {"correct": failed == 0 and len(win.held) > 0,
              "attempted": len(win.chunk_ms), "failed": failed,
              "metrics": metrics, "device": dev, "check_s": check_s,
              "window": {"seconds": win.wall_s, "steps": win.calls * cell.timesteps,
                         "chunk_ms_median": sorted(win.chunk_ms)[len(win.chunk_ms) // 2],
                         "chunk_ms_max": max(win.chunk_ms),
                         "chunk_ms_first": win.chunk_ms[:3]}}
    if trace:
        dev["busy_s"], dev["window_s"] = prof.busy_s, prof.wall_s
        ops = sorted(prof.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        result["breakdown"] = {"device_ops": [[n[:120], s] for n, (s, _) in ops],
                               "idle_gaps": prof.gaps}
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in checks.items()}
    return result


def check_lines(checks: dict) -> list[str]:
    return [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
            for k, c in checks.items()]
