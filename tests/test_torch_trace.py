"""Spans and counters of the stencil kernels' host path
(``repro_torch.telemetry.host``, ``_build.WORK``), on the CPU, no jax.

Off, the path records nothing and opens no profiler range.  On, each call
of ``stencil2d`` and ``stencil3d`` is a tree of spans with one call id; a
"fake card" (the wrappers' CUDA branch on CPU tensors, the library's entry
points replaced by Python functions) reaches the allocation and launch
spans, the work tally and the clock buffer.  The work formulas beside K3
and K4 are held to a brute enumeration of the kernels' own loops.  The
trace exporter puts host spans in a process of their own.
"""
import contextlib
import ctypes
import json
import math

import pytest
import torch

from repro_torch.kernels import _build, stencil2d, stencil3d
from repro_torch.kernels.stencil2d import kernel as k3
from repro_torch.kernels.stencil3d import kernel as k4
from repro_torch.telemetry import (Telemetry, host, recording, trace_events,
                                   validate_trace, write_trace)

CY, CX = (0.1, 0.05, 0.6, 0.05, 0.1), (0.1, 0.02, 0.0, 0.02, 0.1)
C3 = (0.1, 0.2, 0.3, 0.2, 0.1)
STAR = ((0.1, 0.2, 0.3, 0.2, 0.1), (0.1, 0.2, 0.0, 0.2, 0.1),
        (0.1, 0.2, 0.0, 0.2, 0.1))


class FakeLib:
    """The entry points K3's and K4's wrappers call, as Python functions.
    A launch records its arguments and, where it is given a clock buffer,
    counts one block in the buffer's first row."""

    def __init__(self):
        self.calls: list[tuple] = []

        def launch(name):
            def fn(*args):
                self.calls.append((name, args))
                clocks = args[-2] if name == "stencil2d" else None
                if clocks:
                    blocks = k3.CLOCK_FIELDS.index("blocks")
                    ctypes.c_int64.from_address(clocks + 8 * blocks).value += 1
                return 0
            return fn

        self.stencil2d_launch = launch("stencil2d")
        self.stencil3d_launch = launch("stencil3d")
        self.stencil2d_taps_bytes = lambda: k3.pack_taps((0.0,), (0.0,)).nbytes
        self.stencil3d_taps_bytes = lambda: k4.pack_taps((0.0,), (0.0,),
                                                         (0.0,)).nbytes
        self.stencil2d_clock_shape = lambda which: (
            len(k3.CLOCK_FIELDS) if which else k3.CLOCK_SLOTS)


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors through the wrappers' card branch."""
    lib = FakeLib()
    monkeypatch.setattr(_build, "on_card", lambda x: True)
    monkeypatch.setattr(_build, "library", lambda name: lib)
    monkeypatch.setattr(_build, "require_smem", lambda *a: None)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    for mod in (k3, k4):
        mod._check_taps_layout.cache_clear()
    yield lib
    for mod in (k3, k4):
        mod._check_taps_layout.cache_clear()


def _tree(tel):
    """(name, parent's name) of every span, in order, and their call ids."""
    spans = tel.spans
    return ([(s["name"], None if s["parent"] is None
              else spans[s["parent"]]["name"]) for s in spans],
            [s["call"] for s in spans])


def _nested(tel):
    for s in tel.spans:
        assert s["dur"] >= 0 and s["cat"] == "host" and s["track"] == "host"
        if s["parent"] is not None:
            p = tel.spans[s["parent"]]
            assert p["t0"] <= s["t0"]
            assert s["t0"] + s["dur"] <= p["t0"] + p["dur"] + 1e-9


def _raise(*a, **k):
    raise AssertionError("a profiler range was opened")


# -- off -------------------------------------------------------------------
def test_off_records_nothing_and_opens_no_range(monkeypatch, fake_card):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    assert host.span("stencil2d") is host._NULL
    assert host.span("stencil2d", prefix="launch.") is host._NULL
    assert host.clock_buffer("k", "cpu", ("a",), 4) is None
    before = dict(_build.LAUNCHES)
    stencil2d(torch.randn(2, 24, 40), CY, CX, block=(8, 32))
    stencil3d(torch.randn(1, 6, 8, 16), *STAR, block=(4, 4, 8))
    assert _build.LAUNCHES["stencil2d"] == before.get("stencil2d", 0) + 1
    assert _build.LAUNCHES.get("stencil2d_clocked", 0) == \
        before.get("stencil2d_clocked", 0)
    # the main instance: no clock buffer passed
    assert fake_card.calls[0][1][-2] is None


def test_off_on_the_cpu_path(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    stencil2d(torch.randn(2, 24, 40), CY, CX, timesteps=2)
    stencil3d(torch.randn(1, 6, 8, 16), C3, C3, C3)
    assert host._current is None


# -- on: the span tree ------------------------------------------------------
def test_stencil2d_span_tree(fake_card):
    tel = Telemetry()
    with recording(tel):
        for _ in range(2):
            stencil2d(torch.randn(2, 24, 40), CY, CX, block=(8, 32))
    names, calls = _tree(tel)
    one = [("stencil2d", None), ("stencil2d.plan", "stencil2d"),
           ("stencil2d.kernel", "stencil2d"),
           ("stencil2d.alloc", "stencil2d.kernel"),
           ("launch.stencil2d", "stencil2d.kernel")]
    assert names == one * 2
    assert len(set(calls[:5])) == len(set(calls[5:])) == 1
    assert calls[0] != calls[5]
    _nested(tel)


def test_stencil3d_span_tree_has_a_wrapper_span_a_step(fake_card):
    tel = Telemetry()
    with recording(tel):
        stencil3d(torch.randn(1, 6, 8, 16), *STAR, timesteps=3,
                  block=(4, 4, 8))
    names, calls = _tree(tel)
    sweep = [("stencil3d.kernel", "stencil3d"),
             ("stencil3d.alloc", "stencil3d.kernel"),
             ("launch.stencil3d", "stencil3d.kernel")]
    assert names == ([("stencil3d", None), ("stencil3d.plan", "stencil3d")]
                     + sweep * 3)
    assert len(set(calls)) == 1
    _nested(tel)


def test_cpu_path_spans_stop_at_the_wrapper():
    """On a CPU tensor the wrapper runs the plain version: no allocation or
    launch span, and nothing launched."""
    tel = Telemetry()
    before = dict(_build.LAUNCHES)
    with recording(tel, clocks=True) as rec:
        stencil2d(torch.randn(2, 24, 40), CY, CX)
    assert _tree(tel)[0] == [("stencil2d", None),
                             ("stencil2d.plan", "stencil2d"),
                             ("stencil2d.kernel", "stencil2d")]
    assert dict(_build.LAUNCHES) == before and rec.clocks == {}


def test_a_failing_call_closes_its_spans(fake_card):
    tel = Telemetry()
    with recording(tel), pytest.raises(ValueError):
        stencil2d(torch.randn(2, 24, 40), CY, CX, block=(8, 12))
    assert host._current is None
    assert [s["name"] for s in tel.spans] == ["stencil2d", "stencil2d.plan",
                                              "stencil2d.kernel"]
    _nested(tel)


def test_ranges_nest_the_same_names_under_the_profiler(fake_card):
    from torch.profiler import ProfilerActivity, profile
    tel = Telemetry()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recording(tel, ranges=True):
            stencil2d(torch.randn(2, 24, 40), CY, CX, block=(8, 32))
            stencil3d(torch.randn(1, 6, 8, 16), *STAR, timesteps=2,
                      block=(4, 4, 8))
    got = [(e.name, e.cpu_parent.name if e.cpu_parent else None)
           for e in prof.events()
           if e.name.split(".")[0] in ("stencil2d", "stencil3d", "launch")]
    assert sorted(got) == sorted(_tree(tel)[0])


def test_recordings_nest_and_restore():
    outer, inner = Telemetry(), Telemetry()
    with recording(outer):
        with recording(inner):
            stencil2d(torch.randn(1, 16, 16), CY, CX)
        stencil2d(torch.randn(1, 16, 16), CY, CX)
    assert len(inner.spans) == len(outer.spans) == 3
    assert host._current is None


# -- the work tally and the clocked instance ---------------------------------
def test_launches_add_their_work(fake_card):
    was = list(_build.WORK.get("stencil2d", [0, 0, 0]))
    stencil2d(torch.randn(3, 40, 72), CY, CX, timesteps=2, block=(16, 32))
    ops, nbytes = k3.stencil2d_work(3, 40, 72, 2, 2, 2, 16, 32, 4, 9)
    assert _build.WORK["stencil2d"] == [was[0] + 1, was[1] + ops,
                                        was[2] + nbytes]
    w3 = list(_build.WORK.get("stencil3d", [0, 0, 0]))
    stencil3d(torch.randn(2, 9, 10, 24), *STAR, timesteps=2, block=(4, 4, 8))
    ops, nbytes = k4.stencil3d_work(2, 9, 10, 24, 2, 2, 2, 4, 4, 8, 4, True, 13)
    assert _build.WORK["stencil3d"] == [w3[0] + 2, w3[1] + 2 * ops,
                                        w3[2] + 2 * nbytes]
    assert _build.launch_work()["stencil3d"]["bytes"] == \
        _build.WORK["stencil3d"][2]


def test_clocks_launch_the_clocked_instance_and_read_once(fake_card):
    before = dict(_build.LAUNCHES)
    tel = Telemetry()
    with recording(tel, clocks=True) as rec:
        for _ in range(3):
            stencil2d(torch.randn(2, 24, 40), CY, CX, block=(8, 32))
        assert rec.clocks == {}        # nothing read inside the calls
    assert _build.LAUNCHES.get("stencil2d", 0) == before.get("stencil2d", 0)
    assert _build.LAUNCHES["stencil2d_clocked"] == \
        before.get("stencil2d_clocked", 0) + 3
    assert [s["name"] for s in tel.spans].count("launch.stencil2d_clocked") == 3
    ptrs = {args[-2] for _, args in fake_card.calls}
    assert len(ptrs) == 1 and None not in ptrs   # one persistent buffer
    assert rec.clocks == {"stencil2d_clocked": dict(
        dict.fromkeys(k3.CLOCK_FIELDS, 0), blocks=3)}


def test_work_counters_reset():
    _build.WORK["x"] = [1, 2, 3]
    _build.reset_work()
    assert _build.WORK == {} and _build.launch_work() == {}


# -- the work formulas against the kernels' loops ----------------------------
def _k3_brute(b, ny, nx, ry, rx, t, by, bx, itemsize, taps, vec):
    """stencil2d.cu's loads, micro-tiles and stores, tile by tile."""
    hy, hx = ry * t, rx * t
    px = k3._pad8(hx)
    cb = (8 if t > 1 else 0) + px
    h0 = by + 2 * hy
    loaded = stored = micro = 0
    for y0 in range(0, ny, by):
        for x0 in range(0, nx, bx):
            for i in range(h0):
                gy = y0 - hy + i
                row_in = 0 <= gy < ny
                for c in range((bx + 2 * px) // 8):
                    gx = x0 - px + 8 * c
                    in_grid = row_in and gx >= 0 and gx + 8 <= nx
                    if vec and (in_grid or not row_in or gx < 0 or gx >= nx):
                        loaded += 8 * itemsize if in_grid else 0
                    else:
                        loaded += itemsize * sum(
                            row_in and 0 <= gx + e < nx for e in range(8))
            for s in range(1, t + 1):
                r_lo, r_hi = ry * s, h0 - ry * s
                c_lo, c_hi = (cb - hx + rx * s) & ~3, cb + bx + hx - rx * s
                for my in range(math.ceil((r_hi - r_lo) / 8)):
                    for mxi in range(math.ceil((c_hi - c_lo) / 4)):
                        gy0 = y0 + r_lo + 8 * my - hy
                        gx = x0 + c_lo + 4 * mxi - cb
                        if s == t and (gy0 >= ny or gx >= nx):
                            continue
                        micro += 1
                        if s == t:
                            stored += itemsize * sum(
                                gy0 + o < ny and gx + e < nx
                                for o in range(8) for e in range(4))
    return b * micro * 32 * taps, b * (loaded + stored)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("ny,nx,ry,rx,t,by,bx", [
    (24, 40, 1, 1, 1, 8, 32), (37, 70, 2, 3, 1, 16, 32),
    (449, 200, 12, 12, 1, 128, 128), (100, 130, 12, 12, 2, 16, 64),
    (33, 57, 3, 1, 4, 8, 32), (64, 96, 1, 2, 3, 32, 64),
    (9, 10, 5, 5, 1, 8, 8), (150, 333, 12, 12, 4, 16, 128)])
def test_k3_work_equals_its_loops(ny, nx, ry, rx, t, by, bx, itemsize):
    want = _k3_brute(2, ny, nx, ry, rx, t, by, bx, itemsize, 7, vec=1)
    assert k3.stencil2d_work(2, ny, nx, ry, rx, t, by, bx, itemsize, 7) == want
    assert _k3_brute(2, ny, nx, ry, rx, t, by, bx, itemsize, 7, vec=0) == want


def test_k3_work_of_the_seismic_cell():
    """(128, 128) tiles of a 449 x 960 shot load 521 x 1,184 points for
    431,040: 1.43x, and 2.43x with the store.  They sum 456 x 960 points,
    the micro-tiles that start inside the grid, 49 taps each."""
    ops, nbytes = k3.stencil2d_work(1, 449, 960, 12, 12, 1, 128, 128, 4, 49)
    assert nbytes == (521 * 1184 + 449 * 960) * 4
    assert ops == (3 * 128 + 9 * 8) * 960 * 49


def _k4_brute(b, nz, ny, nx, rz, ry, rx, bz, by, bx, itemsize, queued, taps,
              vec):
    """stencil3d.cu's ring loads, the queue's own loads, the columns each
    thread computes at each plane, and its stores, tile by tile."""
    e_ = 16 // itemsize
    px = -(-rx // e_) * e_
    h, w = by + 2 * ry, bx + 2 * px
    nslots = (rz if queued else 2 * rz) + 1 + k4.AHEAD
    loaded = stored = points = 0
    for z0 in range(0, nz, bz):
        z1 = min(z0 + bz, nz)
        for y0 in range(0, ny, by):
            for x0 in range(0, nx, bx):
                def issue(z):
                    n = 0
                    for i in range(h):
                        gy = y0 - ry + i
                        row_in = 0 <= z < nz and 0 <= gy < ny
                        for c in range(w // e_):
                            gx = x0 - px + e_ * c
                            in_grid = row_in and gx >= 0 and gx + e_ <= nx
                            if vec and (in_grid or not row_in or gx < 0
                                        or gx >= nx):
                                n += e_ if in_grid else 0
                            else:
                                n += sum(row_in and 0 <= gx + e < nx
                                         for e in range(e_))
                    return n
                zlo = z0 - (0 if queued else rz)
                for s in range(nslots - 1):
                    if zlo + s < z1 + rz:
                        loaded += issue(zlo + s)
                if queued:
                    for k in range(rz):
                        z = z0 - rz + k
                        loaded += sum(0 <= z < nz and gy < ny and gx < nx
                                      for gy in range(y0, y0 + by)
                                      for gx in range(x0, x0 + bx))
                for z in range(z0, z1):
                    if z + k4.AHEAD < z1:
                        loaded += issue(z + rz + k4.AHEAD)
                    points += by * bx
                    stored += sum(gy < ny and gx < nx
                                  for gy in range(y0, y0 + by)
                                  for gx in range(x0, x0 + bx))
    return b * points * taps, b * (loaded + stored) * itemsize


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("queued", [True, False])
@pytest.mark.parametrize("nz,ny,nx,rz,ry,rx,bz,by,bx", [
    (16, 16, 40, 1, 1, 1, 8, 8, 16), (37, 19, 70, 2, 2, 2, 32, 8, 32),
    (9, 10, 24, 2, 1, 3, 4, 4, 8), (33, 13, 40, 3, 1, 2, 32, 12, 16),
    (3, 20, 64, 2, 2, 2, 32, 16, 64), (12, 9, 33, 4, 2, 5, 5, 8, 24)])
def test_k4_work_equals_its_loops(nz, ny, nx, rz, ry, rx, bz, by, bx, queued,
                                  itemsize):
    args = (2, nz, ny, nx, rz, ry, rx, bz, by, bx, itemsize, queued, 11)
    want = _k4_brute(*args, vec=1)
    assert k4.stencil3d_work(*args) == want
    assert _k4_brute(*args, vec=0) == want


# -- the exporter ------------------------------------------------------------
def test_host_spans_export_as_their_own_process(tmp_path, fake_card):
    tel = Telemetry()
    tel.span("eval abc", cat="tuner", track="search/ideal", t0=0.0, dur=1e-3)
    with recording(tel):
        stencil2d(torch.randn(2, 24, 40), CY, CX, block=(8, 32))
    evs = trace_events(tel)
    procs = {e["pid"]: e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert procs == {1: "tuner", 3: "host"}
    host_x = [e for e in evs if e["ph"] == "X" and e["pid"] == 3]
    assert len(host_x) == 5 and all(e["cat"] == "host" for e in host_x)
    root = next(e for e in host_x if e["name"] == "stencil2d")
    assert root["args"]["parent"] is None
    plan = next(e for e in host_x if e["name"] == "stencil2d.plan")
    assert tel.spans[plan["args"]["parent"]]["name"] == "stencil2d"
    assert {e["args"]["call"] for e in host_x} == {root["args"]["call"]}
    tuner = [e for e in evs if e["ph"] == "X" and e["pid"] == 1]
    assert len(tuner) == 1 and "call" not in tuner[0]["args"]
    path = tmp_path / "host.trace.json"
    write_trace(tel, str(path))
    assert validate_trace(json.loads(path.read_text())) == 6


def test_a_host_only_trace_has_no_tuner_process():
    tel = Telemetry()
    with recording(tel):
        stencil3d(torch.randn(1, 6, 8, 16), C3, C3, C3)
    names = {e["args"]["name"] for e in trace_events(tel)
             if e["name"] == "process_name"}
    assert names == {"host"}
