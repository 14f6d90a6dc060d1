"""Spans and clocks of the kernels' host path, recorded only inside
:func:`recording`.

The stencil ops (``kernels/stencil{2,3}d/ops.py``), their kernel wrappers
and ``kernels/_build.launch`` open a span at each layer boundary::

    stencil2d                      the public op, one call
      stencil2d.plan               taps, backend, reshape, the tile's plan
      stencil2d.kernel             the wrapper (T of them a 3D call)
        stencil2d.alloc            the output's torch.empty_like
        launch.stencil2d           _build.launch, named by its kernel

With no recording installed a span site costs one global lookup and
returns a shared null context: nothing is allocated or recorded, no
profiler range is opened and no clocked kernel runs.  Inside
``recording(sink)`` each span appends a record to the
:class:`~repro_torch.telemetry.Telemetry` sink (``Telemetry.span``, track
``"host"``) with its start and duration on the sink's :meth:`now` clock,
the index in ``sink.spans`` of its parent span (``None`` for a root) and
the id of the public-op call it belongs to, which every span of one call
shares.  ``ranges=True`` also opens a ``torch.profiler.record_function``
range of the same name around each span, so the spans sit on the
profiler's clock beside the device's events; ``clocks=True`` makes the
wrappers that have a clocked instance launch it (:func:`clock_buffer`).
"""
from __future__ import annotations

import contextlib
import itertools

__all__ = ["recording", "span", "clock_buffer", "Recording"]

_NULL = contextlib.nullcontext()
_CALLS = itertools.count(1)            # public-op call ids, unique a process
_current: Recording | None = None


class Recording:
    """What one :func:`recording` installs: the sink, its switches, the
    stack of open spans and the clocked kernels' device buffers.
    ``clocks`` holds each buffer's sums once the recording has ended."""

    def __init__(self, sink, ranges: bool, clocked: bool):
        self.sink, self.ranges, self.clocked = sink, ranges, clocked
        self.stack: list[tuple[int, int]] = []  # open spans: (index, call)
        # (kernel, device) -> (buffer, its fields)
        self.buffers: dict[tuple, tuple] = {}
        self.clocks: dict[str, dict[str, int]] = {}

    def finish(self) -> None:
        """Read every clock buffer once, summed over its slots."""
        for (kernel, _), (buf, fields) in self.buffers.items():
            acc = self.clocks.setdefault(kernel, dict.fromkeys(fields, 0))
            for name, v in zip(fields, buf.sum(0).tolist()):
                acc[name] += int(v)
        self.buffers.clear()


class _Span:
    __slots__ = ("rec", "name", "record", "range")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self) -> dict:
        rec, sink = self.rec, self.rec.sink
        parent, call = rec.stack[-1] if rec.stack else (None, next(_CALLS))
        self.record = sink.span(self.name, cat="host", track="host")
        self.record["parent"], self.record["call"] = parent, call
        rec.stack.append((len(sink.spans) - 1, call))
        self.range = None
        if rec.ranges:
            import torch.profiler
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        return self.record

    def __exit__(self, *exc) -> bool:
        if self.range is not None:
            self.range.__exit__(*exc)
        sink = self.rec.sink
        self.record["dur"] = sink.now() - self.record["t0"]
        self.rec.stack.pop()
        return False


def span(name: str, prefix: str = ""):
    """A span named ``prefix + name`` inside a recording, else the shared
    null context (the name is joined only when recording)."""
    rec = _current
    if rec is None:
        return _NULL
    return _Span(rec, prefix + name if prefix else name)


def clock_buffer(kernel: str, device, fields: tuple[str, ...], slots: int):
    """The persistent int64 ``(slots, len(fields))`` buffer that a clocked
    instance of ``kernel`` adds into on ``device``, made zero on first use;
    None unless a recording asked for ``clocks``.  Read once, when the
    recording ends, into ``Recording.clocks[kernel]``."""
    rec = _current
    if rec is None or not rec.clocked:
        return None
    key = (kernel, str(device))
    if key not in rec.buffers:
        import torch
        rec.buffers[key] = (torch.zeros((slots, len(fields)), dtype=torch.int64,
                                        device=device), tuple(fields))
    return rec.buffers[key][0]


@contextlib.contextmanager
def recording(sink, *, ranges: bool = False, clocks: bool = False):
    """Record the kernels' host spans into ``sink`` (a
    :class:`~repro_torch.telemetry.Telemetry`) while the block runs;
    yields the :class:`Recording`.  ``ranges``: a profiler range around
    each span, for a run under ``torch.profiler``.  ``clocks``: the
    clocked instances where a wrapper has one, counted under their own
    kernel names; their buffers are read when the block ends."""
    global _current
    rec = Recording(sink, ranges, clocks)
    prev, _current = _current, rec
    try:
        yield rec
    finally:
        _current = prev
        rec.finish()
