"""The op's planning per call: the program's ``stencil{2,3}d.plan`` spans
(taps, backend, reshape, the tile's plan; kernels/stencil{2,3}d/ops.py)
over the calls of the traced pass outside the profiler
(bench/program_trace.py)."""
UNIT = "us"


def read(r):
    t = getattr(r, "traced", None)
    s = t.seconds(".plan") if t and t.calls else None
    return None if s is None else 1e6 * s / t.calls
