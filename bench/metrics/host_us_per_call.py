"""The host's time in the op per call: planning, dispatch and launch, from
the benchmark's span around each call in the traced run's window outside
the profiler (kernels/stencil{2,3}d/ops.py and what they call)."""
UNIT = "us"


def read(r):
    spans = r.window.call_s
    return 1e6 * sum(spans) / len(spans) if spans else None
