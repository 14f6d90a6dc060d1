"""The kernel wrappers per call: the program's ``stencil{2,3}d.kernel``
spans (checks, taps, shared memory, the output's allocation and the launch;
kernels/stencil{2,3}d/kernel.py and _build.launch), all T of them a 3D
call, over the calls of the traced pass (bench/program_trace.py)."""
UNIT = "us"


def read(r):
    t = getattr(r, "traced", None)
    s = t.seconds(".kernel") if t and t.calls else None
    return None if s is None else 1e6 * s / t.calls
