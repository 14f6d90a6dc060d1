"""The output's allocation per call: the program's ``stencil{2,3}d.alloc``
spans (the wrappers' torch.empty_like) over the calls of the traced pass
(bench/program_trace.py)."""
UNIT = "us"


def read(r):
    t = getattr(r, "traced", None)
    s = t.seconds(".alloc") if t and t.calls else None
    return None if s is None else 1e6 * s / t.calls
