"""K3's share of a block's time spent loading its tile: the clocked
instance of csrc/stencil2d.cu over the traced pass, thread 0's cycles up to
"the tile is in shared memory" (issuing its loads, then the wait and the
barrier) over its cycles up to its last store, summed over blocks
(bench/program_trace.py)."""
UNIT = "%"


def read(r):
    t = getattr(r, "traced", None)
    c = t.clocks.get("stencil2d_clocked") if t else None
    total = sum(c[p] for p in ("issue", "wait", "sum", "store")) if c else 0
    return 100.0 * (c["issue"] + c["wait"]) / total if total else None
