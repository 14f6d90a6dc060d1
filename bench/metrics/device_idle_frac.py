"""The device's idle share of the traced chunks' wall time: one less the
seconds in which an operation ran on the card (the profiler's device
events, merged) over the chunks' wall time."""
UNIT = "%"


def read(r):
    p = r.profile
    if p is None or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.wall_s)
