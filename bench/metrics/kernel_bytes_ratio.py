"""Bytes the kernels moved over the bytes the steps need: the program's
per-launch work tally (repro_torch.kernels._build.WORK: each tile's
haloed loads as the kernel lays them out, clipped to the grid, and the
stores) over the traced pass, over each call's fields read once and
written once (bench/yardstick.py's bytes rule; at T = 1, once a step)."""
import math

from bench.yardstick import ITEMSIZE

UNIT = "x"


def read(r):
    t = getattr(r, "traced", None)
    moved = sum(w[2] for w in t.work.values()) if t else 0
    if not moved or not t.calls:
        return None
    need = 2 * math.prod(r.cell.shape) * ITEMSIZE[r.cell.config["dtype"]]
    return moved / (need * t.calls)
