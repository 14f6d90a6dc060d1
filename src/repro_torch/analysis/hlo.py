"""HLO post-compile analysis: collective-byte accounting (port of
``repro.analysis.hlo``; pure text, the same results on the same text).

XLA's ``cost_analysis()`` gives flops/bytes but not collective traffic, so
the reference's dry run parses the *optimized* (SPMD-partitioned,
per-device) HLO text and sums the result shapes of every collective op.
Convention: the per-device wire bytes of one op are approximated by its
result-shape bytes (all-gather: received bytes; all-reduce/permute/
all-to-all: payload; reduce-scatter: its result is the post-scatter shard,
multiply by participants to approximate the ring traffic).  Global
collective_bytes = per-device bytes x chips.  The port compiles no HLO: its
dry run (``launch/dryrun.py``) counts its own collectives under the same op
names and convention; these functions read HLO text from elsewhere, such
as the reference's dumps.
"""
from __future__ import annotations

import re
from collections import defaultdict

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"\b(pred|bf16|f16|f32|f64|s8|u8|s16|u16|s32|u32|s64|u64|c64|c128)\[([0-9,]*)\]")
_OP_RE = re.compile(
    r"=\s*(?:\(([^)]*)\)|(" + "|".join(
        re.escape(d) for d in _DTYPE_BYTES) + r")\[([0-9,]*)\][^=]*?)\s+"
    r"(" + "|".join(_COLLECTIVES) + r")(?:-start|-done)?\(")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims.strip():
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


def collective_bytes(hlo_text: str) -> dict:
    """Returns {'total_bytes': per-device bytes, 'by_op': {op: bytes},
    'counts': {op: n}}."""
    by_op: dict[str, int] = defaultdict(int)
    counts: dict[str, int] = defaultdict(int)
    for line in hlo_text.splitlines():
        line = line.strip()
        hit = None
        for op in _COLLECTIVES:
            if f" {op}(" in line or f" {op}-start(" in line:
                hit = op
                break
        if hit is None:
            continue
        if hit == "all-reduce" and "all-reduce-done" in line:
            continue            # -done carries the same shape as -start
        if "-done(" in line:
            continue
        # result type = everything before the '=' is the name; shapes after
        lhs, _, rhs = line.partition("=")
        shapes = _SHAPE_RE.findall(rhs.split("(", 1)[0])
        if not shapes:          # tuple results keep shapes inside parens
            head = rhs.split(hit)[0]
            shapes = _SHAPE_RE.findall(head)
        b = sum(_shape_bytes(dt, dims) for dt, dims in shapes)
        by_op[hit] += b
        counts[hit] += 1
    return {"total_bytes": int(sum(by_op.values())),
            "by_op": dict(by_op), "counts": dict(counts)}


def remat_duplication(hlo_text: str) -> float:
    """Rough remat-waste probe: ratio of fusion/dot ops to unique ones by
    name stem (§Perf hint: count duplicate op names)."""
    names = re.findall(r"%([a-zA-Z0-9_.-]+) = ", hlo_text)
    dots = [n for n in names if n.startswith(("dot", "fusion", "convolution"))]
    stems = set(re.sub(r"[.\d]+$", "", n) for n in dots)
    return len(dots) / max(len(stems), 1)
