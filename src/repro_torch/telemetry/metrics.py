"""Benchmark metrics layer, carried over from ``repro.telemetry.metrics``:
fingerprinted records in an append-only history.

The BENCH_*.json snapshots are overwritten in place on every refresh, so by
themselves they hold no trajectory.  This module turns each artifact case
into one **fingerprinted record** and appends it to ``BENCH_history.jsonl``
(one JSON object per line, append-only, committed to the repo), so the perf
trajectory across PRs — and across CI runs inside one PR — is queryable.
Records and fingerprints are the reference's byte for byte, so a history
written by either package reads in the other (the reference's consumers,
``benchmarks/{observatory,bench_diff,overhead_check}.py``, read it too).

Record shape (``HISTORY_VERSION``)::

    {"v": 1, "schema": "bench_pr4/v1", "config": "smoke", "case": "2d",
     "fingerprint": "<sha1/16 of schema+config+case+identity keys>",
     "ts": 1723118400.0, "source": "BENCH_pr4.json",
     "counters": {...integer-valued, deterministic...},
     "walls": {...float-valued, machine-load measurements...},
     "meta": {...identity: grid, workers, bottleneck labels, ...}}

Numeric classification is the same rule ``bench_diff`` uses: ints (non-bool)
are deterministic counters, floats are walls/derived measurements.  Nested
case dicts (the BENCH_pr5 explore artifacts) are flattened into dotted
paths first (:func:`flatten_case`).  The module is stdlib-only so
scripts can import it without the simulator stack.
"""
from __future__ import annotations

import hashlib
import json
import os
import time

__all__ = ["HISTORY_VERSION", "DEFAULT_HISTORY", "flatten_case",
           "fingerprint", "case_records", "append_history", "load_history",
           "history_for", "trend_values", "record_problem"]

HISTORY_VERSION = 1
DEFAULT_HISTORY = "BENCH_history.jsonl"


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def flatten_case(case: dict, prefix: str = "") -> dict:
    """Flatten nested dicts into dotted paths (``best.cycles``); lists and
    scalars are atomic leaves.  Shared with ``bench_diff``'s intersection
    compare so both layers agree on what a "key" is."""
    out: dict = {}
    for k, v in case.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_case(v, f"{path}."))
        else:
            out[path] = v
    return out


def fingerprint(schema: str, config: str, case: str, meta: dict) -> str:
    """Stable identity of one measured case: what it *is*, not what it
    scored.  Two records with equal fingerprints are the same experiment
    and therefore trend-comparable."""
    ident = json.dumps({"schema": schema, "config": config, "case": case,
                        "meta": meta}, sort_keys=True)
    return hashlib.sha1(ident.encode()).hexdigest()[:16]


def case_records(artifact: dict, *, source: str = "",
                 ts: float | None = None) -> list[dict]:
    """One history record per case of a loaded BENCH_*.json artifact."""
    schema = artifact.get("schema", "?")
    config = artifact.get("config", "?")
    ts = time.time() if ts is None else ts
    records = []
    for name in sorted(artifact.get("cases", {})):
        flat = flatten_case(artifact["cases"][name])
        counters = {k: v for k, v in flat.items() if _is_int(v)}
        walls = {k: v for k, v in flat.items()
                 if isinstance(v, float) and not isinstance(v, bool)}
        meta = {k: v for k, v in flat.items()
                if k not in counters and k not in walls}
        ident = {k: meta[k] for k in
                 ("grid", "radii", "workers", "kind", "ops", "engines")
                 if k in meta}
        records.append({
            "v": HISTORY_VERSION, "schema": schema, "config": config,
            "case": name, "fingerprint": fingerprint(schema, config, name,
                                                     ident),
            "ts": round(ts, 3), "source": source,
            "counters": counters, "walls": walls, "meta": meta})
    return records


def append_history(path: str, records: list[dict]) -> int:
    """Append records as JSONL (the file is append-only by convention —
    rewriting it erases the trajectory the trend gate runs on)."""
    if not records:
        return 0
    with open(path, "a") as f:
        for r in records:
            f.write(json.dumps(r, sort_keys=True) + "\n")
    return len(records)


def load_history(path: str) -> list[dict]:
    """All records, in append (= chronological) order.  Blank or
    unparseable lines are skipped — the history must survive a torn
    append, not abort every consumer forever."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "case" in rec:
                out.append(rec)
    return out


def history_for(records: list[dict], schema: str, config: str,
                case: str) -> list[dict]:
    """The trend line for one experiment, chronological order."""
    return [r for r in records
            if r.get("schema") == schema and r.get("config") == config
            and r.get("case") == case]


def trend_values(records: list[dict], key: str, *, last: int | None = None,
                 kind: str = "counters") -> list:
    """The last ``last`` values of one counter/wall along a trend line
    (records missing the key — or carrying a malformed/unknown payload,
    see :func:`record_problem` — are skipped, so schema growth is
    painless)."""
    vals = [r[kind][key] for r in records
            if isinstance(r.get(kind), dict) and key in r[kind]]
    return vals[-last:] if last else vals


def record_problem(rec: dict) -> str | None:
    """Why one history record can't be trended — ``None`` when well-formed.

    The history is append-only and shared by several producers, so
    consumers (observatory report, overhead gate, trend gate) must treat
    records from a newer version or with a partial/unknown payload shape
    (e.g. a throughput record that has no ``counters``) as *data to skip
    with a named warning*, never as a reason to crash."""
    v = rec.get("v")
    if not isinstance(v, int) or v > HISTORY_VERSION:
        return f"unknown history version {v!r}"
    for kind in ("counters", "walls", "meta"):
        if kind in rec and not isinstance(rec[kind], dict):
            return f"{kind!r} is not a mapping"
    if "counters" not in rec and "walls" not in rec:
        return "no counters/walls payload"
    return None
