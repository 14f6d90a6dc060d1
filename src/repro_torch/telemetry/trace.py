"""Chrome/Perfetto ``trace_event`` export for a :class:`Telemetry` sink,
carried over from ``repro.telemetry.trace``: the same events, in the same
order, for the same run.

Open the written file in https://ui.perfetto.dev (or ``chrome://tracing``).
The mapping from probes to tracks:

* one process group per PE (placed runs: ``PE(r, c)``) or per worker/stage
  pipeline (ideal runs: ``reader/w0`` …), with one thread track per node
  (instruction) inside it — slices are the node's state intervals (``fire``
  runs and the four attributed stall causes; ``inactive`` stretches are
  omitted).  Timebase: 1 simulated cycle = 1 µs.
* one counter track per contended link (any link that ever made a token
  wait) sampling its per-cycle word occupancy, so the hot links from the
  stall-attribution table are visually obvious.
* one process for tuner search spans (``repro_torch.explore`` evaluations),
  on the wall-clock timebase — a whole sweep becomes one inspectable
  artifact.
* one process, ``host``, for the kernels' host spans (track ``host``,
  :mod:`repro_torch.telemetry.host`), on the same wall-clock timebase; each
  slice's ``args`` carry its parent span's index in the sink and its call.

Events are emitted globally sorted by timestamp with integer ``ts``/``dur``
— :func:`validate_trace` checks that (plus the required keys) and is run by
the tests and by ``chip_smoke.py``'s ``observe`` phase on a trace read back
from disk.
"""
from __future__ import annotations

import json

from repro_torch.telemetry.probe import (ST_FIRED, ST_INACTIVE, STATE_NAMES,
                                   Telemetry)

__all__ = ["trace_events", "write_trace", "validate_trace"]

_PID_SPANS = 1                      # tuner/search spans
_PID_LINKS = 2                      # per-link occupancy counters
_PID_HOST = 3                       # the kernels' host spans
_PID_GROUP0 = 10                    # first PE / worker-stage group


def _node_events(tel: Telemetry) -> list[dict]:
    evs: list[dict] = []
    group_pid: dict[str, int] = {}
    for nid, g in enumerate(tel.node_groups):
        if g not in group_pid:
            pid = _PID_GROUP0 + len(group_pid)
            group_pid[g] = pid
            evs.append({"ph": "M", "pid": pid, "ts": 0,
                        "name": "process_name", "args": {"name": g}})
            evs.append({"ph": "M", "pid": pid, "ts": 0,
                        "name": "process_sort_index",
                        "args": {"sort_index": pid}})
        evs.append({"ph": "M", "pid": group_pid[g], "tid": nid, "ts": 0,
                    "name": "thread_name",
                    "args": {"name": f"{tel.node_names[nid]} "
                                     f"({tel.node_ops[nid]})"}})
    for nid, state, t0, t1 in tel.intervals:
        if state == ST_INACTIVE:
            continue
        evs.append({"ph": "X", "pid": group_pid[tel.node_groups[nid]],
                    "tid": nid, "ts": t0, "dur": t1 - t0,
                    "name": STATE_NAMES[state],
                    "cat": "fire" if state == ST_FIRED else "stall"})
    return evs


def _link_events(tel: Telemetry) -> list[dict]:
    evs: list[dict] = []
    contended = [lid for lid in range(len(tel.link_names))
                 if tel.link_stalls[lid] > 0]
    if contended:
        # "links" declares the inventory size: validate_trace rejects any
        # counter sample whose lid falls outside it (a booking against a
        # link the fabric does not have)
        evs.append({"ph": "M", "pid": _PID_LINKS, "ts": 0,
                    "name": "process_name",
                    "args": {"name": "links (contended)",
                             "links": len(tel.link_names)}})
    for lid in contended:
        name = (f"link {tel.link_names[lid]} "
                f"(stall={int(tel.link_stalls[lid])})")
        occ = tel.link_occ.get(lid, {})
        # sample every occupied slot, and drop back to 0 when a busy slot's
        # successor is idle, so the counter reads as per-cycle occupancy
        samples: dict[int, int] = {}
        for slot, words in occ.items():
            samples[slot] = words
        for slot in list(samples):
            if slot + 1 not in samples:
                samples[slot + 1] = 0
        for slot in sorted(samples):
            evs.append({"ph": "C", "pid": _PID_LINKS, "ts": slot,
                        "name": name,
                        "args": {"words": samples[slot], "lid": lid}})
    return evs


def _process_of(track: str) -> tuple[int, str]:
    """(pid, name) of the process a span track belongs to: ``host`` for the
    kernels' host spans, ``tuner`` for every other."""
    if track.split("/")[0] == "host":
        return _PID_HOST, "host"
    return _PID_SPANS, "tuner"


def _span_events(tel: Telemetry) -> list[dict]:
    evs: list[dict] = []
    tracks: dict[str, int] = {}
    named: set[int] = set()
    for sp in tel.spans:
        track = sp.get("track", "spans")
        pid, process = _process_of(track)
        if pid not in named:
            named.add(pid)
            evs.append({"ph": "M", "pid": pid, "ts": 0,
                        "name": "process_name", "args": {"name": process}})
        if track not in tracks:
            tid = len(tracks)
            tracks[track] = tid
            evs.append({"ph": "M", "pid": pid, "tid": tid, "ts": 0,
                        "name": "thread_name", "args": {"name": track}})
        args = sp.get("args", {})
        if "call" in sp:
            args = {**args, "parent": sp["parent"], "call": sp["call"]}
        evs.append({"ph": "X", "pid": pid, "tid": tracks[track],
                    "ts": int(sp["t0"] * 1e6),
                    "dur": max(1, int(sp["dur"] * 1e6)),
                    "name": sp["name"], "cat": sp.get("cat", "span"),
                    "args": args})
    return evs


def trace_events(tel: Telemetry) -> list[dict]:
    """Flatten the sink into ``trace_event`` dicts, globally ts-sorted
    (metadata first)."""
    meta: list[dict] = []
    evs: list[dict] = []
    parts = [_span_events(tel)]
    if tel.attached:
        parts += [_node_events(tel), _link_events(tel)]
    for part in parts:
        for e in part:
            (meta if e["ph"] == "M" else evs).append(e)
    evs.sort(key=lambda e: (e["ts"], e.get("pid", 0), e.get("tid", 0)))
    return meta + evs


def write_trace(tel: Telemetry, path: str) -> dict:
    """Write the Perfetto JSON trace; returns the written object."""
    obj = {"traceEvents": trace_events(tel),
           "displayTimeUnit": "ms",
           "metadata": {"tool": "repro_torch.telemetry",
                        "run": tel.run_label,
                        "cycles": tel.cycles,
                        "clock": "1 cycle = 1 us (sim tracks); "
                                 "wall us (tuner spans)"}}
    with open(path, "w") as f:
        json.dump(obj, f, indent=0, sort_keys=True)
        f.write("\n")
    return obj


def validate_trace(obj: dict | list) -> int:
    """Schema check: required keys per phase, integer non-negative
    timestamps, non-negative durations, monotonic (ts-sorted) event order,
    no two overlapping *exclusive* intervals (fire/stall slices) on one
    node track, and every link-counter sample inside the declared link
    inventory.  Returns the number of non-metadata events; raises
    ValueError naming the violation on the first one."""
    evs = obj["traceEvents"] if isinstance(obj, dict) else obj
    last_ts = None
    n = 0
    n_links = None                        # declared by the links process
    track_end: dict[tuple, int] = {}      # (pid, tid) -> exclusive end ts
    for i, e in enumerate(evs):
        ph = e.get("ph")
        if ph not in ("M", "X", "C", "B", "E", "i", "I"):
            raise ValueError(f"event {i}: unknown phase {ph!r}")
        if "pid" not in e or "name" not in e:
            raise ValueError(f"event {i}: missing pid/name: {e}")
        ts = e.get("ts")
        if not isinstance(ts, int) or ts < 0:
            raise ValueError(f"event {i}: bad ts {ts!r} (want int >= 0)")
        if ph == "M":
            if (e["name"] == "process_name"
                    and "links" in e.get("args", {})):
                n_links = e["args"]["links"]
            continue
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, int) or dur < 0:
                raise ValueError(f"event {i}: bad dur {dur!r}")
            if e.get("cat") in ("fire", "stall"):
                # per-node state slices are exclusive by the telemetry
                # contract: one state per node per cycle
                key = (e["pid"], e.get("tid"))
                end = track_end.get(key)
                if end is not None and ts < end:
                    raise ValueError(
                        f"event {i}: overlapping exclusive intervals on "
                        f"pid={key[0]} tid={key[1]} ({e['name']!r} starts "
                        f"at {ts} before the previous slice ends at {end})")
                track_end[key] = max(end or 0, ts + dur)
        if ph == "C":
            if "args" not in e:
                raise ValueError(f"event {i}: counter without args")
            lid = e["args"].get("lid")
            if lid is not None and (n_links is None
                                    or not 0 <= lid < n_links):
                raise ValueError(
                    f"event {i}: unknown link id {lid} (declared link "
                    f"inventory: {n_links})")
        if last_ts is not None and ts < last_ts:
            raise ValueError(
                f"event {i}: timestamps not monotonic ({ts} < {last_ts})")
        last_ts = ts
        n += 1
    return n
