"""Telemetry sink: per-node / per-link probes + tuner search spans, carried
over from ``repro.telemetry.probe``.

A :class:`Telemetry` object is an opt-in instrumentation sink passed to
``repro_torch.core.simulator.simulate(..., telemetry=)`` (both engines feed it) and
to ``repro.explore.explore(..., telemetry=)`` (the tuner records one span per
evaluation).  The contract with the engines:

* **zero cost when absent** — engines take ``telemetry=None`` and guard every
  probe with one local ``is not None`` check.
* **exact** — the telemetry counters are not estimates: summed, they equal
  the engine's own aggregate stats bit-for-bit (``totals()`` vs ``SimResult``
  / ``RawStats``; parity-gated in the reference's ``tests/test_telemetry.py``).
* **engine-agnostic** — the interpreter records scalar per-cycle events, the
  vector engine batches whole per-cycle state arrays (and multiplies stall
  counts through its event-skip), but both leave identical telemetry: same
  per-node fire timelines, same stall attribution, same per-link bookings.

Every node gets one exclusive state per observed cycle.  **This table is
the canonical stall-state taxonomy** — the engines' classifiers
(``repro_torch.core.engine.interp``/``vector``), the attribution layer
(``repro_torch.telemetry.attribution``) and docs/telemetry.md all reference it
rather than restating it:

====================  ======================================================
``ST_INACTIVE``       retired (addr exhausted / sync emitted / cmp fired)
``ST_FIRED``          consumed tokens this cycle (incl. filter drops, sync
                      count-ticks — the same events the fire counters count)
``ST_INPUT_STARVED``  an input queue is empty and nothing is in flight to it
``ST_OUTPUT_BLOCKED`` inputs ready but a bounded output queue is full
                      (for ``imux`` only the pattern-selected input port
                      counts toward starvation/net-wait)
``ST_MEM_ARB``        a load/store with data+space that lost the rotating
                      memory-port arbitration (credit < 1 element this cycle)
``ST_NET_WAIT``       input empty but tokens are riding the network toward
                      it (network-contention / transit latency)
====================  ======================================================

Per-link telemetry is recorded at booking time (producer side): one word per
hop (sums to ``token_hops``) and the store-and-forward wait per booking
(sums to ``stall_cycles``), plus — when ``timeline`` is on — the per-cycle
slot occupancy each contended link, for the Perfetto counter tracks.
"""
from __future__ import annotations

import time

import numpy as np

__all__ = ["Telemetry", "STALL_CAUSES", "STATE_NAMES", "ST_INACTIVE",
           "ST_FIRED", "ST_INPUT_STARVED", "ST_OUTPUT_BLOCKED", "ST_MEM_ARB",
           "ST_NET_WAIT", "format_stall_summary", "summary_from_state"]

ST_INACTIVE, ST_FIRED, ST_INPUT_STARVED, ST_OUTPUT_BLOCKED, ST_MEM_ARB, \
    ST_NET_WAIT = range(6)

STATE_NAMES = ("inactive", "fire", "input_starved", "output_blocked",
               "memory_arbitration", "network_contention")
#: the four attributed stall causes (states ST_INPUT_STARVED..ST_NET_WAIT)
STALL_CAUSES = STATE_NAMES[ST_INPUT_STARVED:]


def format_stall_summary(summary: dict | None) -> str:
    """Render a stall-attribution summary (see ``Telemetry.stall_summary`` /
    the engines' deadlock path) into the one-line form both engines append to
    ``SimDeadlock`` messages — it must be engine-independent, so it is built
    only from the (parity-checked) summary dict."""
    if not summary:
        return ""
    counts = summary.get("cause_counts", {})
    win = summary.get("window_cycles")
    tag = f"last {win} cycles" if win else "final cycle"
    if not any(counts.values()) and not summary.get("nodes"):
        return f"; stall attribution ({tag}): no stalls recorded"
    head = " ".join(f"{c}={n}" for c, n in counts.items() if n)
    nodes = "; ".join(f"{d['name']}({d['op']}): {d['cause']}"
                      for d in summary.get("nodes", [])[:8])
    return f"; stall attribution ({tag}): [{head}] top blocked: {nodes}"


def summary_from_state(state: np.ndarray, names, ops) -> dict:
    """One-cycle stall-attribution summary — the diagnostic the engines
    build on deadlock when *no* telemetry sink is attached.  Same dict shape
    as :meth:`Telemetry.stall_summary`, derived from a single classified
    state array, so both engines (which agree on the state by the parity
    contract) render identical diagnostics."""
    counts = {c: int((state == ST_INPUT_STARVED + i).sum())
              for i, c in enumerate(STALL_CAUSES)}
    nodes = [{"name": names[nid], "op": ops[nid],
              "cause": STATE_NAMES[int(state[nid])], "stalled_cycles": 1}
             for nid in np.nonzero(state >= ST_INPUT_STARVED)[0][:8].tolist()]
    return {"window_cycles": None, "cause_counts": counts, "nodes": nodes}


class Telemetry:
    """Instrumentation sink for one simulation run (+ any number of spans).

    ``timeline=False`` keeps only the exact counters (per-node fires, stall
    attribution totals, per-link words/stalls) and drops the interval /
    per-slot-occupancy history the trace exporter needs — use it when a run
    is too long to hold its full timeline.
    """

    def __init__(self, *, timeline: bool = True):
        self.timeline = timeline
        self.spans: list[dict] = []
        self._t0 = time.perf_counter()
        self.attached = False
        self.run_label = ""
        self.cycles = 0                 # set by attach()/finish()

    # ------------------------------------------------------------------ runs
    def attach(self, plan, fabric=None) -> None:
        """Bind the sink to one plan (+ optional routed fabric) and reset all
        per-run state.  Called by ``simulate()`` before the engine starts;
        a sink holds exactly one run (spans accumulate across attaches)."""
        g = plan.dfg
        nodes = g.nodes
        self.attached = True
        self.plan = plan
        self.fabric = fabric
        self.run_label = getattr(g, "name", "run")
        self.node_names = [n.name for n in nodes]
        self.node_ops = [n.op for n in nodes]
        self.node_groups = self._groups(nodes, fabric)
        n = len(nodes)
        self.n_nodes = n
        self.fires_total = np.zeros(n, dtype=np.int64)
        self.stall_totals = np.zeros((n, 4), dtype=np.int64)
        # fire-timeline envelope (cycle of first/last fire; 0 = never fired)
        # — kept even with timeline=False so the attribution layer's
        # fill/drain decomposition works on counter-only sinks
        self.first_fire = np.zeros(n, dtype=np.int64)
        self.last_fire = np.zeros(n, dtype=np.int64)
        self._cur_state = np.full(n, -1, dtype=np.int64)
        self._since = np.ones(n, dtype=np.int64)
        self.intervals: list[tuple[int, int, int, int]] = []
        self.last_cycle = 0
        self.cycles = 0
        self.finished = False
        # link inventory (network-aware runs only)
        if fabric is not None:
            self.link_ids = fabric.link_index()
            self.link_names = fabric.link_names()
            nl = len(self.link_ids)
        else:
            self.link_ids = {}
            self.link_names = []
            nl = 0
        self.link_words = np.zeros(nl, dtype=np.int64)
        self.link_stalls = np.zeros(nl, dtype=np.int64)
        self.link_occ: dict[int, dict[int, int]] = {}

    @staticmethod
    def _groups(nodes, fabric):
        """Track-grouping labels: the PE coordinate on placed runs, the
        ``stage/worker`` pipeline otherwise (see docs/telemetry.md)."""
        if fabric is not None:
            coords = fabric.placement.coords
            return [f"PE{coords[n.nid]}" for n in nodes]
        return [f"{n.stage or 'stage'}/w{n.worker}" for n in nodes]

    # --------------------------------------------------------- engine probes
    def observe(self, cycle: int, state: np.ndarray) -> None:
        """Record one simulated cycle: ``state[nid]`` is the node's exclusive
        ``ST_*`` code for ``cycle``.  The array is consumed (copied)."""
        fired = state == ST_FIRED
        self.fires_total += fired
        if fired.any():
            self.last_fire[fired] = cycle
            new = fired & (self.first_fire == 0)
            if new.any():
                self.first_fire[new] = cycle
        st = self.stall_totals
        for c in range(4):
            st[:, c] += state == ST_INPUT_STARVED + c
        if self.timeline:
            cur = self._cur_state
            changed = np.nonzero(state != cur)[0]
            if len(changed):
                since = self._since
                iv = self.intervals
                for nid in changed.tolist():
                    if cur[nid] >= 0:
                        iv.append((nid, int(cur[nid]), int(since[nid]),
                                   cycle))
                    since[nid] = cycle
                cur[changed] = state[changed]
        else:
            self._cur_state[:] = state
        self.last_cycle = cycle

    def observe_repeat(self, k: int) -> None:
        """The engine fast-forwarded ``k`` cycles in which state provably
        could not change (vector event-skip): multiply the standing stall
        attribution instead of re-observing each cycle."""
        cur = self._cur_state
        st = self.stall_totals
        for c in range(4):
            st[:, c] += k * (cur == ST_INPUT_STARVED + c)
        self.last_cycle += k

    def link_book(self, lid: int, slot: int, waited: int) -> None:
        """One token booked one hop: it crosses link ``lid`` at cycle
        ``slot`` after ``waited`` cycles of store-and-forward contention."""
        if not 0 <= lid < len(self.link_words):
            raise ValueError(
                f"unknown link id {lid} (link inventory has "
                f"{len(self.link_words)} links — was the sink attached with "
                f"the fabric the engine is booking against?)")
        self.link_words[lid] += 1
        self.link_stalls[lid] += waited
        if self.timeline:
            occ = self.link_occ.get(lid)
            if occ is None:
                occ = self.link_occ[lid] = {}
            occ[slot] = occ.get(slot, 0) + 1

    def finish(self, cycles: int) -> None:
        """Close the run (also called on the deadlock path, so aborted runs
        still export a valid trace): flush open state intervals."""
        self.cycles = cycles
        self.finished = True
        if self.timeline:
            cur, since = self._cur_state, self._since
            for nid in range(self.n_nodes):
                if cur[nid] >= 0 and self.last_cycle + 1 > since[nid]:
                    self.intervals.append((nid, int(cur[nid]),
                                           int(since[nid]),
                                           self.last_cycle + 1))
                    since[nid] = self.last_cycle + 1

    # -------------------------------------------------------------- counters
    def totals(self) -> dict:
        """Aggregate view of the probes — must equal the engine's own stats
        bit-for-bit (the parity gate): fires by op, loads/stores/flops from
        per-node fires, token_hops/stall_cycles from per-link bookings."""
        # imported here, not at module top: the engines import this module's
        # state constants, so a top-level repro_torch.core import would make
        # `import repro_torch.telemetry` order-dependent (circular)
        from repro_torch.core.dfg import FLOPS_PER_OP
        fires: dict[str, int] = {}
        loads = stores = flops = 0
        for nid, op in enumerate(self.node_ops):
            f = int(self.fires_total[nid])
            if not f:
                continue
            fires[op] = fires.get(op, 0) + f
            if op == "load":
                loads += f
            elif op == "store":
                stores += f
            flops += f * FLOPS_PER_OP.get(op, 0)
        return {"cycles": self.cycles, "fires": fires,
                "fires_total": int(self.fires_total.sum()),
                "loads": loads, "stores": stores, "flops": flops,
                "stall_attribution": {
                    c: int(self.stall_totals[:, i].sum())
                    for i, c in enumerate(STALL_CAUSES)},
                "token_hops": int(self.link_words.sum()),
                "stall_cycles": int(self.link_stalls.sum())}

    def fire_cycles(self, nid: int) -> list[tuple[int, int]]:
        """The node's fire timeline as ``[t0, t1)`` runs of consecutive
        fired cycles (requires ``timeline=True``)."""
        return [(t0, t1) for (n, s, t0, t1) in self.intervals
                if n == nid and s == ST_FIRED]

    def stall_summary(self, window: int | None = None) -> dict:
        """Per-cause attribution over the last ``window`` cycles (whole run
        when None): cause counts in node-cycles plus the most-stalled nodes.
        This is what ``SimDeadlock`` diagnostics embed."""
        if not self.attached:           # no run: empty (renders as a stub)
            return {"window_cycles": None,
                    "cause_counts": {c: 0 for c in STALL_CAUSES},
                    "nodes": []}
        if window and self.timeline:
            lo = max(1, self.last_cycle + 1 - window)
            per = np.zeros((self.n_nodes, 4), dtype=np.int64)
            for nid, s, t0, t1 in self.intervals:
                if s >= ST_INPUT_STARVED and t1 > lo:
                    per[nid, s - ST_INPUT_STARVED] += t1 - max(t0, lo)
            cur, since = self._cur_state, self._since
            if not self.finished:           # open runs up to last_cycle
                for nid in range(self.n_nodes):
                    s = int(cur[nid])
                    if s >= ST_INPUT_STARVED:
                        t0 = max(int(since[nid]), lo)
                        per[nid, s - ST_INPUT_STARVED] += \
                            self.last_cycle + 1 - t0
        else:
            per = self.stall_totals
            window = None
        order = np.argsort(-per.sum(axis=1), kind="stable")
        nodes = []
        for nid in order[:8].tolist():
            tot = int(per[nid].sum())
            if not tot:
                break
            cause = STALL_CAUSES[int(per[nid].argmax())]
            nodes.append({"name": self.node_names[nid],
                          "op": self.node_ops[nid], "cause": cause,
                          "stalled_cycles": tot})
        return {"window_cycles": window,
                "cause_counts": {c: int(per[:, i].sum())
                                 for i, c in enumerate(STALL_CAUSES)},
                "nodes": nodes}

    # ----------------------------------------------------------------- spans
    def now(self) -> float:
        """Seconds since this sink was created (the span timebase)."""
        return time.perf_counter() - self._t0

    def span(self, name: str, *, cat: str = "span", t0: float | None = None,
             dur: float = 0.0, track: str = "spans", **args) -> dict:
        """Record one structured span (tuner evaluations, prune decisions,
        …).  ``t0``/``dur`` in seconds on the :meth:`now` timebase; extra
        keyword arguments become the span's ``args`` payload."""
        sp = {"name": name, "cat": cat, "track": track,
              "t0": self.now() if t0 is None else t0, "dur": dur,
              "args": args}
        self.spans.append(sp)
        return sp
