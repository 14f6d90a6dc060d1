"""Reference interpreter backend: one Python pass over every node per cycle.

This is the oracle the compiled vector engine (:mod:`repro_torch.core.engine.vector`)
is cross-validated against — semantics are specified here, speed there.  The
loop models the TIA firing rule with synchronous two-phase semantics: firing
decisions for cycle ``t`` use queue state at the start of ``t`` (push+pop on
the same queue in one cycle is allowed, a push into a queue that was full at
cycle start is not).  Loads/stores arbitrate for the shared memory-port
budget with rotating (fair round-robin) priority.

Fire accounting: *every* token consumption counts as one fire on both the
per-node counter (``Node.fires``) and the per-op aggregate — including filter
drops and sync count-ticks (whose ``done`` emission is part of the same fire,
not a second one).  The two views are kept consistent so per-PE utilization
can be derived from either.
"""
from __future__ import annotations

from collections import deque
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.core.dfg import DFG, Edge, Node
from repro_torch.core.engine.common import (RawStats, SimDeadlock, deadlock_message)
from repro_torch.telemetry.probe import (ST_FIRED, ST_INACTIVE, ST_INPUT_STARVED,
                                         ST_MEM_ARB, ST_NET_WAIT,
                                         ST_OUTPUT_BLOCKED, format_stall_summary,
                                         summary_from_state)

if TYPE_CHECKING:  # pragma: no cover - avoids core <-> fabric import cycle
    from repro_torch.fabric.route import RoutedFabric
    from repro_torch.telemetry import Telemetry


class _Network:
    """Per-simulation on-chip network state (network-aware mode).

    Tokens pushed onto a routed edge ride through a transit pipeline:
    arrival = injection cycle + hops, plus any store-and-forward stalls when
    a link's words-per-cycle budget is already spoken for in a cycle.  A
    producer's fan-out is one multicast: shared tree links are crossed once
    per token (booked once per firing), not once per edge.
    """

    def __init__(self, fabric: "RoutedFabric", g: DFG,
                 telemetry: "Telemetry | None" = None):
        from repro_torch.fabric.route import edge_key  # deferred: no import cycle
        self.wpc = {k: l.words_per_cycle for k, l in
                    fabric.topo.links.items()}
        self.routes: dict[int, tuple] = {}
        self.edge_by_id: dict[int, Edge] = {}
        for e in g.edges():
            self.routes[id(e)] = fabric.routes[edge_key(e)]
            self.edge_by_id[id(e)] = e
        self.transit: dict[int, deque] = {eid: deque() for eid in self.routes}
        self.used: dict[tuple, int] = {}     # (link, cycle) -> words in flight
        self.last_arrival: dict[int, int] = {}
        self.token_hops = 0
        self.stall_cycles = 0            # link-contention wait, summed
        self.tel = telemetry
        self.lid = telemetry.link_ids if telemetry is not None else None

    def broadcast(self, nd: Node, v, cycle: int) -> None:
        tel = self.tel
        booked: dict[tuple, int] = {}    # link -> slot of this token's copy
        for e in nd.out_edges:
            links = self.routes[id(e)]
            if not links:                # co-resident PEs: ideal local queue
                e.push(v)
                continue
            t = cycle
            for lk in links:
                if lk in booked:         # ride the multicast copy
                    t = booked[lk] + 1
                    continue
                cap = self.wpc[lk]
                slot = t
                while self.used.get((lk, slot), 0) >= cap:
                    slot += 1
                self.stall_cycles += slot - t
                self.used[(lk, slot)] = self.used.get((lk, slot), 0) + 1
                booked[lk] = slot
                self.token_hops += 1
                if tel is not None:
                    tel.link_book(self.lid[lk], slot, slot - t)
                t = slot + 1
            arr = max(t, self.last_arrival.get(id(e), 0))  # FIFO per edge
            self.last_arrival[id(e)] = arr
            self.transit[id(e)].append((arr, v))

    def deliver(self, cycle: int) -> None:
        # slot searches always start at the current cycle, so bookings for
        # past cycles can never be read again — drop them periodically to
        # keep memory flat over long simulations.
        if cycle % 4096 == 0 and self.used:
            self.used = {k: v for k, v in self.used.items() if k[1] >= cycle}
        for eid, dq in self.transit.items():
            if dq and dq[0][0] <= cycle:
                e = self.edge_by_id[eid]
                while dq and dq[0][0] <= cycle:
                    e.push(dq.popleft()[1])

    def edge_full(self, e: Edge) -> bool:
        return e.capacity is not None and \
            len(e.q) + len(self.transit[id(e)]) >= e.capacity

    def in_flight(self) -> bool:
        return any(self.transit.values())


def run(plan, flat_in, flat_out, elems_per_cycle: float,
        max_cycles: int = 50_000_000,
        fabric: "RoutedFabric | None" = None,
        telemetry: "Telemetry | None" = None) -> RawStats:
    """Run the per-cycle interpreter; mutates ``flat_out`` in place."""
    g = plan.dfg

    # queues live on the Edge objects: a completed run drains them, but a
    # deadlocked/timed-out one leaves tokens behind — start every run from
    # the quiescent marking so fix-and-retry on the same plan is valid.
    for nd in g.nodes:
        for e in nd.out_edges:
            e.q.clear()

    # per-node runtime state ---------------------------------------------------
    state: dict[int, dict] = {}
    done_pending = 0
    for nd in g.nodes:
        st: dict = {"k": 0}
        if nd.op == "sync":
            st["count"] = 0
            st["emitted"] = False
        elif nd.op == "cmp":
            st["fired"] = False
            done_pending += 1
        state[nd.nid] = st
    assert done_pending, "graph has no completion (cmp) node"

    net = _Network(fabric, g, telemetry) if fabric is not None else None

    credit = 0.0
    cycles = 0
    fires: dict[str, int] = {}
    loads = stores = flops = 0
    finished = False

    # memory ops arbitrate for bandwidth with *rotating* priority (fair
    # round-robin, like the CGRA's memory-port arbiter); everything else is
    # order-independent because eligibility is snapshotted per cycle.
    mem_nodes = [nd for nd in g.nodes if nd.op in ("load", "store")]
    other_nodes = [nd for nd in g.nodes if nd.op not in ("load", "store")]
    n_mem = max(1, len(mem_nodes))

    nodes = g.nodes
    # hot-loop records: (node, nid, op, state, in_edges, out_edges) resolved
    # once — the edge lists are stable for the whole simulation, and skipping
    # the per-cycle attribute lookups is a measurable win on large graphs.
    # Eligibility snapshots are flat lists indexed by nid (nids are dense).
    rec = {nd.nid: (nd, nd.nid, nd.op, state[nd.nid], nd.in_edges,
                    nd.out_edges) for nd in nodes}
    # imux pops exactly one (pattern-selected) port per firing; snapshotting
    # all-ports-nonempty would both stall it and deadlock re-interleaves.
    snap_recs = [rec[nd.nid] for nd in nodes if nd.op != "imux"]
    imux_recs = [rec[nd.nid] for nd in nodes if nd.op == "imux"]
    mem_recs = [rec[nd.nid] for nd in mem_nodes]
    other_recs = [rec[nd.nid] for nd in other_nodes]
    n_ids = 1 + max(nd.nid for nd in nodes)
    in_avail = [False] * n_ids
    out_free = [False] * n_ids

    tel = telemetry
    all_recs = snap_recs + imux_recs
    prev_fires = [0] * n_ids
    if tel is not None:
        for nd in nodes:           # plans can be re-simulated; fires persist
            prev_fires[nd.nid] = nd.fires

    def _classify(no_fires: bool = False) -> np.ndarray:
        """One exclusive ``ST_*`` code per node for the cycle just executed,
        derived from this cycle's eligibility snapshot plus fire deltas.
        Mirrors the vector engine's classification exactly (parity-gated in
        tests/test_telemetry.py); ``no_fires`` skips the delta check on the
        deadlock path, where by definition nothing fired."""
        stb = np.empty(n_ids, dtype=np.int64)
        for nd, nid, op, stx, ine, _ in all_recs:
            if not no_fires and nd.fires > prev_fires[nid]:
                prev_fires[nid] = nd.fires
                stb[nid] = ST_FIRED
            elif (op == "addr" and stx["k"] >= nd.params["count"]) \
                    or (op == "sync" and stx["emitted"]) \
                    or (op == "cmp" and stx["fired"]):
                stb[nid] = ST_INACTIVE
            elif not in_avail[nid]:
                if net is None:
                    stb[nid] = ST_INPUT_STARVED
                else:
                    if op == "imux":
                        pat = nd.params["pattern"]
                        waiting = bool(
                            net.transit[id(ine[pat[stx["k"] % len(pat)]])])
                    else:
                        waiting = any(net.transit[id(e)] for e in ine)
                    stb[nid] = ST_NET_WAIT if waiting else ST_INPUT_STARVED
            elif not out_free[nid] and not (
                    op in ("sync", "cmp")
                    or (op == "filter" and not nd.params["keep"](stx["k"]))):
                # output space is optional for sync/cmp (emission rides the
                # fire) and for a filter whose next token will be dropped —
                # same out_opt semantics as the compiled plan's.
                stb[nid] = ST_OUTPUT_BLOCKED
            else:           # eligible but lost the memory-port arbitration
                stb[nid] = ST_MEM_ARB
        return stb

    def _final_cycle_summary() -> dict:
        names = [""] * n_ids
        ops = [""] * n_ids
        for nd in nodes:
            names[nd.nid] = nd.name
            ops[nd.nid] = nd.op
        return summary_from_state(_classify(no_fires=True), names, ops)

    while not finished:
        if cycles >= max_cycles:
            if tel is not None:
                tel.finish(cycles)
                summ = tel.stall_summary(window=64)
                raise SimDeadlock(f"exceeded max_cycles={max_cycles}"
                                  + format_stall_summary(summ),
                                  cycles=cycles, timed_out=True,
                                  stall_summary=summ)
            raise SimDeadlock(f"exceeded max_cycles={max_cycles}",
                              cycles=cycles, timed_out=True)
        cycles += 1
        credit = min(credit + elems_per_cycle, 4 * elems_per_cycle)
        if net is not None:
            net.deliver(cycles)          # arrivals land before the snapshot
        # phase 1: snapshot eligibility -----------------------------------
        if net is None:
            for _, nid, _, _, ine, oute in snap_recs:
                in_avail[nid] = all(e.q for e in ine)
                out_free[nid] = all(not e.full() for e in oute)
        else:
            for _, nid, _, _, ine, oute in snap_recs:
                in_avail[nid] = all(e.q for e in ine)
                out_free[nid] = all(not net.edge_full(e) for e in oute)
        for nd_, nid, _, stx, ine, oute in imux_recs:
            pat = nd_.params["pattern"]
            in_avail[nid] = bool(ine[pat[stx["k"] % len(pat)]].q)
            out_free[nid] = (all(not e.full() for e in oute) if net is None
                             else all(not net.edge_full(e) for e in oute))
        any_fired = False
        # phase 2: execute. Memory nodes first in rotated order (fair
        # bandwidth arbitration), then the rest.
        rot = cycles % n_mem
        ordered = mem_recs[rot:] + mem_recs[:rot] + other_recs
        for nd, nid, op, st, in_edges, out_edges in ordered:
            if op == "addr":
                if st["k"] >= nd.params["count"] or not out_free[nid]:
                    continue
                v = st["k"]
                st["k"] += 1
            elif op == "load":
                if not (in_avail[nid] and out_free[nid] and credit >= 1.0):
                    continue
                a = in_edges[0].q.popleft()
                v = float(flat_in[nd.params["indices"][a]])
                credit -= 1.0
                loads += 1
            elif op == "store":
                if not (in_avail[nid] and out_free[nid] and credit >= 1.0):
                    continue
                a = in_edges[0].q.popleft()
                val = in_edges[1].q.popleft()
                flat_out[nd.params["indices"][a]] = val
                credit -= 1.0
                stores += 1
                v = 1  # done token to sync
            elif op == "filter":
                if not in_avail[nid]:
                    continue
                keep = nd.params["keep"](st["k"])
                if keep and not out_free[nid]:
                    continue  # must hold the token until downstream has space
                tok = in_edges[0].q.popleft()
                st["k"] += 1
                if not keep:
                    nd.fires += 1        # a drop is a fire: the token was consumed
                    fires[op] = fires.get(op, 0) + 1
                    any_fired = True
                    continue
                v = tok
            elif op == "mul":
                if not (in_avail[nid] and out_free[nid]):
                    continue
                v = nd.params["coeff"] * in_edges[0].q.popleft()
                flops += 1
            elif op == "mac":
                if not (in_avail[nid] and out_free[nid]):
                    continue
                p = in_edges[0].q.popleft()
                v = p + nd.params["coeff"] * in_edges[1].q.popleft()
                flops += 2
            elif op == "add":
                if not (in_avail[nid] and out_free[nid]):
                    continue
                v = in_edges[0].q.popleft() + in_edges[1].q.popleft()
                flops += 1
            elif op == "sync":
                if st["emitted"] or not in_avail[nid]:
                    continue
                in_edges[0].q.popleft()
                st["count"] += 1
                nd.fires += 1            # each count-tick is one fire …
                fires[op] = fires.get(op, 0) + 1
                any_fired = True
                if st["count"] == nd.params["expected"] and out_free[nid]:
                    st["emitted"] = True  # … and the done emission rides it
                    if net is None:
                        for e in out_edges:
                            e.push(1)
                    else:
                        net.broadcast(nd, 1, cycles)
                continue
            elif op == "imux":  # re-interleave: pop the pattern-selected port
                if not (in_avail[nid] and out_free[nid]):
                    continue
                pat = nd.params["pattern"]
                v = in_edges[pat[st["k"] % len(pat)]].q.popleft()
                st["k"] += 1
            elif op == "cmp":  # a done-combiner (programs may carry several)
                if st["fired"] or not in_avail[nid]:
                    continue
                for e in in_edges:
                    e.q.popleft()
                st["fired"] = True
                done_pending -= 1
                if done_pending == 0:
                    finished = True
                nd.fires += 1
                fires[op] = fires.get(op, 0) + 1
                any_fired = True
                continue
            else:  # mux/demux/copy pass-through
                if not (in_avail[nid] and out_free[nid]):
                    continue
                v = in_edges[0].q.popleft()
            nd.fires += 1
            fires[op] = fires.get(op, 0) + 1
            any_fired = True
            if net is None:
                for e in out_edges:
                    e.push(v)
            else:
                net.broadcast(nd, v, cycles)
        if tel is not None:
            tel.observe(cycles, _classify())
        if not any_fired and not finished:
            if net is not None and net.in_flight():
                continue                 # tokens still riding the network
            if tel is not None:
                tel.finish(cycles)
                summ = tel.stall_summary(window=64)
            else:
                summ = _final_cycle_summary()
            raise SimDeadlock(deadlock_message(cycles, nodes)
                              + format_stall_summary(summ),
                              cycles=cycles, stall_summary=summ)

    if tel is not None:
        tel.finish(cycles)
    return RawStats(
        cycles=cycles, flops=flops, loads=loads, stores=stores, fires=fires,
        max_queue_total=sum(e.max_occupancy for e in g.edges()),
        token_hops=net.token_hops if net is not None else 0,
        stall_cycles=net.stall_cycles if net is not None else 0)
