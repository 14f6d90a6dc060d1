"""Static plan verifier — deadlock-freedom and throughput bounds, no engine.

The engines (``repro_torch.core.engine``) discover a bad mapping the expensive
way: simulate it until nothing can fire and raise :class:`SimDeadlock`.
This module answers the same question *statically*, in microseconds to
milliseconds, from the plan's DFG alone (StencilFlow ships the analogous
per-channel minimum-buffer-depth pass; see ``docs/analysis.md``):

* :func:`verify_plan` — proves deadlock-freedom (``verdict="safe"``) or
  produces a **named counterexample** (the blocked waits-for cycle or
  starvation chain) plus, when the deadlock is capacity-induced, the
  **minimal capacity bump** that provably breaks it
  (``suggested_capacities``, an ``{edge eid: capacity}`` map).
* :func:`lint_plan` — structural invariants that today fail deep inside
  engines: keep-mask/token-count consistency (reusing the exact topo
  token-count pass from ``engine/compile.py``), splice geometry,
  degenerate sync triggers, stale compiled tables, and — given a routed
  fabric — channel overflow and PE slot conflicts.
* :class:`ThroughputBound` — a static cycle/II lower bound with per-stage
  fill estimates, cross-checkable against the measured
  ``repro_torch.telemetry.attribution`` accounting.

**How the deadlock proof works.**  Every edge has exactly one producer and
one consumer, so firing a node only pops its own inputs and pushes its own
outputs — it can never disable another enabled node.  That persistence
makes the token system *confluent*: from a given capacity assignment there
is exactly one quiescent marking, independent of schedule, and both
engines (which are fair, maximal schedulers of the same firing rules)
reach it.  The verifier therefore replays the plan's token flow in
token-count space (whole bursts per visit, no data, no cycle clock) until
it quiesces: all ``cmp`` nodes fired ⇒ every real engine completes;
blocked ⇒ every real engine deadlocks, and the blocked marking *is* the
counterexample.  Capacities only ever help (any fire sequence legal at
smaller queues is legal at larger ones), so the repair loop bumps the
full queues of output-blocked nodes by one and resumes from the same
marking until the flow completes (``static-capacity``) or no node is
output-blocked (``static-deadlock`` — structural, no bump can help).

Routed fabrics don't change the verdict: the network always delivers
(in-flight tokens drain into their destination queues unconditionally),
and a routed engine counts ``queue + transit`` occupancy against the same
capacity the abstract model counts — routed execution is just another
fair schedule of the same system.  The fabric is used for the routed
lints and for hop-aware latency in the throughput bound.

CLI: ``python -m repro_torch.analysis.lint examples/*_torch.py --strict`` (see
``lint.py``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.engine.common import SimDeadlock, mem_elems_per_cycle
from repro_torch.core.engine.compile import token_counts

#: version tag for the verifier's semantics — part of every EvalCache scope
#: (see ``repro.explore.search``) so a verifier upgrade can never replay a
#: stale static verdict from cache.
STATIC_SEMANTICS = "static-verify/v1"

_INF = 1 << 62
#: the default ``apply_min_capacities`` assigns to unsized edges
#: (``repro_torch.core.mapping.nd``) — the fast-path certificate mirrors it.
_DEFAULT_MIN_CAP = 4
#: ops that pop both in-ports per fire (everything else pops port 0 only
#: and merely requires the other ports non-empty — interp.py ground truth).
_POP_BOTH = ("mac", "add", "store")


class StaticDeadlock(SimDeadlock):
    """A *proven* deadlock, raised before any engine ran (``simulate(...,
    verify="static")``).  Subclasses :class:`SimDeadlock` so existing
    handlers keep working; ``cycles`` is 0 (nothing was simulated) and
    ``suggested_capacities`` carries the repair hint when one exists."""

    def __init__(self, msg: str, *, report: "StaticReport"):
        super().__init__(
            msg, cycles=0, timed_out=False,
            suggested_capacities=report.suggested_capacities)
        self.report = report


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding.  ``severity`` is ``"error"`` (the plan cannot run
    correctly) or ``"warning"`` (suspicious but runnable)."""
    kind: str
    severity: str
    message: str
    nodes: tuple = ()
    edges: tuple = ()

    def __str__(self) -> str:
        return f"[{self.severity}] {self.kind}: {self.message}"


@dataclasses.dataclass(frozen=True)
class Counterexample:
    """The named witness of a blocked quiescent marking: either a waits-for
    cycle (node A waits on a full queue into B, B waits on an empty queue
    from C, … back to A) or a starvation chain ending at a node that has
    already produced every token it ever will."""
    kind: str                             # "waits-cycle" | "starvation-chain"
    nodes: tuple                          # node names along the walk
    edges: tuple                          # human-readable edge descriptions
    detail: str

    def describe(self) -> str:
        arrow = " ⇠waits-on⇠ ".join(self.nodes)
        return f"{self.kind}: {arrow} — {self.detail}"


@dataclasses.dataclass(frozen=True)
class ThroughputBound:
    """Static lower bounds on the run (sound: measured >= every field).

    ``cycles_lb``      max(memory bound, pipeline-depth bound)
    ``ii_lb``          cycles_lb / stores — initiation interval per output
    ``mem_cycles_lb``  required (loads+stores) / elements-per-cycle
    ``depth_cycles_lb``max over nodes of (pipeline depth + required fires)
    ``fill_lb``        min store depth: cycles before the first store *can*
                       fire — lower-bounds attribution's "fill" phase
    ``stage_fill``     per-stage minimum depth (attribution stage labels)
    """
    cycles_lb: int
    ii_lb: float
    mem_cycles_lb: int
    depth_cycles_lb: int
    loads: int
    stores: int
    fill_lb: int
    stage_fill: dict


@dataclasses.dataclass
class StaticReport:
    """Everything :func:`verify_plan` learned about one plan."""
    verdict: str                          # "safe" | "deadlock" | "unknown"
    reason: str | None                    # "static-capacity" (a bump fixes
                                          # it) | "static-deadlock"
                                          # (structural) | None when safe
    certificate: str | None               # "min-capacities" | "quiescence"
                                          # | "lint" — how safety/deadlock
                                          # was established
    findings: list[Finding]
    counterexample: Counterexample | None
    suggested_capacities: dict[int, int] | None
    bound: ThroughputBound | None
    stats: dict

    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    def ok(self) -> bool:
        """Deadlock-free *and* lint-clean (the ``--strict`` CLI bar)."""
        return self.verdict == "safe" and not self.errors()

    def describe(self) -> str:
        parts = [f"verdict={self.verdict}"]
        if self.reason:
            parts.append(self.reason)
        if self.counterexample is not None:
            parts.append(self.counterexample.describe())
        if self.suggested_capacities:
            parts.append(f"suggested capacity bumps: "
                         f"{dict(sorted(self.suggested_capacities.items()))}")
        for f in self.findings:
            parts.append(str(f))
        return "; ".join(parts)


def _edge_desc(e, qlen: int, cap: int, state: str) -> str:
    c = "∞" if cap >= _INF else cap
    return (f"{e.src.name}->{e.dst.name}#p{e.dst_port} "
            f"(eid {e.eid}, {qlen}/{c} {state})")


def _fires_total(g, topo, emit) -> dict[int, int]:
    """Fires each node performs over a *full* run (every token consumed)."""
    ft: dict[int, int] = {}
    for nd in topo:
        ins = [emit[e.src.nid] for e in nd.in_edges]
        if nd.op == "addr":
            ft[nd.nid] = int(nd.params["count"])
        elif nd.op == "filter":
            ft[nd.nid] = ins[0] if ins else 0
        elif nd.op == "imux":
            ft[nd.nid] = sum(ins)
        elif nd.op == "sync":
            ft[nd.nid] = int(nd.params["expected"])
        elif nd.op == "cmp":
            ft[nd.nid] = 1
        else:
            ft[nd.nid] = min(ins) if ins else 0
    return ft


class _TokenFlow:
    """Token-count abstract interpreter (the quiescence engine).

    State is one integer per queue plus per-node progress counters; a
    ``run()`` sweeps the graph in topo order, letting every node fire its
    maximal burst under current queue space, until a full sweep makes no
    progress.  By confluence (module docstring) the final marking — and
    hence the complete/blocked verdict — is schedule-independent and
    matches what any engine reaches."""

    def __init__(self, g, emit, keeps, ft):
        self.g = g
        self.edges = g.finalize()
        self.topo = g.topo_order()
        self.caps = [(_INF if e.capacity is None else int(e.capacity))
                     for e in self.edges]
        self.qlen = [0] * len(self.edges)
        self.ft = ft
        self.fired = {n.nid: 0 for n in g.nodes}
        self.pos = {n.nid: 0 for n in g.nodes}     # addr/filter/imux progress
        self.sync_emitted = {n.nid: False for n in g.nodes if n.op == "sync"}
        self.cmp_done = {n.nid: False for n in g.nodes if n.op == "cmp"}
        self.n_cmp = len(self.cmp_done)
        self.done = 0
        self.keeps = keeps
        self.csum = {nid: np.concatenate(([0], np.cumsum(arr, dtype=np.int64)))
                     for nid, arr in keeps.items()}
        self.total_fires = sum(ft.values())
        self.sweeps = 0
        self.sweep_guard = self.total_fires + len(self.topo) + 64

    # ----- firing -----------------------------------------------------------
    def _space(self, nd) -> int:
        s = _INF
        for e in nd.out_edges:
            s = min(s, self.caps[e.eid] - self.qlen[e.eid])
        return s

    def _push(self, nd, b: int) -> None:
        for e in nd.out_edges:
            self.qlen[e.eid] += b

    def _step(self, nd) -> int:
        """Fire ``nd``'s maximal burst on the current marking; returns the
        number of fires (0 = nothing enabled)."""
        op, q = nd.op, self.qlen
        if op == "addr":
            b = min(int(nd.params["count"]) - self.pos[nd.nid],
                    self._space(nd))
            if b <= 0:
                return 0
            self.pos[nd.nid] += b
            self._push(nd, b)
            return b
        if op == "cmp":
            if self.cmp_done[nd.nid] or any(q[e.eid] == 0
                                            for e in nd.in_edges):
                return 0
            for e in nd.in_edges:
                q[e.eid] -= 1
            self.cmp_done[nd.nid] = True
            self.done += 1
            return 1
        if op == "sync":
            # pops port 0 only; the expected-th pop carries the one done
            # emission and is held until the out queue has room (the out
            # queue is necessarily empty before it, so nothing is lost)
            if self.sync_emitted[nd.nid] or any(q[e.eid] == 0
                                                for e in nd.in_edges):
                return 0
            exp = int(nd.params["expected"])
            in0 = nd.in_edges[0].eid
            fired = min(q[in0], exp - 1 - self.pos[nd.nid])
            if fired > 0:
                q[in0] -= fired
                self.pos[nd.nid] += fired
            if (self.pos[nd.nid] == exp - 1 and q[in0] > 0
                    and self._space(nd) >= 1):
                q[in0] -= 1
                self.pos[nd.nid] += 1
                self.sync_emitted[nd.nid] = True
                self._push(nd, 1)
                fired += 1
            return max(fired, 0)
        if op == "filter":
            in0 = nd.in_edges[0].eid
            csum = self.csum[nd.nid]
            k = self.pos[nd.nid]
            avail = min(q[in0], len(csum) - 1 - k)
            if avail <= 0:
                return 0
            space = self._space(nd)
            if space >= _INF:
                c = avail
            else:
                # largest c with (keeps in [k, k+c)) <= space: drops are
                # free, a keep holds until its broadcast has room
                c = int(np.searchsorted(csum, csum[k] + space,
                                        side="right")) - 1 - k
                c = max(0, min(c, avail))
            if c <= 0:
                return 0
            pushed = int(csum[k + c] - csum[k])
            q[in0] -= c
            self.pos[nd.nid] = k + c
            if pushed:
                self._push(nd, pushed)
            return c
        if op == "imux":
            pat = nd.params["pattern"]
            fired = 0
            while self.pos[nd.nid] < self.ft[nd.nid]:
                sel = nd.in_edges[pat[self.pos[nd.nid] % len(pat)]].eid
                if q[sel] == 0 or self._space(nd) < 1:
                    break
                q[sel] -= 1
                self._push(nd, 1)
                self.pos[nd.nid] += 1
                fired += 1
            return fired
        # load / mul / mac / add / store / mux / demux / copy: every in-port
        # must be non-empty per fire; pop port 0 (and port 1 for joins)
        ine = nd.in_edges
        if not ine or any(q[e.eid] == 0 for e in ine):
            return 0
        popped = ine[:2] if op in _POP_BOTH else ine[:1]
        b = min(min(q[e.eid] for e in popped), self._space(nd))
        if b <= 0:
            return 0
        for e in popped:
            q[e.eid] -= b
        self._push(nd, b)
        return b

    def run(self) -> str:
        """Sweep to quiescence: "complete" (all cmp fired), "blocked", or
        "budget" (the sweep guard tripped — defensive, should not happen
        on the worker-pipeline op vocabulary)."""
        while True:
            self.sweeps += 1
            if self.sweeps > self.sweep_guard:
                return "budget"
            progress = 0
            for nd in self.topo:
                f = self._step(nd)
                if f:
                    progress += f
                    self.fired[nd.nid] += f
            if self.done == self.n_cmp:
                return "complete"
            if progress == 0:
                return "blocked"

    # ----- diagnosis on a blocked marking -----------------------------------
    def _blocker(self, nd):
        """What prevents ``nd``'s next fire on this marking: ``("in", e)``
        (required empty input), ``("out", e)`` (full output), or ``None``
        when the node has nothing left to do."""
        q, op = self.qlen, nd.op

        def full_out():
            for e in nd.out_edges:
                if self.caps[e.eid] - q[e.eid] <= 0:
                    return e
            return None

        def empty_in(edges):
            for e in edges:
                if q[e.eid] == 0:
                    return e
            return None

        if op == "addr":
            if self.pos[nd.nid] >= int(nd.params["count"]):
                return None
            e = full_out()
            return ("out", e) if e is not None else None
        if op == "cmp":
            if self.cmp_done[nd.nid]:
                return None
            e = empty_in(nd.in_edges)
            return ("in", e) if e is not None else None
        if op == "sync":
            if self.sync_emitted[nd.nid]:
                return None
            e = empty_in(nd.in_edges)
            if e is not None:
                return ("in", e)
            e = full_out()
            return ("out", e) if e is not None else None
        if op == "filter":
            if self.pos[nd.nid] >= len(self.csum[nd.nid]) - 1:
                return None
            if q[nd.in_edges[0].eid] == 0:
                return ("in", nd.in_edges[0])
            e = full_out()
            return ("out", e) if e is not None else None
        if op == "imux":
            if self.pos[nd.nid] >= self.ft[nd.nid]:
                return None
            pat = nd.params["pattern"]
            sel = nd.in_edges[pat[self.pos[nd.nid] % len(pat)]]
            if q[sel.eid] == 0:
                return ("in", sel)
            e = full_out()
            return ("out", e) if e is not None else None
        if not nd.in_edges or self.fired[nd.nid] >= self.ft[nd.nid]:
            return None
        e = empty_in(nd.in_edges)
        if e is not None:
            return ("in", e)
        e = full_out()
        return ("out", e) if e is not None else None

    def output_blocked(self) -> set[int]:
        """Eids of full out-queues of nodes whose only blocker is a full
        output — the candidates a capacity bump can unstick."""
        cands: set[int] = set()
        for nd in self.topo:
            b = self._blocker(nd)
            if b is not None and b[0] == "out":
                for e in nd.out_edges:
                    if self.caps[e.eid] - self.qlen[e.eid] <= 0:
                        cands.add(e.eid)
        return cands

    def counterexample(self) -> Counterexample:
        """Walk the waits-for relation from an unfired cmp: blocked-on-empty
        goes to the producer, blocked-on-full to the consumer.  The walk
        either revisits a node (a waits-for cycle) or reaches a node with
        nothing left to produce (a starvation chain)."""
        start = next(nd for nd in self.topo
                     if nd.op == "cmp" and not self.cmp_done[nd.nid])
        names: list[str] = []
        edescs: list[str] = []
        seen: dict[int, int] = {}
        nd = start
        while nd.nid not in seen:
            seen[nd.nid] = len(names)
            names.append(f"{nd.name}({nd.op})")
            b = self._blocker(nd)
            if b is None:
                fired, total = self.fired[nd.nid], self.ft[nd.nid]
                return Counterexample(
                    kind="starvation-chain", nodes=tuple(names),
                    edges=tuple(edescs),
                    detail=(f"{nd.name} has already produced everything it "
                            f"ever will ({fired}/{total} fires); the tokens "
                            f"downstream is waiting for do not exist"))
            kind, e = b
            state = "empty" if kind == "in" else "full"
            edescs.append(_edge_desc(e, self.qlen[e.eid],
                                     self.caps[e.eid], state))
            nd = e.src if kind == "in" else e.dst
        i = seen[nd.nid]
        return Counterexample(
            kind="waits-cycle", nodes=tuple(names[i:]) + (names[i],),
            edges=tuple(edescs[i:]),
            detail="each node waits on the next; no fire can ever happen")


# ----- lints ----------------------------------------------------------------

def lint_plan(plan, fabric=None) -> list[Finding]:
    """Structural lints over ``plan.dfg`` (+ routed-fabric accounting when
    ``fabric`` is given).  Pure inspection — never mutates the plan."""
    g = plan.dfg
    findings: list[Finding] = []
    try:
        topo = g.topo_order()
    except ValueError as e:
        findings.append(Finding("cyclic-dfg", "error", str(e)))
        return findings
    if not any(nd.op == "cmp" for nd in g.nodes):
        findings.append(Finding(
            "no-cmp", "error",
            "graph has no completion (cmp) node — a run can never finish"))
    for e in g.finalize():
        if e.capacity is not None and e.capacity < 1:
            findings.append(Finding(
                "zero-capacity", "error",
                f"queue {_edge_desc(e, 0, e.capacity, 'declared')} can "
                f"never hold a token", edges=(e.eid,)))
    emit, keeps = token_counts(g)
    for nd in topo:
        ins = [emit[e.src.nid] for e in nd.in_edges]
        if nd.op == "cmp":
            for e in nd.in_edges:
                if emit[e.src.nid] == 0:
                    findings.append(Finding(
                        "cmp-starved", "error",
                        f"completion node {nd.name} port {e.dst_port} never "
                        f"receives a token from {e.src.name}({e.src.op})",
                        nodes=(nd.name, e.src.name)))
        elif nd.op == "sync":
            exp = int(nd.params["expected"])
            arriving = ins[0] if ins else 0
            if exp < 1:
                findings.append(Finding(
                    "sync-degenerate", "error",
                    f"sync {nd.name} expects {exp} tokens; its done trigger "
                    f"can never fire", nodes=(nd.name,)))
            elif arriving < exp:
                findings.append(Finding(
                    "sync-starved", "error",
                    f"sync {nd.name} expects {exp} done tokens but at most "
                    f"{arriving} will ever arrive", nodes=(nd.name,)))
            elif arriving > exp:
                findings.append(Finding(
                    "sync-excess", "warning",
                    f"sync {nd.name} expects {exp} done tokens but "
                    f"{arriving} arrive; {arriving - exp} are never "
                    f"consumed", nodes=(nd.name,)))
        elif nd.op == "filter":
            arr = keeps.get(nd.nid)
            if arr is not None and len(arr) and not arr.any():
                findings.append(Finding(
                    "filter-drops-all", "warning",
                    f"filter {nd.name} drops all {len(arr)} tokens it "
                    f"sees", nodes=(nd.name,)))
        elif nd.op == "imux":
            pat = list(nd.params["pattern"])
            bad = [p for p in pat if p < 0 or p >= len(nd.in_edges)]
            if bad or not pat:
                findings.append(Finding(
                    "splice-pattern", "error",
                    f"imux {nd.name} pattern {pat} references ports {bad} "
                    f"outside its {len(nd.in_edges)} inputs",
                    nodes=(nd.name,)))
            else:
                total = sum(ins)
                rounds, extra = divmod(total, len(pat))
                for port, have in enumerate(ins):
                    need = (rounds * pat.count(port)
                            + sum(1 for j in range(extra) if pat[j] == port))
                    if need != have:
                        findings.append(Finding(
                            "splice-geometry", "error",
                            f"imux {nd.name} pattern consumes {need} tokens "
                            f"from port {port} over {total} fires but "
                            f"{have} arrive", nodes=(nd.name,)))
        elif nd.op in _POP_BOTH and len(ins) >= 2 and ins[0] != ins[1]:
            findings.append(Finding(
                "join-imbalance", "warning",
                f"{nd.name}({nd.op}) joins streams of {ins[0]} vs {ins[1]} "
                f"tokens; the surplus is never consumed", nodes=(nd.name,)))
    cache = getattr(plan, "_compiled_cache", None)
    if cache:
        # entries are (fabric, CompiledPlan) pairs — see compiled_for()
        if any(not cp.is_current() for _fab, cp in cache.values()):
            findings.append(Finding(
                "stale-compile", "warning",
                "cached compiled tables predate a DFG mutation; engines "
                "will transparently recompile"))
    if fabric is not None:
        findings += _lint_fabric(g, fabric)
    return findings


def _lint_fabric(g, fabric) -> list[Finding]:
    """Routed-fabric accounting lints (``fabric`` is a ``RoutedFabric``)."""
    findings: list[Finding] = []
    topo = fabric.topo
    for lk, n in sorted(fabric.channel_load.items()):
        budget = topo.links[lk].channels
        if n > budget:
            findings.append(Finding(
                "channel-overflow", "error",
                f"link {lk[0]}->{lk[1]} carries {n} multicast trees over "
                f"{budget} channels"))
    per_pe: dict = {}
    for nid, coord in fabric.placement.coords.items():
        per_pe[coord] = per_pe.get(coord, 0) + 1
    for coord, n in sorted(per_pe.items()):
        slots = topo.pes[coord].slots
        if n > slots:
            findings.append(Finding(
                "slot-conflict", "error",
                f"PE {coord} holds {n} instructions over its {slots} "
                f"slots"))
    return findings


# ----- throughput bound -----------------------------------------------------

def _required_fires(g, topo, emit, keeps, ft) -> dict[int, int]:
    """Fires each node must perform *before the run can complete* (all cmp
    fired) — a reverse-topo demand pass.  Usually equal to ``ft``; smaller
    when excess tokens exist that completion never waits for."""
    demand: dict[int, int] = {}           # eid -> tokens required on edge
    req: dict[int, int] = {}
    for nd in reversed(topo):
        if nd.op == "cmp":
            r = 1
        else:
            t = max((demand.get(e.eid, 0) for e in nd.out_edges), default=0)
            t = min(t, emit[nd.nid])
            if t == 0:
                r = 0
            elif nd.op == "sync":
                r = int(nd.params["expected"])
            elif nd.op == "filter":
                kpos = np.flatnonzero(keeps[nd.nid])
                r = int(kpos[t - 1]) + 1
            else:
                r = t
        req[nd.nid] = min(r, ft[nd.nid])
        for i, e in enumerate(nd.in_edges):
            if req[nd.nid] == 0:
                d = 0
            elif nd.op == "cmp":
                d = 1
            elif nd.op == "imux":
                pat = nd.params["pattern"]
                d = sum(1 for j in range(req[nd.nid])
                        if pat[j % len(pat)] == i)
            elif nd.op in _POP_BOTH:
                d = req[nd.nid]
            elif i == 0:                  # pop-port-0 ops incl. filter/sync
                d = req[nd.nid]
            else:                         # gating port: one token suffices
                d = 1
            demand[e.eid] = max(demand.get(e.eid, 0), d)
    return req


def throughput_bound(plan, *, fabric=None, machine=None,
                     mem_efficiency: float = 1.0) -> ThroughputBound:
    """Static lower bound on a completing run's cycle count.

    A node at pipeline depth ``d`` (longest in-edge path; an edge costs
    ``1 + hops`` cycles routed, 1 ideal) cannot fire before cycle ``d+1``
    and fires at most once per cycle, so its ``m``-th required fire lands
    at cycle >= ``d+m``.  The memory bound charges every required
    load/store against the shared port's elements-per-cycle budget."""
    g = plan.dfg
    topo = g.topo_order()
    g.finalize()
    emit, keeps = token_counts(g)
    ft = _fires_total(g, topo, emit)
    req = _required_fires(g, topo, emit, keeps, ft)
    hops = {}
    if fabric is not None:
        for e in g.finalize():
            hops[e.eid] = fabric.hops(e)
    depth: dict[int, int] = {}
    for nd in topo:
        depth[nd.nid] = max(
            (depth[e.src.nid] + 1 + hops.get(e.eid, 0)
             for e in nd.in_edges), default=0)
    loads = sum(req[nd.nid] for nd in g.nodes if nd.op == "load")
    stores = sum(req[nd.nid] for nd in g.nodes if nd.op == "store")
    depth_lb = max((depth[nd.nid] + req[nd.nid] for nd in g.nodes),
                   default=0)
    mem_lb = 0
    spec = getattr(plan, "spec", None)
    if machine is not None and spec is not None:
        epc = mem_elems_per_cycle(spec, machine, mem_efficiency)
        if epc > 0:
            mem_lb = math.ceil((loads + stores) / epc)
    cycles_lb = max(depth_lb, mem_lb)
    stage_fill: dict[str, int] = {}
    from repro_torch.telemetry.attribution import stage_label
    for nd in g.nodes:
        lbl = stage_label(nd.stage, nd.op)
        d = depth[nd.nid]
        stage_fill[lbl] = min(stage_fill.get(lbl, d), d)
    fill_lb = min((depth[nd.nid] for nd in g.nodes if nd.op == "store"),
                  default=0)
    return ThroughputBound(
        cycles_lb=cycles_lb, ii_lb=cycles_lb / max(1, stores),
        mem_cycles_lb=mem_lb, depth_cycles_lb=depth_lb,
        loads=loads, stores=stores, fill_lb=fill_lb, stage_fill=stage_fill)


# ----- the verifier ---------------------------------------------------------

def _capacity_certified(plan, findings) -> bool:
    """Fast-path safety certificate: the plan records its analytic per-edge
    minimum capacities (``plan.min_capacities``, the PR 2 mandatory-
    buffering / PR 3 skew-buffer formulas) and every bounded queue is at
    least that minimum (unrecorded edges: the ``apply_min_capacities``
    default).  Capacities only ever help, so any plan at least as large as
    the auto-sizing completes whenever the auto-sized plan does — O(E),
    no token replay needed."""
    mc = getattr(plan, "min_capacities", None)
    if not mc:
        return False
    if any(f.severity == "error" or f.kind in ("join-imbalance",
                                               "sync-excess")
           for f in findings):
        return False
    return all(e.capacity is None
               or e.capacity >= mc.get(id(e), _DEFAULT_MIN_CAP)
               for e in plan.dfg.edges())


def verify_plan(plan, *, fabric=None, machine=None,
                mem_efficiency: float = 1.0) -> StaticReport:
    """Statically verify ``plan`` (optionally placed+routed on ``fabric``):
    lints, deadlock verdict with counterexample + capacity repair, and —
    when the plan can complete — the throughput bound.  Never mutates the
    plan and never runs an engine."""
    findings = lint_plan(plan, fabric)
    if any(f.kind == "cyclic-dfg" for f in findings):
        return StaticReport(
            verdict="deadlock", reason="static-deadlock", certificate="lint",
            findings=findings, counterexample=None,
            suggested_capacities=None, bound=None, stats={})
    g = plan.dfg
    topo = g.topo_order()
    g.finalize()
    emit, keeps = token_counts(g)
    ft = _fires_total(g, topo, emit)
    stats: dict = {"nodes": len(g.nodes), "edges": len(g.finalize()),
                   "total_fires": sum(ft.values())}

    def bound():
        return throughput_bound(plan, fabric=fabric, machine=machine,
                                mem_efficiency=mem_efficiency)

    if not any(nd.op == "cmp" for nd in g.nodes):
        # nothing ever signals completion — structurally stuck by definition
        return StaticReport(
            verdict="deadlock", reason="static-deadlock", certificate="lint",
            findings=findings, counterexample=None,
            suggested_capacities=None, bound=None, stats=stats)
    if _capacity_certified(plan, findings):
        stats["certificate"] = "min-capacities"
        return StaticReport(
            verdict="safe", reason=None, certificate="min-capacities",
            findings=findings, counterexample=None,
            suggested_capacities=None, bound=bound(), stats=stats)

    flow = _TokenFlow(g, emit, keeps, ft)
    status = flow.run()
    counter = None
    suggested: dict[int, int] | None = None
    if status == "blocked":
        counter = flow.counterexample()
        # capacity repair: bump every output-blocked full queue by one and
        # resume — tokens only move forward, so the partial marking stays
        # valid under the larger capacities.  Terminates: total tokens are
        # finite, so either the flow completes or nothing is output-blocked.
        suggested = {}
        rounds = 0
        guard = flow.total_fires + len(flow.edges) + 64
        while status == "blocked":
            cands = flow.output_blocked()
            if not cands:
                suggested = None          # structural: no bump can help
                break
            rounds += 1
            if rounds > guard:
                status = "budget"
                break
            for eid in cands:
                flow.caps[eid] += 1
                suggested[eid] = flow.caps[eid]
            status = flow.run()
        stats["bump_rounds"] = rounds
    stats["sweeps"] = flow.sweeps
    if status == "budget":
        return StaticReport(
            verdict="unknown", reason=None, certificate=None,
            findings=findings, counterexample=counter,
            suggested_capacities=None, bound=None, stats=stats)
    if counter is not None:
        reason = ("static-capacity" if suggested else "static-deadlock")
        return StaticReport(
            verdict="deadlock", reason=reason, certificate="quiescence",
            findings=findings, counterexample=counter,
            suggested_capacities=suggested or None, bound=None, stats=stats)
    stats["certificate"] = "quiescence"
    return StaticReport(
        verdict="safe", reason=None, certificate="quiescence",
        findings=findings, counterexample=None, suggested_capacities=None,
        bound=bound(), stats=stats)


def suggest_capacity_fix(plan) -> dict[int, int] | None:
    """The verifier's repair hint for a deadlocking plan: an ``{eid:
    capacity}`` map proven sufficient for completion, or ``None`` when the
    plan is safe, structurally stuck, or unanalyzable."""
    try:
        report = verify_plan(plan)
    except Exception:                     # diagnosis must never mask errors
        return None
    return report.suggested_capacities


def apply_suggested_capacities(plan, suggested: dict) -> int:
    """Grow the plan's queues to a ``suggested_capacities`` hint (eid keys;
    JSON-string keys from cache records accepted).  Returns the number of
    edges grown; marks the DFG mutated so compiled tables invalidate."""
    edges = plan.dfg.finalize()
    grown = 0
    for eid, cap in suggested.items():
        e = edges[int(eid)]
        if e.capacity is not None and e.capacity < int(cap):
            e.capacity = int(cap)
            grown += 1
    if grown:
        plan.dfg.mark_mutated()
    return grown


def check_static(plan, *, fabric=None, machine=None,
                 mem_efficiency: float = 1.0) -> StaticReport:
    """``simulate(..., verify="static")`` pre-flight: run the verifier and
    raise :class:`StaticDeadlock` (with the repair hint attached) when the
    plan provably cannot complete.  Returns the report otherwise."""
    report = verify_plan(plan, fabric=fabric, machine=machine,
                         mem_efficiency=mem_efficiency)
    if report.verdict == "deadlock":
        raise StaticDeadlock(
            f"static verifier rejected the plan before simulation: "
            f"{report.describe()}", report=report)
    return report
