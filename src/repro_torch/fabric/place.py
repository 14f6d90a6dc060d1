"""Placement: logical DFG nodes -> physical PEs (stage/worker-aware).

Two phases, both deterministic under a fixed seed:

1. **Greedy seed** — nodes are laid out worker-pipeline by worker-pipeline
   (reader → compute → writer → sync per worker) along a snake scan of the
   grid, so each worker's MUL→MAC chain starts out physically contiguous.
   Memory ops (load/store) are snapped to the nearest mem-capable PE (the
   fabric boundary, where the memory ports are).

2. **Simulated annealing** — random single-node moves and pair swaps,
   accepted by Metropolis on the *weighted hop count*
   ``sum_e traffic(e) * hops(e)``, where ``traffic`` is the analytic number
   of tokens each queue carries (reader streams, filter keep-counts, writer
   stores — all known statically from the MappingPlan).

The weighted hop count is exactly the quantity the network-aware simulator
pays for, so annealing directly minimizes routed latency and link pressure.
"""
from __future__ import annotations

import dataclasses
import math
import random

from repro_torch.core.dfg import DFG, Edge, Node
from repro_torch.core.mapping import MappingPlan
from repro_torch.fabric.topology import Coord, FabricTopology, op_class


class PlacementError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# analytic per-edge traffic (tokens pushed over the edge during one run)
# ---------------------------------------------------------------------------
def _node_tokens(n: Node, memo: dict[int, int]) -> int:
    if n.nid in memo:
        return memo[n.nid]
    memo[n.nid] = 1  # cycle guard (DFGs are acyclic; belt and braces)
    op = n.op
    if op == "addr":
        t = n.params["count"]
    elif op == "load":
        t = _node_tokens(n.in_edges[0].src, memo) if n.in_edges else 1
    elif op == "filter":
        t = n.params.get("keep_count", n.params.get("n", 1))
    elif op == "store":
        t = len(n.params.get("indices", ())) or 1
    elif op == "sync":
        t = 1
    elif op == "cmp":
        t = 0
    elif op == "imux":  # re-interleave: forwards every popped input token
        t = (sum(_node_tokens(e.src, memo) for e in n.in_edges)
             if n.in_edges else 1)
    else:  # mul/mac/add/mux/demux/copy: fire once per complete input set
        t = (min(_node_tokens(e.src, memo) for e in n.in_edges)
             if n.in_edges else 1)
    memo[n.nid] = t
    return t


def edge_traffic(g: DFG) -> dict[int, int]:
    """edge id -> analytic token count (the annealing weight)."""
    memo: dict[int, int] = {}
    return {id(e): _node_tokens(e.src, memo) for e in g.edges()}


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Placement:
    topo: FabricTopology
    plan: MappingPlan
    coords: dict[int, Coord]            # nid -> PE coordinate
    seed: int
    traffic: dict[int, int]             # edge id -> tokens

    def hops(self, e: Edge) -> int:
        return self.topo.distance(self.coords[e.src.nid],
                                  self.coords[e.dst.nid])

    def weighted_hops(self) -> int:
        return sum(self.traffic[id(e)] * self.hops(e)
                   for e in self.plan.dfg.edges())

    def pes_used(self) -> int:
        return len(set(self.coords.values()))

    def utilization(self) -> float:
        """Fraction of physical PEs holding at least one instruction."""
        return self.pes_used() / len(self.topo.pes)


def _stage_rank(n: Node) -> int:
    return {"reader": 0, "compute": 1, "writer": 2, "sync": 3}.get(n.stage, 4)


def _seed_key(n: Node) -> tuple:
    """Greedy-seed order: subgraph by subgraph (program graphs tag each
    operator's nodes with ``subgraph=<topo index>`` so every op's chains stay
    physically contiguous instead of interleaving by worker id), then worker
    pipeline by worker pipeline, and *within* a compute worker one axis
    tap-chain at a time (rank-3 workers carry three chains plus an ADD tree;
    interleaving them would scatter each MUL→MAC string across the fabric
    before annealing starts).  Temporal layers are kept together the same
    way.  Single-op plans carry no ``subgraph`` tag — their order is
    unchanged."""
    return (n.params.get("subgraph", 0), n.worker, _stage_rank(n),
            n.params.get("layer", 0), -n.params.get("axis", -1), n.nid)


def _snake(topo: FabricTopology) -> list[Coord]:
    out = []
    for r in range(topo.rows):
        cols = range(topo.cols) if r % 2 == 0 else range(topo.cols - 1, -1, -1)
        out.extend((r, c) for c in cols)
    return out


def place(plan: MappingPlan, topo: FabricTopology, *, seed: int = 0,
          anneal_iters: int | None = None, restarts: int = 1) -> Placement:
    """Place every DFG node on a capability-compatible PE slot.

    ``restarts > 1`` runs the whole greedy-seed + annealing pipeline under
    seeds ``seed, seed+1, …`` and keeps the placement with the lowest
    weighted hop count — the restartable form the mapping auto-tuner
    (``repro.explore``) uses to spend extra placement budget on finalists.
    Deterministic for a fixed ``(seed, restarts)``; ``restarts=1`` is
    bit-identical to the previous single-shot behaviour."""
    if restarts < 1:
        raise ValueError("restarts must be >= 1")
    if restarts > 1:
        best = None
        for s in range(seed, seed + restarts):
            cand = place(plan, topo, seed=s, anneal_iters=anneal_iters)
            if best is None or cand.weighted_hops() < best.weighted_hops():
                best = cand
        return best
    g = plan.dfg
    nodes = sorted(g.nodes, key=_seed_key)
    if len(nodes) > topo.total_slots():
        raise PlacementError(
            f"{len(nodes)} instructions exceed {topo.total_slots()} PE slots "
            f"on {topo!r}")
    # per-capability-class budgets: deep multi-chain workers (3D, fused
    # layers) are alu/util-heavy, so check every class, not just mem.
    demand: dict[str, int] = {}
    for n in nodes:
        cls = op_class(n.op)
        demand[cls] = demand.get(cls, 0) + 1
    for cls, need in demand.items():
        have = topo.total_slots(cls)
        if need > have:
            where = " (fabric boundary)" if cls == "mem" else ""
            raise PlacementError(
                f"{need} {cls!r} ops exceed {have} {cls}-capable slots"
                f"{where}")

    # --- phase 1: greedy snake-order seed -----------------------------------
    order = _snake(topo)
    free = {c: topo.pes[c].slots for c in order}
    coords: dict[int, Coord] = {}
    cursor = 0
    for n in nodes:
        if op_class(n.op) == "mem":
            # snap to nearest mem-capable PE with a free slot
            anchor = order[cursor % len(order)]
            best = min(
                (c for c in order if free[c] > 0 and topo.capable(c, n.op)),
                key=lambda c: (topo.distance(anchor, c), c))
            coords[n.nid] = best
            free[best] -= 1
            continue
        while free[order[cursor % len(order)]] <= 0:
            cursor += 1
        c = order[cursor % len(order)]
        coords[n.nid] = c
        free[c] -= 1

    traffic = edge_traffic(g)
    pl = Placement(topo, plan, coords, seed, traffic)

    # --- phase 2: simulated annealing on weighted hop count -----------------
    rng = random.Random(seed)
    iters = (anneal_iters if anneal_iters is not None
             else min(30_000, 60 * len(nodes)))
    if iters <= 0:
        return pl

    # incident edge lists for O(degree) delta evaluation
    incident: dict[int, list[Edge]] = {n.nid: [] for n in g.nodes}
    for e in g.edges():
        incident[e.src.nid].append(e)
        if e.dst.nid != e.src.nid:
            incident[e.dst.nid].append(e)

    def node_cost(nid: int) -> int:
        return sum(traffic[id(e)] * topo.distance(coords[e.src.nid],
                                                  coords[e.dst.nid])
                   for e in incident[nid])

    all_coords = list(order)
    by_nid = {n.nid: n for n in g.nodes}
    residents: dict[Coord, list[int]] = {c: [] for c in order}
    for nid, c in coords.items():
        residents[c].append(nid)
    movable = [n.nid for n in nodes if incident[n.nid]]
    mean_w = (sum(traffic.values()) / max(1, len(traffic)))
    t0, t1 = 4.0 * mean_w, 0.02 * mean_w + 1e-9
    cooling = (t1 / t0) ** (1.0 / iters)
    temp = t0
    for _ in range(iters):
        temp *= cooling
        nid = movable[rng.randrange(len(movable))]
        tgt = all_coords[rng.randrange(len(all_coords))]
        src_c = coords[nid]
        if tgt == src_c or not topo.capable(tgt, by_nid[nid].op):
            continue
        if free[tgt] > 0:                      # move into a free slot
            before = node_cost(nid)
            coords[nid] = tgt
            delta = node_cost(nid) - before
            if delta <= 0 or rng.random() < math.exp(-delta / temp):
                free[tgt] -= 1
                free[src_c] += 1
                residents[src_c].remove(nid)
                residents[tgt].append(nid)
            else:
                coords[nid] = src_c
        else:                                  # swap with a resident node
            here = [m for m in residents[tgt]
                    if topo.capable(src_c, by_nid[m].op)]
            if not here:
                continue
            mid = here[rng.randrange(len(here))]
            before = node_cost(nid) + node_cost(mid)
            coords[nid], coords[mid] = tgt, src_c
            delta = node_cost(nid) + node_cost(mid) - before
            if delta <= 0 or rng.random() < math.exp(-delta / temp):
                residents[src_c].remove(nid)
                residents[tgt].append(nid)
                residents[tgt].remove(mid)
                residents[src_c].append(mid)
            else:
                coords[nid], coords[mid] = src_c, tgt

    # invariant check: capabilities + slot budgets survived annealing
    occ: dict[Coord, int] = {}
    for n in g.nodes:
        c = coords[n.nid]
        occ[c] = occ.get(c, 0) + 1
        if not topo.capable(c, n.op):
            raise PlacementError(f"node {n.name} ({n.op}) on incapable PE {c}")
    for c, k in occ.items():
        if k > topo.pes[c].slots:
            raise PlacementError(f"PE {c} over capacity: {k} instructions")
    return pl
