"""Dimension-ordered XY routing with per-link channel accounting.

Every DFG edge whose endpoints sit on different PEs becomes a static route:
column-first (X), then row (Y) — deadlock-free dimension-ordered routing; on
a torus each axis takes the shorter wrap direction.

Fan-out is **multicast**: the XY routes from one producer to its consumers
always share link prefixes, and their union is a tree, so all edges of one
producer occupy a single channel (routing track) on every shared link and a
broadcast token crosses each tree link once — exactly the paper's
load-once/forward-neighbor-to-neighbor claim, and the BandMap model of
circuit-switched CGRA interconnect allocation.  When any link's tree count
exceeds its channel budget, :func:`route` fails loudly with the hot-spot
list — a mapping that does not route is not a mapping.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.dfg import Edge
from repro_torch.fabric.place import Placement
from repro_torch.fabric.topology import Coord, FabricTopology, LinkKey

EdgeKey = tuple[int, int, int]          # (src nid, dst nid, dst port)


def edge_key(e: Edge) -> EdgeKey:
    return (e.src.nid, e.dst.nid, e.dst_port)


class RouteError(RuntimeError):
    pass


def _axis_steps(a: int, b: int, n: int, torus: bool) -> list[int]:
    """Positions visited walking one axis from a to b (excluding a)."""
    if a == b:
        return []
    fwd = (b - a) % n
    bwd = (a - b) % n
    if torus and bwd < fwd:
        step, dist = -1, bwd
    elif torus:
        step, dist = 1, fwd
    else:
        step, dist = (1 if b > a else -1), abs(b - a)
    out, cur = [], a
    for _ in range(dist):
        cur = (cur + step) % n if torus else cur + step
        out.append(cur)
    return out


def xy_route(topo: FabricTopology, src: Coord, dst: Coord) -> list[LinkKey]:
    """Directed link sequence of the X-then-Y dimension-ordered route."""
    links: list[LinkKey] = []
    cur = src
    for c in _axis_steps(src[1], dst[1], topo.cols, topo.torus):   # X first
        nxt = (cur[0], c)
        links.append((cur, nxt))
        cur = nxt
    for r in _axis_steps(src[0], dst[0], topo.rows, topo.torus):   # then Y
        nxt = (r, cur[1])
        links.append((cur, nxt))
        cur = nxt
    assert cur == dst
    return links


@dataclasses.dataclass
class RoutedFabric:
    """A fully placed-and-routed configuration, ready to simulate."""
    placement: Placement
    routes: dict[EdgeKey, tuple[LinkKey, ...]]
    channel_load: dict[LinkKey, int]       # multicast trees per link
    traffic_load: dict[LinkKey, int]       # token-traffic per link

    @property
    def topo(self) -> FabricTopology:
        return self.placement.topo

    def route_for(self, e: Edge) -> tuple[LinkKey, ...]:
        return self.routes[edge_key(e)]

    def hops(self, e: Edge) -> int:
        return len(self.routes[edge_key(e)])

    def link_index(self) -> dict[LinkKey, int]:
        """Dense link ids (topology iteration order) for engines that keep
        per-link bandwidth state in flat arrays instead of dict probes
        (``repro_torch.core.engine.compile.compile_network``)."""
        return {lk: i for i, lk in enumerate(self.topo.links)}

    def words_per_cycle(self) -> list[int]:
        """Per-link dynamic bandwidth, aligned with :meth:`link_index`."""
        return [l.words_per_cycle for l in self.topo.links.values()]

    def link_names(self) -> list[str]:
        """Human-readable ``(r,c)->(r,c)`` labels aligned with
        :meth:`link_index` — the one naming scheme shared by :meth:`stats`
        hotspots and the telemetry link tracks (``repro_torch.telemetry``), so a
        link in a Perfetto trace is findable in the routing report."""
        return [f"{a}->{b}" for a, b in self.topo.links]

    # ----- congestion / utilization reporting -------------------------------
    def hotspots(self, k: int = 5) -> list[tuple[LinkKey, int, int]]:
        """Top-k links by channel load: (link, trees, token traffic)."""
        ranked = sorted(self.channel_load,
                        key=lambda l: (-self.channel_load[l],
                                       -self.traffic_load.get(l, 0), l))
        return [(l, self.channel_load[l], self.traffic_load.get(l, 0))
                for l in ranked[:k]]

    def stats(self) -> dict:
        hops = [len(r) for r in self.routes.values()]
        routed = [h for h in hops if h > 0]
        topo = self.topo
        max_load = max(self.channel_load.values(), default=0)
        return {
            "pes_used": self.placement.pes_used(),
            "pe_utilization": round(self.placement.utilization(), 4),
            "edges": len(self.routes),
            "edges_routed": len(routed),
            "edges_local": len(hops) - len(routed),
            "hops_mean": round(sum(hops) / max(1, len(hops)), 3),
            "hops_max": max(hops, default=0),
            "weighted_hops": self.placement.weighted_hops(),
            "links_used": len(self.channel_load),
            "link_utilization": round(
                len(self.channel_load) / max(1, len(topo.links)), 4),
            "max_channel_load": max_load,
            "channel_capacity": (min(l.channels for l in topo.links.values())
                                 if topo.links else 0),
            "hotspots": [
                {"link": f"{a}->{b}", "trees": c, "traffic": t}
                for (a, b), c, t in self.hotspots()],
        }


def route(placement: Placement, *, strict: bool = True) -> RoutedFabric:
    """Route every DFG edge; ``strict`` fails when channel demand exceeds any
    link's budget (set False to get the overloaded result for inspection)."""
    topo = placement.topo
    routes: dict[EdgeKey, tuple[LinkKey, ...]] = {}
    channel_load: dict[LinkKey, int] = {}
    traffic_load: dict[LinkKey, int] = {}
    for n in placement.plan.dfg.nodes:
        if not n.out_edges:
            continue
        src = placement.coords[n.nid]
        tree: set[LinkKey] = set()         # union of this producer's routes
        for e in n.out_edges:
            dst = placement.coords[e.dst.nid]
            links = tuple(xy_route(topo, src, dst))
            routes[edge_key(e)] = links
            tree.update(links)
        # one channel + one token-copy per tree link (multicast)
        w = max((placement.traffic.get(id(e), 1) for e in n.out_edges),
                default=1)
        for lk in tree:
            assert lk in topo.links, f"route uses non-existent link {lk}"
            channel_load[lk] = channel_load.get(lk, 0) + 1
            traffic_load[lk] = traffic_load.get(lk, 0) + w
    rf = RoutedFabric(placement, routes, channel_load, traffic_load)
    if strict:
        over = [(lk, n) for lk, n in channel_load.items()
                if n > topo.links[lk].channels]
        if over:
            over.sort(key=lambda x: -x[1])
            msg = ", ".join(f"{a}->{b}: {n}/{topo.links[(a, b)].channels}"
                            for (a, b), n in over[:5])
            raise RouteError(
                f"{len(over)} link(s) over channel capacity (demand/budget): "
                f"{msg}. Use a larger fabric, more channels/link, or a "
                f"different placement seed.")
    return rf


def apply_routed_capacities(rf: RoutedFabric, *, slack: int = 1) -> int:
    """Grow every bounded edge's queue capacity by its routed hop depth.

    The ideal-mode minima (``MappingPlan.min_capacities``) assume a token is
    consumable the cycle after it is produced.  On the routed fabric a token
    spends ``hops`` extra cycles in per-link transit buffers, and the routed
    engines count in-flight transit words against the edge's capacity — so an
    edge sized to the ideal minimum back-pressures (or deadlocks a mux cycle)
    purely because its route is long.  This rewrites each bounded edge to::

        capacity += hops(edge) + slack

    leaving unbounded edges (``capacity=None``) alone, and returns the number
    of edges grown.  The mutation is recorded (``DFG.mark_mutated``) so the
    compiled-engine plan cache re-specializes instead of reusing a stale
    ring presize.  The tuner applies this automatically for routed
    evaluations when ``SearchConfig.capacity == "auto"``.
    """
    g = rf.placement.plan.dfg
    grown = 0
    for e in g.edges():
        if e.capacity is None:
            continue
        hops = len(rf.routes.get(edge_key(e), ()))
        if hops:
            e.capacity += hops + slack
            grown += 1
    if grown:
        g.mark_mutated()
    return grown
