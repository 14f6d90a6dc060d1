"""Per-PE configuration export for a placed-and-routed mapping.

Physical twins of the logical emitters in ``core.dfg`` (paper §V):

* :func:`placed_assembly` — ``DFG.to_assembly()`` extended with each
  instruction's physical PE coordinate and each queue's route, written as a
  compass-direction string (``E E N``), i.e. the switch settings a bitstream
  generator would consume.
* :func:`placed_dot` — ``DFG.to_dot()`` with nodes pinned at their grid
  coordinates (``pos="col,row!"``, neato-compatible) and colored by stage,
  so the physical layout renders as the fabric floorplan.
"""
from __future__ import annotations

from repro_torch.core.dfg import _DOT_COLORS
from repro_torch.fabric.route import RoutedFabric
from repro_torch.fabric.topology import FabricTopology, LinkKey


def _direction(lk: LinkKey, topo: FabricTopology) -> str:
    (r1, c1), (r2, c2) = lk
    dr, dc = r2 - r1, c2 - c1
    # wrap-form deltas (e.g. dc == 1-cols for an eastward wrap) only exist on
    # a torus; on a mesh they would collide with the opposite direction when
    # cols == 2 or rows == 2.
    if dc == 1 or (topo.torus and dc == 1 - topo.cols):
        return "E"
    if dc == -1 or (topo.torus and dc == topo.cols - 1):
        return "W"
    if dr == 1 or (topo.torus and dr == 1 - topo.rows):
        return "S"
    return "N"


def route_string(rf: RoutedFabric, links: tuple[LinkKey, ...]) -> str:
    return " ".join(_direction(lk, rf.topo) for lk in links) or "local"


def placed_assembly(rf: RoutedFabric) -> str:
    """One line per instruction with its PE coordinate and routed queues."""
    pl = rf.placement
    g = pl.plan.dfg
    out = [f"; {g.name} on {pl.topo!r}",
           f"; placement seed={pl.seed} weighted_hops={pl.weighted_hops()}"]
    for n in g.nodes:
        r, c = pl.coords[n.nid]
        srcs = ",".join(f"n{e.src.nid}.out" for e in n.in_edges) or "-"
        for line in [f"PE({r:>2},{c:>2}) n{n.nid:<4} {n.op:<7} "
                     f"stage={n.stage}/{n.worker} src=[{srcs}]"]:
            out.append(line)
        for e in n.out_edges:
            links = rf.route_for(e)
            dst_r, dst_c = pl.coords[e.dst.nid]
            out.append(f"    -> n{e.dst.nid}.p{e.dst_port} @({dst_r},{dst_c}) "
                       f"hops={len(links)} route=[{route_string(rf, links)}]")
    return "\n".join(out)


def placed_dot(rf: RoutedFabric) -> str:
    """Graphviz dot with physical positions (render with ``neato -n``)."""
    pl = rf.placement
    g = pl.plan.dfg
    scale = 1.2
    lines = [f'digraph "{g.name}_placed" {{',
             "  layout=neato;", "  node [style=filled, shape=box];"]
    # offset co-resident instructions slightly so they stay visible
    seen: dict[tuple[int, int], int] = {}
    for n in g.nodes:
        r, c = pl.coords[n.nid]
        k = seen.get((r, c), 0)
        seen[(r, c)] = k + 1
        x = c * scale + 0.25 * (k % 2)
        y = -r * scale - 0.25 * (k // 2)
        color = _DOT_COLORS.get(n.op, "white")
        lines.append(
            f'  n{n.nid} [label="{n.name}\\n({r},{c})", '
            f'fillcolor="{color}", pos="{x:.2f},{y:.2f}!"];')
    for e in g.edges():
        hops = rf.hops(e)
        attr = "" if hops == 0 else f' [label="{hops}h"]'
        lines.append(f"  n{e.src.nid} -> n{e.dst.nid}{attr};")
    lines.append("}")
    return "\n".join(lines)
