"""Dataflow-graph DSL (paper §V).

An algorithm for the CGRA is a graph whose nodes are instructions mapped to
PEs and whose edges are producer→consumer queues.  The paper built a C-based
DSL that creates each pipeline stage (control / reader / compute / writer /
sync workers) parametrically, auto-connects ports by name, emits a high-level
assembly program, and renders Graphviz dot.  This module is that tool in
Python.

Node op vocabulary (matches the paper's Fig. 7 legend):
  ``load``/``store``      memory ops (rate-limited by the memory model)
  ``mul``/``mac``/``add`` arithmetic PEs (1 / 2 / 1 flops per fire)
  ``filter``              data-filtering PE (0^m 1^n 0^p patterns, §III-A)
  ``addr``                address/index generator (control unit)
  ``sync``                store counter -> done trigger
  ``mux``/``demux``/``copy``/``cmp``  pass-through utility ops
  ``imux``                pattern-driven interleaving mux (program-graph
                          re-interleave buffers, ``repro.program.lower``)
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Optional

FLOPS_PER_OP = {"mul": 1, "mac": 2, "add": 1}

# dot colours follow the paper's Fig. 7 legend.
_DOT_COLORS = {
    "mux": "lightyellow", "imux": "lightyellow", "mul": "orange", "mac": "red",
    "demux": "lightblue",
    "add": "green", "addr": "cyan", "load": "palegreen", "store": "plum",
    "filter": "gray80", "sync": "gold", "copy": "gray90", "cmp": "gray90",
}


@dataclasses.dataclass
class Edge:
    """A producer→consumer queue."""
    src: "Node"
    dst: "Node"
    dst_port: int
    capacity: Optional[int] = None       # None = unbounded
    q: deque = dataclasses.field(default_factory=deque)
    max_occupancy: int = 0
    eid: int = -1                        # dense id, assigned by DFG.finalize()

    def full(self) -> bool:
        return self.capacity is not None and len(self.q) >= self.capacity

    def push(self, v) -> None:
        self.q.append(v)
        if len(self.q) > self.max_occupancy:
            self.max_occupancy = len(self.q)


@dataclasses.dataclass
class Node:
    """One instruction mapped to one PE."""
    nid: int
    op: str
    name: str
    stage: str = ""                      # reader|compute|writer|sync|control
    worker: int = -1                     # logical worker id
    params: dict = dataclasses.field(default_factory=dict)
    in_edges: list = dataclasses.field(default_factory=list)   # port-ordered
    out_edges: list = dataclasses.field(default_factory=list)  # broadcast set
    fires: int = 0


class DFG:
    """Builder + container.  ``add``/``connect`` mirror the paper's DSL API."""

    def __init__(self, name: str = "dfg"):
        self.name = name
        self.nodes: list[Node] = []
        self._ids = itertools.count()
        self._version = 0                 # bumped on add/connect
        self._finalized_version = -1
        self._edge_list: list[Edge] = []

    # ----- construction -----------------------------------------------------
    def add(self, op: str, name: str = "", *, stage: str = "", worker: int = -1,
            **params) -> Node:
        n = Node(nid=next(self._ids), op=op, name=name or f"{op}{worker}",
                 stage=stage, worker=worker, params=params)
        self.nodes.append(n)
        self._version += 1
        return n

    def connect(self, src: Node, dst: Node, port: int | None = None,
                capacity: Optional[int] = None) -> Edge:
        port = len(dst.in_edges) if port is None else port
        e = Edge(src=src, dst=dst, dst_port=port, capacity=capacity)
        src.out_edges.append(e)
        # keep in_edges port-ordered
        dst.in_edges.append(e)
        dst.in_edges.sort(key=lambda ee: ee.dst_port)
        self._version += 1
        return e

    # ----- compile hooks (repro_torch.core.engine) ---------------------------
    @property
    def version(self) -> int:
        """Monotone mutation counter — compiled tables key on it so stale
        compiles are detected (see ``repro_torch.core.engine.compile``)."""
        return self._version

    def mark_mutated(self) -> None:
        """Record an out-of-band mutation (e.g. edge-capacity rewrites by
        ``apply_min_capacities``) so cached compiled plans invalidate."""
        self._version += 1

    def finalize(self) -> list[Edge]:
        """Assign dense ``Edge.eid`` ids (producer order, then port order) and
        return the edge list.  Idempotent until the graph is mutated again;
        node ``nid``s are already dense by construction."""
        if self._finalized_version != self._version:
            self._edge_list = []
            for n in self.nodes:
                for e in n.out_edges:
                    e.eid = len(self._edge_list)
                    self._edge_list.append(e)
            self._finalized_version = self._version
        return self._edge_list

    def topo_order(self) -> list[Node]:
        """Kahn topological order (worker pipelines are feed-forward DAGs)."""
        indeg = {n.nid: len(n.in_edges) for n in self.nodes}
        by_nid = {n.nid: n for n in self.nodes}
        ready = [n for n in self.nodes if not indeg[n.nid]]
        out: list[Node] = []
        while ready:
            n = ready.pop()
            out.append(n)
            for e in n.out_edges:
                indeg[e.dst.nid] -= 1
                if indeg[e.dst.nid] == 0:
                    ready.append(by_nid[e.dst.nid])
        if len(out) != len(self.nodes):
            raise ValueError(f"DFG {self.name!r} has a cycle; cannot compile")
        return out

    # ----- inventory ---------------------------------------------------------
    def pe_counts(self) -> dict[str, int]:
        c: dict[str, int] = {}
        for n in self.nodes:
            c[n.op] = c.get(n.op, 0) + 1
        return c

    def mac_pes(self) -> int:
        """MAC-slot PEs the roofline counts (mul+mac+add occupy MAC-capable PEs)."""
        return sum(1 for n in self.nodes if n.op in FLOPS_PER_OP)

    def edges(self):
        for n in self.nodes:
            yield from n.out_edges

    # ----- emitters (paper §V: dot + high-level assembly) --------------------
    def to_dot(self) -> str:
        lines = [f'digraph "{self.name}" {{', "  rankdir=LR;", "  node [style=filled];"]
        stages = {}
        for n in self.nodes:
            stages.setdefault((n.stage, n.worker), []).append(n)
        for (stage, worker), ns in sorted(stages.items()):
            lines.append(f'  subgraph "cluster_{stage}_{worker}" {{')
            lines.append(f'    label="{stage} worker {worker}";')
            for n in ns:
                color = _DOT_COLORS.get(n.op, "white")
                lines.append(
                    f'    n{n.nid} [label="{n.name}\\n{n.op}", fillcolor="{color}"];')
            lines.append("  }")
        for e in self.edges():
            cap = "" if e.capacity is None else f' [label="q={e.capacity}"]'
            lines.append(f"  n{e.src.nid} -> n{e.dst.nid}{cap};")
        lines.append("}")
        return "\n".join(lines)

    def to_assembly(self) -> str:
        """High-level assembly: one line per PE instruction, named ports."""
        out = [f"; {self.name}: {len(self.nodes)} PEs, "
               f"{sum(1 for _ in self.edges())} queues"]
        for n in self.nodes:
            srcs = ",".join(f"n{e.src.nid}.out" for e in n.in_edges) or "-"
            dsts = ",".join(f"n{e.dst.nid}.p{e.dst_port}" for e in n.out_edges) or "-"
            ps = " ".join(f"{k}={v}" for k, v in n.params.items()
                          if not callable(v) and not isinstance(v, (list, dict)))
            out.append(f"PE{n.nid:<5} {n.op:<7} dst=[{dsts}] src=[{srcs}] "
                       f"stage={n.stage}/{n.worker} {ps}")
        return "\n".join(out)
