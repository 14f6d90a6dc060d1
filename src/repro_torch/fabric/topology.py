"""Physical PE-grid fabric model (paper §II hardware).

The paper's CGRA is a 2D array of processing elements joined by an on-chip
network; loaded values travel PE-to-PE instead of through shared memory.
``FabricTopology`` is the parametric description of that hardware the rest of
the ``fabric`` subsystem maps onto:

* an R×C grid of PEs with per-PE *op-class* capabilities and a small number
  of instruction ``slots`` (real CGRAs time-multiplex a few static
  instructions per PE);
* 4-neighbour directed links, either **mesh** (no wraparound) or **torus**
  (wraparound), each with a static routing-track budget (``channels`` —
  BandMap-style circuit-switched allocation) and a dynamic bandwidth
  (``words_per_cycle`` — contended during network-aware simulation).

Memory ports live on the fabric boundary by default: only boundary PEs carry
the ``mem`` capability, so loads/stores must be placed where the memory
controllers are — the physical constraint that makes placement non-trivial.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

Coord = tuple[int, int]                 # (row, col)
LinkKey = tuple[Coord, Coord]           # directed (src PE, dst PE)

# op -> op-class; placement only matches classes, not individual ops.
OP_CLASS = {
    "load": "mem", "store": "mem",
    "mul": "alu", "mac": "alu", "add": "alu",
    # everything else (filter/addr/sync/mux/demux/copy/cmp) is light-weight
    # control/routing logic any PE implements.
}


def op_class(op: str) -> str:
    return OP_CLASS.get(op, "util")


@dataclasses.dataclass(frozen=True)
class PE:
    row: int
    col: int
    capabilities: frozenset[str]        # subset of {"mem", "alu", "util"}
    slots: int                          # static instructions this PE can hold

    @property
    def coord(self) -> Coord:
        return (self.row, self.col)


@dataclasses.dataclass(frozen=True)
class Link:
    src: Coord
    dst: Coord
    channels: int                       # static routing tracks (route-time)
    words_per_cycle: int                # dynamic bandwidth (sim-time)

    @property
    def key(self) -> LinkKey:
        return (self.src, self.dst)


class FabricTopology:
    """R×C PE grid with 4-neighbour links (mesh or torus)."""

    def __init__(self, rows: int, cols: int, *, torus: bool = False,
                 slots: int = 4, channels: int = 32, words_per_cycle: int = 1,
                 mem_boundary_only: bool = True):
        if rows < 2 or cols < 2:
            raise ValueError("fabric needs at least a 2x2 grid")
        self.rows = rows
        self.cols = cols
        self.torus = torus
        self.pes: dict[Coord, PE] = {}
        for r in range(rows):
            for c in range(cols):
                caps = {"alu", "util"}
                boundary = r in (0, rows - 1) or c in (0, cols - 1)
                if boundary or not mem_boundary_only:
                    caps.add("mem")
                self.pes[(r, c)] = PE(r, c, frozenset(caps), slots)
        self.links: dict[LinkKey, Link] = {}
        for (r, c) in self.pes:
            for dr, dc in ((0, 1), (0, -1), (1, 0), (-1, 0)):
                nr, nc = r + dr, c + dc
                if torus:
                    nr, nc = nr % rows, nc % cols
                elif not (0 <= nr < rows and 0 <= nc < cols):
                    continue
                self.links[((r, c), (nr, nc))] = Link(
                    (r, c), (nr, nc), channels, words_per_cycle)

    # ----- constructors ------------------------------------------------------
    @classmethod
    def mesh(cls, rows: int, cols: int, **kw) -> "FabricTopology":
        return cls(rows, cols, torus=False, **kw)

    @classmethod
    def torus_grid(cls, rows: int, cols: int, **kw) -> "FabricTopology":
        return cls(rows, cols, torus=True, **kw)

    # ----- geometry ----------------------------------------------------------
    def coords(self) -> Iterator[Coord]:
        return iter(self.pes)

    def capable(self, coord: Coord, op: str) -> bool:
        return op_class(op) in self.pes[coord].capabilities

    def _axis_dist(self, a: int, b: int, n: int) -> int:
        d = abs(a - b)
        return min(d, n - d) if self.torus else d

    def distance(self, a: Coord, b: Coord) -> int:
        """Hop count of the minimal (XY) route between two PEs."""
        return (self._axis_dist(a[0], b[0], self.rows)
                + self._axis_dist(a[1], b[1], self.cols))

    def total_slots(self, cls_name: str | None = None) -> int:
        if cls_name is None:
            return sum(p.slots for p in self.pes.values())
        return sum(p.slots for p in self.pes.values()
                   if cls_name in p.capabilities)

    def __repr__(self) -> str:
        kind = "torus" if self.torus else "mesh"
        return (f"FabricTopology({self.rows}x{self.cols} {kind}, "
                f"{len(self.links)} links, {self.total_slots()} slots)")
