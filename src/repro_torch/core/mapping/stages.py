"""Composable worker-pipeline stages (paper §III, dimension-generic).

The paper builds every mapping out of the same five stage families; each is a
small builder over the DFG DSL here, parameterized by rank through the
:mod:`repro_torch.core.mapping.streams` algebra:

* :class:`ReaderBank` — ``w`` interleaved load streams (reader ``k`` owns the
  flat row-major sites ``≡ k (mod w)``; for rank >= 2 this is the paper's
  column ownership, which requires ``n_inner % w == 0``).
* :class:`TapChain` — one axis of one compute worker: a data-filtering PE per
  tap (generalized ``0^m 1^n 0^p`` keep-mask) feeding a MUL -> MAC -> ... -> MAC
  chain.  The innermost axis has ``2r+1`` taps sourced from ``2r+1``
  *different* streams; every outer axis has ``2r`` taps (centre shared) all
  sourced from the *one* stream that owns the worker's innermost class.
  Geometry is explicit (``out_box`` + ``sources``), so the producing streams
  may be readers, a previous temporal layer, or — for program graphs
  (:mod:`repro.program`) — another operator's compute workers spliced in
  directly; :func:`owning_stream` resolves each tap's producer purely by
  innermost congruence class.
* :class:`AddTree` — joins the per-axis chain tails of a worker (rank-1
  workers have a single chain and no ADDs; rank ``d`` needs ``d-1``).
* :class:`WriterBank` — per-worker address generator + store.
* :class:`SyncTree` — per-worker store counters combined into one ``done``.

Mandatory buffering (§III-B) is derived per tap, not per special case: with
``row_tokens[b]`` = filtered tokens per unit step along axis ``b`` and
``gate`` = the chain-wide worst-case token lag ``max_b r_b * row_tokens[b]``,
a tap at offset ``o`` on axis ``a`` must queue

    max(2, gate - o * row_tokens[a] + 2)

tokens: its values arrive that many outputs ahead of the slowest tap of the
worker.  At rank 1 this is the familiar ``2r - j + 2``; at rank 2 it is the
paper's ~``2*ry`` resident rows.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.dfg import DFG, Node
from repro_torch.core.mapping.streams import (StreamSpec, band_keep,
                                              row_major_strides)
from repro_torch.core.spec import StencilSpec


@dataclasses.dataclass
class WorkerStream:
    """A producing node together with the site stream it emits."""
    node: Node
    spec: StreamSpec


# ---------------------------------------------------------------------------
# stream geometry (the worker-selection / band rules proved in streams.py)
# ---------------------------------------------------------------------------
def reader_stream(spec: StencilSpec, k: int, workers: int) -> StreamSpec:
    """Reader ``k``'s interleaved load stream."""
    if spec.ndim == 1:
        return StreamSpec(((k, spec.grid_shape[0], workers),))
    outer = tuple((0, n, 1) for n in spec.grid_shape[:-1])
    return StreamSpec(outer + ((k, spec.grid_shape[-1], workers),))


def layer_stream(spec: StencilSpec, layer: int, worker: int,
                 workers: int) -> StreamSpec:
    """Compute worker ``worker``'s output stream after ``layer`` fused sweeps:
    the interior shrunk by ``layer*r`` per face, innermost axis in the
    worker's congruence class."""
    axes = []
    for b, (n, r) in enumerate(zip(spec.grid_shape, spec.radii)):
        if b == spec.ndim - 1:
            axes.append((layer * r + worker, n - layer * r, workers))
        else:
            axes.append((layer * r, n - layer * r, 1))
    return StreamSpec(tuple(axes))


def row_tokens(out_counts: tuple[int, ...]) -> tuple[int, ...]:
    """Filtered tokens per unit step along each axis, for one worker whose
    per-axis output counts are ``out_counts`` — the row-major strides of the
    output box."""
    return row_major_strides(out_counts)


def owning_stream(sources: list[WorkerStream], inner_lo: int) -> WorkerStream:
    """The source stream whose innermost congruence class contains coordinate
    ``inner_lo``.  One rule covers every producer kind: readers sit at inner
    base ``k``, layer-``t`` workers at ``t*r + c``, and program-graph
    producers at ``margin + c`` — all resolved uniformly by
    ``inner_lo ≡ start (mod step)``."""
    for ws in sources:
        start, _, step = ws.spec.axes[-1]
        if (inner_lo - start) % step == 0:
            return ws
    raise ValueError(
        f"no source stream owns innermost coordinate {inner_lo} "
        f"(classes available: {[ws.spec.axes[-1][:1] for ws in sources]})")


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------
class ReaderBank:
    """``w`` reader workers: per-reader address generator + load.

    ``base`` offsets the flat load indices (program graphs pack several input
    fields into one flat memory image, one grid-sized slot per field).
    """

    def __init__(self, g: DFG, spec: StencilSpec, workers: int,
                 queue_capacity: int | None, *, base: int = 0, tag: str = "",
                 params: dict | None = None):
        extra = params or {}
        self.streams: list[WorkerStream] = []
        self.loads: list[list[int]] = []
        for k in range(workers):
            stream = reader_stream(spec, k, workers)
            idx = stream.flat_indices(spec.grid_shape)
            if base:
                idx = [base + i for i in idx]
            addr = g.add("addr", f"rd_addr{tag}{k}", stage="reader", worker=k,
                         count=len(idx), **extra)
            load = g.add("load", f"rd{tag}{k}", stage="reader", worker=k,
                         indices=idx, **extra)
            g.connect(addr, load, capacity=queue_capacity)
            self.streams.append(WorkerStream(load, stream))
            self.loads.append(idx)


class TapChain:
    """One axis of one compute worker: per-tap filter + MUL/MAC chain.

    The geometry is explicit so the chain can be spliced onto any producer:

    * ``out_box`` — the worker's output region, per-axis ``[lo, hi)`` with the
      innermost ``lo`` already in the worker's congruence class; tap ``(axis,
      o)`` needs that box shifted by ``o`` along ``axis``.
    * ``sources`` — streams that jointly cover every innermost class (readers,
      the previous temporal layer, or another operator's workers);
      :func:`owning_stream` picks each tap's producer by congruence.
    * ``src_min`` — optional analytic minimum capacity for the producer →
      filter queues (program graphs put the inter-operator skew buffer here).

    ``center_extra`` is added to the centre-tap coefficient (the innermost
    chain carries every axis's centre contribution once, §III-B).
    """

    def __init__(self, g: DFG, *, coeffs, radius: int, axis: int, inner: bool,
                 out_box: tuple[tuple[int, int], ...],
                 sources: list[WorkerStream], worker: int, tag: str,
                 queue_capacity: int | None, min_caps: dict[int, int],
                 rt: tuple[int, ...], gate: int, center_extra: float = 0.0,
                 src_min: int = 0, params: dict | None = None):
        r = radius
        taps = list(range(2 * r + 1)) if inner else \
            [j for j in range(2 * r + 1) if j != r]
        assert taps, "outer axis with radius 0 has no taps; skip the chain"
        extra = params or {}
        prev: Node | None = None
        for j in taps:
            o = j - r
            bands = tuple((lo + (o if b == axis else 0),
                           hi + (o if b == axis else 0))
                          for b, (lo, hi) in enumerate(out_box))
            src = owning_stream(sources, bands[-1][0])
            mask = band_keep(src.spec, bands)
            f = g.add("filter", f"flt_{tag}_a{axis}_w{worker}_t{j}",
                      stage="compute", worker=worker, axis=axis,
                      m=mask.lead, n=mask.kept, keep=mask.keep,
                      keep_count=mask.kept,
                      # compiled form of the same pattern: the vector engine
                      # evaluates digit windows over np.arange instead of
                      # calling ``keep`` once per token.
                      keep_vec={"windows": mask.windows,
                                "counts": src.spec.counts}, **extra)
            e_src = g.connect(src.node, f, capacity=queue_capacity)
            if src_min:
                min_caps[id(e_src)] = max(min_caps.get(id(e_src), 0), src_min)
            coeff = float(coeffs[j]) + (center_extra if j == r else 0.0)
            op = "mul" if prev is None else "mac"
            pe = g.add(op, f"{op}_{tag}_a{axis}_w{worker}_t{j}",
                       stage="compute", worker=worker, coeff=coeff, axis=axis,
                       **extra)
            if prev is not None:
                g.connect(prev, pe, port=0, capacity=queue_capacity)
            e = g.connect(f, pe, port=(0 if prev is None else 1),
                          capacity=queue_capacity)
            # mandatory buffering: this tap's values arrive up to
            # gate - o*rt[axis] outputs before the worker can consume them.
            min_caps[id(e)] = max(2, gate - o * rt[axis] + 2)
            prev = pe
        self.axis = axis
        self.radius = r
        self.tail: Node = prev


class AddTree:
    """Joins a worker's per-axis chain tails: innermost chain first, then one
    ADD per outer chain (rank-1 workers pass through untouched)."""

    def __init__(self, g: DFG, chains: list[TapChain], *, worker: int,
                 tag: str, queue_capacity: int | None,
                 min_caps: dict[int, int], rt: tuple[int, ...], gate: int,
                 params: dict | None = None):
        extra = params or {}
        tail = chains[0].tail
        for i, ch in enumerate(chains[1:]):
            addn = g.add("add", f"axis_add_{tag}_w{worker}_{i}",
                         stage="compute", worker=worker, **extra)
            e_part = g.connect(tail, addn, port=0, capacity=queue_capacity)
            # the partial side leads the remaining (slower) outer chains by
            # up to the full gate; the joining chain only by its own slack.
            min_caps[id(e_part)] = gate + 2
            e_chain = g.connect(ch.tail, addn, port=1,
                                capacity=queue_capacity)
            min_caps[id(e_chain)] = max(
                2, gate - ch.radius * rt[ch.axis] + 2)
            tail = addn
        self.tail: Node = tail


def compute_layer(g: DFG, *, radii: tuple[int, ...], coeffs,
                  out_streams: list[StreamSpec],
                  sources: list[WorkerStream], tag: str,
                  queue_capacity: int | None, min_caps: dict[int, int],
                  center_extra: float = 0.0, src_min: int = 0,
                  params: dict | None = None) -> list[WorkerStream]:
    """One full compute layer: per worker an innermost :class:`TapChain`,
    one outer chain per non-zero-radius axis, and the joining
    :class:`AddTree`.  Shared by :func:`map_nd` (temporal layers over one
    spec) and program-graph lowering (per-op layers spliced onto another
    op's streams) so the chain-assembly rules live in exactly one place."""
    d = len(radii)
    tails = []
    for c, stream in enumerate(out_streams):
        box = tuple((lo, hi) for lo, hi, _ in stream.axes)
        rt = row_tokens(stream.counts)
        gate = max(r * rt[b] for b, r in enumerate(radii))
        chains = [TapChain(g, coeffs=coeffs[-1], radius=radii[-1],
                           axis=d - 1, inner=True, out_box=box,
                           sources=sources, worker=c, tag=tag,
                           queue_capacity=queue_capacity, min_caps=min_caps,
                           rt=rt, gate=gate, center_extra=center_extra,
                           src_min=src_min, params=params)]
        for axis in range(d - 2, -1, -1):
            if radii[axis] == 0:
                continue
            chains.append(TapChain(g, coeffs=coeffs[axis],
                                   radius=radii[axis], axis=axis,
                                   inner=False, out_box=box, sources=sources,
                                   worker=c, tag=tag,
                                   queue_capacity=queue_capacity,
                                   min_caps=min_caps, rt=rt, gate=gate,
                                   src_min=src_min, params=params))
        tree = AddTree(g, chains, worker=c, tag=tag,
                       queue_capacity=queue_capacity, min_caps=min_caps,
                       rt=rt, gate=gate, params=params)
        tails.append(tree.tail)
    return [WorkerStream(t, s) for t, s in zip(tails, out_streams)]


class WriterBank:
    """Per-worker address generator + store for the final layer's outputs."""

    def __init__(self, g: DFG, tails: list[Node], out_idx: list[list[int]],
                 queue_capacity: int | None, *, tag: str = "",
                 params: dict | None = None):
        extra = params or {}
        self.stores: list[Node] = []
        for c, tail in enumerate(tails):
            addr = g.add("addr", f"wr_addr{tag}{c}", stage="writer", worker=c,
                         count=len(out_idx[c]), **extra)
            st = g.add("store", f"wr{tag}{c}", stage="writer", worker=c,
                       indices=out_idx[c], **extra)
            g.connect(addr, st, port=0, capacity=queue_capacity)
            g.connect(tail, st, port=1, capacity=queue_capacity)
            self.stores.append(st)


class SyncTree:
    """Per-worker store counters combined into one ``done`` trigger.  Program
    graphs build one tree per output field (``tag`` keeps names distinct); the
    simulator finishes when *every* ``cmp`` node has fired."""

    def __init__(self, g: DFG, stores: list[Node], expected: list[int],
                 queue_capacity: int | None, *, tag: str = "",
                 params: dict | None = None):
        extra = params or {}
        self.done = g.add("cmp", f"done{tag}", stage="sync", worker=-1,
                          **extra)
        self.syncs: list[Node] = []
        for c, (st, exp) in enumerate(zip(stores, expected)):
            sy = g.add("sync", f"sync{tag}{c}", stage="sync", worker=c,
                       expected=exp, **extra)
            g.connect(st, sy, capacity=queue_capacity)
            g.connect(sy, self.done, capacity=queue_capacity)
            self.syncs.append(sy)
