"""``map_nd``: one dimension-generic worker-pipeline mapper (paper §III).

The paper's 1D (§III-A) and 2D (§III-B) mappings — and their 3D extension —
are instances of one construction, assembled from the stage library in
:mod:`repro_torch.core.mapping.stages`:

* ``w`` readers load the grid interleaved in flat row-major order (reader
  ``k`` owns sites ``≡ k (mod w)``); for rank >= 2 this requires the
  innermost extent to divide by ``w`` (the paper's column ownership —
  strip-mine with :func:`repro_torch.core.mapping.plan_blocks` otherwise).
* Each of ``w`` compute workers owns the interior outputs whose innermost
  coordinate is ``≡ r_inner + c (mod w)`` and evaluates them with one
  :class:`TapChain` per axis — ``2r+1`` taps from ``2r+1`` different streams
  on the innermost axis, ``2r`` taps from a single stream on every outer
  axis — joined by an :class:`AddTree`.
* ``timesteps > 1`` stacks compute layers uniformly at every rank (§IV):
  layer ``t`` consumes layer ``t-1``'s output streams directly, with the
  *same* interleave/filter algebra, because the class delta between adjacent
  layers is always ``r_inner + c (+ tap offset)``.
* Writers and sync workers attach to the final layer only; I/O happens at
  the pipeline ends and every element is loaded exactly once.

Mandatory buffering (§III-B) is computed per tap from the per-axis token-lag
formula in :mod:`repro_torch.core.mapping.stages` and returned as
``MappingPlan.min_capacities``; ``auto_capacity=True`` applies it so the
simulator can verify both the bound and the deadlock below it.
"""
from __future__ import annotations

from repro_torch.core.dfg import DFG
from repro_torch.core.mapping.plan import MappingPlan
from repro_torch.core.mapping.stages import (ReaderBank, SyncTree, WorkerStream,
                                             WriterBank, compute_layer,
                                             layer_stream, row_tokens)
from repro_torch.core.spec import StencilSpec


def map_nd(spec: StencilSpec, workers: int, queue_capacity: int | None = None,
           auto_capacity: bool = False) -> MappingPlan:
    """Map a star stencil of any rank onto the CGRA worker pipeline."""
    d = spec.ndim
    w = workers
    T = spec.timesteps
    shape = spec.grid_shape
    radii = spec.radii
    if w < 1:
        raise ValueError("need at least one worker")
    if d >= 2 and shape[-1] % w:
        fit = max(k for k in range(1, min(w, shape[-1]) + 1)
                  if shape[-1] % k == 0)
        raise ValueError(
            f"rank-{d} spec (grid_shape={shape}) needs inner extent % workers"
            f" == 0 (column ownership); got {shape[-1]} % {w} == "
            f"{shape[-1] % w}. Strip-mine with plan_blocks() first, or use "
            f"workers={fit} — the largest count <= {w} that divides "
            f"{shape[-1]}.")
    interior_inner = shape[-1] - 2 * radii[-1] * T
    if w > interior_inner:
        raise ValueError(
            f"rank-{d} spec (grid_shape={shape}, radii={radii}, "
            f"timesteps={T}): {w} workers but only {interior_inner} interior "
            f"sites along the innermost axis, so some workers would own no "
            f"outputs (their sync would never trigger). Use workers <= "
            f"{interior_inner}.")

    g = DFG(f"stencil{d}d_{'x'.join(map(str, shape))}"
            f"_r{'x'.join(map(str, radii))}_w{w}_t{T}")
    min_caps: dict[int, int] = {}

    readers = ReaderBank(g, spec, w, queue_capacity)
    sources: list[WorkerStream] = readers.streams
    center_extra = sum(float(spec.coeffs[b][radii[b]]) for b in range(d - 1))

    out_streams = []
    for layer in range(1, T + 1):
        out_streams = [layer_stream(spec, layer, c, w) for c in range(w)]
        sources = compute_layer(
            g, radii=radii, coeffs=spec.coeffs, out_streams=out_streams,
            sources=sources, tag=f"l{layer}", queue_capacity=queue_capacity,
            min_caps=min_caps, center_extra=center_extra,
            params={"layer": layer})

    out_idx = [s.flat_indices(shape) for s in out_streams]
    writers = WriterBank(g, [ws.node for ws in sources], out_idx,
                         queue_capacity)
    SyncTree(g, writers.stores, [len(o) for o in out_idx], queue_capacity)

    if auto_capacity:
        apply_min_capacities(g, min_caps)
    chains_note = " + ".join(
        f"ax{b}:{2 * r + (1 if b == d - 1 else 0)}"
        for b, r in enumerate(radii) if r or b == d - 1)
    buf = sum(2 * r * rt for r, rt in
              zip(radii[:-1], row_tokens(shape)[:-1]))
    return MappingPlan(
        spec=spec, workers=w, dfg=g, reader_loads=readers.loads,
        writer_stores=out_idx, sync_expect=[len(o) for o in out_idx],
        pe_counts=g.pe_counts(), mac_pes=g.mac_pes(), min_capacities=min_caps,
        notes=(f"{d}D: {T} layer(s) x {w} workers x taps({chains_note}); "
               f"final interior {tuple(n - 2 * r * T for n, r in zip(shape, radii))}"
               + (f"; mandatory buffering ~= {buf} elements" if d > 1 else "")))


def apply_min_capacities(g: DFG, min_caps: dict[int, int]) -> None:
    """Set every queue to its analytic minimum (default 4 when no bound was
    derived) — the ``auto_capacity=True`` policy, shared with program-graph
    lowering (:mod:`repro.program.lower`).

    Bumps the graph's mutation counter so any compiled tables built *before*
    the recapacity (``repro_torch.core.engine.compile``) invalidate instead of
    silently simulating with the stale capacities."""
    for e in g.edges():
        if id(e) in min_caps:
            e.capacity = min_caps[id(e)]
        elif e.capacity is None:
            e.capacity = 4
    g.mark_mutated()


# ---------------------------------------------------------------------------
# rank-specific wrappers.  map_1d/map_2d exist for source compatibility with
# the pre-refactor hand-rolled builders and *assert* the structural contract
# they used to guarantee (same PE inventory, same sync expectations).
# ---------------------------------------------------------------------------
def map_1d(spec: StencilSpec, workers: int, queue_capacity: int | None = None,
           auto_capacity: bool = False) -> MappingPlan:
    assert spec.ndim == 1, "map_1d needs a 1D spec"
    plan = map_nd(spec, workers, queue_capacity, auto_capacity)
    (n,), (r,), T, w = spec.grid_shape, spec.radii, spec.timesteps, workers
    if r:
        assert plan.pe_counts == {
            "addr": 2 * w, "load": w, "filter": T * w * (2 * r + 1),
            "mul": T * w, "mac": T * w * 2 * r, "store": w, "sync": w,
            "cmp": 1,
        }
    assert plan.sync_expect == [len(range(T * r + c, n - T * r, w))
                                for c in range(w)]
    return plan


def map_2d(spec: StencilSpec, workers: int, queue_capacity: int | None = None,
           auto_capacity: bool = False) -> MappingPlan:
    assert spec.ndim == 2, "map_2d needs a 2D spec"
    plan = map_nd(spec, workers, queue_capacity, auto_capacity)
    (ny, nx), (ry, rx), T, w = (spec.grid_shape, spec.radii, spec.timesteps,
                                workers)
    if T == 1 and ry and rx:      # the exact pre-refactor single-sweep shape
        assert plan.pe_counts == {
            "addr": 2 * w, "load": w, "filter": w * (2 * rx + 1 + 2 * ry),
            "mul": 2 * w, "mac": w * (2 * rx + 2 * ry - 1), "add": w,
            "store": w, "sync": w, "cmp": 1,
        }
        assert plan.sync_expect == [
            (ny - 2 * ry) * len(range(rx + c, nx - rx, w)) for c in range(w)]
    return plan


def map_3d(spec: StencilSpec, workers: int, queue_capacity: int | None = None,
           auto_capacity: bool = False) -> MappingPlan:
    assert spec.ndim == 3, "map_3d needs a 3D spec"
    return map_nd(spec, workers, queue_capacity, auto_capacity)
