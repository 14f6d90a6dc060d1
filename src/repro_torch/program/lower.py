"""Lower a :class:`StencilProgram` into ONE combined worker-pipeline DFG.

The StencilFlow insight: chaining stencil operators through the on-chip
network — producer worker streams spliced *directly* into consumer tap
chains — removes the store-to-memory/reload-from-memory round trip between
operators, which is where spatial architectures beat GPUs hardest.  This
module is that splice for the paper's CGRA worker pipeline:

* Each op is lowered with the mapper's stage library (:mod:`repro_torch.core.mapping`):
  per-worker :class:`TapChain`/:class:`AddTree` stacks whose *sources* are the
  producing op's worker output streams (or reader streams for external
  fields).  :func:`~repro_torch.core.mapping.stages.owning_stream` resolves every
  tap's producer by innermost congruence class, so the same rule that stacks
  temporal layers inside one op splices *between* ops.
* **Inter-operator skew buffers** generalize the mapper's per-axis mandatory
  buffering.  Each field carries a site-lead ``D(f)`` — the deepest
  pipeline distance from the external inputs, in grid sites, where a stencil
  op contributes ``timesteps * max_b(r_b * stride_b)``.  When an op joins
  fields of different depth (a combine after a fan-out), the shallow field's
  producer→filter queue must absorb ``(max_i D(f_i) - D(f)) / step`` tokens
  or the shared producer deadlocks behind the deep branch; ``auto_capacity``
  sizes exactly that.
* **Interleave fallback**: when producer and consumer worker counts differ,
  the streams cannot be spliced class-for-class; an explicit re-interleave
  buffer is inserted — per consumer class one ``imux`` node fed by strided
  filters on every producer stream, merging tokens in a per-row periodic
  pattern back into row-major order at the consumer's interleave.
* Output fields get :class:`WriterBank`/:class:`SyncTree` pairs (one ``cmp``
  per field; the simulator finishes when all have fired); several outputs
  pack into one flat image, one grid-sized slot per field, and likewise for
  external inputs.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.dfg import DFG
from repro_torch.core.mapping.nd import apply_min_capacities
from repro_torch.core.mapping.stages import (ReaderBank, SyncTree, WorkerStream,
                                             WriterBank, band_keep, compute_layer,
                                             owning_stream)
from repro_torch.core.mapping.streams import StreamSpec, row_major_strides
from repro_torch.core.spec import StencilSpec
from repro_torch.program.ir import StencilOp, StencilProgram


@dataclasses.dataclass
class ProgramPlan:
    """The program lowering's output contract (the multi-op ``MappingPlan``).

    Duck-types what :func:`repro_torch.core.simulator.simulate` consumes: ``spec``
    (machine-model carrier), ``dfg``, ``workers``, ``mac_pes`` — plus
    ``out_shape`` so several output fields pack into one output image.
    """

    program: StencilProgram
    dfg: DFG
    op_workers: dict[str, int]
    spec: StencilSpec                     # representative: grid + dtype
    in_fields: tuple[str, ...]
    out_fields: tuple[str, ...]
    out_shape: tuple[int, ...]
    reader_loads: dict[str, list[list[int]]]
    writer_stores: dict[str, list[list[int]]]
    sync_expect: dict[str, list[int]]
    pe_counts: dict
    mac_pes: int
    min_capacities: dict[int, int]
    notes: str = ""

    @property
    def workers(self) -> int:
        return max(self.op_workers.values())

    def pack_inputs(self, inputs: dict[str, np.ndarray]) -> np.ndarray:
        """Stack the named input fields into the flat memory image the
        readers index (one grid-sized slot per field, program order)."""
        missing = [f for f in self.in_fields if f not in inputs]
        if missing:
            raise ValueError(f"missing input fields: {missing}")
        return np.stack([np.asarray(inputs[f], dtype=np.float64)
                         for f in self.in_fields])

    def unpack_outputs(self, output: np.ndarray) -> dict[str, np.ndarray]:
        """Split a simulated output image back into named fields."""
        grid = self.program.grid_shape
        out = np.asarray(output).reshape((len(self.out_fields),) + grid)
        return {f: out[i] for i, f in enumerate(self.out_fields)}


def _site_gate(op) -> int:
    """An op's pipeline lead in grid sites: how far ahead of its output site
    its furthest tap reaches (0 for elementwise combines).  The per-axis
    reaches are *summed* — a deliberate overestimate of the ``max`` that the
    op truly needs, so skew buffers sized from accumulated leads stay
    sufficient down arbitrarily deep chains."""
    if not isinstance(op, StencilOp):
        return 0
    strides = row_major_strides(op.spec.grid_shape)
    return op.spec.timesteps * sum(
        r * s for r, s in zip(op.spec.radii, strides))


def field_leads(program: StencilProgram) -> dict[str, int]:
    """Site-lead ``D(f)`` per field: the deepest pipeline distance from the
    external inputs, in grid sites (the generalized skew/delay-buffer
    quantity)."""
    lead = {f: 0 for f in program.in_fields}
    for op in program.schedule():
        lead[op.output] = (max(lead[f] for f in op.inputs) + _site_gate(op))
    return lead


def _box_streams(grid: tuple[int, ...], margin: tuple[int, ...],
                 w: int) -> list[StreamSpec]:
    """The ``w`` interleaved worker streams over a valid box with ``margin``:
    outer axes full-box, innermost axis class ``margin + c (mod w)``."""
    d = len(grid)
    out = []
    for c in range(w):
        axes = tuple(
            (margin[b] + (c if b == d - 1 else 0), grid[b] - margin[b],
             w if b == d - 1 else 1) for b in range(d))
        out.append(StreamSpec(axes))
    return out


def _remux(g: DFG, field: str, sources: list[WorkerStream], w_src: int,
           w_dst: int, grid: tuple[int, ...], margin: tuple[int, ...],
           queue_capacity: int | None, min_caps: dict[int, int],
           subgraph: int) -> list[WorkerStream]:
    """Explicit re-interleave buffer: ``w_src`` producer streams -> ``w_dst``
    consumer-class streams over the same valid box.

    Per consumer class ``c`` one ``imux`` merges strided filters on every
    producer stream that owns sites of that class, popping ports in the
    per-row periodic pattern that restores row-major order.
    """
    out: list[WorkerStream] = []
    sg = {"subgraph": subgraph}
    for c, stream in enumerate(_box_streams(grid, margin, w_dst)):
        cnt_inner = stream.counts[-1]
        assert cnt_inner > 0, "empty re-interleave class (validated upstream)"
        pattern_src = [(c + i * w_dst) % w_src for i in range(cnt_inner)]
        classes = sorted(set(pattern_src))
        port_of = {p: k for k, p in enumerate(classes)}
        imux = g.add("imux", f"imux_{field}w{w_dst}_c{c}", stage="compute",
                     worker=c, pattern=[port_of[p] for p in pattern_src],
                     **sg)
        for p in classes:
            src = owning_stream(sources, margin[-1] + p)
            cnt_p = src.spec.counts[-1]
            start_p = src.spec.axes[-1][0]
            target = margin[-1] + c

            def keep(s: int, _cnt=cnt_p, _st=start_p, _w=w_src, _t=target,
                     _wd=w_dst) -> bool:
                return (_st + (s % _cnt) * _w - _t) % _wd == 0

            kept_row = sum(1 for j in range(cnt_p)
                           if (start_p + j * w_src - target) % w_dst == 0)
            kept = kept_row * math.prod(src.spec.counts[:-1])
            f = g.add("filter", f"rflt_{field}w{w_dst}_c{c}_p{p}",
                      stage="compute", worker=c, m=0, n=kept, keep=keep,
                      keep_count=kept,
                      # compiled form for the vector engine: keep(s) iff
                      # (off + (s % cnt) * step) % mod == 0.
                      keep_mod={"cnt": cnt_p, "step": w_src,
                                "off": start_p - target, "mod": w_dst}, **sg)
            g.connect(src.node, f, capacity=queue_capacity)
            e = g.connect(f, imux, port=port_of[p], capacity=queue_capacity)
            # the imux drains a port only at its pattern slots; a full row of
            # this port's tokens may queue while the other ports drain.
            min_caps[id(e)] = kept_row + 4
        out.append(WorkerStream(imux, stream))
    return out


def lower(program: StencilProgram, workers, queue_capacity: int | None = None,
          auto_capacity: bool = False) -> ProgramPlan:
    """Lower every op of ``program`` into one combined DFG.

    ``workers`` is a single int (every op) or a ``{op name: int}`` dict;
    differing counts trigger the explicit re-interleave fallback between the
    mismatched ops.
    """
    grid = program.grid_shape
    d = len(grid)
    ngrid = math.prod(grid)
    ops = program.schedule()
    margins = program.margins()
    leads = field_leads(program)
    if isinstance(workers, int):
        opw = {op.name: workers for op in ops}
    else:
        opw = dict(workers)
        missing = [op.name for op in ops if op.name not in opw]
        if missing:
            raise ValueError(f"no worker count for ops {missing}")

    # per-op legality (the map_nd preconditions, with the op named) ---------
    for op in ops:
        w = opw[op.name]
        if w < 1:
            raise ValueError(f"op {op.name!r}: need at least one worker")
        if d >= 2 and grid[-1] % w:
            raise ValueError(
                f"op {op.name!r} (grid_shape={grid}): inner extent "
                f"{grid[-1]} % workers {w} != 0; choose a divisor")
        interior_inner = grid[-1] - 2 * margins[op.output][-1]
        if w > interior_inner:
            raise ValueError(
                f"op {op.name!r} (grid_shape={grid}): {w} workers but only "
                f"{interior_inner} valid sites along the innermost axis of "
                f"{op.output!r}; some workers would own no outputs. Use "
                f"workers <= {interior_inner}.")

    g = DFG(f"program_{program.name}")
    min_caps: dict[int, int] = {}
    streams: dict[str, list[WorkerStream]] = {}
    stream_w: dict[str, int] = {}
    remux_cache: dict[tuple[str, int], list[WorkerStream]] = {}
    reader_loads: dict[str, list[list[int]]] = {}

    # external inputs: one ReaderBank per field, interleaved at the first
    # consumer's worker count (other counts re-interleave on demand).
    first_w: dict[str, int] = {}
    for op in ops:
        for f in op.inputs:
            if f in program.in_fields and f not in first_w:
                first_w[f] = opw[op.name]
    for slot, f in enumerate(program.in_fields):
        bank = ReaderBank(g, program.rep_spec, first_w[f], queue_capacity,
                          base=slot * ngrid, tag=f"_{f}_",
                          params={"subgraph": 0})
        streams[f] = bank.streams
        stream_w[f] = first_w[f]
        reader_loads[f] = bank.loads

    def streams_for(f: str, w: int, subgraph: int) -> list[WorkerStream]:
        if stream_w[f] == w:
            return streams[f]
        key = (f, w)
        if key not in remux_cache:
            remux_cache[key] = _remux(
                g, f, streams[f], stream_w[f], w, grid, margins[f],
                queue_capacity, min_caps, subgraph)
        return remux_cache[key]

    def src_cap(op, fname: str, step: int) -> int:
        """Producer→filter queue bound: intra-op slack + inter-op skew.  A
        field joined with deeper siblings (combine after a fan-out) must
        queue the depth difference or the shared producer deadlocks behind
        the deep branch."""
        skew = max(leads[f] for f in op.inputs) - leads[fname]
        return 6 + -(-skew // step)

    for i, op in enumerate(ops, start=1):
        w = opw[op.name]
        sg = {"subgraph": i}
        if isinstance(op, StencilOp):
            radii, coeffs, T = op.spec.radii, op.spec.coeffs, op.spec.timesteps
            center_extra = sum(float(coeffs[b][radii[b]])
                               for b in range(d - 1))
            cur = streams_for(op.input, w, i)
            m_in = margins[op.input]
            for t in range(1, T + 1):
                m_t = tuple(mb + t * rb for mb, rb in zip(m_in, radii))
                smin = src_cap(op, op.input, cur[0].spec.axes[-1][2]) \
                    if t == 1 else 0
                cur = compute_layer(
                    g, radii=radii, coeffs=coeffs,
                    out_streams=_box_streams(grid, m_t, w), sources=cur,
                    tag=f"{op.name}_l{t}", queue_capacity=queue_capacity,
                    min_caps=min_caps, center_extra=center_extra,
                    src_min=smin, params={**sg, "layer": t})
        else:                                     # elementwise CombineOp
            m_out = margins[op.output]
            out_streams = _box_streams(grid, m_out, w)
            tails = []
            for c in range(w):
                box = tuple((lo, hi) for lo, hi, _ in out_streams[c].axes)
                prev = None
                for k, (fname, coeff) in enumerate(
                        zip(op.inputs, op.coeffs)):
                    srcs = streams_for(fname, w, i)
                    src = owning_stream(srcs, box[-1][0])
                    mask = band_keep(src.spec, box)
                    f = g.add("filter", f"flt_{op.name}_w{c}_i{k}",
                              stage="compute", worker=c, m=mask.lead,
                              n=mask.kept, keep=mask.keep,
                              keep_count=mask.kept,
                              keep_vec={"windows": mask.windows,
                                        "counts": src.spec.counts}, **sg)
                    e_src = g.connect(src.node, f, capacity=queue_capacity)
                    smin = src_cap(op, fname, src.spec.axes[-1][2])
                    min_caps[id(e_src)] = max(min_caps.get(id(e_src), 0),
                                              smin)
                    opn = "mul" if prev is None else "mac"
                    pe = g.add(opn, f"{opn}_{op.name}_w{c}_i{k}",
                               stage="compute", worker=c, coeff=float(coeff),
                               **sg)
                    if prev is not None:
                        g.connect(prev, pe, port=0, capacity=queue_capacity)
                    e = g.connect(f, pe, port=(0 if prev is None else 1),
                                  capacity=queue_capacity)
                    min_caps[id(e)] = 4
                    prev = pe
                tails.append(prev)
            cur = [WorkerStream(tl, s) for tl, s in zip(tails, out_streams)]
        streams[op.output] = cur
        stream_w[op.output] = w

    # writers + one sync tree (one cmp) per output field --------------------
    writer_stores: dict[str, list[list[int]]] = {}
    sync_expect: dict[str, list[int]] = {}
    multi_out = len(program.out_fields) > 1
    wsg = {"subgraph": len(ops) + 1}
    for slot, fname in enumerate(program.out_fields):
        ws = streams[fname]
        base = slot * ngrid if multi_out else 0
        idx = [[base + i for i in s.spec.flat_indices(grid)] if base
               else s.spec.flat_indices(grid) for s in ws]
        wb = WriterBank(g, [s.node for s in ws], idx, queue_capacity,
                        tag=f"_{fname}", params=wsg)
        SyncTree(g, wb.stores, [len(o) for o in idx], queue_capacity,
                 tag=f"_{fname}", params=wsg)
        writer_stores[fname] = idx
        sync_expect[fname] = [len(o) for o in idx]

    if auto_capacity:
        apply_min_capacities(g, min_caps)

    out_shape = ((len(program.out_fields),) + grid if multi_out else grid)
    return ProgramPlan(
        program=program, dfg=g, op_workers=opw, spec=program.rep_spec,
        in_fields=program.in_fields, out_fields=program.out_fields,
        out_shape=out_shape, reader_loads=reader_loads,
        writer_stores=writer_stores, sync_expect=sync_expect,
        pe_counts=g.pe_counts(), mac_pes=g.mac_pes(),
        min_capacities=min_caps,
        notes=(f"program {program.name}: {len(ops)} ops "
               f"{[op.name for op in ops]}, "
               f"workers {sorted(set(opw.values()))}, "
               f"{len(remux_cache)} re-interleave(s), "
               f"inputs {list(program.in_fields)} -> "
               f"outputs {list(program.out_fields)}"))


def simulate_program(plan: ProgramPlan, inputs: dict[str, np.ndarray],
                     machine, **kw):
    """Convenience wrapper: pack inputs, run the core simulator, split the
    output image back into named fields.  Returns ``(SimResult, fields)``."""
    from repro_torch.core.simulator import simulate
    res = simulate(plan, plan.pack_inputs(inputs), machine, **kw)
    return res, plan.unpack_outputs(res.output)
