"""Stencil-program IR: multi-operator DAGs over named fields.

The paper maps a *single* star stencil; real workloads (the paper's
seismic/oil-and-gas motivation, weather kernels like horizontal diffusion)
are **programs** of several dependent stencil operators.  Following
StencilFlow, a :class:`StencilProgram` is a DAG whose nodes are

* :class:`StencilOp` — apply a star stencil (a full :class:`StencilSpec`,
  including fused ``timesteps``) to one named field, producing another;
* :class:`CombineOp` — an elementwise linear combine
  ``out = sum_i coeffs[i] * inputs[i]`` (``a + b``, ``a - k*b``, ...);

and whose edges are the fields.  One field may fan out into any number of
consumers.  Fields that no op produces are the program's external inputs;
fields that no op consumes (or an explicit ``outputs=`` list) are its
results.

Shape/halo inference: every field lives on the one program grid and carries a
per-axis **margin** — the rim of sites that hold no valid value.  External
inputs have margin 0; a stencil op adds ``radius * timesteps`` per axis; a
combine's margin is the per-axis max of its inputs' margins (the intersection
of their valid boxes).  Margins are exactly the information the lowering
(:mod:`repro_torch.program.lower`) needs to splice producer worker streams straight
into consumer tap chains, and the oracle (:mod:`repro_torch.program.oracle`) needs
to mask each intermediate.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.spec import StencilSpec


@dataclasses.dataclass(frozen=True)
class StencilOp:
    """Apply ``spec`` (incl. fused ``spec.timesteps`` sweeps) to ``input``."""

    name: str
    spec: StencilSpec
    input: str
    output: str

    @property
    def inputs(self) -> tuple[str, ...]:
        return (self.input,)


@dataclasses.dataclass(frozen=True)
class CombineOp:
    """Elementwise linear combine: ``out = sum_i coeffs[i] * inputs[i]``."""

    name: str
    inputs: tuple[str, ...]
    coeffs: tuple[float, ...]
    output: str

    def __post_init__(self):
        if not self.inputs:
            raise ValueError(f"combine op {self.name!r} needs >= 1 input")
        if len(self.coeffs) != len(self.inputs):
            raise ValueError(
                f"combine op {self.name!r}: {len(self.inputs)} inputs but "
                f"{len(self.coeffs)} coefficients")


class StencilProgram:
    """A validated, scheduled stencil-operator DAG.

    Construction performs all static analysis: single assignment per field,
    one shared grid/dtype, cycle detection (Kahn), topological scheduling,
    and per-field margin inference with non-empty valid boxes.
    """

    def __init__(self, name: str, ops, outputs=None,
                 grid_shape: tuple[int, ...] | None = None,
                 dtype: str | None = None):
        self.name = name
        self.ops: tuple = tuple(ops)
        if not self.ops:
            raise ValueError("a StencilProgram needs at least one op")
        names = [op.name for op in self.ops]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate op names: {sorted(names)}")

        # one grid, one dtype, shared by every stencil op -------------------
        specs = [op.spec for op in self.ops if isinstance(op, StencilOp)]
        shapes = {s.grid_shape for s in specs} | (
            {tuple(grid_shape)} if grid_shape else set())
        if len(shapes) != 1:
            got = sorted(shapes) or "none (pass grid_shape= for " \
                                    "combine-only programs)"
            raise ValueError(
                f"program {name!r} needs exactly one grid shape; got {got}")
        dtypes = {s.dtype for s in specs} | ({dtype} if dtype else set())
        if len(dtypes) != 1:
            got = sorted(dtypes) or "none (pass dtype= for combine-only " \
                                    "programs)"
            raise ValueError(
                f"program {name!r} needs exactly one dtype; got {got}")
        self.grid_shape: tuple[int, ...] = next(iter(shapes))
        self.dtype: str = next(iter(dtypes))

        # single assignment + external inputs -------------------------------
        producer: dict[str, object] = {}
        for op in self.ops:
            if op.output in producer:
                raise ValueError(
                    f"field {op.output!r} produced by both "
                    f"{producer[op.output].name!r} and {op.name!r} "
                    "(fields are single-assignment)")
            producer[op.output] = op
        self._producer = producer
        in_fields: list[str] = []
        for op in self.ops:
            for f in op.inputs:
                if f not in producer and f not in in_fields:
                    in_fields.append(f)
        self.in_fields: tuple[str, ...] = tuple(in_fields)

        # cycle detection + topological schedule (Kahn) ---------------------
        indeg = {op.name: sum(1 for f in op.inputs if f in producer)
                 for op in self.ops}
        consumers: dict[str, list] = {}
        for op in self.ops:
            for f in op.inputs:
                consumers.setdefault(f, []).append(op)
        ready = [op for op in self.ops if indeg[op.name] == 0]
        order: list = []
        while ready:
            op = ready.pop(0)
            order.append(op)
            for nxt in consumers.get(op.output, []):
                indeg[nxt.name] -= 1
                if indeg[nxt.name] == 0:
                    ready.append(nxt)
        if len(order) != len(self.ops):
            stuck = sorted(n for n, k in indeg.items() if k > 0)
            raise ValueError(f"program {name!r} has a cycle through ops "
                             f"{stuck}")
        self._schedule: tuple = tuple(order)

        # outputs: explicit, or every field nothing consumes ----------------
        consumed = {f for op in self.ops for f in op.inputs}
        if outputs is None:
            outputs = [op.output for op in self._schedule
                       if op.output not in consumed]
        for f in outputs:
            if f not in producer:
                raise ValueError(f"output field {f!r} is not produced by any "
                                 "op")
        if not outputs:
            raise ValueError(f"program {name!r} has no output fields")
        self.out_fields: tuple[str, ...] = tuple(outputs)

        # margin inference (per-field halo accounting across the DAG) -------
        d = len(self.grid_shape)
        m: dict[str, tuple[int, ...]] = {f: (0,) * d for f in self.in_fields}
        for op in self._schedule:
            if isinstance(op, StencilOp):
                m[op.output] = tuple(
                    mi + r * op.spec.timesteps
                    for mi, r in zip(m[op.input], op.spec.radii))
            else:
                m[op.output] = tuple(
                    max(m[f][b] for f in op.inputs) for b in range(d))
            for n, mb in zip(self.grid_shape, m[op.output]):
                if n - 2 * mb < 1:
                    raise ValueError(
                        f"field {op.output!r} (op {op.name!r}) has an empty "
                        f"valid box: margin {m[op.output]} on grid "
                        f"{self.grid_shape}")
        self._margins = m

    # ----- queries -----------------------------------------------------------
    def schedule(self) -> tuple:
        """Ops in dependency (topological) order."""
        return self._schedule

    def producer_of(self, field: str):
        return self._producer.get(field)

    def margins(self) -> dict[str, tuple[int, ...]]:
        """Per-field, per-axis invalid rim width (external inputs: 0)."""
        return dict(self._margins)

    def field_interior(self, field: str) -> tuple[int, ...]:
        """Valid-box extents of ``field``: ``n - 2*margin`` per axis."""
        return tuple(n - 2 * mb
                     for n, mb in zip(self.grid_shape, self._margins[field]))

    @property
    def rep_spec(self) -> StencilSpec:
        """A representative spec (grid/dtype carrier) for machine models and
        reader-stream construction."""
        for op in self.ops:
            if isinstance(op, StencilOp):
                return op.spec
        d = len(self.grid_shape)
        return StencilSpec(self.grid_shape, (0,) * d, ((1.0,),) * d,
                           dtype=self.dtype)

    def __repr__(self) -> str:
        return (f"StencilProgram({self.name!r}, {len(self.ops)} ops, "
                f"grid={self.grid_shape}, in={list(self.in_fields)}, "
                f"out={list(self.out_fields)})")
