"""Composed torch reference for stencil programs (+ a numpy twin), carried
over from ``repro.program.oracle`` (whose twin is jnp).

Executes the DAG op-by-op — each stencil op as ``spec.timesteps`` masked
sweeps, each combine as a masked elementwise linear combination — with the
same margin discipline the lowering implements in hardware: after every op,
everything outside the output field's valid box is zeroed, so invalid rim
values never propagate (the program-level generalization of
``core.reference``'s support-only convention).

``program_reference_np`` is the simulator tests' ground truth (no torch
involvement, float64 end to end, like ``stencil_reference_np``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.reference import _interior_mask, _np_shift, stencil_sweep
from repro_torch.program.ir import StencilOp, StencilProgram


def _mask(shape, margin) -> np.ndarray:
    return _interior_mask(shape, margin, 1)


def program_reference_np(program: StencilProgram,
                         inputs: dict[str, np.ndarray]
                         ) -> dict[str, np.ndarray]:
    """Execute the DAG with numpy; returns the named output fields."""
    dt = np.float64 if program.dtype == "float64" else np.float32
    missing = [f for f in program.in_fields if f not in inputs]
    if missing:
        raise ValueError(f"missing input fields: {missing}")
    vals = {f: np.asarray(inputs[f], dtype=dt) for f in program.in_fields}
    margins = program.margins()
    shape = program.grid_shape
    for op in program.schedule():
        if isinstance(op, StencilOp):
            out = vals[op.input]
            m_in = margins[op.input]
            for t in range(1, op.spec.timesteps + 1):
                acc = np.zeros_like(out)
                for ax, (r, coeffs) in enumerate(zip(op.spec.radii,
                                                     op.spec.coeffs)):
                    for k, c in enumerate(coeffs):
                        if c == 0.0:
                            continue
                        acc += c * _np_shift(out, k - r, ax)
                m_t = tuple(mb + t * rb
                            for mb, rb in zip(m_in, op.spec.radii))
                out = np.where(_mask(shape, m_t), acc, 0.0)
        else:
            acc = np.zeros(shape, dtype=dt)
            for f, c in zip(op.inputs, op.coeffs):
                acc = acc + c * vals[f]
            out = np.where(_mask(shape, margins[op.output]), acc, 0.0)
        vals[op.output] = out
    return {f: vals[f] for f in program.out_fields}


def program_reference(program: StencilProgram, inputs: dict) -> dict:
    """torch twin of :func:`program_reference_np` (per-op sweeps on the
    inputs' device; dtype follows the inputs, as in
    :func:`core.reference.stencil_sweep`)."""
    vals = dict(inputs)
    margins = program.margins()
    shape = program.grid_shape

    def where(mask, x):
        m = torch.from_numpy(mask).to(x.device)
        return torch.where(m, x, torch.zeros_like(x))

    for op in program.schedule():
        if isinstance(op, StencilOp):
            out = vals[op.input]
            m_in = margins[op.input]
            for t in range(1, op.spec.timesteps + 1):
                out = stencil_sweep(out, op.spec)
                m_t = tuple(mb + t * rb
                            for mb, rb in zip(m_in, op.spec.radii))
                out = where(_mask(shape, m_t), out)
        else:
            acc = torch.zeros_like(vals[op.inputs[0]])
            for f, c in zip(op.inputs, op.coeffs):
                acc = acc + torch.tensor(c, dtype=acc.dtype,
                                         device=acc.device) * vals[f]
            out = where(_mask(shape, margins[op.output]), acc)
        vals[op.output] = out
    return {f: vals[f] for f in program.out_fields}
