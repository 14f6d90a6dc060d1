"""Shared contract between the simulation backends (interp & vector).

Both engines consume the same inputs — a plan (``MappingPlan`` or program
``ProgramPlan``), a flat input image, a preallocated flat output image, the
per-cycle memory-element budget — and return the same :class:`RawStats`.
``repro_torch.core.simulator.simulate`` turns RawStats into the public
:class:`~repro_torch.core.simulator.SimResult`; the engines themselves never touch
roofline math or result formatting, so the two backends can be compared
field-for-field in tests.
"""
from __future__ import annotations

import dataclasses


class SimDeadlock(RuntimeError):
    """Raised on deadlock or a ``max_cycles`` overrun.  ``cycles`` carries
    how many cycles were simulated before giving up (budget accounting in
    ``repro.explore``); ``timed_out`` distinguishes the overrun case.

    ``stall_summary`` is the stall-attribution diagnostic (which nodes were
    blocked on what — see ``repro_torch.telemetry``): the last-N-cycle window when
    a telemetry sink was attached, the final-cycle classification otherwise.
    Both engines embed its rendered form in the exception message.

    ``suggested_capacities`` is the static verifier's repair hint
    (``repro_torch.analysis.static_verify``): an ``{edge eid: capacity}`` map
    proven sufficient for the plan to complete, or ``None`` when the
    deadlock is structural (no capacity bump helps) or the hint was never
    computed (e.g. a timeout).  The stall table says *where* the pipeline
    stuck; this says *how to fix it*."""

    def __init__(self, msg: str, *, cycles: int = 0,
                 timed_out: bool = False,
                 stall_summary: dict | None = None,
                 suggested_capacities: dict | None = None):
        super().__init__(msg)
        self.cycles = cycles
        self.timed_out = timed_out
        self.stall_summary = stall_summary
        self.suggested_capacities = suggested_capacities


@dataclasses.dataclass
class RawStats:
    """Engine-agnostic simulation outcome (the cross-validated surface)."""
    cycles: int
    flops: int
    loads: int
    stores: int
    fires: dict[str, int]
    max_queue_total: int
    token_hops: int = 0              # network-aware mode only
    stall_cycles: int = 0


def mem_elems_per_cycle(spec, machine, mem_efficiency: float) -> float:
    """Element-ops per cycle the shared memory port sustains (fractional
    credit is carried across cycles by the engines)."""
    return mem_efficiency * machine.bw_gbps / machine.clock_ghz / (
        8 if spec.dtype == "float64" else spec.bytes_per_elem)


def deadlock_message(cycles: int, nodes) -> str:
    """The diagnostic both engines raise on deadlock: names + queue states of
    (up to 8) nodes that hold input tokens but cannot fire."""
    stuck = [f"{nd.name}({nd.op}) in={[len(e.q) for e in nd.in_edges]} "
             f"outfull={[e.full() for e in nd.out_edges]}"
             for nd in nodes if any(e.q for e in nd.in_edges)][:8]
    return f"deadlock at cycle {cycles}; sample blocked nodes: {stuck}"
