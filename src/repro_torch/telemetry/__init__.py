"""Opt-in observability substrate, carried over from ``repro.telemetry``
(docs/telemetry.md).

    from repro_torch.telemetry import Telemetry, write_trace, render_report

    tel = Telemetry()
    res = simulate(plan, x, CGRA, fabric=rf, telemetry=tel)
    print(render_report(tel))          # fabric heatmap + stall attribution
    write_trace(tel, "run.trace.json") # open in ui.perfetto.dev

The sink is exact (counters sum bit-for-bit to the simulator's aggregate
stats, across both engines) and free when absent (``telemetry=None`` keeps
the engines on their uninstrumented hot paths).  The mapping auto-tuner
records a search span per evaluation into the same sink (``explore(...,
telemetry=tel)``), so one trace file can hold a whole sweep.

The stencil kernels' host path records its spans into the same sink inside
``recording(tel)`` (:mod:`repro_torch.telemetry.host`); ``__all__`` stays
the reference's.
"""
from repro_torch.telemetry.attribution import (CycleAccounting, attribute,
                                               render_attribution, stage_label)
from repro_torch.telemetry.host import recording  # noqa: F401
from repro_torch.telemetry.metrics import (append_history, case_records,
                                           load_history)
from repro_torch.telemetry.probe import (ST_FIRED, ST_INACTIVE, ST_INPUT_STARVED,
                                         ST_MEM_ARB, ST_NET_WAIT,
                                         ST_OUTPUT_BLOCKED, STALL_CAUSES,
                                         STATE_NAMES, Telemetry,
                                         format_stall_summary)
from repro_torch.telemetry.report import (bottleneck_table, render_report,
                                          utilization_grid)
from repro_torch.telemetry.trace import (trace_events, validate_trace,
                                         write_trace)

__all__ = ["Telemetry", "STALL_CAUSES", "STATE_NAMES", "ST_INACTIVE",
           "ST_FIRED", "ST_INPUT_STARVED", "ST_OUTPUT_BLOCKED", "ST_MEM_ARB",
           "ST_NET_WAIT", "format_stall_summary", "trace_events",
           "write_trace", "validate_trace", "utilization_grid",
           "bottleneck_table", "render_report", "CycleAccounting",
           "attribute", "render_attribution", "stage_label",
           "case_records", "append_history", "load_history"]
