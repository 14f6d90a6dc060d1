"""Opt-in observability substrate, carried over from ``repro.telemetry``:
so far the probe sink and stall attribution, which the engines and the
static verifier need (metrics, report and trace are not ported yet).

    from repro_torch.telemetry import Telemetry, attribute

    tel = Telemetry()
    res = simulate(plan, x, CGRA, fabric=rf, telemetry=tel)
    acct = attribute(tel)              # per-stage stall attribution

The sink is exact (counters sum bit-for-bit to the simulator's aggregate
stats, across both engines) and free when absent (``telemetry=None`` keeps
the engines on their uninstrumented hot paths).
"""
from repro_torch.telemetry.attribution import (CycleAccounting, attribute,
                                               render_attribution, stage_label)
from repro_torch.telemetry.probe import (ST_FIRED, ST_INACTIVE, ST_INPUT_STARVED,
                                         ST_MEM_ARB, ST_NET_WAIT,
                                         ST_OUTPUT_BLOCKED, STALL_CAUSES,
                                         STATE_NAMES, Telemetry,
                                         format_stall_summary)

__all__ = ["Telemetry", "STALL_CAUSES", "STATE_NAMES", "ST_INACTIVE",
           "ST_FIRED", "ST_INPUT_STARVED", "ST_OUTPUT_BLOCKED", "ST_MEM_ARB",
           "ST_NET_WAIT", "format_stall_summary", "CycleAccounting",
           "attribute", "render_attribution", "stage_label"]
