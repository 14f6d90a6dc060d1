"""Text reports over a :class:`Telemetry` sink, carried over from
``repro.telemetry.report`` (the same text, line for line).

Two renderers, both pure functions of the recorded counters (no timeline
needed, so they work on ``Telemetry(timeline=False)`` runs too):

* :func:`utilization_grid` — the physical fabric as an ASCII heatmap, one
  cell per PE, shaded by fire-cycles / total-cycles of the instructions
  placed there (ideal runs fall back to a per-worker/stage table).
* :func:`bottleneck_table` — top-K nodes by attributed stall cycles, with
  the cause breakdown, plus the top contended links — this is the "why is
  this mapping routed-bound" answer the tuner's finalists need.
"""
from __future__ import annotations

import numpy as np

from repro_torch.telemetry.probe import STALL_CAUSES, Telemetry

__all__ = ["utilization_grid", "bottleneck_table", "render_report"]

_SHADES = " .:-=+*#%@"


def _shade(frac: float) -> str:
    return _SHADES[min(len(_SHADES) - 1, int(frac * (len(_SHADES) - 1)
                                             + 0.5))]


def utilization_grid(tel: Telemetry) -> str:
    """ASCII fabric heatmap (placed runs) or worker/stage utilization table
    (ideal runs); utilization = fired cycles / simulated cycles."""
    if not tel.attached:
        return "utilization: no run attached"
    cyc = max(1, tel.cycles)
    if tel.fabric is not None:
        topo = tel.fabric.topo
        coords = tel.fabric.placement.coords
        busy: dict[tuple, int] = {}
        for nid in range(tel.n_nodes):
            c = coords[nid]
            busy[c] = busy.get(c, 0) + int(tel.fires_total[nid])
        lines = [f"fabric utilization ({topo.rows}x{topo.cols}; "
                 f"shade = fire-cycles/cycle, max {_SHADES[-1]!r} = 100%)"]
        for r in range(topo.rows):
            row = "".join(
                _shade(min(1.0, busy.get((r, c), 0) / cyc))
                if (r, c) in busy else "·"
                for c in range(topo.cols))
            lines.append(f"  {r:>3} |{row}|")
        used = [min(1.0, b / cyc) for b in busy.values()]
        lines.append(f"  {len(busy)} PEs used, mean busy "
                     f"{100 * sum(used) / max(1, len(used)):.1f}% of "
                     f"{tel.cycles} cycles")
        return "\n".join(lines)
    # ideal mode: aggregate by worker/stage group
    busy_g: dict[str, int] = {}
    n_g: dict[str, int] = {}
    for nid, g in enumerate(tel.node_groups):
        busy_g[g] = busy_g.get(g, 0) + int(tel.fires_total[nid])
        n_g[g] = n_g.get(g, 0) + 1
    lines = ["worker/stage utilization (ideal run; busy% = mean "
             "fire-cycles/cycle over the group's instructions)"]
    for g in sorted(busy_g):
        frac = busy_g[g] / (cyc * n_g[g])
        bar = _shade(min(1.0, frac)) * max(1, int(min(1.0, frac) * 20))
        lines.append(f"  {g:<16} {100 * frac:5.1f}% |{bar}")
    return "\n".join(lines)


def bottleneck_table(tel: Telemetry, k: int = 10) -> str:
    """Top-``k`` stall-attribution table: which nodes lost the most cycles,
    and to what — plus the most contended links."""
    if not tel.attached:
        return "bottlenecks: no run attached (no stalls recorded)"
    per = tel.stall_totals
    order = np.argsort(-per.sum(axis=1), kind="stable")[:k]
    lines = [f"top-{k} bottlenecks (stalled cycles by cause; "
             f"run = {tel.cycles} cycles)",
             f"  {'node':<22}{'group':<14}{'total':>8}  "
             + "".join(f"{c.split('_')[0]:>10}" for c in STALL_CAUSES)]
    any_row = False
    for nid in order.tolist():
        tot = int(per[nid].sum())
        if tot == 0:
            break
        any_row = True
        lines.append(
            f"  {tel.node_names[nid][:21]:<22}"
            f"{tel.node_groups[nid][:13]:<14}{tot:>8}  "
            + "".join(f"{int(per[nid, i]):>10}"
                      for i in range(len(STALL_CAUSES))))
    if not any_row:
        lines.append("  (no stalls recorded)")
    hot = np.argsort(-tel.link_stalls, kind="stable")[:5]
    rows = [(int(l), int(tel.link_stalls[l]), int(tel.link_words[l]))
            for l in hot.tolist() if tel.link_stalls[l] > 0]
    if rows:
        lines.append("  contended links (stall-cycles / words carried):")
        for lid, st, w in rows:
            lines.append(f"    {tel.link_names[lid]:<24} {st:>8} / {w}")
    return "\n".join(lines)


def render_report(tel: Telemetry, k: int = 10) -> str:
    """Full text report: totals, heatmap, bottleneck attribution.  A sink
    that never observed a run renders a stub instead of raising — report
    paths run on failure/cleanup codepaths too."""
    if not tel.attached:
        return ("telemetry: no run attached — no stalls recorded "
                f"({len(tel.spans)} span(s))")
    t = tel.totals()
    head = (f"telemetry: {tel.run_label} — {t['cycles']} cycles, "
            f"{t['fires_total']} fires, {t['loads']} loads, "
            f"{t['stores']} stores, token_hops={t['token_hops']}, "
            f"net stall_cycles={t['stall_cycles']}\n"
            f"stall attribution (node-cycles): "
            + " ".join(f"{c}={n}"
                       for c, n in t["stall_attribution"].items()))
    return "\n".join([head, utilization_grid(tel), bottleneck_table(tel, k)])
