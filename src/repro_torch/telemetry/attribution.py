"""Cycle-accounting profiler: where did a run's cycles go?

:func:`attribute` consumes a finished :class:`repro_torch.telemetry.Telemetry`
sink (the exclusive per-node per-cycle states of docs/telemetry.md) and
decomposes the measured run into an **exact** accounting:

* **phases** — pipeline *fill* (cycles before the first store fired),
  *steady* state, and *drain* (cycles after the last load fired), derived
  from the sink's fire-timeline envelope.  ``fill + steady + drain ==
  SimResult.cycles`` always, by construction.
* **causes** — the roofline gap attributed to the four stall causes
  (``repro_torch.telemetry.STALL_CAUSES``: input-starved / output-blocked /
  memory-arbitration / network-contention), in node-cycles.  Together with
  fired and inactive node-cycles these tile ``cycles * n_nodes`` exactly.
* **stages** — the same breakdown rolled up per mapping pipeline stage
  (ReaderBank / TapChain / AddTree / WriterBank / SyncTree — the paper's
  §III worker pipeline, recovered from ``Node.stage`` + op).
* **critical path** — a source→sink chain through the DFG extracted from
  the fire timelines: starting at the completion node, each step walks to
  the predecessor whose *last* fire is latest, i.e. the chain that kept
  the run alive longest.
* **bottleneck** — one label (``fill-bound`` / ``memory-bound`` /
  ``network-bound`` / ``capacity-bound`` / ``starved`` /
  ``compute-bound``) summarizing the dominant term; the tuner records it
  per evaluation and surfaces it on the Pareto front.

Everything here is a *pure function of the sink's exact counters*, which
both engines fill identically (the PR 6 parity gates) — so the
decomposition is bit-identical across interp and vector by construction,
and ``tests/test_attribution.py`` gates it end-to-end anyway.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.telemetry.probe import STALL_CAUSES, Telemetry

__all__ = ["CycleAccounting", "attribute", "render_attribution",
           "stage_label", "STAGE_ORDER"]

#: canonical render order of the mapping pipeline stages
STAGE_ORDER = ("ReaderBank", "TapChain", "AddTree", "WriterBank", "SyncTree")

_STAGE_BY_TAG = {"reader": "ReaderBank", "writer": "WriterBank",
                 "sync": "SyncTree"}


def stage_label(stage: str, op: str) -> str:
    """Map a node's ``(Node.stage, op)`` onto the paper's pipeline stage.
    ``compute`` nodes split into the TapChain (filter/mul/mac/imux — the
    per-axis tap pipelines and their splice muxes) and the AddTree
    (cross-axis ``add`` reduction)."""
    if stage == "compute":
        return "AddTree" if op == "add" else "TapChain"
    if stage in _STAGE_BY_TAG:
        return _STAGE_BY_TAG[stage]
    return stage.capitalize() if stage else "Other"


@dataclasses.dataclass
class CycleAccounting:
    """The exact decomposition of one run (see the module docstring)."""
    run: str
    cycles: int
    n_nodes: int
    phases: dict                # {"fill": int, "steady": int, "drain": int}
    causes: dict                # stall node-cycles per STALL_CAUSES entry
    fired: int                  # total fired node-cycles
    inactive: int               # total inactive (retired/unobserved) slots
    stages: dict                # stage -> {"nodes", "fired", "inactive", ...}
    critical_path: list         # source->sink node dicts (see attribute())
    bottleneck: str

    def as_dict(self) -> dict:
        return {"run": self.run, "cycles": self.cycles,
                "n_nodes": self.n_nodes, "phases": dict(self.phases),
                "causes": dict(self.causes), "fired": self.fired,
                "inactive": self.inactive,
                "stages": {k: dict(v) for k, v in self.stages.items()},
                "critical_path": [dict(d) for d in self.critical_path],
                "bottleneck": self.bottleneck}


def _phases(tel: Telemetry) -> dict:
    """fill/steady/drain from the fire-timeline envelope.  Exactness
    contract: the three terms are clamped to sum to ``cycles`` exactly."""
    cycles = tel.cycles
    first_out = min((int(tel.first_fire[nid])
                     for nid, op in enumerate(tel.node_ops)
                     if op == "store" and tel.first_fire[nid] > 0),
                    default=cycles + 1)
    last_in = max((int(tel.last_fire[nid])
                   for nid, op in enumerate(tel.node_ops) if op == "load"),
                  default=0)
    fill = max(0, min(first_out - 1, cycles))
    drain = max(0, min(cycles - last_in, cycles - fill))
    return {"fill": fill, "steady": cycles - fill - drain, "drain": drain}


def _critical_path(tel: Telemetry) -> list:
    """Walk the DFG backwards from the completion node along latest-last-fire
    predecessors; ties break to the lowest nid so the path is deterministic
    (and therefore engine-independent, like everything else here)."""
    nodes = tel.plan.dfg.nodes
    fired = [nid for nid in range(tel.n_nodes) if tel.fires_total[nid] > 0]
    if not fired:
        return []
    sink = next((n.nid for n in nodes
                 if n.op == "cmp" and tel.fires_total[n.nid] > 0),
                max(fired, key=lambda nid: (int(tel.last_fire[nid]), -nid)))
    path = []
    seen = set()
    nid = sink
    while nid is not None and nid not in seen and len(path) <= tel.n_nodes:
        seen.add(nid)
        st = tel.stall_totals[nid]
        tot = int(st.sum())
        path.append({
            "name": tel.node_names[nid], "op": tel.node_ops[nid],
            "stage": stage_label(nodes[nid].stage, nodes[nid].op),
            "first_fire": int(tel.first_fire[nid]),
            "last_fire": int(tel.last_fire[nid]),
            "fires": int(tel.fires_total[nid]), "stalled": tot,
            "cause": STALL_CAUSES[int(st.argmax())] if tot else None})
        preds = [e.src.nid for e in nodes[nid].in_edges
                 if tel.fires_total[e.src.nid] > 0 and e.src.nid not in seen]
        nid = (min(preds, key=lambda p: (-int(tel.last_fire[p]), p))
               if preds else None)
    path.reverse()
    return path


def _bottleneck(cycles: int, phases: dict, causes: dict) -> str:
    if cycles <= 0:
        return "compute-bound"
    if 2 * (phases["fill"] + phases["drain"]) >= cycles:
        return "fill-bound"
    if not any(causes.values()):
        return "compute-bound"
    label = {"input_starved": "starved", "output_blocked": "capacity-bound",
             "memory_arbitration": "memory-bound",
             "network_contention": "network-bound"}
    top = max(STALL_CAUSES, key=lambda c: causes.get(c, 0))
    return label[top]


def attribute(tel: Telemetry, result=None) -> CycleAccounting:
    """Decompose a finished run.  ``result`` (the run's ``SimResult``) is
    optional; when given, the exact-sum contract against ``result.cycles``
    is asserted here instead of merely in the tests."""
    if not tel.attached:
        raise ValueError("attribute() needs a sink that observed a run "
                         "(simulate(..., telemetry=tel) first)")
    if not tel.finished:
        raise ValueError("attribute() needs a finished run "
                         "(the engine did not reach finish())")
    cycles, n = tel.cycles, tel.n_nodes
    nodes = tel.plan.dfg.nodes

    causes = {c: int(tel.stall_totals[:, i].sum())
              for i, c in enumerate(STALL_CAUSES)}
    fired = int(tel.fires_total.sum())
    inactive = cycles * n - fired - sum(causes.values())

    stages: dict[str, dict] = {}
    for nid in range(n):
        lab = stage_label(nodes[nid].stage, nodes[nid].op)
        row = stages.setdefault(
            lab, {"nodes": 0, "fired": 0, "inactive": 0,
                  **{c: 0 for c in STALL_CAUSES}})
        row["nodes"] += 1
        row["fired"] += int(tel.fires_total[nid])
        stalled = 0
        for i, c in enumerate(STALL_CAUSES):
            v = int(tel.stall_totals[nid, i])
            row[c] += v
            stalled += v
        row["inactive"] += cycles - int(tel.fires_total[nid]) - stalled

    phases = _phases(tel)
    acct = CycleAccounting(
        run=tel.run_label, cycles=cycles, n_nodes=n, phases=phases,
        causes=causes, fired=fired, inactive=inactive, stages=stages,
        critical_path=_critical_path(tel),
        bottleneck=_bottleneck(cycles, phases, causes))

    # the exact-sum contract, checked on every call (cheap):
    assert sum(phases.values()) == cycles, (phases, cycles)
    assert inactive >= 0, "states overflow cycles*n_nodes — engine drift?"
    tiled = sum(v["fired"] + v["inactive"]
                + sum(v[c] for c in STALL_CAUSES)
                for v in stages.values())
    assert tiled == cycles * n, (tiled, cycles * n)
    if result is not None and result.cycles != cycles:
        raise AssertionError(
            f"sink saw {cycles} cycles but SimResult says {result.cycles}")
    return acct


def render_attribution(acct: CycleAccounting) -> str:
    """Terminal view of one accounting: phase bar, cause shares, the
    per-stage table, and the critical path."""
    c = max(1, acct.cycles)
    lines = [f"cycle accounting: {acct.run} — {acct.cycles} cycles, "
             f"bottleneck: {acct.bottleneck}",
             "  phases: " + "  ".join(
                 f"{k}={v} ({100 * v / c:.1f}%)"
                 for k, v in acct.phases.items())]
    active = max(1, acct.cycles * acct.n_nodes - acct.inactive)
    lines.append("  stall causes (node-cycles, % of non-retired): "
                 + (" ".join(f"{k}={v} ({100 * v / active:.1f}%)"
                             for k, v in acct.causes.items() if v)
                    or "none"))
    order = [s for s in STAGE_ORDER if s in acct.stages] + sorted(
        s for s in acct.stages if s not in STAGE_ORDER)
    lines.append(f"  {'stage':<12}{'nodes':>6}{'fired':>10}{'inactive':>10}"
                 + "".join(f"{cz.split('_')[0]:>10}" for cz in STALL_CAUSES))
    for s in order:
        v = acct.stages[s]
        lines.append(f"  {s:<12}{v['nodes']:>6}{v['fired']:>10}"
                     f"{v['inactive']:>10}"
                     + "".join(f"{v[cz]:>10}" for cz in STALL_CAUSES))
    if acct.critical_path:
        lines.append("  critical path (source -> sink by last fire):")
        for d in acct.critical_path:
            stall = (f", stalled {d['stalled']} ({d['cause']})"
                     if d["stalled"] else "")
            lines.append(f"    {d['name']} [{d['stage']}] fires "
                         f"{d['first_fire']}..{d['last_fire']} "
                         f"x{d['fires']}{stall}")
    return "\n".join(lines)
