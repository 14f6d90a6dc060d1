"""Analytical pruning of the mapping lattice (the cheap half of the search).

Before any cycle is simulated the tuner discards configs that provably
cannot map or cannot win, using only the §VI roofline arithmetic and the
``map_nd`` structural constraints:

* ``indivisible``      — rank >= 2 column ownership needs the innermost
                         extent (of the tile, when tiling) to divide by the
                         worker count.
* ``no-interior``      — more workers than interior sites along the
                         innermost axis: some workers would own no outputs.
* ``temporal``         — the fused depth must divide the workload's sweep
                         count (and stay 1 for program targets — fusion is
                         per-op in the program IR).
* ``tile-degenerate``  — the fused halo leaves a tile no interior.
* ``mac-overflow``     — the plan's MAC chains (w x temporal x chain length,
                         summed over program ops) exceed the machine's MACs.
* ``roofline-excess``  — workers beyond the bandwidth-limited demand
                         (+ ``worker_slack``): §VI says extra workers only
                         burn PEs once the memory system is saturated, so
                         they cannot beat a front that already contains the
                         saturating count.

``prune_space`` returns the surviving configs plus a :class:`PruneLog`
(reason -> count, and the dropped configs for the artifact/stats).  A second
exact gate, :func:`fits_fabric`, runs post-build on survivors headed to the
routed stage (instruction count vs PE slots per capability class).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.roofline import Machine, workers_demanded
from repro_torch.explore.space import MappingConfig, SpaceOptions, feasible_workers
from repro_torch.fabric.topology import FabricTopology, op_class


@dataclasses.dataclass
class PruneLog:
    reasons: dict[str, int] = dataclasses.field(default_factory=dict)
    dropped: list[tuple[MappingConfig, str]] = dataclasses.field(
        default_factory=list)

    def drop(self, cfg: MappingConfig, reason: str) -> None:
        self.reasons[reason] = self.reasons.get(reason, 0) + 1
        self.dropped.append((cfg, reason))

    def as_dict(self) -> dict:
        return dict(sorted(self.reasons.items()))


def prune_reason(target, machine: Machine, cfg: MappingConfig,
                 options: SpaceOptions) -> str | None:
    """The first rule ``cfg`` violates, or None if it survives."""
    if cfg.temporal < 1 or target.workload_timesteps % cfg.temporal:
        return "temporal"
    if target.kind != "spec" and (cfg.temporal != 1 or cfg.tile is not None):
        return "temporal" if cfg.temporal != 1 else "tile-degenerate"
    if cfg.tile is not None:
        spec = target.spec
        if len(cfg.tile) != spec.ndim:
            return "tile-degenerate"
        for n, t, r in zip(spec.grid_shape, cfg.tile, spec.radii):
            if t > n or t - 2 * r * cfg.temporal < 1:
                return "tile-degenerate"
    if not feasible_workers(target, cfg):
        inner = target.inner_extent(cfg)
        if target.ndim() >= 2 and inner % max(1, cfg.workers):
            return "indivisible"
        return "no-interior"
    if machine.num_macs and target.mac_demand(cfg) > machine.num_macs:
        return "mac-overflow"
    need = workers_demanded(target.roofline_spec(), machine)
    if cfg.workers > need + options.worker_slack:
        return "roofline-excess"
    return None


def prune_space(target, machine: Machine, configs, options: SpaceOptions,
                *, keep: MappingConfig | None = None
                ) -> tuple[list[MappingConfig], PruneLog]:
    """Split ``configs`` into survivors and a reason log.  ``keep`` (the
    analytical seed) is exempt from the *roofline* rule only — it must still
    be mappable, but we never prune the baseline we compare against."""
    log = PruneLog()
    kept = []
    for cfg in configs:
        reason = prune_reason(target, machine, cfg, options)
        if reason == "roofline-excess" and keep is not None and cfg == keep:
            reason = None
        if reason is None:
            kept.append(cfg)
        else:
            log.drop(cfg, reason)
    return kept, log


def static_prune_reason(plan, fabric=None) -> tuple[str, dict | None] | None:
    """Post-build static-verifier gate (``repro_torch.analysis.static_verify``):
    a config whose plan provably deadlocks is pruned *before* any engine
    burns up to ``max_cycles`` on it.  Returns ``(reason,
    suggested_capacities)`` — reason ``"static-capacity: ..."`` when a
    capacity bump (the returned hint) provably fixes it, ``"static-deadlock:
    ..."`` when the deadlock is structural — or ``None`` for plans the
    verifier proves safe (or cannot decide: never prune on "unknown")."""
    from repro_torch.analysis.static_verify import verify_plan
    report = verify_plan(plan, fabric=fabric)
    if report.verdict != "deadlock":
        return None
    detail = (report.counterexample.describe() if report.counterexample
              else "; ".join(str(f) for f in report.errors()) or "unfixable")
    return f"{report.reason}: {detail}", report.suggested_capacities


def fits_fabric(plan, topo: FabricTopology) -> str | None:
    """Exact post-build fabric gate: instruction count vs total slots and
    per-capability-class slot budgets (mirrors ``place``'s own precheck
    without paying for placement).  Returns a reason string or None."""
    nodes = plan.dfg.nodes
    if len(nodes) > topo.total_slots():
        return (f"fabric-slots: {len(nodes)} instructions > "
                f"{topo.total_slots()} slots")
    demand: dict[str, int] = {}
    for n in nodes:
        cls = op_class(n.op)
        demand[cls] = demand.get(cls, 0) + 1
    for cls, need in demand.items():
        have = topo.total_slots(cls)
        if need > have:
            return f"fabric-slots: {need} {cls!r} ops > {have} {cls} slots"
    return None
