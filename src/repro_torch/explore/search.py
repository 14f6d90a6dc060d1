"""Budgeted design-space search: enumerate → prune → measure → Pareto.

The measured half of the tuner.  Stage 1 simulates every pruned-in config in
*ideal* mode (no network) with the compiled vector engine — fast enough that
a whole worker/temporal/capacity/tiling lattice costs less than one routed
interp run used to.  With ``Budget.batch_size`` set, stage 1 instead chunks
the pending configs and runs each chunk as **one** launch of the cuda
engine's kernel, K7 (:func:`repro_torch.core.simulator.simulate_batch`), on
``explore``'s ``device`` (the card unless the caller passes ``"cpu"``, which
runs K7's plain version); lanes the cuda engine can't express fall back to
the sequential engine.  Stage 2 takes the stage-1 Pareto finalists (plus,
always, the paper's analytical baseline) and pays for physics: seeded
placement (optionally restarted), XY routing, and network-aware simulation
per candidate fabric, producing the final objective vectors

    (workload cycles, PEs used, max channel load).

Every simulate() call is budgeted (``Budget.max_evals`` /
``Budget.max_sim_cycles``) and cached by canonical config hash
(:mod:`repro_torch.explore.cache`), failures included — a config known to
deadlock is never paid for twice.  The analytical config is evaluated
first, so even a one-eval budget yields the baseline, and the best()
pick can only match or beat it.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.analysis.static_verify import STATIC_SEMANTICS
from repro_torch.core.engine import ENGINE_SEMANTICS
from repro_torch.core.engine.common import SimDeadlock
from repro_torch.core.roofline import Machine
from repro_torch.core.simulator import simulate
from repro_torch.explore.cache import EvalCache
from repro_torch.explore.pareto import best_point, pareto_front
from repro_torch.explore.prune import (PruneLog, fits_fabric, prune_space,
                                       static_prune_reason)
from repro_torch.explore.space import (MappingConfig, SpaceOptions, as_target,
                                       enumerate_space)


@dataclasses.dataclass(frozen=True)
class Budget:
    """What the measured stage may spend.  ``None`` = unlimited.

    ``batch_size`` switches the stage-1 ideal sweep to the batched cuda
    engine: pending configs are chunked into groups of ``batch_size`` and
    each group simulates as one launch of K7 (``simulate_batch``), instead
    of one sequential ``vector.run`` per config.  Lanes the cuda engine
    rejects fall back to the sequential evaluator; stage-2 routed
    finalists always use the sequential engine (the cuda path is
    ideal-mode only).  ``None`` keeps the sequential stage 1."""
    max_evals: int | None = None          # simulate() calls (cache hits free)
    max_sim_cycles: int | None = None     # summed simulated cycles
    routed_finalists: int = 4             # stage-1 survivors that get routed
    sim_max_cycles: int = 5_000_000       # per-simulation runaway guard
    batch_size: int | None = None         # stage-1 lanes per batched launch


@dataclasses.dataclass
class EvalPoint:
    """One measured mapping: config + objective vector + provenance."""
    config: MappingConfig
    cycles: int                           # workload cycles (sim x repeats)
    pes: int                              # instructions (ideal) / PEs (routed)
    max_channel_load: int                 # 0 in ideal mode
    gflops: float
    routed: bool
    cached: bool = False
    sim_cycles: int = 0                   # raw cycles of the simulate() call
    bottleneck: str = ""                  # attribution label ("" = unknown)

    def objectives(self) -> tuple[int, int, int]:
        return (self.cycles, self.pes, self.max_channel_load)

    def as_dict(self) -> dict:
        return {"config": self.config.canonical(),
                "cycles": self.cycles, "pes": self.pes,
                "max_channel_load": self.max_channel_load,
                "gflops": round(self.gflops, 3), "routed": self.routed,
                "cached": self.cached, "bottleneck": self.bottleneck}


@dataclasses.dataclass
class ExploreResult:
    target: str
    machine: str
    points: list[EvalPoint]               # final-mode measurements
    ideal_points: list[EvalPoint]
    front: list[EvalPoint]
    analytic: EvalPoint | None            # the paper's §VI baseline, measured
    analytic_config: MappingConfig
    failures: list[dict]
    prune: PruneLog
    stats: dict

    def best(self) -> EvalPoint:
        return best_point(self.front, key=EvalPoint.objectives)

    def to_json(self) -> dict:
        best = self.best() if self.front else None
        return {
            "target": self.target, "machine": self.machine,
            "analytic": self.analytic.as_dict() if self.analytic else None,
            "best": best.as_dict() if best else None,
            "front": [p.as_dict() for p in self.front],
            "n_points": len(self.points),
            "failures": self.failures,
            "pruned": self.prune.as_dict(),
            "stats": self.stats,
        }


class _BudgetState:
    def __init__(self, budget: Budget):
        self.budget = budget
        self.evals = 0
        self.sim_cycles = 0

    def exhausted(self) -> bool:
        b = self.budget
        return ((b.max_evals is not None and self.evals >= b.max_evals)
                or (b.max_sim_cycles is not None
                    and self.sim_cycles >= b.max_sim_cycles))

    def charge(self, cycles: int) -> None:
        self.evals += 1
        self.sim_cycles += cycles


def _machine_sig(machine: Machine) -> dict:
    return {"name": machine.name, "clock_ghz": machine.clock_ghz,
            "num_macs": machine.num_macs, "bw_gbps": machine.bw_gbps,
            "peak_gflops": machine.peak_gflops}


def _mk_topo(fabric: tuple[int, int, str]):
    from repro_torch.fabric import FabricTopology
    rows, cols, kind = fabric
    if kind == "torus":
        return FabricTopology.torus_grid(rows, cols)
    return FabricTopology.mesh(rows, cols)


def _point_from_cache(cfg: MappingConfig, ent: dict,
                      routed: bool) -> EvalPoint:
    return EvalPoint(config=cfg, cycles=ent["cycles"], pes=ent["pes"],
                     max_channel_load=ent["chan"], gflops=ent["gflops"],
                     routed=routed, cached=True,
                     sim_cycles=ent["sim_cycles"],
                     bottleneck=ent.get("bottleneck", ""))


def _hint_json(suggested: dict | None) -> dict | None:
    """``suggested_capacities`` as a JSON-stable ``{str(eid): cap}`` map —
    the form failure records and cache entries carry (eids are deterministic
    per config, so a rebuilt plan accepts the replayed hint as-is)."""
    if not suggested:
        return None
    return {str(k): int(v) for k, v in sorted(suggested.items())}


def _paranoia_check(target, cfg: MappingConfig, plan, machine: Machine,
                    state: _BudgetState, rf) -> None:
    """``static_paranoia``: prove the verifier right the expensive way — a
    statically-rejected config must really deadlock when simulated.  Used
    by the fuzz gate; raises AssertionError on any unsound verdict."""
    x = target.make_input(plan)
    try:
        simulate(plan, x, machine, engine="vector", fabric=rf,
                 max_cycles=state.budget.sim_max_cycles)
    except SimDeadlock as e:
        if not e.timed_out:
            return
        raise AssertionError(
            f"static verifier rejected {cfg.canonical()} but the "
            f"simulation timed out instead of deadlocking") from e
    raise AssertionError(
        f"static verifier rejected {cfg.canonical()} but the simulation "
        f"completed — unsound static verdict")


def _evaluate(target, cfg: MappingConfig, machine: Machine, *, scope: dict,
              cache: EvalCache, state: _BudgetState, engine: str,
              failures: list, skipped: list, verify: bool,
              routed: bool, tel=None, static_gate: bool = False,
              paranoia: bool = False) -> EvalPoint | None:
    """One (possibly cached) measurement; None on failure/budget-skip."""
    key = cfg.key(scope, ideal=not routed)
    t0 = time.perf_counter()
    mode = "routed" if routed else "ideal"

    def span(outcome: str, *, cached: bool = False,
             cycles: int | None = None, bottleneck: str = "") -> None:
        """One structured span per evaluation into the telemetry sink —
        exported as a search-timeline trace (docs/telemetry.md)."""
        if tel is None:
            return
        b = state.budget
        el = time.perf_counter() - t0
        tel.span(f"{mode} {key[:10]}", cat="tuner", track=f"search/{mode}",
                 t0=tel.now() - el, dur=el, key=key, phase=mode,
                 config=cfg.canonical(), outcome=outcome, cached=cached,
                 cycles=cycles, bottleneck=bottleneck,
                 evals_remaining=(None if b.max_evals is None
                                  else b.max_evals - state.evals),
                 sim_cycles_remaining=(None if b.max_sim_cycles is None
                                       else b.max_sim_cycles
                                       - state.sim_cycles))

    ent = cache.get(key)
    if ent is not None:
        if "failed" in ent:
            rec = {"config": cfg.canonical(), "reason": ent["failed"],
                   "cached": True}
            if ent.get("suggested_capacities"):
                # cached failures replay the capacity-repair hint too
                rec["suggested_capacities"] = ent["suggested_capacities"]
            failures.append(rec)
            span(f"cached-failure: {ent['failed']}", cached=True)
            return None
        span("cached", cached=True, cycles=ent["sim_cycles"])
        return _point_from_cache(cfg, ent, routed)
    if state.exhausted():
        skipped.append(cfg)
        span("budget-skipped")
        return None

    def fail(reason: str, suggested: dict | None = None) -> None:
        rec = {"config": cfg.canonical(), "reason": reason, "cached": False}
        ent = {"failed": reason}
        hint = _hint_json(suggested)
        if hint:
            rec["suggested_capacities"] = hint
            ent["suggested_capacities"] = hint
        failures.append(rec)
        cache.put(key, ent)
        span(f"failed: {reason}")

    try:
        plan = target.build(cfg)
    except ValueError as e:
        fail(f"build: {e}")
        return None

    rf = placement = None
    if routed:
        topo = _mk_topo(cfg.fabric)
        reason = fits_fabric(plan, topo)
        if reason is not None:
            fail(reason)
            return None
        from repro_torch.fabric import (PlacementError, RouteError,
                                        apply_routed_capacities, place, route)
        try:
            placement = place(plan, topo, seed=cfg.place_seed,
                              restarts=cfg.place_restarts)
            rf = route(placement)
        except (PlacementError, RouteError) as e:
            fail(f"place/route: {e}")
            return None
        if cfg.capacity == "auto":
            # routed auto-capacity: grow the analytic minima by each edge's
            # routed hop depth — ideal minima back-pressure on long routes
            apply_routed_capacities(rf)

    if static_gate:
        # after apply_routed_capacities so the gate judges the capacities
        # the engine would actually run with
        sr = static_prune_reason(plan, fabric=rf)
        if sr is not None:
            reason, suggested = sr
            if paranoia:
                _paranoia_check(target, cfg, plan, machine, state, rf)
            fail(reason, suggested)
            return None

    from repro_torch.telemetry import Telemetry, attribute
    mtel = Telemetry(timeline=False)      # counters only: cheap attribution
    x = target.make_input(plan)
    try:
        res = simulate(plan, x, machine, engine=engine, fabric=rf,
                       max_cycles=state.budget.sim_max_cycles,
                       telemetry=mtel)
    except SimDeadlock as e:
        state.charge(e.cycles)            # the cycles burnt before giving up
        fail(f"{'timeout' if e.timed_out else 'deadlock'}: {e}",
             getattr(e, "suggested_capacities", None))
        return None
    state.charge(res.cycles)
    if verify:
        target.verify(plan, cfg, x, res)
    bottleneck = attribute(mtel, res).bottleneck

    pt = EvalPoint(
        config=cfg,
        cycles=res.cycles * target.repeats(cfg),
        pes=placement.pes_used() if placement is not None
        else len(plan.dfg.nodes),
        max_channel_load=(rf.stats()["max_channel_load"]
                          if rf is not None else 0),
        gflops=res.gflops, routed=routed, sim_cycles=res.cycles,
        bottleneck=bottleneck)
    cache.put(key, {"cycles": pt.cycles, "pes": pt.pes,
                    "chan": pt.max_channel_load, "gflops": pt.gflops,
                    "sim_cycles": pt.sim_cycles, "bottleneck": pt.bottleneck})
    span("measured", cycles=res.cycles, bottleneck=bottleneck)
    return pt


def _stage1_batched(target, kept, machine, *, base_scope: dict,
                    seq_scope: dict, cache: EvalCache, state: _BudgetState,
                    engine: str, failures: list, skipped: list,
                    verify: bool, tel=None, static_gate: bool = False,
                    paranoia: bool = False,
                    device=None) -> list[EvalPoint]:
    """Stage-1 ideal sweep as chunked one-launch cuda batches.

    Pending (uncached, in-budget) configs are built, chunked into groups of
    ``Budget.batch_size`` and dispatched through ``simulate_batch`` on
    ``device`` — each chunk is one launch of K7, one block a plan.
    Measurements are keyed under the cuda engine's own scope (``engine`` +
    ``engine_semantics``), so batched results and sequential ``engine``
    results can never replay each other.  Per-lane failures come back *as
    values*: deadlocks/timeouts are cached as failures exactly like the
    sequential path; lanes the cuda engine rejects
    (:class:`~repro_torch.core.engine.cuda_engine.CudaLoweringError`) fall
    back to the sequential evaluator under its own scope."""
    from repro_torch.core.simulator import simulate_batch

    scope = {**base_scope, "engine": "cuda",
             "engine_semantics": ENGINE_SEMANTICS["cuda"], "mode": "ideal"}
    points: list[EvalPoint] = []
    pending: list[tuple[MappingConfig, str]] = []

    def span(key: str, outcome: str, t0: float, *, cached: bool = False,
             cycles: int | None = None) -> None:
        if tel is None:
            return
        el = time.perf_counter() - t0
        b = state.budget
        tel.span(f"ideal {key[:10]}", cat="tuner", track="search/ideal",
                 t0=tel.now() - el, dur=el, key=key, phase="ideal",
                 outcome=outcome, cached=cached, cycles=cycles,
                 batched=True,
                 evals_remaining=(None if b.max_evals is None
                                  else b.max_evals - state.evals),
                 sim_cycles_remaining=(None if b.max_sim_cycles is None
                                       else b.max_sim_cycles
                                       - state.sim_cycles))

    for cfg in kept:
        key = cfg.key(scope, ideal=True)
        t0 = time.perf_counter()
        ent = cache.get(key)
        if ent is not None:
            if "failed" in ent:
                rec = {"config": cfg.canonical(),
                       "reason": ent["failed"], "cached": True}
                if ent.get("suggested_capacities"):
                    rec["suggested_capacities"] = ent["suggested_capacities"]
                failures.append(rec)
                span(key, f"cached-failure: {ent['failed']}", t0, cached=True)
            else:
                span(key, "cached", t0, cached=True,
                     cycles=ent["sim_cycles"])
                points.append(_point_from_cache(cfg, ent, False))
            continue
        pending.append((cfg, key))

    bsz = max(1, int(state.budget.batch_size))
    i = 0
    while i < len(pending):
        if state.exhausted():
            for cfg, key in pending[i:]:
                skipped.append(cfg)
                span(key, "budget-skipped", time.perf_counter())
            break
        take = bsz
        if state.budget.max_evals is not None:
            # never dispatch more lanes than the eval budget has left
            take = min(take, state.budget.max_evals - state.evals)
        chunk = pending[i:i + take]
        i += len(chunk)
        lanes = []                        # (cfg, key, plan, x, t0)
        for cfg, key in chunk:
            t0 = time.perf_counter()
            try:
                plan = target.build(cfg)
            except ValueError as e:
                failures.append({"config": cfg.canonical(),
                                 "reason": f"build: {e}", "cached": False})
                cache.put(key, {"failed": f"build: {e}"})
                span(key, f"failed: build: {e}", t0)
                continue
            if static_gate:
                sr = static_prune_reason(plan)
                if sr is not None:
                    reason, suggested = sr
                    if paranoia:
                        _paranoia_check(target, cfg, plan, machine, state,
                                        None)
                    rec = {"config": cfg.canonical(), "reason": reason,
                           "cached": False}
                    ent = {"failed": reason}
                    hint = _hint_json(suggested)
                    if hint:
                        rec["suggested_capacities"] = hint
                        ent["suggested_capacities"] = hint
                    failures.append(rec)
                    cache.put(key, ent)
                    span(key, f"failed: {reason}", t0)
                    continue
            lanes.append((cfg, key, plan, target.make_input(plan), t0))
        if not lanes:
            continue
        raw = simulate_batch([(p, x) for _c, _k, p, x, _t in lanes],
                             machine, max_cycles=state.budget.sim_max_cycles,
                             engine="cuda", device=device)
        for (cfg, key, plan, x, t0), res in zip(lanes, raw):
            if isinstance(res, NotImplementedError):
                # lowering rejected this lane: sequential fallback, measured
                # and cached under the sequential engine's own scope
                pt = _evaluate(target, cfg, machine, scope=seq_scope,
                               cache=cache, state=state, engine=engine,
                               failures=failures, skipped=skipped,
                               verify=verify, routed=False, tel=tel)
                if pt is not None:
                    points.append(pt)
                continue
            if isinstance(res, SimDeadlock):
                state.charge(res.cycles)  # the cycles burnt before giving up
                reason = (f"{'timeout' if res.timed_out else 'deadlock'}: "
                          f"{res}")
                rec = {"config": cfg.canonical(), "reason": reason,
                       "cached": False}
                ent = {"failed": reason}
                hint = _hint_json(getattr(res, "suggested_capacities", None))
                if hint:
                    rec["suggested_capacities"] = hint
                    ent["suggested_capacities"] = hint
                failures.append(rec)
                cache.put(key, ent)
                span(key, f"failed: {reason}", t0)
                continue
            state.charge(res.cycles)
            if verify:
                target.verify(plan, cfg, x, res)
            pt = EvalPoint(
                config=cfg, cycles=res.cycles * target.repeats(cfg),
                pes=len(plan.dfg.nodes), max_channel_load=0,
                gflops=res.gflops, routed=False, sim_cycles=res.cycles,
                bottleneck="")
            cache.put(key, {"cycles": pt.cycles, "pes": pt.pes, "chan": 0,
                            "gflops": pt.gflops, "sim_cycles": pt.sim_cycles,
                            "bottleneck": ""})
            span(key, "measured", t0, cycles=res.cycles)
            points.append(pt)
    return points


def explore(target, machine: Machine, *,
            options: SpaceOptions | None = None,
            budget: Budget | None = None,
            cache: EvalCache | str | None = None,
            engine: str = "vector",
            workload_timesteps: int = 1,
            verify: bool = False,
            telemetry=None,
            static_verify: bool = True,
            static_paranoia: bool = False,
            device=None) -> ExploreResult:
    """Search mapping configs for ``target`` (a ``StencilSpec``, a
    ``StencilProgram``, or a ready-made target) on ``machine`` and return
    the measured Pareto front.  See the module docstring for the staging;
    ``docs/explore.md`` for the full semantics.

    ``telemetry``: a ``repro_torch.telemetry.Telemetry`` sink — the search records
    one structured span per evaluation into it (config hash, outcome or
    prune reason, cache hit/miss, wall time, budget remaining), kept in its
    ``spans`` list (the port has no trace export yet).

    ``static_verify`` (default on) runs every freshly-built plan through the
    static verifier (``repro_torch.analysis.static_verify``) before paying for any
    simulation: provable deadlocks are recorded as ``static-capacity`` /
    ``static-deadlock`` failures — with the verifier's
    ``suggested_capacities`` repair hint on the failure record and in the
    cache entry — and never reach an engine.  ``static_paranoia``
    additionally simulates every statically-rejected config and asserts it
    really deadlocks (the fuzz-suite soundness gate; expensive).

    ``device``: where a batched stage 1 (``Budget.batch_size``) runs K7:
    ``None`` is the card, which raises where there is none; ``"cpu"`` runs
    its plain version.  Without ``batch_size`` nothing reaches the card."""
    t0 = time.perf_counter()
    target = as_target(target, workload_timesteps=workload_timesteps)
    options = options or SpaceOptions()
    budget = budget or Budget()
    if not isinstance(cache, EvalCache):
        cache = EvalCache(cache)

    configs, analytic_cfg = enumerate_space(target, machine, options)
    kept, plog = prune_space(target, machine, configs, options,
                             keep=analytic_cfg)
    if telemetry is not None:       # pruned configs get a (zero-cost) span
        for cfg, reason in plog.dropped:
            telemetry.span(f"pruned {reason}", cat="tuner",
                           track="search/prune", config=cfg.canonical(),
                           outcome=f"pruned: {reason}")
    # analytical baseline first: even a one-eval budget measures it
    kept.sort(key=lambda c: c != analytic_cfg)

    state = _BudgetState(budget)
    failures: list[dict] = []
    skipped: list[MappingConfig] = []
    # sim_max_cycles is part of the scope: a timeout under a small budget
    # must not be replayed from cache as a failure under a bigger one
    # capacity_model names the queue-sizing policy measured evals ran under
    # (hop/v1 = routed auto-capacity grows minima by hop depth); bumping it
    # invalidates cached evals taken under the older sizing.
    # engine + engine_semantics scope a measurement to the backend (and its
    # semantics version) that took it: batched-cuda evals can never be
    # replayed as vector evals or vice versa.
    # static_semantics scopes entries to the static-verifier version that
    # gated them: a verifier semantics bump (or turning the gate off) must
    # re-measure, not replay verdict-dependent failures from cache.
    base_scope = {"target": target.signature(),
                  "machine": _machine_sig(machine), "engine": engine,
                  "engine_semantics": ENGINE_SEMANTICS[engine],
                  "sim_max_cycles": budget.sim_max_cycles,
                  "capacity_model": "hop/v1",
                  "static_semantics":
                      STATIC_SEMANTICS if static_verify else None}

    # ----- stage 1: ideal-mode sweep ----------------------------------------
    scope = {**base_scope, "mode": "ideal"}
    if budget.batch_size:
        ideal_points = _stage1_batched(
            target, kept, machine, base_scope=base_scope, seq_scope=scope,
            cache=cache, state=state, engine=engine, failures=failures,
            skipped=skipped, verify=verify, tel=telemetry,
            static_gate=static_verify, paranoia=static_paranoia,
            device=device)
    else:
        ideal_points = []
        for cfg in kept:
            pt = _evaluate(target, cfg, machine, scope=scope, cache=cache,
                           state=state, engine=engine, failures=failures,
                           skipped=skipped, verify=verify, routed=False,
                           tel=telemetry, static_gate=static_verify,
                           paranoia=static_paranoia)
            if pt is not None:
                ideal_points.append(pt)

    analytic_pt = next((p for p in ideal_points
                        if p.config == analytic_cfg), None)

    # ----- stage 2: route the finalists -------------------------------------
    points = ideal_points
    if options.fabrics and ideal_points:
        finalists = pareto_front(ideal_points, key=EvalPoint.objectives)
        finalists = sorted(finalists, key=EvalPoint.objectives)
        finalists = finalists[:max(1, budget.routed_finalists)]
        if analytic_pt is not None and analytic_pt not in finalists:
            finalists.append(analytic_pt)
        scope = {**base_scope, "mode": "routed"}
        routed_points = []
        for pt in finalists:
            for fab in options.fabrics:
                for seed in options.place_seeds:
                    cfg = pt.config.with_fabric(fab, seed,
                                                options.place_restarts)
                    rpt = _evaluate(target, cfg, machine, scope=scope,
                                    cache=cache, state=state, engine=engine,
                                    failures=failures, skipped=skipped,
                                    verify=False, routed=True, tel=telemetry,
                                    static_gate=static_verify,
                                    paranoia=static_paranoia)
                    if rpt is not None:
                        routed_points.append(rpt)
        points = routed_points
        # the baseline must be measured in the SAME mode as the points it
        # anchors: if its routed eval failed there is no baseline (None),
        # never the ideal-mode stand-in (routed >= ideal would skew margins)
        analytic_pt = next(
            (p for p in routed_points
             if p.config.fabric == options.fabrics[0]
             and p.config.place_seed == options.place_seeds[0]
             and dataclasses.replace(p.config, fabric=None, place_seed=0,
                                     place_restarts=1) == analytic_cfg),
            None)

    front = pareto_front(points, key=EvalPoint.objectives)
    cache.save()
    # fold static-gate rejections into the prune log (reason prefix only:
    # "static-capacity"/"static-deadlock") so artifacts report them next to
    # the analytical prune rules; they stay in `failures` with full detail.
    for f in failures:
        if f["reason"].startswith("static-"):
            pfx = f["reason"].split(":", 1)[0]
            plog.reasons[pfx] = plog.reasons.get(pfx, 0) + 1
    stats = {
        "n_configs": len(configs), "n_pruned": len(plog.dropped),
        "n_kept": len(kept), "n_measured": state.evals,
        "n_cached": cache.hits, "n_failures": len(failures),
        "n_budget_skipped": len(skipped),
        "static_pruned": sum(1 for f in failures
                             if f["reason"].startswith("static-")),
        "sim_cycles_total": state.sim_cycles,
        "wall_s": round(time.perf_counter() - t0, 3),
        "cache": cache.stats(),
    }
    return ExploreResult(
        target=target.name, machine=machine.name, points=points,
        ideal_points=ideal_points, front=front, analytic=analytic_pt,
        analytic_config=analytic_cfg, failures=failures, prune=plog,
        stats=stats)
