"""Cycle-level CGRA simulator (paper §VIII) — backend-dispatching facade,
carried over from ``repro.core.simulator`` (host numpy).

Models a triggered-instruction fabric: every node (= instruction mapped to a
PE) *fires* in a cycle iff all its input queues hold data and all its output
queues have space — exactly the TIA firing rule [Parashar et al., IEEE Micro
'14].  Loads/stores additionally arbitrate for a shared memory-bandwidth
budget (``bw_gbps / clock / bytes_per_elem`` element-ops per cycle, fractional
credit carried across cycles).

The simulator *executes the numerics*: it produces the output grid, so every
mapping is validated end-to-end against ``core.reference`` — not just timed.
Program-graph plans (``repro_torch.program``) are simulated by the same
machinery:
they carry several ``cmp`` completion nodes (one per output field — the run
ends when *all* have fired), ``imux`` re-interleave nodes, and an
``out_shape`` that packs one grid-sized slot per output field.

Three backends implement the identical semantics (see ``docs/simulator.md``):

* ``engine="interp"`` — :mod:`repro_torch.core.engine.interp`, the reference
  per-node Python interpreter (the oracle).
* ``engine="vector"`` — :mod:`repro_torch.core.engine.vector`, the compiled
  struct-of-arrays engine: the DFG is compiled once into dense numpy tables
  (op-kind buckets, CSR edge indices, one ring-buffer pool for all queues)
  and each cycle runs as a handful of vectorized passes per op-kind.  Cycle
  counts, fire counts, hop/stall stats and output grids are bit-identical to
  the interpreter; wall-clock is 5-20x faster on program-pipeline grids.
* ``engine="cuda"`` — :mod:`repro_torch.core.engine.cuda_engine`, the
  compiled tables' cycle loop run to its fixed point by one hand-written
  CUDA kernel (K7), one block a plan, a whole batch in one launch
  (:func:`simulate_batch`); identical results in ideal mode.

**Network-aware mode** (``fabric=`` a placed-and-routed ``RoutedFabric`` from
``repro_torch.fabric``): every producer→consumer queue is no longer a free one-hop
wire.  A pushed token enters the on-chip network, pays one cycle per hop of
its XY route, and contends with co-routed trees for each link's
words-per-cycle bandwidth (store-and-forward: a token blocked on a busy link
departs on the link's next free slot).  Fan-out is multicast — one producer's
token crosses each shared tree link once.  Values and firing rules are
untouched, so the output grid is bit-identical to ideal mode and routed
cycle counts are >= ideal ones.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.core.engine import cuda_engine as _cuda
from repro_torch.core.engine import interp as _interp
from repro_torch.core.engine import vector as _vector
from repro_torch.core.engine.common import SimDeadlock, mem_elems_per_cycle
from repro_torch.core.mapping import MappingPlan
from repro_torch.core.roofline import Machine, analyze

if TYPE_CHECKING:  # pragma: no cover - avoids core <-> fabric import cycle
    from repro_torch.fabric.route import RoutedFabric
    from repro_torch.telemetry import Telemetry

__all__ = ["SimDeadlock", "SimResult", "simulate", "simulate_batch",
           "ENGINES"]

ENGINES = ("interp", "vector", "cuda")


@dataclasses.dataclass
class SimResult:
    cycles: int
    flops: int
    loads: int
    stores: int
    fires: dict[str, int]
    output: np.ndarray
    gflops: float
    pct_of_roofline: float
    pct_of_compute_peak: float
    max_queue_total: int
    mac_pes: int
    fabric: dict | None = None          # network-aware mode: routing stats

    def summary(self) -> str:
        s = (f"cycles={self.cycles} flops={self.flops} "
             f"GFLOPS={self.gflops:.1f} roofline%={self.pct_of_roofline:.1%} "
             f"loads={self.loads} stores={self.stores} macPEs={self.mac_pes}")
        if self.fabric is not None:
            s += (f" | fabric: pe_util={self.fabric['pe_utilization']:.0%} "
                  f"hops_mean={self.fabric['hops_mean']} "
                  f"max_chan={self.fabric['max_channel_load']} "
                  f"token_hops={self.fabric['token_hops']}")
        return s


def _attach_hint(plan, exc: SimDeadlock) -> SimDeadlock:
    """Enrich an engine deadlock with the static verifier's capacity-repair
    hint (``suggested_capacities``) — *how to fix it*, next to the stall
    table's *where it stuck*.  Timeouts are left alone (the run may simply
    need more cycles) and diagnosis failures never mask the deadlock."""
    if not exc.timed_out and exc.suggested_capacities is None:
        from repro_torch.analysis.static_verify import suggest_capacity_fix
        exc.suggested_capacities = suggest_capacity_fix(plan)
    return exc


def simulate(plan: MappingPlan, x: np.ndarray, machine: Machine,
             max_cycles: int = 50_000_000,
             mem_efficiency: float = 1.0,
             fabric: "RoutedFabric | None" = None,
             engine: str = "interp",
             telemetry: "Telemetry | None" = None,
             verify: str | None = None, device=None) -> SimResult:
    """``mem_efficiency`` derates the memory-port bandwidth to model cache
    conflict misses (the paper observed "more conflict misses in the cache
    for stencil 2D" — its cycle-accurate 2D result corresponds to ~0.80;
    our queue model is ideal at 1.0).

    ``fabric``: a ``repro_torch.fabric.route.RoutedFabric`` for this plan turns on
    network-aware mode (routed hop latency + link-bandwidth contention).

    ``engine``: ``"interp"`` (reference per-node interpreter), ``"vector"``
    (compiled struct-of-arrays engine, identical results, much faster), or
    ``"cuda"`` (the compiled tables' cycle loop as one CUDA kernel, a batch
    of one — identical results in ideal mode; raises
    ``NotImplementedError`` with ``fabric=`` or ``telemetry=``, see
    :mod:`repro_torch.core.engine.cuda_engine`).

    ``device``: where ``engine="cuda"`` runs: ``None`` is the card (raises
    without one), ``"cpu"`` the kernel's plain version.  The host engines
    ignore it.

    ``telemetry``: a ``repro_torch.telemetry.Telemetry`` sink to record per-node
    fire/stall timelines, stall attribution and per-link occupancy into
    (``docs/telemetry.md``); ``None`` (the default) keeps the engines on
    their uninstrumented hot paths.

    ``verify="static"``: pre-flight the plan through the static verifier
    (``repro_torch.analysis.static_verify``) and raise ``StaticDeadlock`` —
    naming the waits-for counterexample and carrying the capacity-repair
    hint — *before* burning any engine cycles on a plan that provably
    cannot complete.  See ``docs/analysis.md``.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; choose one of {ENGINES}")
    if verify is not None:
        if verify != "static":
            raise ValueError(f"unknown verify mode {verify!r}; "
                             f"only 'static' is supported")
        from repro_torch.analysis.static_verify import check_static
        check_static(plan, fabric=fabric, machine=machine,
                     mem_efficiency=mem_efficiency)
    spec = plan.spec
    flat_in = np.asarray(x, dtype=np.float64).reshape(-1)
    # program plans (repro.program) pack several output fields into one image
    out_shape = tuple(getattr(plan, "out_shape", None) or spec.grid_shape)
    flat_out = np.zeros(int(np.prod(out_shape)), dtype=np.float64)

    epc = mem_elems_per_cycle(spec, machine, mem_efficiency)
    if engine == "cuda":
        backend = functools.partial(_cuda.run, device=device)
    else:
        backend = _interp.run if engine == "interp" else _vector.run
    if telemetry is not None:
        telemetry.attach(plan, fabric)
    try:
        stats = backend(plan, flat_in, flat_out, epc, max_cycles, fabric,
                        telemetry)
    except SimDeadlock as e:
        raise _attach_hint(plan, e)
    return _to_result(plan, machine, stats, flat_out, out_shape, fabric)


def _to_result(plan, machine: Machine, stats, flat_out, out_shape,
               fabric) -> SimResult:
    gflops = (stats.flops / stats.cycles) * machine.clock_ghz
    roof = analyze(plan.spec, machine, workers=plan.workers)
    fabric_stats = None
    if fabric is not None:
        fabric_stats = {**fabric.stats(),
                        "token_hops": stats.token_hops,
                        "stall_cycles": stats.stall_cycles}
    return SimResult(
        cycles=stats.cycles, flops=stats.flops, loads=stats.loads,
        stores=stats.stores, fires=stats.fires,
        output=flat_out.reshape(out_shape), gflops=gflops,
        pct_of_roofline=gflops / roof.achievable_gflops,
        pct_of_compute_peak=gflops / machine.peak_gflops,
        max_queue_total=stats.max_queue_total, mac_pes=plan.mac_pes,
        fabric=fabric_stats)


def simulate_batch(items, machine: Machine,
                   max_cycles: int = 50_000_000,
                   mem_efficiency: float = 1.0,
                   engine: str = "cuda", device=None):
    """Simulate B independent ``(plan, x)`` pairs and return a list of
    per-lane outcomes, aligned with ``items``: a :class:`SimResult` on
    success, or the failure **as a value** — ``SimDeadlock`` for
    deadlock/timeout, ``NotImplementedError`` (``CudaLoweringError``) for
    lanes the cuda engine rejects.  Nothing is raised for per-lane
    failures, so one bad lane never poisons its siblings.

    With ``engine="cuda"`` (the default) the whole batch runs as **one
    launch** of K7 on ``device`` (``None``: the card, which raises where
    there is none; ``"cpu"``: the kernel's plain version), one block a
    plan (:mod:`repro_torch.core.engine.cuda_engine`); this is the
    auto-tuner's batched stage-1 evaluator.  Any other engine falls back to
    a sequential host loop with the same returns-as-values contract (handy
    for benchmarking the batched path against the sequential one)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; choose one of {ENGINES}")
    prepped = []
    for plan, x in items:
        spec = plan.spec
        flat_in = np.asarray(x, dtype=np.float64).reshape(-1)
        out_shape = tuple(getattr(plan, "out_shape", None) or spec.grid_shape)
        flat_out = np.zeros(int(np.prod(out_shape)), dtype=np.float64)
        epc = mem_elems_per_cycle(spec, machine, mem_efficiency)
        prepped.append((plan, flat_in, flat_out, out_shape, epc))

    if engine == "cuda":
        from repro_torch.core.engine.compile import compiled_for
        batch, out = [], [None] * len(prepped)
        for i, (plan, flat_in, flat_out, _os, epc) in enumerate(prepped):
            try:
                batch.append((i, compiled_for(plan, None), flat_in,
                              flat_out, epc))
            except ValueError as e:        # uncompilable op vocabulary
                out[i] = _cuda.CudaLoweringError(str(e))
        raw = _cuda.run_compiled_batch(
            [(cp, fi, fo, epc) for _i, cp, fi, fo, epc in batch],
            max_cycles=max_cycles, device=device) if batch else []
        for (i, _cp, _fi, _fo, _epc), stats in zip(batch, raw):
            plan, _flat_in, flat_out, out_shape, _e = prepped[i]
            if isinstance(stats, SimDeadlock):
                out[i] = _attach_hint(plan, stats)
            elif isinstance(stats, Exception):
                out[i] = stats
            else:
                out[i] = _to_result(plan, machine, stats, flat_out,
                                    out_shape, None)
        return out

    results = []
    for plan, flat_in, flat_out, out_shape, epc in prepped:
        backend = _interp.run if engine == "interp" else _vector.run
        try:
            stats = backend(plan, flat_in, flat_out, epc, max_cycles,
                            None, None)
        except SimDeadlock as e:
            results.append(_attach_hint(plan, e))
            continue
        results.append(_to_result(plan, machine, stats, flat_out, out_shape,
                                  None))
    return results
