"""The mapping design space: configs, targets, enumeration, canonical hashes.

A :class:`MappingConfig` names one point of the lattice the tuner searches:

* ``workers``        — worker-pipeline width (the paper's §VI knob)
* ``temporal``       — fused time-steps per sweep (§IV temporal layers);
                       must divide the target's ``workload_timesteps``
* ``capacity``       — queue-capacity policy: ``"auto"`` (the §III-B
                       mandatory-buffering minima via ``auto_capacity``),
                       ``"unbounded"`` (idealized infinite queues), or a
                       fixed uniform int (which may deadlock — the tuner
                       records that as a measured failure)
* ``tile``           — optional ``plan_blocks`` block shape: the sweep is
                       strip-mined and one representative block is simulated,
                       workload cycles = per-block cycles x #blocks
* ``fabric``         — optional physical grid ``(rows, cols, kind)`` for the
                       routed stage, with ``place_seed``/``place_restarts``

Targets adapt the two plan kinds to one interface: :class:`SpecTarget` wraps
a single-op :class:`~repro_torch.core.spec.StencilSpec` (mapped with ``map_nd``),
:class:`ProgramTarget` wraps a :class:`~repro_torch.program.ir.StencilProgram`
(lowered with ``repro_torch.program.lower``).  Everything hashes canonically
(:meth:`MappingConfig.key`) so evaluations cache across runs.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import math

import numpy as np

from repro_torch.core.mapping import map_nd, plan_blocks
from repro_torch.core.roofline import Machine, worker_fit, workers_demanded
from repro_torch.core.spec import StencilSpec


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    workers: int
    temporal: int = 1
    capacity: str | int = "auto"
    tile: tuple[int, ...] | None = None
    fabric: tuple[int, int, str] | None = None     # (rows, cols, mesh|torus)
    place_seed: int = 0
    place_restarts: int = 1

    def __post_init__(self):
        if isinstance(self.capacity, str) and self.capacity not in (
                "auto", "unbounded"):
            raise ValueError(
                f"capacity policy must be 'auto', 'unbounded' or an int; "
                f"got {self.capacity!r}")
        if isinstance(self.capacity, int) and self.capacity < 1:
            raise ValueError("fixed queue capacity must be >= 1")

    # ----- canonical identity ------------------------------------------------
    def canonical(self, *, ideal: bool = False) -> dict:
        """JSON-stable description; ``ideal=True`` drops the physical knobs
        (fabric, placement seed) that cannot change an ideal-mode result, so
        routed variants share one cached ideal evaluation."""
        d = {"workers": self.workers, "temporal": self.temporal,
             "capacity": self.capacity,
             "tile": list(self.tile) if self.tile else None}
        if not ideal:
            d["fabric"] = list(self.fabric) if self.fabric else None
            d["place_seed"] = self.place_seed
            d["place_restarts"] = self.place_restarts
        return d

    def key(self, scope: dict, *, ideal: bool = False) -> str:
        """Canonical hash of (scope, config) — the eval-cache key.  ``scope``
        carries the target + machine signature."""
        blob = json.dumps({"scope": scope,
                           "config": self.canonical(ideal=ideal)},
                          sort_keys=True, separators=(",", ":"))
        return hashlib.sha1(blob.encode()).hexdigest()

    def with_fabric(self, fabric: tuple[int, int, str], seed: int,
                    restarts: int = 1) -> "MappingConfig":
        return dataclasses.replace(self, fabric=fabric, place_seed=seed,
                                   place_restarts=restarts)


@dataclasses.dataclass(frozen=True)
class SpaceOptions:
    """What the lattice enumerates.  ``workers=None`` derives candidates from
    the machine (1 .. min(physical fit, roofline demand + slack))."""
    workers: tuple[int, ...] | None = None
    temporal: tuple[int, ...] = (1,)
    capacities: tuple = ("auto",)
    tiles: tuple = (None,)                 # None = full grid, or block shapes
    fabrics: tuple[tuple[int, int, str], ...] = ()
    place_seeds: tuple[int, ...] = (0,)
    place_restarts: int = 1
    worker_slack: int = 2                  # workers kept above the BW demand
    max_workers: int = 16


# ---------------------------------------------------------------------------
# targets
# ---------------------------------------------------------------------------
def _digest(obj) -> str:
    return hashlib.sha1(
        json.dumps(obj, sort_keys=True, separators=(",", ":"),
                   default=str).encode()).hexdigest()[:16]


class SpecTarget:
    """A single-op stencil workload: advance ``workload_timesteps`` sweeps of
    ``spec`` (configs trade how many of them fuse into one pass)."""

    kind = "spec"

    def __init__(self, spec: StencilSpec, *, workload_timesteps: int = 1,
                 name: str | None = None):
        if spec.timesteps != 1:
            raise ValueError(
                "pass the single-sweep spec; fusion is the tuner's 'temporal'"
                " knob (workload_timesteps carries the sweep count)")
        if workload_timesteps < 1:
            raise ValueError("workload_timesteps must be >= 1")
        self.spec = spec
        self.workload_timesteps = workload_timesteps
        self.name = name or (f"stencil{spec.ndim}d_"
                             f"{'x'.join(map(str, spec.grid_shape))}")

    def signature(self) -> dict:
        return {"kind": self.kind, "grid": list(self.spec.grid_shape),
                "radii": list(self.spec.radii), "dtype": self.spec.dtype,
                "coeffs": _digest(self.spec.coeffs),
                "workload_timesteps": self.workload_timesteps}

    def sim_spec(self, cfg: MappingConfig) -> StencilSpec:
        """The spec one simulate() call maps: fused ``temporal`` steps over
        the tile (or full) grid."""
        spec = self.spec
        if cfg.temporal != spec.timesteps:
            spec = dataclasses.replace(spec, timesteps=cfg.temporal)
        if cfg.tile is not None:
            spec = dataclasses.replace(spec, grid_shape=tuple(cfg.tile))
        return spec

    def repeats(self, cfg: MappingConfig) -> int:
        """How many simulate() results one workload costs: #sweep passes
        (``workload_timesteps / temporal``) x #blocks (tiled sweeps run the
        blocks back to back; the estimate ignores inter-block pipeline
        overlap, so it is conservative)."""
        passes = self.workload_timesteps // cfg.temporal
        if cfg.tile is None:
            return passes
        shrink = tuple(2 * r * cfg.temporal for r in self.spec.radii)
        out_tile = tuple(t - s for t, s in zip(cfg.tile, shrink))
        full_out = tuple(n - s for n, s in zip(self.spec.grid_shape, shrink))
        blocks = math.prod(-(-f // o) for f, o in zip(full_out, out_tile))
        return passes * blocks

    def build(self, cfg: MappingConfig):
        spec = self.sim_spec(cfg)
        qcap = cfg.capacity if isinstance(cfg.capacity, int) else None
        return map_nd(spec, cfg.workers, queue_capacity=qcap,
                      auto_capacity=cfg.capacity == "auto")

    def make_input(self, plan) -> np.ndarray:
        return np.random.default_rng(0).normal(size=plan.spec.grid_shape)

    def verify(self, plan, cfg: MappingConfig, x: np.ndarray, res) -> None:
        """Cross-check the simulated numerics against the jnp-free oracle
        (the tile/temporal geometry is baked into ``sim_spec``, so the
        reference applies verbatim)."""
        from repro_torch.core.reference import stencil_reference_np
        ref = stencil_reference_np(np.asarray(x), self.sim_spec(cfg))
        np.testing.assert_allclose(res.output, ref, atol=1e-9)

    def inner_extent(self, cfg: MappingConfig) -> int:
        grid = cfg.tile if cfg.tile is not None else self.spec.grid_shape
        return grid[-1]

    def ndim(self) -> int:
        return self.spec.ndim

    def mac_demand(self, cfg: MappingConfig) -> int:
        """MAC-class PEs the mapped plan will occupy (w chains per layer)."""
        return cfg.workers * cfg.temporal * self.spec.macs_per_worker

    def roofline_spec(self) -> StencilSpec:
        return self.spec


class ProgramTarget:
    """A multi-operator stencil program DAG, lowered into one fused pipeline
    (``repro_torch.program.lower``).  Temporal layering and tiling are per-op
    properties of the program itself, so those knobs stay at 1/None."""

    kind = "program"

    def __init__(self, program, *, name: str | None = None):
        self.program = program
        self.workload_timesteps = 1
        self.name = name or program.name

    def signature(self) -> dict:
        ops = []
        for op in self.program.schedule():
            spec = getattr(op, "spec", None)
            ops.append({
                "name": op.name, "out": op.output,
                "in": list(op.inputs),
                "spec": None if spec is None else {
                    "radii": list(spec.radii), "timesteps": spec.timesteps,
                    "coeffs": _digest(spec.coeffs)},
            })
        return {"kind": self.kind, "name": self.program.name,
                "grid": list(self.program.grid_shape),
                "dtype": self.program.dtype, "ops": ops}

    def repeats(self, cfg: MappingConfig) -> int:
        return 1

    def build(self, cfg: MappingConfig):
        from repro_torch.program import lower
        qcap = cfg.capacity if isinstance(cfg.capacity, int) else None
        return lower(self.program, workers=cfg.workers, queue_capacity=qcap,
                     auto_capacity=cfg.capacity == "auto")

    def make_input(self, plan) -> np.ndarray:
        rng = np.random.default_rng(0)
        return plan.pack_inputs({f: rng.normal(size=self.program.grid_shape)
                                 for f in plan.in_fields})

    def verify(self, plan, cfg: MappingConfig, x: np.ndarray, res) -> None:
        from repro_torch.program import program_reference_np
        rng = np.random.default_rng(0)
        inputs = {f: rng.normal(size=self.program.grid_shape)
                  for f in plan.in_fields}
        ref = program_reference_np(self.program, inputs)
        fields = plan.unpack_outputs(res.output)
        for f in plan.out_fields:
            np.testing.assert_allclose(fields[f], ref[f], atol=1e-9)

    def inner_extent(self, cfg: MappingConfig) -> int:
        return self.program.grid_shape[-1]

    def ndim(self) -> int:
        return len(self.program.grid_shape)

    def mac_demand(self, cfg: MappingConfig) -> int:
        total = 0
        for op in self.program.schedule():
            spec = getattr(op, "spec", None)
            mpw = spec.macs_per_worker * spec.timesteps if spec else 1
            total += cfg.workers * mpw
        return total

    def roofline_spec(self) -> StencilSpec:
        """Representative spec for worker selection: the op with the deepest
        MAC chain dominates the physical-fit cap."""
        specs = [op.spec for op in self.program.schedule()
                 if getattr(op, "spec", None) is not None]
        if not specs:
            raise ValueError(f"program {self.program.name!r} has no "
                             f"stencil ops to size workers from")
        return max(specs, key=lambda s: s.macs_per_worker)


def as_target(target, *, workload_timesteps: int = 1):
    """Coerce a StencilSpec / StencilProgram / ready-made target."""
    if isinstance(target, StencilSpec):
        return SpecTarget(target, workload_timesteps=workload_timesteps)
    if hasattr(target, "schedule") and hasattr(target, "grid_shape"):
        return ProgramTarget(target)
    if hasattr(target, "build") and hasattr(target, "signature"):
        return target
    raise TypeError(f"cannot make an exploration target from {target!r}")


# ---------------------------------------------------------------------------
# enumeration
# ---------------------------------------------------------------------------
def analytic_config(target, machine: Machine) -> MappingConfig:
    """The paper's analytical §VI choice, made feasible: ``select_workers``'
    count clamped to the largest worker count that divides the innermost
    extent (rank >= 2 column ownership) and leaves every worker an output.
    This config is always seeded into the search space, so the measured
    best can only match or beat it."""
    spec = target.roofline_spec()
    need = workers_demanded(spec, machine)
    fit = worker_fit(spec, machine)
    cfg = MappingConfig(workers=max(1, min(need, fit)))
    while cfg.workers > 1 and not feasible_workers(target, cfg):
        cfg = dataclasses.replace(cfg, workers=cfg.workers - 1)
    return cfg


def feasible_workers(target, cfg: MappingConfig) -> bool:
    """Static mapper feasibility: divisibility + at least one output per
    worker (mirrors the ``map_nd`` constructor checks without building)."""
    w = cfg.workers
    if w < 1:
        return False
    inner = target.inner_extent(cfg)
    if target.ndim() >= 2 and inner % w:
        return False
    if target.kind == "spec":
        spec = target.spec
        interior = inner - 2 * spec.radii[-1] * cfg.temporal
        if w > interior:
            return False
    else:
        # programs accumulate margins op by op; the lowering itself checks
        # exactly — here only the cheap global bound
        if w > inner:
            return False
    return True


def derive_worker_candidates(target, machine: Machine,
                             options: SpaceOptions) -> tuple[int, ...]:
    """1..min(fit, demand+slack, max_workers), the roofline-informed ladder."""
    spec = target.roofline_spec()
    hi = min(worker_fit(spec, machine) if machine.num_macs else
             options.max_workers,
             workers_demanded(spec, machine) + options.worker_slack,
             options.max_workers)
    return tuple(range(1, max(1, hi) + 1))


def enumerate_space(target, machine: Machine, options: SpaceOptions
                    ) -> tuple[list[MappingConfig], MappingConfig]:
    """The ideal-mode lattice (fabric applied later, to finalists only) plus
    the always-included analytical seed config."""
    workers = (options.workers if options.workers is not None
               else derive_worker_candidates(target, machine, options))
    temporal = options.temporal
    if target.kind != "spec":
        temporal = (1,)
    tiles = options.tiles if target.kind == "spec" else (None,)
    configs = []
    seen = set()
    for w, t, cap, tile in itertools.product(
            workers, temporal, options.capacities, tiles):
        cfg = MappingConfig(workers=w, temporal=t, capacity=cap,
                            tile=tuple(tile) if tile else None)
        k = (w, t, cap, cfg.tile)
        if k not in seen:
            seen.add(k)
            configs.append(cfg)
    analytic = analytic_config(target, machine)
    if not any(c.workers == analytic.workers and c.temporal == 1
               and c.capacity == analytic.capacity and c.tile is None
               for c in configs):
        configs.insert(0, analytic)
    return configs, analytic


def tile_candidates(spec: StencilSpec, storage_budgets_bytes,
                    lane_multiple: int = 128) -> tuple:
    """Distinct ``plan_blocks`` block shapes for a ladder of storage budgets
    (the tiling axis of the lattice); budgets below the minimal working set
    are skipped, full-grid blocks collapse to ``None``."""
    out, seen = [], set()
    for b in storage_budgets_bytes:
        try:
            bp = plan_blocks(spec, b, lane_multiple=lane_multiple)
        except ValueError:
            continue
        tile = None if bp.block_shape == spec.grid_shape else bp.block_shape
        if tile not in seen:
            seen.add(tile)
            out.append(tile)
    return tuple(out) or (None,)
