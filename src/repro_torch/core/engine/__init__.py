"""Simulation backends: reference interpreter and compiled vector engine,
carried over from ``repro.core.engine`` (host numpy).

``repro_torch.core.simulator.simulate(..., engine="interp"|"vector")``
dispatches here.  Both backends implement identical semantics over the same
:class:`~repro_torch.core.engine.common.RawStats` contract; the vector engine
compiles the DFG once into struct-of-arrays tables
(:mod:`repro_torch.core.engine.compile`) and runs each cycle as a handful of
vectorized numpy passes (:mod:`repro_torch.core.engine.vector`).  The
reference's third backend, the batched jax engine, is not ported yet: its
counterpart is to be a hand-written CUDA engine, and until then
``simulate(..., engine="jax")`` and ``simulate_batch`` raise
``NotImplementedError``.

``ENGINE_SEMANTICS`` names each backend's cycle-semantics version.  It is
part of the auto-tuner's EvalCache scope key, so measurements taken by one
engine are never replayed as another's (and a semantics bump invalidates
that engine's cached evals only).  The tags are the reference's: the
semantics are the same, bit for bit.
"""
from repro_torch.core.engine.common import RawStats, SimDeadlock
from repro_torch.core.engine.compile import (CompiledPlan, StaleCompiledPlanError,
                                             compile_plan, compiled_for)

#: engine name -> semantics version tag (EvalCache scope component).
ENGINE_SEMANTICS = {"interp": "interp/v1", "vector": "vector-soa/v1"}

__all__ = ["RawStats", "SimDeadlock", "CompiledPlan",
           "StaleCompiledPlanError", "compile_plan", "compiled_for",
           "ENGINE_SEMANTICS"]
