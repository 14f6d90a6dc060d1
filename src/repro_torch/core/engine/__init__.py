"""Simulation backends: reference interpreter and compiled vector engine,
carried over from ``repro.core.engine`` (host numpy), and the batched CUDA
engine.

``repro_torch.core.simulator.simulate(..., engine="interp"|"vector"|"cuda")``
dispatches here.  All three implement identical semantics over the same
:class:`~repro_torch.core.engine.common.RawStats` contract; the vector engine
compiles the DFG once into struct-of-arrays tables
(:mod:`repro_torch.core.engine.compile`) and runs each cycle as a handful of
vectorized numpy passes (:mod:`repro_torch.core.engine.vector`); the cuda
engine (:mod:`repro_torch.core.engine.cuda_engine`, the counterpart of the
reference's jax engine) runs those tables' cycle loop in one hand-written
kernel, K7, a whole batch of plans in one launch (``simulate_batch``).

``ENGINE_SEMANTICS`` names each backend's cycle-semantics version.  It is
part of the auto-tuner's EvalCache scope key, so measurements taken by one
engine are never replayed as another's (and a semantics bump invalidates
that engine's cached evals only).  The host engines' tags are the
reference's: the semantics are the same, bit for bit.  ``"cuda"`` is the
port's own engine (the reference names its device engine ``"jax"``).
"""
from repro_torch.core.engine.common import RawStats, SimDeadlock
from repro_torch.core.engine.compile import (CompiledPlan, StaleCompiledPlanError,
                                             compile_plan, compiled_for)

#: engine name -> semantics version tag (EvalCache scope component).
ENGINE_SEMANTICS = {"interp": "interp/v1", "vector": "vector-soa/v1",
                    "cuda": "cuda-batch/v1"}

__all__ = ["RawStats", "SimDeadlock", "CompiledPlan",
           "StaleCompiledPlanError", "compile_plan", "compiled_for",
           "ENGINE_SEMANTICS"]
