"""Static analysis passes, carried over from ``repro.analysis``: the plan
verifier (``static_verify``, see docs/analysis.md), which ``simulate`` calls
on every deadlock, is the front door; the lint CLI
(``python -m repro_torch.analysis.lint``) is imported directly by its
users and, as in the reference, not re-exported here.
"""
from repro_torch.analysis.static_verify import (STATIC_SEMANTICS,  # noqa: F401
                                                Counterexample, Finding,
                                                StaticDeadlock, StaticReport,
                                                ThroughputBound,
                                                apply_suggested_capacities,
                                                check_static, lint_plan,
                                                suggest_capacity_fix,
                                                throughput_bound, verify_plan)

__all__ = [
    "STATIC_SEMANTICS", "Counterexample", "Finding", "StaticDeadlock",
    "StaticReport", "ThroughputBound", "apply_suggested_capacities",
    "check_static", "lint_plan", "suggest_capacity_fix", "throughput_bound",
    "verify_plan",
]
