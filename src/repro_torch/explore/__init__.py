"""Mapping auto-tuner: measured design-space exploration (docs/explore.md),
carried over from ``repro.explore`` (host numpy; the batched stage 1 runs
on the card through ``simulate_batch``).

The paper picks worker counts analytically (§VI roofline) — this package
closes the loop with *measured* search over the whole mapping lattice
(workers x temporal layers x queue-capacity policy x ``plan_blocks`` tiling
x fabric grid/topology x placement seed), pruned by the same roofline
arithmetic and evaluated with the compiled vector engine:

    from repro_torch.core import CGRA
    from repro_torch.core.spec import heat_2d
    from repro_torch.explore import explore, SpaceOptions, Budget

    res = explore(heat_2d(48, 96, dtype="float64"), CGRA,
                  options=SpaceOptions(fabrics=((16, 16, "mesh"),)),
                  budget=Budget(routed_finalists=3),
                  cache=".explore_cache.json")
    res.best()        # lexicographic (cycles, PEs, channel load) winner
    res.front         # the measured Pareto front
    res.analytic      # the paper's §VI baseline, measured the same way

Works for single-op specs (``map_nd``) and program DAGs
(``repro_torch.program.lower``) alike.
"""
from repro_torch.explore.cache import EvalCache
from repro_torch.explore.pareto import (assert_non_dominated, best_point,
                                        dominates, pareto_front)
from repro_torch.explore.prune import (PruneLog, fits_fabric, prune_reason,
                                       prune_space)
from repro_torch.explore.search import Budget, EvalPoint, ExploreResult, explore
from repro_torch.explore.space import (MappingConfig, ProgramTarget, SpaceOptions,
                                       SpecTarget, analytic_config, as_target,
                                       enumerate_space, tile_candidates)

__all__ = ["EvalCache", "assert_non_dominated", "best_point", "dominates",
           "pareto_front", "PruneLog", "fits_fabric", "prune_reason",
           "prune_space", "Budget", "EvalPoint", "ExploreResult", "explore",
           "MappingConfig", "ProgramTarget", "SpaceOptions", "SpecTarget",
           "analytic_config", "as_target", "enumerate_space",
           "tile_candidates"]
