"""The paper's contribution, ported: stencil specs, the torch oracle, CGRA
mapping, cycle simulation and the §VI roofline (with the H100 parts in place
of the reference's TPU constants)."""
from repro_torch.core.spec import (StencilSpec, heat_2d, heat_3d, paper_stencil_1d,
                                   paper_stencil_2d, spec_from_fields, star_3d)
from repro_torch.core.reference import stencil_reference, stencil_reference_np
from repro_torch.core.roofline import (CGRA, H100_PCIE, H100_SXM, V100, Machine,
                                       analyze)
from repro_torch.core.mapping import (BlockPlan, MappingPlan, map_1d, map_2d,
                                      map_3d, map_nd, plan_blocks)
from repro_torch.core.simulator import SimDeadlock, SimResult, simulate
from repro_torch.core.temporal import crossover_timesteps, fusion_report

__all__ = ["StencilSpec", "heat_2d", "heat_3d", "paper_stencil_1d",
           "paper_stencil_2d", "spec_from_fields", "star_3d",
           "stencil_reference", "stencil_reference_np", "CGRA", "H100_PCIE",
           "H100_SXM", "V100", "Machine", "analyze", "BlockPlan",
           "MappingPlan", "map_1d", "map_2d", "map_3d", "map_nd",
           "plan_blocks", "SimDeadlock", "SimResult", "simulate",
           "crossover_timesteps", "fusion_report"]
