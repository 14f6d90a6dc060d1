"""Stencil specs and the torch oracle (the ported part of ``repro.core``)."""
from repro_torch.core.spec import (StencilSpec, heat_2d, heat_3d, paper_stencil_1d,
                                   paper_stencil_2d, spec_from_fields, star_3d)
from repro_torch.core.reference import stencil_reference, stencil_reference_np
from repro_torch.core.mapping import BlockPlan, plan_blocks

__all__ = ["StencilSpec", "heat_2d", "heat_3d", "paper_stencil_1d",
           "paper_stencil_2d", "spec_from_fields", "star_3d",
           "stencil_reference", "stencil_reference_np", "BlockPlan",
           "plan_blocks"]
