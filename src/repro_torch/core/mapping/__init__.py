"""Tile planning (the ported part of ``repro.core.mapping``)."""
from repro_torch.core.mapping.blocks import (BlockPlan, minimal_working_set_bytes,
                                             plan_blocks)

__all__ = ["BlockPlan", "plan_blocks", "minimal_working_set_bytes"]
