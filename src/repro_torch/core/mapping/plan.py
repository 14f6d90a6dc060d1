"""The mapper's output contract: a logical DFG plus its analytic metadata."""
from __future__ import annotations

import dataclasses

from repro_torch.core.dfg import DFG
from repro_torch.core.spec import StencilSpec


@dataclasses.dataclass
class MappingPlan:
    spec: StencilSpec
    workers: int
    dfg: DFG
    reader_loads: list[list[int]]         # flat indices per reader
    writer_stores: list[list[int]]        # flat indices per writer
    sync_expect: list[int]
    pe_counts: dict
    mac_pes: int
    min_capacities: dict[int, int]        # edge id -> analytic min queue depth
    notes: str = ""
