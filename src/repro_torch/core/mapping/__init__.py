"""Stencil → CGRA dataflow-graph mapping (paper §III), dimension-generic.

The package decomposes the paper's worker pipeline into composable stages
(:mod:`~repro_torch.core.mapping.stages`) over a single stream algebra
(:mod:`~repro_torch.core.mapping.streams`) and builds every rank's mapping with one
entry point, :func:`map_nd` (:mod:`~repro_torch.core.mapping.nd`):

* ``w`` **reader workers** load the grid interleaved in flat row-major order
  (reader ``k`` owns sites ``k, k+w, k+2w, ...``).
* ``w`` **compute workers** per temporal layer: per-axis filter + MUL/MAC
  tap chains (the ``0^m 1^n 0^p`` keep patterns of §III-A generalized to one
  digit window per axis) joined by an axis-combining ADD tree.
* ``w`` **writer** and **sync workers** store the final layer's outputs and
  count them against analytically known expectations (§III-A).

``map_1d``/``map_2d`` are thin wrappers that assert the structural contract
of the pre-refactor hand-rolled builders; ``map_3d`` (and any higher rank)
falls out of the same construction.  Mandatory buffering (§III-B) is derived
per axis — see :mod:`~repro_torch.core.mapping.stages` — and ``plan_blocks``
(:mod:`~repro_torch.core.mapping.blocks`) strip-mines grids whose innermost extent
does not divide by ``w``.
"""
from repro_torch.core.mapping.blocks import (BlockPlan, minimal_working_set_bytes,
                                             plan_blocks)
from repro_torch.core.mapping.nd import (apply_min_capacities, map_1d, map_2d,
                                         map_3d, map_nd)
from repro_torch.core.mapping.plan import MappingPlan
from repro_torch.core.mapping.stages import (AddTree, ReaderBank, SyncTree,
                                             TapChain, WorkerStream, WriterBank,
                                             compute_layer, layer_stream,
                                             owning_stream, reader_stream,
                                             row_tokens)
from repro_torch.core.mapping.streams import KeepMask, StreamSpec, band_keep

__all__ = ["BlockPlan", "plan_blocks", "minimal_working_set_bytes",
           "apply_min_capacities", "map_1d",
           "map_2d", "map_3d", "map_nd", "MappingPlan", "AddTree",
           "ReaderBank", "SyncTree", "TapChain", "WorkerStream", "WriterBank",
           "compute_layer", "layer_stream", "owning_stream", "reader_stream",
           "row_tokens", "KeepMask", "StreamSpec", "band_keep"]
