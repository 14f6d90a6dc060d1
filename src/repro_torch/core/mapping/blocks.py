"""Strip-mining / blocking planner (§III-B "Blocking"), copied from
``repro.core.mapping.blocks`` — also reused by the CUDA 3D kernel to size its
tile under a shared-memory budget."""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.spec import StencilSpec


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    block_shape: tuple[int, ...]
    halo: tuple[int, ...]
    grid: tuple[int, ...]               # number of blocks per axis
    working_set_bytes: int
    storage_budget_bytes: int

    @property
    def fits(self) -> bool:
        return self.working_set_bytes <= self.storage_budget_bytes


def minimal_working_set_bytes(spec: StencilSpec) -> int:
    """Working set of the smallest possible block, ``(1, …, 1)`` — the hard
    floor any storage budget must clear for this spec."""
    halo = tuple(r * spec.timesteps for r in spec.radii)
    return (math.prod(1 + 2 * h for h in halo) + 1) * spec.bytes_per_elem


def plan_blocks(spec: StencilSpec, storage_budget_bytes: int,
                lane_multiple: int = 128) -> BlockPlan:
    """Choose per-axis block sizes so (block + 2*halo) working sets fit the
    on-fabric storage (CGRA scratchpad or TPU VMEM).

    Strategy (paper: vertical strips sized so ``2*ry*block_size`` fits):
    keep the innermost axis in lane_multiple chunks as large as possible,
    then grow outer axes.  If even the seed block overshoots a tight budget,
    the block *shrinks* toward ``(1, …, 1)`` — outer axes first, so the
    innermost axis keeps its lane alignment as long as possible — and a
    budget below the ``(1, …, 1)`` working set raises ``ValueError`` (the
    returned plan always has ``fits == True``).

    Raises:
      ValueError: when the halo-inclusive working set of a ``(1, …, 1)``
        block already exceeds ``storage_budget_bytes`` (the message carries
        the computed minimal working set).
    """
    halo = tuple(r * spec.timesteps for r in spec.radii)
    b = spec.bytes_per_elem
    shape = list(spec.grid_shape)
    block = [min(s, 8) for s in shape]
    block[-1] = min(shape[-1], lane_multiple)

    def ws(blk):  # in + out working set with halos
        inner = math.prod(bb + 2 * h for bb, h in zip(blk, halo))
        return (inner + math.prod(blk)) * b

    minimal = minimal_working_set_bytes(spec)
    if minimal > storage_budget_bytes:
        raise ValueError(
            f"storage budget {storage_budget_bytes} B cannot hold even a "
            f"(1, …, 1) block of {spec.grid_shape} (radii {spec.radii}, "
            f"timesteps {spec.timesteps}): minimal halo-inclusive working "
            f"set is {minimal} B")

    # shrink toward (1, …, 1) when the seed block overshoots: outer axes
    # halve first (innermost keeps its lane alignment while any outer axis
    # can still give ground — the seed never exceeds one lane chunk), then
    # the innermost halves too.
    while ws(block) > storage_budget_bytes:
        outer = [ax for ax in range(spec.ndim - 1) if block[ax] > 1]
        if outer:
            block[max(outer, key=lambda a: block[a])] //= 2
        else:   # block[-1] > 1 is guaranteed: the (1, …, 1) floor fits
            block[-1] //= 2

    # grow innermost first, then outer axes round-robin
    order = list(range(spec.ndim - 1, -1, -1))
    progress = True
    while progress:
        progress = False
        for ax in order:
            step = lane_multiple if ax == spec.ndim - 1 else 8
            cand = list(block)
            cand[ax] = min(shape[ax], cand[ax] + step)
            if cand[ax] != block[ax] and ws(cand) <= storage_budget_bytes:
                block = cand
                progress = True
    grid = tuple(math.ceil(s / bb) for s, bb in zip(shape, block))
    return BlockPlan(tuple(block), halo, grid, ws(block), storage_budget_bytes)
