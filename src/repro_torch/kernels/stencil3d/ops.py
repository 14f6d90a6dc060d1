"""Public entry point for the 3D stencil.

``timesteps > 1`` runs T separate sweeps (each one kernel launch), as the
JAX package does: fused-T 3D star sweeps have diamond composite support, and
the device-memory round trip between sweeps is the documented trade.  Launch
``t`` zeroes the ``r·t`` rim and casts to the grid's type, which is the
re-mask and cast between sweeps of ``repro.kernels.stencil3d.ops``.
"""
from __future__ import annotations

import torch

from repro_torch.core.mapping import plan_blocks
from repro_torch.core.spec import StencilSpec
from repro_torch.kernels import _build
from repro_torch.kernels.stencil3d.kernel import stencil3d_kernel

DEFAULT_BLOCK = (32, 16, 64)   # z chunk, then a 16 x 64 column tile


def _auto_block(shape: tuple[int, int, int], cz, cy, cx, dtype: str,
                budget: int) -> tuple[int, int, int]:
    """Pick (bz, by, bx) with the CGRA strip-mining planner (§III-B): the
    same ``plan_blocks`` that sizes scratchpad strips sizes the kernel's
    tile, with warp-wide (32) x steps.  The planner budgets the whole haloed
    box; the kernel keeps only ``2·rz+1`` of its planes resident, so a plan
    that fits the budget always fits the kernel."""
    spec = StencilSpec(tuple(shape), tuple((len(c) - 1) // 2 for c in (cz, cy, cx)),
                       (tuple(cz), tuple(cy), tuple(cx)), dtype=dtype)
    return plan_blocks(spec, budget, lane_multiple=32).block_shape


def stencil3d(x: torch.Tensor, cz, cy, cx, *, timesteps: int = 1,
              backend: str = "auto",
              block: tuple[int, int, int] | None = DEFAULT_BLOCK) -> torch.Tensor:
    """Batched 3D star stencil over the last three axes (z, y, x).

    ``block=None`` derives the tile from
    :func:`repro_torch.core.mapping.plan_blocks` under the card's shared
    memory per block instead of using a fixed shape.
    """
    cz = tuple(float(c) for c in cz)
    cy = tuple(float(c) for c in cy)
    cx = tuple(float(c) for c in cx)
    _build.check_backend(backend, x)
    nz, ny, nx = x.shape[-3:]
    if block is None and x.is_cuda:
        block = _auto_block((nz, ny, nx), cz, cy, cx,
                            str(x.dtype).removeprefix("torch."),
                            _build.smem_per_block(x.device))
    out = x.reshape(-1, nz, ny, nx).contiguous()
    for t in range(1, timesteps + 1):
        out = stencil3d_kernel(out, cz, cy, cx, block=block, step=t)
    return out.reshape(x.shape)
