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
from repro_torch.kernels.stencil3d.kernel import (MAX_THREADS, MICRO,
                                                  instance, smem_bytes,
                                                  stencil3d_kernel)

# z chunk, then a 32 x 128 column tile: 256 threads of 4 x 4 columns
DEFAULT_BLOCK = (32, 32, 128)


def fit_block(block: tuple[int, int, int], radii: tuple[int, int, int],
              itemsize: int, budget: int,
              queued: bool = False) -> tuple[int, int, int]:
    """``block`` made legal for the kernel (``by`` rounded up to a multiple
    of 4, ``bx`` of 8, at most 256 threads), then halved in y, then in x,
    until its shared memory (for a compile-time instance where ``queued``)
    fits ``budget``.  Raises ValueError when not even a 4 x 8 column tile
    fits: the halo is then too wide for one block."""
    bz, by, bx = block
    my, mx = MICRO
    by, bx = max(my, -(-by // my) * my), max(8, -(-bx // 8) * 8)
    while True:
        if by * bx <= MAX_THREADS * my * mx and smem_bytes(
                *radii, by, bx, itemsize, queued) <= budget:
            return max(1, bz), by, bx
        if by > my:
            by = max(my, by // 2 // my * my)
        elif bx > 8:
            bx = max(8, bx // 2 // 8 * 8)
        else:
            raise ValueError(
                f"a 4 x 8 column tile of the 3D stencil at r={radii} needs "
                f"{smem_bytes(*radii, my, 8, itemsize, queued)} B of shared "
                f"memory; the budget is {budget} B")


def _auto_block(shape: tuple[int, int, int], cz, cy, cx, dtype: str,
                budget: int) -> tuple[int, int, int]:
    """Pick (bz, by, bx) with the CGRA strip-mining planner (§III-B): the
    same ``plan_blocks`` that sizes scratchpad strips sizes the kernel's
    tile, with warp-wide (32) x steps, made legal for the kernel and fitted
    to its ring of planes by :func:`fit_block`.  The planner may shrink a
    block toward (1, 1, 1) under a tight budget; :func:`fit_block` rounds
    that up to the kernel's smallest tile."""
    radii = tuple((len(c) - 1) // 2 for c in (cz, cy, cx))
    # a grid no wider than its halo is all rim; plan it as the smallest
    # grid the spec takes
    shape = tuple(max(n, 2 * r + 1) for n, r in zip(shape, radii))
    spec = StencilSpec(shape, radii, (tuple(cz), tuple(cy), tuple(cx)),
                       dtype=dtype)
    block = plan_blocks(spec, budget, lane_multiple=32).block_shape
    return fit_block(block, radii, spec.bytes_per_elem, budget,
                     instance(cz, cy, cx) > 0)


def stencil3d(x: torch.Tensor, cz, cy, cx, *, timesteps: int = 1,
              backend: str = "auto",
              block: tuple[int, int, int] | str | None = None) -> torch.Tensor:
    """Batched 3D star stencil over the last three axes (z, y, x).

    ``block=None`` runs ``DEFAULT_BLOCK``, halved in y, then x, where a wide
    halo needs it (:func:`fit_block`); ``block="plan"`` derives the tile
    from :func:`repro_torch.core.mapping.plan_blocks` under the card's
    shared memory per block; a tuple is used as given.  On the card the
    radius of each axis is at most 31 (the kernel's tap struct).
    """
    cz = tuple(float(c) for c in cz)
    cy = tuple(float(c) for c in cy)
    cx = tuple(float(c) for c in cx)
    _build.check_backend(backend, x)
    nz, ny, nx = x.shape[-3:]
    if x.is_cuda and (block is None or block == "plan"):
        budget = _build.smem_per_block(x.device)
        if block is None:
            radii = tuple((len(c) - 1) // 2 for c in (cz, cy, cx))
            block = fit_block(DEFAULT_BLOCK, radii, x.element_size(), budget,
                              instance(cz, cy, cx) > 0)
        else:
            block = _auto_block((nz, ny, nx), cz, cy, cx,
                                str(x.dtype).removeprefix("torch."), budget)
    out = x.reshape(-1, nz, ny, nx).contiguous()
    for t in range(1, timesteps + 1):
        out = stencil3d_kernel(out, cz, cy, cx, block=block, step=t)
    return out.reshape(x.shape)
