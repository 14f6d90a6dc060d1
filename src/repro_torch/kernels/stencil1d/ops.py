"""Public entry point for the 1D stencil: planning and backend dispatch.

``stencil1d(x, coeffs)`` accepts any (..., N) tensor: it flattens the leading
dims to a batch and hands it to the kernel wrapper, which launches the CUDA
kernel on a CUDA tensor and runs the plain version on a CPU tensor
(``backend="auto"``); ``backend="cuda"`` insists on the kernel and raises
on a CPU tensor.  The kernel masks the ragged edge itself, so there is no
padding and no re-mask here.
"""
from __future__ import annotations

import torch

from repro_torch.core.spec import StencilSpec
from repro_torch.kernels import _build
from repro_torch.kernels.stencil1d.kernel import smem_bytes, stencil1d_kernel

MAX_BLOCK_B = 4       # vpu rows per tile
MAX_BLOCK_N = 2048    # vpu columns per tile: a 0.8% halo at r = 8
MXU_BLOCK = (16, 512)  # mxu tile: one mma's 16 rows; a 3% halo at r = 8
# The H100 gives an SM 1 KB of shared memory more than a block may opt in
# to, and reserves 1 KB a block: two blocks fit where each takes at most
# (budget - 1024) / 2.
_BLOCK_RESERVE = 1024


def plan_1d_blocks(n: int, batch: int, radius: int, timesteps: int,
                   variant: str = "vpu",
                   smem_budget: int = _build.H100_SMEM_PER_BLOCK,
                   itemsize: int = 4) -> tuple[int, int]:
    """Pick (block_b, block_n) whose shared-memory workspace fits
    ``smem_budget`` bytes, for a grid of ``itemsize``-byte elements.

    Rows: all of a short batch, up to 4 (vpu) or 16 (mxu, one mma's).
    Columns: the widest power of two from 128 to 2048 (vpu) or 512 (mxu),
    no wider than the row needs, at which two blocks share an SM; failing
    that, the widest that fits one block.  Raises ValueError when not even
    a one-row, 128-column tile fits."""
    def fits(bb: int, bn: int, budget: int = smem_budget) -> bool:
        return smem_bytes(variant, radius, timesteps, bb, bn,
                          itemsize) <= budget

    max_b, max_n = ((MXU_BLOCK[0], MXU_BLOCK[1]) if variant == "mxu"
                    else (MAX_BLOCK_B, MAX_BLOCK_N))
    block_b, block_n = max(1, min(batch, max_b)), 128
    if not fits(block_b, block_n):
        block_b = 1
        if not fits(block_b, block_n):
            raise ValueError(
                f"a (1, 128) tile of the 1D stencil at r={radius}, "
                f"T={timesteps} needs "
                f"{smem_bytes(variant, radius, timesteps, 1, 128, itemsize)} "
                f"B of shared memory; the budget is {smem_budget} B")
    budget = smem_budget
    if fits(block_b, block_n, (smem_budget - _BLOCK_RESERVE) // 2):
        budget = (smem_budget - _BLOCK_RESERVE) // 2
    while block_n < min(n, max_n) and fits(block_b, 2 * block_n, budget):
        block_n *= 2
    return block_b, block_n


def stencil1d(x: torch.Tensor, coeffs: tuple[float, ...], *,
              timesteps: int = 1, backend: str = "auto",
              variant: str = "vpu",
              block: tuple[int, int] | None = None) -> torch.Tensor:
    """Batched 1D star stencil along the last axis. See ref.py for semantics."""
    coeffs = tuple(float(c) for c in coeffs)
    _build.check_backend(backend, x)
    r = (len(coeffs) - 1) // 2
    n = x.shape[-1]
    xb = x.reshape(-1, n).contiguous()
    if block is None and xb.is_cuda:
        block = plan_1d_blocks(n, xb.shape[0], r, timesteps, variant,
                               _build.smem_per_block(xb.device),
                               xb.element_size())
    y = stencil1d_kernel(xb, coeffs, timesteps=timesteps, block=block,
                         variant=variant)
    return y.reshape(x.shape)


def stencil1d_from_spec(x: torch.Tensor, spec: StencilSpec, **kw) -> torch.Tensor:
    if spec.ndim != 1:
        raise ValueError(f"stencil1d_from_spec needs a 1D spec, got {spec.ndim}D")
    return stencil1d(x, spec.coeffs[0], timesteps=spec.timesteps, **kw)
