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

MAX_BLOCK_B = 4       # rows per tile: the mxu kernel's rows per warp
MAX_BLOCK_N = 1024    # columns per tile: keeps a tile near 33-40 KB


def plan_1d_blocks(n: int, batch: int, radius: int, timesteps: int,
                   variant: str = "vpu",
                   smem_budget: int = _build.H100_SMEM_PER_BLOCK
                   ) -> tuple[int, int]:
    """Pick (block_b, block_n): up to 4 rows, and the widest power-of-two
    column count from 128 to 1024 (no wider than the row needs) whose
    shared-memory workspace fits ``smem_budget`` bytes.  Raises ValueError
    when not even a one-row, 128-column tile fits."""
    block_b, block_n = max(1, min(batch, MAX_BLOCK_B)), 128

    def fits(bb: int, bn: int) -> bool:
        return smem_bytes(variant, radius, timesteps, bb, bn) <= smem_budget

    if not fits(block_b, block_n):
        block_b = 1
        if not fits(block_b, block_n):
            raise ValueError(
                f"a (1, 128) tile of the 1D stencil at r={radius}, "
                f"T={timesteps} needs "
                f"{smem_bytes(variant, radius, timesteps, 1, 128)} B of shared "
                f"memory; the budget is {smem_budget} B")
    while block_n < min(n, MAX_BLOCK_N) and fits(block_b, 2 * block_n):
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
                               _build.smem_per_block(xb.device))
    y = stencil1d_kernel(xb, coeffs, timesteps=timesteps, block=block,
                         variant=variant)
    return y.reshape(x.shape)


def stencil1d_from_spec(x: torch.Tensor, spec: StencilSpec, **kw) -> torch.Tensor:
    if spec.ndim != 1:
        raise ValueError(f"stencil1d_from_spec needs a 1D spec, got {spec.ndim}D")
    return stencil1d(x, spec.coeffs[0], timesteps=spec.timesteps, **kw)
