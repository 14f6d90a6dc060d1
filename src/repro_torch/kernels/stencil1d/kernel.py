"""Wrapper of the hand-written CUDA kernels K1 (``variant="vpu"``, a
shift-FMA ladder) and K2 (``variant="mxu"``, a banded product) in
``csrc/stencil1d.cu``, which replace ``repro.kernels.stencil1d.kernel``'s
``stencil1d_pallas``.

A block ``(block_b, block_n)`` is the output tile of one thread block:
``block_b`` rows by ``block_n`` columns.  Its shared-memory workspace holds
``block_n + 2·r·T`` float32 columns per row twice (ping-pong), whatever the
grid's type, plus the band sub-block for ``mxu``.  The kernel zero-fills
outside the row and masks the ``r·T`` rim itself, so no padding is needed.
On a CPU tensor the wrapper runs the plain version, :func:`stencil1d_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.stencil1d.ref import stencil1d_ref

VARIANTS = ("vpu", "mxu")
MXU_TILE = 32                # kTn in stencil1d.cu
_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_size_t,
             ctypes.c_void_p]


def smem_bytes(variant: str, radius: int, timesteps: int, block_b: int,
               block_n: int) -> int:
    """Dynamic shared memory of one tile, laid out as stencil1d.cu uses it."""
    w0 = block_n + 2 * radius * timesteps
    if variant == "mxu":
        band = (MXU_TILE + 2 * radius) * MXU_TILE
        return 4 * (band + 2 * block_b * (w0 + MXU_TILE))
    taps = (2 * radius + 1 + 3) // 4 * 4
    return 4 * (taps + 2 * block_b * w0)


def stencil1d_kernel(x: torch.Tensor, coeffs: tuple[float, ...], *,
                     timesteps: int = 1, block: tuple[int, int] | None = None,
                     variant: str = "vpu") -> torch.Tensor:
    """x: (B, N) float32/bfloat16 -> (B, N).  Launches K1/K2 on a CUDA tensor
    (``block`` required there); runs :func:`stencil1d_ref` on a CPU one."""
    dtype_code = _build.check_grid(x, 2, "stencil1d")
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if timesteps < 1:
        raise ValueError("timesteps must be >= 1")
    if x.device.type == "cpu":
        return stencil1d_ref(x, tuple(coeffs), timesteps)
    r = _build.radius(coeffs, "stencil1d")
    if block is None:
        raise ValueError("stencil1d_kernel needs a block on the card")
    bb, bn = block
    if bb < 1 or bn < 1:
        raise ValueError(f"stencil1d block {block} must be positive")
    smem = smem_bytes(variant, r, timesteps, bb, bn)
    _build.require_smem(f"stencil1d block {block} at r={r}, T={timesteps}",
                        smem, x.device)
    b, n = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    c = _build.device_coeffs(tuple(float(v) for v in coeffs), x.device)
    with torch.cuda.device(x.device):
        _build.launch(f"stencil1d_{variant}", "stencil1d", _ARGTYPES,
                      int(variant == "mxu"), x.data_ptr(), out.data_ptr(),
                      c.data_ptr(), dtype_code, b, n, r, timesteps, bb, bn,
                      smem, _build.stream_handle(x.device))
    return out
