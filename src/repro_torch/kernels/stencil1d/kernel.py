"""Wrapper of the hand-written CUDA kernels K1 (``variant="vpu"``, a
shift-FMA ladder) and K2 (``variant="mxu"``, the band product on the tensor
cores in 3xTF32) in ``csrc/stencil1d.cu``, which replace
``repro.kernels.stencil1d.kernel``'s ``stencil1d_pallas``.

A block ``(block_b, block_n)`` is the output tile of one thread block:
``block_b`` rows by ``block_n`` columns.  K1's shared-memory workspace holds
``block_n + 2·r·T`` float32 columns per row twice (ping-pong), whatever the
grid's type.  K2's holds two input tiles and the output tile in the grid's
type, rows rounded up to an mma's 16, and for T > 1 two float32 sweep
buffers (:func:`smem_bytes`).  The
kernels zero-fill outside the row and mask the ``r·T`` rim themselves, so no
padding is needed.  On a CPU tensor the wrapper runs the plain version,
:func:`stencil1d_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.stencil1d.ref import stencil1d_ref

VARIANTS = ("vpu", "mxu")
MXU_ROWS = 16                # an mma's rows: K2 rounds block_b up to this
_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_size_t,
             ctypes.c_void_p]


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def smem_bytes(variant: str, radius: int, timesteps: int, block_b: int,
               block_n: int, itemsize: int = 4) -> int:
    """Dynamic shared memory of one thread block, laid out as stencil1d.cu
    uses it (``mxu_layout`` there; the kernel refuses any other size).

    mxu: the split band of the generic instance (two arrays of ``K + 8``
    floats, ``K = ceil8(8 + 2r)``); two raw tiles (the one being summed and
    the next in flight) of ``block_b`` rounded up to 16 rows by
    ``lw = ceil16(2·ph + block_n + 16)`` columns in the grid's type (``ph``:
    the halo ``r·T`` rounded up to one 16-byte chunk), rows padded to 16
    bytes past a multiple of 128; the output tile in the grid's type,
    ``ceil8(block_n)`` columns padded to 16 (bf16) or 32 (f32) bytes past a
    multiple of 128; for T > 1 two float32 buffers of ``ceil32(lw) + 4``
    floats a row.  vpu: the taps and two float32 buffers of
    ``block_n + 2·r·T`` columns."""
    if variant == "mxu":
        rows = _round_up(block_b, MXU_ROWS)
        k = _round_up(8 + 2 * radius, 8)
        ph = _round_up(radius * timesteps, 16 // itemsize)
        lw = _round_up(2 * ph + block_n + 16, 16)
        raw_words = _round_up(lw * itemsize // 4, 32) + 4
        out_words = (_round_up(_round_up(block_n, 8) * itemsize // 4, 32)
                     + (8 if itemsize == 4 else 4))
        f32_words = 2 * (_round_up(lw, 32) + 4) if timesteps > 1 else 0
        return 4 * (2 * (k + 8) + rows * (2 * raw_words + out_words
                                          + f32_words))
    w0 = block_n + 2 * radius * timesteps
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
    smem = smem_bytes(variant, r, timesteps, bb, bn, x.element_size())
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
