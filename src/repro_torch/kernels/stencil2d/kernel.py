"""Wrapper of the hand-written CUDA kernel K3 in ``csrc/stencil2d.cu``,
which replaces ``repro.kernels.stencil2d.kernel``'s ``stencil2d_pallas``.

A block ``(by, bx)`` is the output tile of one thread block.  Its
shared-memory workspace is the ``(by + 2·ry·T) x (bx + 2·rx·T)`` haloed
rectangle in float32 plus a second buffer 2·ry rows shorter for the sweeps'
ping-pong.  The kernel zero-fills outside the grid and masks the rim itself,
so no padding is needed.  On a CPU tensor the wrapper runs the plain
version, :func:`stencil2d_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.stencil2d.ref import stencil2d_ref

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_size_t, ctypes.c_void_p]


def smem_bytes(ry: int, rx: int, timesteps: int, by: int, bx: int) -> int:
    """Dynamic shared memory of one tile, laid out as stencil2d.cu uses it."""
    h0, w0 = by + 2 * ry * timesteps, bx + 2 * rx * timesteps
    taps = (2 * ry + 2 * rx + 2 + 3) // 4 * 4
    return 4 * (taps + (2 * h0 - 2 * ry) * w0)


def stencil2d_kernel(x: torch.Tensor, cy: tuple[float, ...],
                     cx: tuple[float, ...], *, timesteps: int = 1,
                     block: tuple[int, int] | None = None) -> torch.Tensor:
    """x: (B, ny, nx) float32/bfloat16 -> same.  Launches K3 on a CUDA tensor
    (``block`` required there); runs :func:`stencil2d_ref` on a CPU one."""
    dtype_code = _build.check_grid(x, 3, "stencil2d")
    if timesteps < 1:
        raise ValueError("timesteps must be >= 1")
    if x.device.type == "cpu":
        return stencil2d_ref(x, tuple(cy), tuple(cx), timesteps)
    ry, rx = _build.radius(cy, "stencil2d"), _build.radius(cx, "stencil2d")
    if block is None:
        raise ValueError("stencil2d_kernel needs a block on the card")
    by, bx = block
    if by < 1 or bx < 1:
        raise ValueError(f"stencil2d block {block} must be positive")
    smem = smem_bytes(ry, rx, timesteps, by, bx)
    _build.require_smem(f"stencil2d block {block} at r=({ry}, {rx}), "
                        f"T={timesteps}", smem, x.device)
    b, ny, nx = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    c = _build.device_coeffs(tuple(float(v) for v in (*cy, *cx)), x.device)
    with torch.cuda.device(x.device):
        _build.launch("stencil2d", "stencil2d", _ARGTYPES, x.data_ptr(),
                      out.data_ptr(), c.data_ptr(), dtype_code, b, ny, nx, ry,
                      rx, timesteps, by, bx, smem,
                      _build.stream_handle(x.device))
    return out
