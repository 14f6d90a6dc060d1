"""Wrapper of the hand-written CUDA kernel K4 in ``csrc/stencil3d.cu``,
which replaces ``repro.kernels.stencil3d.kernel``'s ``stencil3d_pallas``.

One launch is one sweep.  A block ``(bz, by, bx)`` is the work of one thread
block: a ``by x bx`` column tile marched over ``bz`` planes, keeping a ring
of ``2·rz+1`` haloed ``(by + 2·ry) x (bx + 2·rx)`` float32 planes in shared
memory.  The kernel zero-fills outside the grid and zeroes within
``r·step`` of every face, so the T-sweep loop in ops.py needs no padding and
no separate re-mask.  On a CPU tensor the wrapper runs the plain version,
:func:`stencil3d_sweep_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.stencil3d.ref import stencil3d_sweep_ref

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int64]
             + [ctypes.c_int] * 12 + [ctypes.c_size_t, ctypes.c_void_p])


def smem_bytes(rz: int, ry: int, rx: int, by: int, bx: int) -> int:
    """Dynamic shared memory of one tile, laid out as stencil3d.cu uses it."""
    taps = (2 * (rz + ry + rx) + 3 + 3) // 4 * 4
    return 4 * (taps + (2 * rz + 1) * (by + 2 * ry) * (bx + 2 * rx))


def stencil3d_kernel(x: torch.Tensor, cz: tuple[float, ...],
                     cy: tuple[float, ...], cx: tuple[float, ...], *,
                     block: tuple[int, int, int] | None = None,
                     step: int = 1) -> torch.Tensor:
    """x: (B, nz, ny, nx) float32/bfloat16 -> same: sweep number ``step``
    (its rim is ``r·step``).  Launches K4 on a CUDA tensor (``block``
    required there); runs :func:`stencil3d_sweep_ref` on a CPU one."""
    dtype_code = _build.check_grid(x, 4, "stencil3d")
    if step < 1:
        raise ValueError("step must be >= 1")
    if x.device.type == "cpu":
        return stencil3d_sweep_ref(x, tuple(cz), tuple(cy), tuple(cx), step)
    rz, ry, rx = (_build.radius(c, "stencil3d") for c in (cz, cy, cx))
    if block is None:
        raise ValueError("stencil3d_kernel needs a block on the card")
    bz, by, bx = block
    if min(block) < 1:
        raise ValueError(f"stencil3d block {block} must be positive")
    smem = smem_bytes(rz, ry, rx, by, bx)
    _build.require_smem(f"stencil3d block {block} at r=({rz}, {ry}, {rx})",
                        smem, x.device)
    b, nz, ny, nx = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    c = _build.device_coeffs(tuple(float(v) for v in (*cz, *cy, *cx)), x.device)
    with torch.cuda.device(x.device):
        _build.launch("stencil3d", "stencil3d", _ARGTYPES, x.data_ptr(),
                      out.data_ptr(), c.data_ptr(), dtype_code, b, nz, ny, nx,
                      rz, ry, rx, rz * step, ry * step, rx * step, bz, by, bx,
                      smem, _build.stream_handle(x.device))
    return out
