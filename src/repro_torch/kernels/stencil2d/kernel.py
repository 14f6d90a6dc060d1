"""Wrapper of the hand-written CUDA kernel K3 in ``csrc/stencil2d.cu``,
which replaces ``repro.kernels.stencil2d.kernel``'s ``stencil2d_pallas``.

A block ``(by, bx)`` (multiples of 8) is the output tile of one thread
block of 32 x 8 threads, each computing 8 x 4 micro-tiles from registers.
Its shared-memory workspace is the haloed rectangle in float32, its rows
padded so that 16-byte chunks line up with the grid's rows; for T > 1 a
second buffer of the same size and margins of 8 columns a side and 8 rows
below (:func:`smem_bytes`).  The taps go to the kernel as a struct
(:func:`pack_taps`): the compacted non-zero taps of each chain in ascending
order (:func:`compact_taps`), and the dense ones by offset.  The struct
holds 128 taps per axis, so the kernel takes radii up to 63.  The kernel
zero-fills outside the grid and masks the rim itself, so no padding is
needed.  On a CPU tensor the wrapper runs the plain version,
:func:`stencil2d_ref`.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.stencil2d.ref import stencil2d_ref

MAX_TAPS = 128          # kMaxTaps in stencil2d.cu: 2r + 1 <= 128 per axis
MICRO = (8, 4)          # kMY, kMX: rows x columns a thread computes at once
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_size_t, ctypes.c_void_p]


def _pad8(v: int) -> int:
    return (v + 7) // 8 * 8


def smem_bytes(ry: int, rx: int, timesteps: int, by: int, bx: int) -> int:
    """Dynamic shared memory of one tile, laid out as stencil2d.cu uses it."""
    hy, hx = ry * timesteps, rx * timesteps
    fused = timesteps > 1
    margin = 8 if fused else 0
    w0 = 2 * (margin + _pad8(hx)) + bx
    rows = by + 2 * hy + (MICRO[0] if fused else 0)
    return 4 * rows * w0 * (2 if fused else 1)


def compact_taps(coeffs: tuple[float, ...]) -> tuple[list[int], list[float]]:
    """The non-zero taps of one chain as (offsets, coefficients), in the
    chain's ascending order; the kernel sums exactly these, in this order."""
    keep = [(k, float(c)) for k, c in enumerate(coeffs) if c != 0.0]
    return [k for k, _ in keep], [c for _, c in keep]


@functools.lru_cache(maxsize=64)
def pack_taps(cy: tuple[float, ...], cx: tuple[float, ...]) -> np.ndarray:
    """The taps laid out as ``struct Taps`` of stencil2d.cu: the counts of
    non-zero taps (ny, nx), their offsets, their coefficients, then the
    dense coefficients by offset; 4-byte fields.  Built once per taps."""
    if max(len(cy), len(cx)) > MAX_TAPS:
        raise ValueError(f"stencil2d kernel takes at most {MAX_TAPS} taps per "
                         f"axis (radius <= {(MAX_TAPS - 1) // 2}), got "
                         f"{len(cy)} and {len(cx)}")
    (oy, vy), (ox, vx) = compact_taps(cy), compact_taps(cx)
    buf = np.zeros(2 + 6 * MAX_TAPS, dtype=np.int32)
    f = buf.view(np.float32)
    buf[0], buf[1] = len(oy), len(ox)
    base = 2
    for ints in (oy, ox):
        buf[base:base + len(ints)] = ints
        base += MAX_TAPS
    for vals in (vy, vx, cy, cx):
        f[base:base + len(vals)] = vals
        base += MAX_TAPS
    return buf


@functools.cache
def _check_taps_layout() -> None:
    """Refuse a library whose ``struct Taps`` is not the buffer
    :func:`pack_taps` builds (the launch copies that many bytes from it)."""
    fn = _build.library("stencil2d").stencil2d_taps_bytes
    fn.restype = ctypes.c_int
    want = pack_taps((0.0,), (0.0,)).nbytes
    if fn() != want:
        raise RuntimeError(f"stencil2d.cu's struct Taps is {fn()} B, pack_taps "
                           f"builds {want} B: MAX_TAPS and kMaxTaps differ")


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
    if by < 8 or bx < 8 or by % 8 or bx % 8:
        raise ValueError(f"stencil2d block {block} must be positive multiples "
                         "of 8")
    taps = pack_taps(tuple(float(c) for c in cy), tuple(float(c) for c in cx))
    _check_taps_layout()
    smem = smem_bytes(ry, rx, timesteps, by, bx)
    _build.require_smem(f"stencil2d block {block} at r=({ry}, {rx}), "
                        f"T={timesteps}", smem, x.device)
    b, ny, nx = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    vec = int(nx % (16 // x.element_size()) == 0
              and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        _build.launch("stencil2d", "stencil2d", _ARGTYPES, x.data_ptr(),
                      out.data_ptr(), taps.ctypes.data, dtype_code, b, ny, nx,
                      ry, rx, timesteps, by, bx, vec, smem,
                      _build.stream_handle(x.device))
    return out
