"""Wrapper of the hand-written CUDA kernels K1 (``variant="vpu"``, a
shift-FMA ladder from registers) and K2 (``variant="mxu"``, the band product
on the tensor cores in 3xTF32) in ``csrc/stencil1d.cu``, which replace
``repro.kernels.stencil1d.kernel``'s ``stencil1d_pallas``.

A block ``(block_b, block_n)`` is the output tile of one thread block:
``block_b`` rows by ``block_n`` columns.  Both kernels are persistent and
share one memory pipeline: their shared memory holds two input tiles and
the output tile in the grid's type, and for T > 1 two float32 sweep buffers
(:func:`smem_bytes`).  K2 rounds the tile's rows up to an mma's 16.  K1 runs
a compile-time instance at r = 8 with all 17 taps non-zero (the paper's
17-pt) and a generic one for every other radius or pattern, which sums the
non-zero taps compacted on the host (:func:`instance`, :func:`pack_taps`).
The kernels zero-fill outside the row and mask the ``r·T`` rim themselves,
so no padding is needed.  On a CPU tensor the wrapper runs the plain
version, :func:`stencil1d_ref`.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.stencil1d.ref import stencil1d_ref
from repro_torch.kernels.stencil2d.kernel import compact_taps

VARIANTS = ("vpu", "mxu")
MXU_ROWS = 16                # an mma's rows: K2 rounds block_b up to this
INSTANCES = (8,)             # K1's compile-time radii (kVpuRadius)
_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_size_t, ctypes.c_void_p]


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def smem_bytes(variant: str, radius: int, timesteps: int, block_b: int,
               block_n: int, itemsize: int = 4) -> int:
    """Dynamic shared memory of one thread block, laid out as stencil1d.cu
    uses it (``tile_layout`` there; the kernels refuse any other size).

    Both variants: a head; two raw tiles (the one being summed and the next
    in flight) of ``lw`` columns in the grid's type, rows padded to 16 bytes
    past a multiple of 128; the output tile in the grid's type,
    ``ceil8(block_n)`` columns padded to 16 (bf16) or 32 (f32) bytes past a
    multiple of 128; for T > 1 two float32 buffers of ``ceil32(lw) + 4``
    floats a row.  ``ph`` is the halo ``r·T`` rounded up to one 16-byte
    chunk.

    mxu: ``block_b`` rounded up to 16 rows, ``lw = ceil16(2·ph + block_n +
    16)``, and as head the split band of the generic instance (two arrays of
    ``K + 8`` floats, ``K = ceil8(8 + 2r)``).  vpu: ``block_b`` rows,
    ``lw = ph + block_n + r·T`` rounded up to a chunk, and as head room for
    ``2r+1`` (offset, value) pairs of taps, rounded up to 16 bytes."""
    chunk = 16 // itemsize
    ph = _round_up(radius * timesteps, chunk)
    if variant == "mxu":
        rows = _round_up(block_b, MXU_ROWS)
        lw = _round_up(2 * ph + block_n + 16, 16)
        head = 4 * 2 * (_round_up(8 + 2 * radius, 8) + 8)
    else:
        rows = block_b
        lw = _round_up(ph + block_n + radius * timesteps, chunk)
        head = _round_up(8 * (2 * radius + 1), 16)
    raw_words = _round_up(lw * itemsize // 4, 32) + 4
    out_words = (_round_up(_round_up(block_n, 8) * itemsize // 4, 32)
                 + (8 if itemsize == 4 else 4))
    f32_words = 2 * (_round_up(lw, 32) + 4) if timesteps > 1 else 0
    return head + 4 * rows * (2 * raw_words + out_words + f32_words)


def instance(coeffs: tuple[float, ...]) -> int:
    """K1's instance for these taps: the radius ``R`` of a compile-time
    instance where the taps have that radius and all ``2R+1`` are non-zero
    as the kernel gets them, in float32 (the instance skips no tap), else 0,
    the generic instance.  stencil1d.cu's launcher refuses any other
    choice."""
    r = (len(coeffs) - 1) // 2
    taps = np.asarray(coeffs, dtype=np.float32)
    return r if r in INSTANCES and bool((taps != 0).all()) else 0


@functools.lru_cache(maxsize=64)
def pack_taps(coeffs: tuple[float, ...]) -> np.ndarray:
    """K1's taps: the non-zero ones as (offset, float32 value bits) int32
    pairs, shape (m, 2), in ascending order (:func:`compact_taps`)."""
    offsets, values = compact_taps(coeffs)
    buf = np.zeros((len(offsets), 2), dtype=np.int32)
    buf[:, 0] = offsets
    buf[:, 1] = np.asarray(values, dtype=np.float32).view(np.int32)
    return buf


@functools.lru_cache(maxsize=64)
def _device_taps(coeffs: tuple[float, ...], device: torch.device) -> torch.Tensor:
    """:func:`pack_taps` on ``device``, built once per device."""
    return torch.from_numpy(pack_taps(coeffs)).to(device)


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
    coeffs = tuple(float(v) for v in coeffs)
    if variant == "mxu":
        inst, taps = 0, _build.device_coeffs(coeffs, x.device)
        ntaps = len(coeffs)
    else:
        inst, taps = instance(coeffs), _device_taps(coeffs, x.device)
        ntaps = taps.shape[0]
    with torch.cuda.device(x.device):
        _build.launch(f"stencil1d_{variant}", "stencil1d", _ARGTYPES,
                      int(variant == "mxu"), inst, x.data_ptr(),
                      out.data_ptr(), taps.data_ptr(), ntaps, dtype_code, b, n,
                      r, timesteps, bb, bn, smem,
                      _build.stream_handle(x.device))
    return out
