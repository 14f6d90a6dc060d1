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

Each launch adds its work to ``_build.WORK`` (:func:`stencil2d_work`).
Inside ``repro_torch.telemetry.recording(clocks=True)`` the wrapper
launches the clocked instance instead, counted as ``stencil2d_clocked``:
the same outputs, bit for bit, and each block's time split by phase
(:data:`CLOCK_FIELDS`).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.stencil2d.ref import stencil2d_ref
from repro_torch.telemetry import host

MAX_TAPS = 128          # kMaxTaps in stencil2d.cu: 2r + 1 <= 128 per axis
MICRO = (8, 4)          # kMY, kMX: rows x columns a thread computes at once
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p]
# the clocked instance's record (stencil2d.cu: cIssue ... cBytes), one row
# of kClockSlots: thread 0's clock64() cycles issuing the tile's loads,
# waiting until it is in shared memory, summing and storing; the blocks;
# the bytes their loads requested
CLOCK_FIELDS = ("issue", "wait", "sum", "store", "blocks", "bytes")
CLOCK_SLOTS = 256


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


@functools.lru_cache(maxsize=256)
def stencil2d_work(b: int, ny: int, nx: int, ry: int, rx: int,
                   timesteps: int, by: int, bx: int, itemsize: int,
                   taps: int) -> tuple[int, int]:
    """(multiply-adds, bytes) of one launch over ``b`` grids of ny x nx in
    (by, bx) tiles, ``taps`` non-zero taps a point (the kernel skips the
    zero ones).  Bytes: every tile's haloed rectangle as the kernel lays it
    out (columns out to ``pad8(rx·T)`` a side), clipped to the grid, where
    it zero-fills instead of loading; then every output stored once.
    Multiply-adds: every micro-tile of 8 x 4 a sweep computes, the fused
    sweeps' shrinking regions rounded out to whole micro-tiles, the last
    sweep's without those that start past the grid's end (it skips them).
    Tile rows and columns contribute independently, so each is a sum over
    the tiles of one axis."""
    hy, hx = ry * timesteps, rx * timesteps
    px = _pad8(hx)
    ys, xs = range(0, ny, by), range(0, nx, bx)
    rows = sum(_build.overlap(y0 - hy, y0 + by + hy, ny) for y0 in ys)
    cols = sum(_build.overlap(x0 - px, x0 + bx + px, nx) for x0 in xs)
    nbytes = b * (rows * cols + ny * nx) * itemsize
    my, mx = MICRO
    cb = (8 if timesteps > 1 else 0) + px   # shared column of output column 0
    h0 = by + 2 * hy
    micro = 0
    for s in range(1, timesteps + 1):
        r_lo, r_hi = ry * s, h0 - ry * s
        c_lo, c_hi = (cb - hx + rx * s) & ~3, cb + bx + hx - rx * s
        nmy, nmx = -(-(r_hi - r_lo) // my), -(-(c_hi - c_lo) // mx)
        if s < timesteps:
            micro += len(ys) * nmy * len(xs) * nmx
        else:
            kept_y = sum(min(nmy, -(-(ny - y0 - r_lo + hy) // my)) for y0 in ys)
            kept_x = sum(min(nmx, -(-(nx - x0 - c_lo + cb) // mx)) for x0 in xs)
            micro += kept_y * kept_x
    return b * micro * my * mx * taps, nbytes


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
    :func:`pack_taps` builds (the launch copies that many bytes from it),
    or whose clock buffer is not :data:`CLOCK_SLOTS` x :data:`CLOCK_FIELDS`."""
    lib = _build.library("stencil2d")
    fn = lib.stencil2d_taps_bytes
    fn.restype = ctypes.c_int
    want = pack_taps((0.0,), (0.0,)).nbytes
    if fn() != want:
        raise RuntimeError(f"stencil2d.cu's struct Taps is {fn()} B, pack_taps "
                           f"builds {want} B: MAX_TAPS and kMaxTaps differ")
    shape = lib.stencil2d_clock_shape
    shape.argtypes, shape.restype = [ctypes.c_int], ctypes.c_int
    if (shape(0), shape(1)) != (CLOCK_SLOTS, len(CLOCK_FIELDS)):
        raise RuntimeError(f"stencil2d.cu's clock buffer is {shape(0)} x "
                           f"{shape(1)}, kernel.py's {CLOCK_SLOTS} x "
                           f"{len(CLOCK_FIELDS)}")


def stencil2d_kernel(x: torch.Tensor, cy: tuple[float, ...],
                     cx: tuple[float, ...], *, timesteps: int = 1,
                     block: tuple[int, int] | None = None) -> torch.Tensor:
    """x: (B, ny, nx) float32/bfloat16 -> same.  Launches K3 on a CUDA tensor
    (``block`` required there); runs :func:`stencil2d_ref` on a CPU one."""
    with host.span("stencil2d.kernel"):
        dtype_code = _build.check_grid(x, 3, "stencil2d")
        if timesteps < 1:
            raise ValueError("timesteps must be >= 1")
        if not _build.on_card(x):
            return stencil2d_ref(x, tuple(cy), tuple(cx), timesteps)
        ry, rx = _build.radius(cy, "stencil2d"), _build.radius(cx, "stencil2d")
        if block is None:
            raise ValueError("stencil2d_kernel needs a block on the card")
        by, bx = block
        if by < 8 or bx < 8 or by % 8 or bx % 8:
            raise ValueError(f"stencil2d block {block} must be positive "
                             "multiples of 8")
        taps = pack_taps(tuple(float(c) for c in cy),
                         tuple(float(c) for c in cx))
        _check_taps_layout()
        smem = smem_bytes(ry, rx, timesteps, by, bx)
        _build.require_smem(f"stencil2d block {block} at r=({ry}, {rx}), "
                            f"T={timesteps}", smem, x.device)
        b, ny, nx = x.shape
        with host.span("stencil2d.alloc"):
            out = torch.empty_like(x)
        if out.numel() == 0:
            return out
        vec = int(nx % (16 // x.element_size()) == 0
                  and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
        work = stencil2d_work(b, ny, nx, ry, rx, timesteps, by, bx,
                              x.element_size(), int(taps[0]) + int(taps[1]))
        clocks = host.clock_buffer("stencil2d_clocked", x.device,
                                   CLOCK_FIELDS, CLOCK_SLOTS)
        with torch.cuda.device(x.device):
            name = "stencil2d" if clocks is None else "stencil2d_clocked"
            _build.launch(name, "stencil2d", _ARGTYPES, x.data_ptr(), out.data_ptr(),
                          taps.ctypes.data, dtype_code, b, ny, nx, ry, rx,
                          timesteps, by, bx, vec, smem,
                          None if clocks is None else clocks.data_ptr(),
                          _build.stream_handle(x.device), work=work)
        return out
