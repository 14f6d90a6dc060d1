"""Wrapper of the hand-written CUDA kernel K4 in ``csrc/stencil3d.cu``,
which replaces ``repro.kernels.stencil3d.kernel``'s ``stencil3d_pallas``.

One launch is one sweep.  A block ``(bz, by, bx)`` is the work of one thread
block: a ``by x bx`` column tile marched over ``bz`` planes by
``(bx/4) x (by/4)`` threads, each owning a 4 x 4 micro-tile of columns; so
``by`` is a multiple of 4, ``bx`` of 8 (a 16-byte chunk of bf16) and
``by·bx <= 4096`` (:func:`check_block`).  Shared memory is a ring of haloed
``(by + 2·ry) x (bx + 2·px)`` planes in the grid's type, ``px`` being ``rx``
rounded up to a 16-byte chunk (:func:`smem_bytes`).  The radii (1, 1, 1) and
(2, 2, 2) with the star pattern of taps (every tap non-zero but the y and x
centres, as ``star_3d`` and ``heat_3d`` have them) run compile-time
instances that keep the z taps' values in registers and sum without tests;
every other radius or pattern runs the generic instance, whose ring holds
all ``2·rz+1`` planes of the z taps (:func:`instance`).  The taps go to the kernel as a struct
(:func:`pack_taps`) of 64 taps per axis, so the kernel takes radii up to 31.
The kernel zero-fills outside the grid and zeroes within ``r·step`` of every
face, so the T-sweep loop in ops.py needs no padding and no separate
re-mask.  On a CPU tensor the wrapper runs the plain version,
:func:`stencil3d_sweep_ref`.  Each launch adds its work to ``_build.WORK``
(:func:`stencil3d_work`).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.stencil2d.kernel import compact_taps
from repro_torch.kernels.stencil3d.ref import stencil3d_sweep_ref
from repro_torch.telemetry import host

MAX_TAPS = 64           # kMaxTaps in stencil3d.cu: 2r + 1 <= 64 per axis
MICRO = (4, 4)          # kMY, kMX: rows x columns a thread owns
MAX_THREADS = 256       # kMaxThreads: by·bx / 16 threads at most
AHEAD = 2               # kAhead: planes in flight beyond the one needed next
INSTANCES = (1, 2)      # compile-time radii (rz = ry = rx)
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int64]
             + [ctypes.c_int] * 14 + [ctypes.c_size_t, ctypes.c_void_p])


def check_block(block: tuple[int, int, int]) -> None:
    """Refuse a tile the kernel does not take: ``bz >= 1``, ``by`` a
    positive multiple of 4, ``bx`` of 8, at most 256 threads."""
    bz, by, bx = block
    if (bz < 1 or by < MICRO[0] or by % MICRO[0] or bx < 8 or bx % 8
            or by * bx > MAX_THREADS * MICRO[0] * MICRO[1]):
        raise ValueError(f"stencil3d block {block} must be (bz >= 1, by a "
                         "positive multiple of 4, bx of 8) with by * bx <= "
                         f"{MAX_THREADS * MICRO[0] * MICRO[1]}")


def instance(cz, cy, cx) -> int:
    """The kernel instance that runs these taps: ``R`` where every axis has
    the radius ``R`` of a compile-time instance and the taps have the star
    pattern (every tap non-zero but the y and x centres), else 0, the
    generic instance.  The test is on the taps as the kernel gets them, in
    float32 (stencil3d.cu's ``star_pattern`` refuses any other choice)."""
    r = (len(cz) - 1) // 2
    if r not in INSTANCES or not len(cz) == len(cy) == len(cx):
        return 0
    cz, cy, cx = (np.asarray(c, dtype=np.float32) for c in (cz, cy, cx))
    centre = np.arange(2 * r + 1) == r
    star = (cz != 0).all() and ((cy == 0) == centre).all() and (
        (cx == 0) == centre).all()
    return r if star else 0


def ring_slots(rz: int, queued: bool) -> int:
    """Planes the kernel keeps in shared memory: the centres still to come
    in a compile-time instance (``queued``, the z values in registers),
    every z tap's plane in the generic one, and the planes in flight."""
    return (rz if queued else 2 * rz) + 1 + AHEAD


def smem_bytes(rz: int, ry: int, rx: int, by: int, bx: int,
               itemsize: int = 4, queued: bool = False) -> int:
    """Dynamic shared memory of one tile, laid out as stencil3d.cu uses it:
    :func:`ring_slots` haloed planes in the grid's type."""
    chunk = 16 // itemsize
    px = -(-rx // chunk) * chunk
    return (ring_slots(rz, queued) * (by + 2 * ry) * (bx + 2 * px)
            * itemsize)


@functools.lru_cache(maxsize=256)
def stencil3d_work(b: int, nz: int, ny: int, nx: int, rz: int, ry: int,
                   rx: int, bz: int, by: int, bx: int, itemsize: int,
                   queued: bool, taps: int) -> tuple[int, int]:
    """(multiply-adds, bytes) of one launch over ``b`` grids of nz x ny x nx
    in (bz, by, bx) tiles, ``taps`` non-zero taps a point (the generic
    instance walks the compacted taps; a compile-time instance's star
    pattern has no zero tap).  Bytes: every haloed plane a tile's z-march
    loads into its ring, ``(by + 2ry) x (bx + 2px)`` with ``px`` = rx
    rounded up to a 16-byte chunk, clipped to the grid where the kernel
    zero-fills instead of loading (planes z0 .. z1 + rz, from z0 - rz in the
    generic instance); in a compile-time instance (``queued``) also the rz
    planes before each z chunk, each thread's own columns read from global
    memory; then every output stored once.  Multiply-adds: every column of
    every tile, past the grid's end too, at every plane of its chunk.  The
    tiles of each axis contribute independently."""
    chunk = 16 // itemsize
    px = -(-rx // chunk) * chunk
    zs, ys, xs = range(0, nz, bz), range(0, ny, by), range(0, nx, bx)
    first = 0 if queued else rz
    planes = sum(_build.overlap(z0 - first, min(z0 + bz, nz) + rz, nz)
                 for z0 in zs)
    rows = sum(_build.overlap(y0 - ry, y0 + by + ry, ny) for y0 in ys)
    cols = sum(_build.overlap(x0 - px, x0 + bx + px, nx) for x0 in xs)
    loaded = planes * rows * cols
    if queued:
        loaded += sum(_build.overlap(z0 - rz, z0, nz) for z0 in zs) * ny * nx
    ops = b * nz * len(ys) * by * len(xs) * bx * taps
    return ops, b * (loaded + nz * ny * nx) * itemsize


@functools.lru_cache(maxsize=64)
def pack_taps(cz: tuple[float, ...], cy: tuple[float, ...],
              cx: tuple[float, ...]) -> np.ndarray:
    """The taps laid out as ``struct Taps`` of stencil3d.cu: the counts of
    non-zero taps (nz, ny, nx), their offsets, their coefficients, then the
    dense coefficients by offset; 4-byte fields.  Built once per taps."""
    if max(len(cz), len(cy), len(cx)) > MAX_TAPS:
        raise ValueError(f"stencil3d kernel takes at most {MAX_TAPS} taps per "
                         f"axis (radius <= {(MAX_TAPS - 1) // 2}), got "
                         f"{len(cz)}, {len(cy)} and {len(cx)}")
    packed = [compact_taps(c) for c in (cz, cy, cx)]
    buf = np.zeros(3 + 9 * MAX_TAPS, dtype=np.int32)
    f = buf.view(np.float32)
    buf[:3] = [len(o) for o, _ in packed]
    base = 3
    for offsets, _ in packed:
        buf[base:base + len(offsets)] = offsets
        base += MAX_TAPS
    for vals in [v for _, v in packed] + [cz, cy, cx]:
        f[base:base + len(vals)] = vals
        base += MAX_TAPS
    return buf


@functools.cache
def _check_taps_layout() -> None:
    """Refuse a library whose ``struct Taps`` is not the buffer
    :func:`pack_taps` builds (the launch copies that many bytes from it)."""
    fn = _build.library("stencil3d").stencil3d_taps_bytes
    fn.restype = ctypes.c_int
    want = pack_taps((0.0,), (0.0,), (0.0,)).nbytes
    if fn() != want:
        raise RuntimeError(f"stencil3d.cu's struct Taps is {fn()} B, pack_taps "
                           f"builds {want} B: MAX_TAPS and kMaxTaps differ")


def stencil3d_kernel(x: torch.Tensor, cz: tuple[float, ...],
                     cy: tuple[float, ...], cx: tuple[float, ...], *,
                     block: tuple[int, int, int] | None = None,
                     step: int = 1) -> torch.Tensor:
    """x: (B, nz, ny, nx) float32/bfloat16 -> same: sweep number ``step``
    (its rim is ``r·step``).  Launches K4 on a CUDA tensor (``block``
    required there); runs :func:`stencil3d_sweep_ref` on a CPU one."""
    with host.span("stencil3d.kernel"):
        dtype_code = _build.check_grid(x, 4, "stencil3d")
        if step < 1:
            raise ValueError("step must be >= 1")
        if not _build.on_card(x):
            return stencil3d_sweep_ref(x, tuple(cz), tuple(cy), tuple(cx),
                                       step)
        rz, ry, rx = (_build.radius(c, "stencil3d") for c in (cz, cy, cx))
        if block is None:
            raise ValueError("stencil3d_kernel needs a block on the card")
        check_block(block)
        bz, by, bx = block
        cz, cy, cx = (tuple(float(v) for v in c) for c in (cz, cy, cx))
        taps = pack_taps(cz, cy, cx)
        _check_taps_layout()
        inst = instance(cz, cy, cx)
        smem = smem_bytes(rz, ry, rx, by, bx, x.element_size(), inst > 0)
        _build.require_smem(f"stencil3d block {block} at r=({rz}, {ry}, {rx})",
                            smem, x.device)
        b, nz, ny, nx = x.shape
        with host.span("stencil3d.alloc"):
            out = torch.empty_like(x)
        if out.numel() == 0:
            return out
        vec = int(nx % (16 // x.element_size()) == 0
                  and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
        work = stencil3d_work(b, nz, ny, nx, rz, ry, rx, bz, by, bx,
                              x.element_size(), inst > 0,
                              int(taps[0]) + int(taps[1]) + int(taps[2]))
        with torch.cuda.device(x.device):
            _build.launch("stencil3d", "stencil3d", _ARGTYPES, x.data_ptr(),
                          out.data_ptr(), taps.ctypes.data, dtype_code, b,
                          inst, nz, ny, nx, rz, ry, rx, rz * step, ry * step,
                          rx * step, bz, by, bx, vec, smem,
                          _build.stream_handle(x.device), work=work)
        return out
