"""Wrapper of the hand-written CUDA kernel K5 in ``csrc/conv1d.cu``, which
replaces ``repro.kernels.conv1d.kernel``'s ``conv1d_pallas`` and the bias
its op adds after it.

Work is split into runs of consecutive positions of one batch row, one a
thread.  Where K <= 4, ``C * itemsize`` is a multiple of 16 and ``x``,
``w`` and ``y`` start on 16-byte boundaries, a vector instance runs: a
thread owns a 16-byte chunk of channels and keeps several rows' loads in
flight; every other case runs the generic instance, one channel a thread
(:func:`plan`).
The kernel zero-fills before position 0, reads its left halo itself, sums in
float32 in tap order, casts to ``x.dtype`` and adds the optional bias after
that cast in float32, rounding again.  On a CPU tensor the wrapper runs the
plain version, :func:`conv1d_ref`, which adds the bias before its one cast.

:func:`conv1d_bwd` wraps the backward of the same source
(``conv1d_bwd_launch``): one pass over x and dy gives dx, dw and db, dx with
the bits of K5 on the time-reversed gradient, dw and db from f32 partial
sums added in an order that depends on the shapes alone (:func:`plan_bwd`),
so the result is deterministic.  Its plain version is
:func:`conv1d_bwd_ref`.

On meta tensors both wrappers return meta outputs of the kernel's shapes
and types, launch nothing, and count the launch and its work
(:func:`conv1d_work`, :func:`conv1d_bwd_work`) in ``_build.META``.  They
allocate what the card's launch allocates, the backward's f32 workspace
too, so that a dry run counts a step's memory as the card holds it; meta
tensors have no address, so the backward plans the card's usual case,
every tensor 16-byte aligned.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv1d.ref import conv1d_bwd_ref, conv1d_ref

MAX_TAPS = 32      # the widest register window of the generic instance
VEC_TAPS = 4       # the vector instances: K = 1 .. VEC_TAPS (kVecTaps)
MAX_THREADS = 256  # threads per block the kernels are built for (kMaxThreads)
AHEADS = (1, 2, 4, 8)   # rows in flight a vector thread is built for
# The vector plan (scripts/k5_tiles.py measures it): runs of RUN positions
# with AHEAD rows in flight in blocks of THREADS, the run shorter where the
# grid would leave an SM fewer than MIN_THREADS_PER_SM threads.
RUN, AHEAD, THREADS, MIN_THREADS_PER_SM = 8, 8, 64, 512
GENERIC_RUN, GENERIC_THREADS = 64, 128
# The backward's plan (scripts/k5_bwd.py --sweep measures it): runs of
# BWD_RUN positions, BWD_THREADS a block (32 chunks of BWD_THREADS / 32
# runs, whose sums meet in shared memory), BWD_AHEAD[itemsize] rows a block
# of loads (two blocks in flight); the generic instance over runs of
# BWD_GENERIC_RUN.  SUM_CHAINS: the chains of workspace rows its second
# kernel adds (kSumChains).
BWD_RUN, BWD_THREADS, BWD_AHEAD = 32, 128, {2: 2, 4: 4}
BWD_GENERIC_RUN, BWD_GENERIC_THREADS = 64, 128
SUM_CHAINS = 8
_BWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                 ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p]
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of K5: ``instance`` is the vector instance's K, or 0 for
    the generic instance; a thread owns ``run`` positions; ``threads`` a
    block; ``ahead`` rows in flight a vector thread (1 for the generic)."""
    instance: int
    run: int
    threads: int
    ahead: int


def plan(batch: int, seq: int, ch: int, taps: int, itemsize: int, sms: int,
         aligned: bool) -> Plan:
    """K5's launch for x (batch, seq, ch) and ``taps`` taps on a card with
    ``sms`` SMs; ``aligned``: x, w and y start on 16-byte boundaries.

    A vector instance where ``taps <= VEC_TAPS``, the rows are whole
    16-byte chunks and ``aligned``: runs of ``RUN`` positions, halved while
    the grid (a thread a run and chunk) gives the SMs fewer than
    ``MIN_THREADS_PER_SM`` threads each, ``min(AHEAD, run)`` rows in flight,
    ``THREADS`` a block.  Else the generic instance over runs of
    ``GENERIC_RUN``."""
    if not (aligned and taps <= VEC_TAPS and ch * itemsize % 16 == 0):
        return Plan(0, GENERIC_RUN, GENERIC_THREADS, 1)
    chunks = ch * itemsize // 16
    run = RUN
    while (run > 1
           and batch * chunks * -(-seq // run) < sms * MIN_THREADS_PER_SM):
        run //= 2
    return Plan(taps, run, THREADS, min(AHEAD, run))


def conv1d_work(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor | None = None) -> tuple[int, int]:
    """(operations, bytes) of one launch of K5: an FMA a tap a point,
    ``2·K·B·S·C``; x, w and b read once, y written once."""
    return 2 * w.shape[0] * x.numel(), _build.nbytes(x, w, b, x)


def conv1d_bwd_work(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor | None = None, *, need_x: bool = True,
                    need_wb: bool = True) -> tuple[int, int]:
    """(operations, bytes) of one launch of K5's backward: an FMA a tap a
    point for dx, one for dw and an add for db, ``(4·K+1)·x.numel()`` for
    all three; x, dy, w and the bias counted once each as inputs, dx, dw
    and db once each as outputs."""
    k, n = w.shape[0], x.numel()
    ops = 2 * k * n * need_x + (2 * k + 1) * n * need_wb
    nbytes = (_build.nbytes(x, x, w) + need_x * _build.nbytes(x)
              + need_wb * (_build.nbytes(w) + 2 * _build.nbytes(b)))
    return ops, nbytes


def _check_plan(p: Plan, taps: int) -> None:
    if (p.instance not in (0, taps) or p.instance > VEC_TAPS or p.run < 1
            or p.threads < 32 or p.threads > MAX_THREADS or p.threads % 32
            or p.ahead not in AHEADS):
        raise ValueError(f"conv1d: {p} does not fit {taps} taps (instance 0 "
                         f"or K <= {VEC_TAPS}, threads a multiple of 32 up to "
                         f"{MAX_THREADS}, ahead in {AHEADS})")


def conv1d_kernel(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor | None = None, *,
                  launch: Plan | None = None) -> torch.Tensor:
    """x: (B, S, C) float32/bfloat16, w: (K, C) of the same type, optional
    bias b: (C,) float32 or bfloat16 -> (B, S, C) in ``x.dtype``.  Launches
    K5 on a CUDA tensor, with :func:`plan`'s launch unless ``launch`` gives
    another (the launcher refuses a vector instance the tensors do not
    allow); runs :func:`conv1d_ref` on a CPU one."""
    dtype_code = _build.check_grid(x, 3, "conv1d", meta=True)
    if w.dim() != 2 or w.shape[1] != x.shape[2] or w.dtype != x.dtype:
        raise ValueError(f"conv1d takes taps (K, {x.shape[2]}) of type "
                         f"{x.dtype}, got {tuple(w.shape)} {w.dtype}")
    if b is not None and tuple(b.shape) != (x.shape[2],):
        raise ValueError(f"conv1d takes a bias ({x.shape[2]},), got "
                         f"{tuple(b.shape)}")
    for t in (w, b):
        if t is not None and t.device != x.device:
            raise ValueError(f"conv1d: taps or bias on {t.device}, input on "
                             f"{x.device}")
    if x.device.type == "cpu":
        return conv1d_ref(x, w, b)
    kk = w.shape[0]
    if not 1 <= kk <= MAX_TAPS:
        raise ValueError(f"conv1d kernel takes 1 to {MAX_TAPS} taps, got {kk}")
    if x.device.type == "meta":
        if x.numel():
            _build.count_meta("conv1d", *conv1d_work(x, w, b))
        return torch.empty_like(x)
    w = w.contiguous()
    bias_code, bias_ptr = -1, None
    if b is not None:
        if b.dtype not in _build.DTYPE_CODES:
            b = b.float()             # the bits of the op's b.float()
        b = b.contiguous()
        bias_code, bias_ptr = _build.DTYPE_CODES[b.dtype], b.data_ptr()
    bs, s, c = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    if launch is None:
        launch = launch_plan(x, w)
    _check_plan(launch, kk)
    with torch.cuda.device(x.device):
        _build.launch("conv1d", "conv1d", _ARGTYPES, x.data_ptr(),
                      w.data_ptr(), bias_ptr, out.data_ptr(), dtype_code,
                      bias_code, bs, s, c, kk, launch.instance, launch.run,
                      launch.threads, launch.ahead,
                      _build.stream_handle(x.device))
    return out


def launch_plan(x: torch.Tensor, w: torch.Tensor) -> Plan:
    """:func:`plan` for these CUDA tensors.  The output comes from
    ``torch.empty_like``, whose caching allocator starts every block on a
    512-byte boundary; the launcher checks it with x and w all the same."""
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    bs, s, c = x.shape
    return plan(bs, s, c, w.shape[0], x.element_size(), sms, aligned)


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """One launch of K5's backward: ``instance`` is the vector instance's
    K, or 0 for the generic instance; a thread owns ``run`` positions;
    ``threads`` a block (32 units of ``threads // 32`` runs); ``ahead`` rows
    in flight a vector thread (1 for the generic)."""
    instance: int
    run: int
    threads: int
    ahead: int


def plan_bwd(batch: int, seq: int, ch: int, taps: int, itemsize: int,
             aligned: bool) -> BwdPlan:
    """K5's backward for x (batch, seq, ch) and ``taps`` taps; ``aligned``:
    x, dy, w and dx start on 16-byte boundaries.  A vector instance where
    ``taps <= VEC_TAPS``, the rows are whole 16-byte chunks and
    ``aligned``, else the generic instance.  The shapes alone decide it,
    never the card, so the order of dw's and db's sums, and their bits, do
    too."""
    if not (aligned and taps <= VEC_TAPS and ch * itemsize % 16 == 0):
        return BwdPlan(0, BWD_GENERIC_RUN, BWD_GENERIC_THREADS, 1)
    return BwdPlan(taps, BWD_RUN, BWD_THREADS, BWD_AHEAD[itemsize])


def bwd_groups(p: BwdPlan, batch: int, seq: int) -> int:
    """Rows of the backward's workspace: its blocks along the positions,
    ``threads // 32`` runs each."""
    return -(-batch * -(-seq // p.run) // (p.threads // 32))


def conv1d_bwd(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor | None = None, *, need_x: bool = True,
               need_wb: bool = True, launch: BwdPlan | None = None
               ) -> tuple[torch.Tensor | None, torch.Tensor | None,
                          torch.Tensor | None]:
    """(dx, dw, db): the gradients of the forward's input x (B, S, C), taps
    w (K, C) of x's type and bias b (C,) or None, for its output's gradient
    dy (B, S, C) of x's type; dx None unless ``need_x``, dw and db None
    unless ``need_wb`` (db also without a bias), each in its input's type.
    Launches K5's backward on CUDA tensors, once, with :func:`plan_bwd`'s
    launch unless ``launch`` gives another; runs :func:`conv1d_bwd_ref` on
    CPU ones."""
    dtype_code = _build.check_grid(x, 3, "conv1d_bwd", strided=True,
                                   meta=True)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"conv1d_bwd: dy {tuple(dy.shape)} {dy.dtype} on "
                         f"{dy.device} must match x {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")
    if w.dim() != 2 or w.shape[1] != x.shape[2] or w.dtype != x.dtype:
        raise ValueError(f"conv1d_bwd takes taps (K, {x.shape[2]}) of type "
                         f"{x.dtype}, got {tuple(w.shape)} {w.dtype}")
    if b is not None and tuple(b.shape) != (x.shape[2],):
        raise ValueError(f"conv1d_bwd takes a bias ({x.shape[2]},), got "
                         f"{tuple(b.shape)}")
    if x.device.type == "cpu":
        dx, dw, db = conv1d_bwd_ref(x, w, b, dy)
        return (dx if need_x else None, dw if need_wb else None,
                db if need_wb else None)
    kk = w.shape[0]
    if not 1 <= kk <= MAX_TAPS:
        raise ValueError(f"conv1d kernel takes 1 to {MAX_TAPS} taps, got {kk}")
    if b is not None and b.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"conv1d_bwd: the bias is float32 or bfloat16, got "
                        f"{b.dtype}")
    if not (need_x or need_wb):
        return None, None, None
    x, dy, w = x.contiguous(), dy.contiguous(), w.contiguous()
    bs, s, c = x.shape
    dx = torch.empty_like(x) if need_x else None
    dw = torch.empty_like(w) if need_wb else None
    db = (torch.empty(b.shape, dtype=b.dtype, device=x.device)
          if need_wb and b is not None else None)
    meta = x.device.type == "meta"
    if x.numel() == 0:
        for t in (dw, db):
            if t is not None and not meta:
                t.zero_()
        return dx, dw, db
    if launch is None:
        # meta has no addresses: the card's usual case, aligned (the
        # caching allocator starts every block on a 512-byte boundary)
        aligned = meta or all(t.data_ptr() % 16 == 0 for t in (x, dy, w))
        launch = plan_bwd(bs, s, c, kk, x.element_size(), aligned)
    _check_plan(launch, kk)
    groups = bwd_groups(launch, bs, s)
    # the per-group f32 sums, on meta too: a dry run's count of a step's
    # memory sees what the launch holds
    part = (torch.empty((groups, kk + 1, c), dtype=torch.float32,
                        device=x.device) if need_wb else None)
    if meta:
        _build.count_meta("conv1d_bwd", *conv1d_bwd_work(
            x, w, b, need_x=need_x, need_wb=need_wb))
        return dx, dw, db
    with torch.cuda.device(x.device):
        _build.launch("conv1d_bwd", "conv1d", _BWD_ARGTYPES, x.data_ptr(),
                      dy.data_ptr(), w.data_ptr(),
                      *(None if t is None else t.data_ptr()
                        for t in (dx, part, dw, db)), dtype_code,
                      -1 if db is None else _build.DTYPE_CODES[db.dtype],
                      bs, s, c, groups, kk, launch.instance, launch.run,
                      launch.threads, launch.ahead,
                      _build.stream_handle(x.device), entry="conv1d_bwd")
    return dx, dw, db
