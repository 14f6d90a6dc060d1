"""Wrapper of the hand-written CUDA kernel K6 in ``csrc/swa.cu``, which
replaces ``repro.kernels.swa.kernel``'s ``swa_pallas``.

Both types run on the tensor cores.  bfloat16: one block of two
warpgroups per (batch, query head, 128-query tile) computes QKᵀ and P·V
with ``wgmma`` out of bf16 tiles in shared memory (Q, and a two-stage ring
of 64-key K/V tiles filled by ``cp.async``, all in the 128-byte swizzle).
float32: one block of 8 warps per (batch, query head, 64-query tile) on
32-key tiles computes them with ``mma.sync`` in 3xTF32 (each operand split
into two TF32 parts, three products summed in f32, long sums in chunks),
which keeps its 2e-5 limit where one TF32 product would not; Q and a
two-stage ring of K/V tiles are f32 in shared memory, and the two warps
that share 16 query rows, 16 keys of a tile each, share the rows' running
max and hand each other their probabilities.  Both mask by the true
sequence length, so nothing is padded, and both read q, k, v and write the
output through (batch, head, position) strides, so a (B, S, H, D) tensor
viewed as (B, H, S, D) goes in without a copy and the output takes q's
layout.  Shared memory is :func:`smem_bytes`.  On a CPU tensor the wrapper
runs the plain version, :func:`swa_ref`.

:func:`swa_bwd_kernel` wraps the backward in ``csrc/swa_bwd.cu``, which
has no TPU counterpart (the JAX package differentiates the forward by
autodiff).  What bounds it is operations: five products over the band
(S, dP, dQ, dK, dV), 0.163 ms in bf16 at the model's (1, 10/1, 4096, 256)
with window 2048; recomputing the rows' log-sum-exp (the forward keeps
none) and splitting dQ from dK/dV without atomics make it eight.  Both
types run them on the tensor cores: ``swa_bwd_dq`` (one block per batch,
query head and query tile: the rows' LSE in a first pass over the band,
``D = rowsum(dO * O)``, then dQ += dS·K) and ``swa_bwd_dkdv`` (one block
per batch, KV head, 64-key tile and part of the group's query heads,
:func:`bwd_parts`: one group of warps computes Pᵀ and dV, the other dPᵀ,
dSᵀ and dK, Pᵀ handed across in shared memory; each part writes f32
partial sums that ``swa_bwd_fold`` adds in a fixed order and casts).
bfloat16 uses ``wgmma`` out of bf16 tiles in shared memory, as the forward
does, with P and dS rounded to bf16 in registers; float32 uses
``mma.sync`` in 3xTF32 (each operand split into two TF32 parts, three
products summed in f32), which keeps its 1e-5 bar where one TF32 product
would not.  No atomics: the same inputs give the same bits.  Shared memory
:func:`bwd_smem_bytes`.  Its plain version is :func:`swa_bwd_ref` (and
:func:`swa_bwd_fold_ref` the fold's).

On meta tensors every wrapper returns meta outputs of its kernel's shapes
and types, launches nothing, and counts the launch and its work
(:func:`swa_work`, :func:`swa_bwd_work`, :func:`swa_bwd_fold_work`) in
``_build.META``.  Each allocates what its card branch allocates (the
copies of inputs without a unit D stride too), so that a dry run counts a
step's memory as the card holds it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.swa.ref import (swa_bwd_fold_ref, swa_bwd_ref,
                                        swa_ref)

F32_BLOCK_Q, F32_BLOCK_K, F32_WARPS = 64, 32, 8   # kFRows, kFKeys, kFThreads / 32
F32_XCH = 2 * 8 * 32            # kXch: u32s of a warp's P fragments (tf32.cuh)
WG_BLOCK_Q, WG_BLOCK_K = 128, 64                  # kWQ, kWK in swa.cu
MAX_HEAD_DIM = 256
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_size_t,
             ctypes.c_void_p]


# swa_bwd_dq_launch: 8 pointers (q, k, v, o, dO, dq, lse, delta), then
# the scalars; swa_bwd_dkdv_launch: 6 (q, k, v, dO, lse, delta), the
# scalars, and the partial sums' pointer and their number of parts before
# smem
_SCALARS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float]
_BWD_ARGTYPES = [ctypes.c_void_p] * 8 + _SCALARS + [ctypes.c_size_t,
                                                     ctypes.c_void_p]
_DKDV_ARGTYPES = [ctypes.c_void_p] * 6 + _SCALARS + [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_void_p]
_FOLD_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_int64, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_void_p]
BWD_BLOCK_Q, BWD_TILE = 128, 64        # kDqRows, kTile in swa_bwd.cu
F32_BWD_ROWS, F32_BWD_KEYS, F32_BWD_QT = 64, 32, 16   # kFRows, kFKeys, kFQT
# swa_bwd_dkdv splits a group's query heads into as many parts as keep its
# blocks within this many (the H100's SMs; a constant, so the split, and
# with it the bits, depend on the shapes alone), and in f32 within
# F32_PARTS_WAVES times as many: its blocks' bands differ in length, and
# more, shorter blocks even out what each SM is given
PARTS_BLOCKS = 132
F32_PARTS_WAVES = 3


def bwd_smem_bytes(head_dim: int, dtype: torch.dtype = torch.bfloat16
                   ) -> dict[str, int]:
    """Dynamic shared memory of one block of each backward kernel, as
    swa_bwd.cu lays it out, D zero-filled to Dp = 64, 128 or 256.  bf16
    (and 1024 bytes to align the swizzled tiles): dq holds Q and dO (128
    rows), two 64-key K stages, one V tile and the rows' D; dkdv its 64
    keys' K and V, two stages of 64-query Q and dO tiles with their LSE and
    D, and the 64 x 64 f32 Pᵀ handed between its warpgroups.  f32 (tiles
    in f32, unpadded): dq holds Q and dO (64 rows), two 32-key tiles (K and
    V), the 8 warps' dS fragments (2 k-steps x 8 u32 x 32 lanes), the rows'
    D and each warp's (max, sum) of its 16 rows; dkdv its 64 keys' K and V,
    two stages of 16-query Q and dO tiles with their LSE and D, and the
    4 warps' Pᵀ fragments (8 x 32 f32)."""
    dp = next(p for p in (64, 128, 256) if head_dim <= p)
    if dtype == torch.bfloat16:
        return {"swa_bwd_dq": 2 * dp * (2 * BWD_BLOCK_Q + 3 * BWD_TILE)
                + 4 * BWD_BLOCK_Q + 1024,
                "swa_bwd_dkdv": 2 * dp * 6 * BWD_TILE + 4 * 4 * BWD_TILE
                + 4 * BWD_TILE * BWD_TILE + 1024}
    return {"swa_bwd_dq": 4 * dp * (2 * F32_BWD_ROWS + 2 * F32_BWD_KEYS)
            + 4 * (8 * F32_XCH + F32_BWD_ROWS + 8 * 16 * 2),
            "swa_bwd_dkdv": 4 * dp * (2 * BWD_TILE + 4 * F32_BWD_QT)
            + 4 * (4 * F32_BWD_QT + 4 * 8 * 32)}


def bwd_parts(batch: int, hkv: int, seq: int, group: int,
              dtype: torch.dtype = torch.bfloat16) -> int:
    """Parts of a KV head's group of query heads that ``swa_bwd_dkdv`` runs
    as blocks of their own: the most that keep batch x hkv x 64-key tiles x
    parts within PARTS_BLOCKS (f32: F32_PARTS_WAVES x PARTS_BLOCKS), at
    least 1, at most the group.  bf16 splits the group's heads, f32 its
    (head, 16-query tile) steps.  At the model's (1, 10/1, 4096): 2 in
    bf16, 6 in f32."""
    blocks = batch * hkv * -(-seq // BWD_TILE)
    waves = F32_PARTS_WAVES if dtype == torch.float32 else 1
    return max(1, min(group, waves * PARTS_BLOCKS // max(blocks, 1)))


def smem_bytes(head_dim: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of one block, laid out as swa.cu uses it, D
    zero-filled to Dp = 64, 128 or 256: for bf16, Q and two (K, V) stages,
    and 1024 bytes to align the swizzled tiles; for f32 (swa.cu's
    f32_smem), Q and two (K, V) stages, the 8 warps' P fragments (2 k-steps
    x 8 u32 x 32 lanes) and each warp's 16 rows' tile max."""
    dp = next(p for p in (64, 128, 256) if head_dim <= p)
    if dtype == torch.bfloat16:
        return 2 * (WG_BLOCK_Q + 4 * WG_BLOCK_K) * dp + 1024
    return (4 * dp * (F32_BLOCK_Q + 4 * F32_BLOCK_K)
            + 4 * F32_WARPS * (F32_XCH + 16))


def band_pairs(seq: int, window: int) -> int:
    """(query, key) pairs inside the causal band: sum_i min(i + 1, window)."""
    w = min(window, seq)
    return w * (w + 1) // 2 + (seq - w) * w


def _product_ops(q: torch.Tensor, window: int) -> int:
    """Operations of one (S x D) product over the band of every (batch,
    query head): 2·D a (query, key) pair."""
    b, hq, s, d = q.shape
    return band_pairs(s, window) * b * hq * 2 * d


def swa_work(q: torch.Tensor, k: torch.Tensor, window: int
             ) -> tuple[int, int]:
    """(operations, bytes) of one launch of K6: QKᵀ and P·V over the band,
    ``band_pairs(S, window)·B·Hq·4·D``; q, k and v read once, the output
    (q's shape) written once."""
    return 2 * _product_ops(q, window), _build.nbytes(q, k, k, q)


def swa_bwd_work(entry: str, q: torch.Tensor, k: torch.Tensor,
                 window: int) -> tuple[int, int]:
    """(operations, bytes) of one launch of ``swa_bwd_dq`` (3 products
    over the band: S, dP, dQ; reads q, k, v, o, dO, writes dq and the rows'
    f32 LSE and D) or ``swa_bwd_dkdv`` (4: S, dP, dK, dV; reads q, k, v,
    dO, LSE and D, dK and dV counted at k's shape and type)."""
    rows = 2 * q.numel() // q.shape[-1] * 4        # LSE and D, f32 (B, Hq, S)
    if entry == "swa_bwd_dq":
        return (3 * _product_ops(q, window),
                _build.nbytes(q, k, k, q, q, q) + rows)
    if entry == "swa_bwd_dkdv":
        return (4 * _product_ops(q, window),
                _build.nbytes(q, k, k, q, k, k) + rows)
    raise ValueError(f"unknown backward entry {entry!r}")


def swa_bwd_fold_work(partial: torch.Tensor, k: torch.Tensor
                      ) -> tuple[int, int]:
    """(operations, bytes) of one launch of ``swa_bwd_fold``: an add an
    element of the partial sums, which it reads once; dk and dv written
    once."""
    return partial.numel(), _build.nbytes(partial, k, k)


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    """The kernel takes any (batch, head, position) strides, but a unit
    stride along D."""
    return t if t.stride(-1) == 1 else t.contiguous()


def swa_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               window: int) -> torch.Tensor:
    """q: (B, Hq, S, D), k/v: (B, Hkv, S, D), float32/bfloat16 -> (B, Hq, S, D)
    in q's memory layout.  Launches K6 on a CUDA tensor; runs
    :func:`swa_ref` on a CPU one."""
    dtype_code = _build.check_grid(q, 4, "swa", strided=True, meta=True)
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device or t.dim() != 4:
            raise ValueError(f"swa: {name} must be a 4-d {q.dtype} tensor on "
                             f"{q.device}, got {t.dim()}-d {t.dtype} on "
                             f"{t.device}")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if k.shape != (b, hkv, s, d) or v.shape != k.shape or hq % hkv:
        raise ValueError(f"swa: q {tuple(q.shape)} and k/v {tuple(k.shape)}, "
                         f"{tuple(v.shape)} need k = v = (B, Hkv, S, D) with "
                         "Hq % Hkv == 0")
    if window < 1:
        raise ValueError(f"swa: window must be >= 1, got {window}")
    if q.device.type == "cpu":
        return swa_ref(q, k, v, window=window)
    if d > MAX_HEAD_DIM:
        raise ValueError(f"swa kernel takes head_dim <= {MAX_HEAD_DIM}, got {d}")
    # copies of any input without a unit D stride, held through the
    # launch, on meta as on the card
    q, k, v = _unit_last(q), _unit_last(k), _unit_last(v)
    out = torch.empty_like(q)           # q's layout where q is dense
    if q.device.type == "meta":
        if q.numel():
            _build.count_meta("swa", *swa_work(q, k, window))
        return out
    smem = smem_bytes(d, q.dtype)
    _build.require_smem(f"swa at head_dim {d}", smem, q.device)
    if out.numel() == 0:
        return out
    tensors = (q, k, v, out)
    strides = [st for t in tensors for st in t.stride()[:3]]
    per16 = 16 // q.element_size()      # elements in 16 bytes
    vec = int(d % per16 == 0 and all(st % per16 == 0 for st in strides)
              and all(t.data_ptr() % 16 == 0 for t in tensors))
    c_strides = (ctypes.c_int64 * 12)(*strides)
    with torch.cuda.device(q.device):
        _build.launch("swa", "swa", _ARGTYPES, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), dtype_code,
                      ctypes.addressof(c_strides), b, hq, hkv, s, d,
                      min(window, s), 1.0 / (d ** 0.5), vec, smem,
                      _build.stream_handle(q.device))
    return out


def _check_bwd(q, k, v, **like_q) -> int:
    """Validate the backward's inputs; returns the dtype code."""
    dtype_code = _build.check_grid(q, 4, "swa_bwd", strided=True, meta=True)
    b, hq, s, d = q.shape
    hkv = k.shape[1] if k.dim() == 4 else 0
    shapes = {"k": (b, hkv, s, d), "v": (b, hkv, s, d)}
    for name, t in (("k", k), ("v", v), *like_q.items()):
        shape = shapes.get(name, q.shape)
        if t.dtype != q.dtype or t.device != q.device or t.shape != shape:
            raise ValueError(f"swa_bwd: {name} must be a {q.dtype} tensor "
                             f"{tuple(shape)} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"swa_bwd: Hq {hq} must be a multiple of Hkv {hkv}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"swa kernel takes head_dim <= {MAX_HEAD_DIM}, got {d}")
    return dtype_code


def _bwd_launch(entry: str, tensors, lse, delta, dtype_code, q, hkv,
                window, partial: torch.Tensor | None = None,
                parts: int = 1) -> None:
    if q.device.type == "meta":
        _build.count_meta(entry, *swa_bwd_work(entry, q, tensors[1], window))
        return
    if q.device.type != "cuda":
        raise ValueError(f"{entry} launches a CUDA kernel and takes CUDA "
                         f"tensors (or meta ones), got {q.device} "
                         "(swa_bwd_kernel runs the plain version on CPU "
                         "ones)")
    b, hq, s, d = q.shape
    smem = bwd_smem_bytes(d, q.dtype)[entry]
    _build.require_smem(f"{entry} at head_dim {d}", smem, q.device)
    c_strides = (ctypes.c_int64 * 24)(*[
        st for t in tensors
        for st in (t.stride()[:3] if t is not None else (0, 0, 0))])
    # the entry's tensors: q, k, v, o, dO, dq or q, k, v, dO
    slots = (0, 1, 2, 4) if entry == "swa_bwd_dkdv" else range(6)
    ptrs = [tensors[i].data_ptr() for i in slots]
    extra, argtypes = [], _BWD_ARGTYPES
    if entry == "swa_bwd_dkdv":
        extra = [partial.data_ptr(), parts]
        argtypes = _DKDV_ARGTYPES
    with torch.cuda.device(q.device):
        _build.launch(entry, "swa_bwd", argtypes, *ptrs,
                      lse.data_ptr(), delta.data_ptr(), dtype_code,
                      ctypes.addressof(c_strides), b, hq, hkv, s, d,
                      min(window, s), 1.0 / (d ** 0.5), *extra, smem,
                      _build.stream_handle(q.device), entry=entry)


def swa_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               out: torch.Tensor, dout: torch.Tensor, *, window: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CUDA (or meta) tensors only: launches ``swa_bwd_dq`` -> (dq in q's
    layout, the rows' log-sum-exp and D = rowsum(dout * out), both (B, Hq,
    S) f32)."""
    dtype_code = _check_bwd(q, k, v, out=out, dout=dout)
    q, k, v, out, dout = (_unit_last(t) for t in (q, k, v, out, dout))
    dq = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    if q.numel():
        _bwd_launch("swa_bwd_dq", (q, k, v, out, dout, dq, None, None), lse,
                    delta, dtype_code, q, k.shape[1], window)
    return dq, lse, delta


def _check_dkdv(q, k, v, dout, lse, delta) -> int:
    dtype_code = _check_bwd(q, k, v, dout=dout)
    if lse.shape != q.shape[:3] or delta.shape != lse.shape or any(
            t.dtype != torch.float32 or not t.is_contiguous()
            for t in (lse, delta)):
        raise ValueError("swa_bwd_dkdv takes swa_bwd_dq's lse and delta: "
                         f"contiguous f32 {tuple(q.shape[:3])}")
    return dtype_code


def swa_bwd_dkdv_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         dout: torch.Tensor, lse: torch.Tensor,
                         delta: torch.Tensor, *, window: int) -> torch.Tensor:
    """CUDA (or meta) tensors only: launches ``swa_bwd_dkdv`` with
    :func:`swa_bwd_dq`'s ``lse`` and ``delta`` -> each part's f32 partial
    dK and dV, (2, parts, B, Hkv, S, D) with ``parts`` :func:`bwd_parts`."""
    dtype_code = _check_dkdv(q, k, v, dout, lse, delta)
    q, k, v, dout = (_unit_last(t) for t in (q, k, v, dout))
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    parts = bwd_parts(b, hkv, s, hq // hkv, q.dtype)
    partial = torch.empty((2, parts, b, hkv, s, d), dtype=torch.float32,
                          device=q.device)
    if q.numel():
        _bwd_launch("swa_bwd_dkdv", (q, k, v, None, dout, None, None, None),
                    lse, delta, dtype_code, q, hkv, window, partial, parts)
    elif q.device.type != "meta":
        partial.zero_()
    return partial


def swa_bwd_fold(partial: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) in k's type and k's and v's layouts: the sum over the
    parts, in order, of :func:`swa_bwd_dkdv_partial`'s ``partial``.
    Launches ``swa_bwd_fold`` on a CUDA tensor; runs
    :func:`swa_bwd_fold_ref` on a CPU one."""
    if (partial.dim() != 6 or partial.shape[0] != 2
            or partial.shape[2:] != k.shape or v.shape != k.shape
            or partial.dtype != torch.float32 or not partial.is_contiguous()
            or k.dtype not in _build.DTYPE_CODES or v.dtype != k.dtype
            or len({t.device for t in (partial, k, v)}) != 1):
        raise ValueError("swa_bwd_fold takes contiguous f32 partial sums "
                         "(2, parts, B, Hkv, S, D) and f32 or bf16 k and v "
                         f"(B, Hkv, S, D) on one device, got "
                         f"{tuple(partial.shape)} {partial.dtype} and "
                         f"{tuple(k.shape)} {k.dtype}")
    if partial.device.type == "cpu":
        return swa_bwd_fold_ref(partial, k.dtype)
    dk, dv = torch.empty_like(_unit_last(k)), torch.empty_like(_unit_last(v))
    if partial.device.type == "meta":
        if dk.numel():
            _build.count_meta("swa_bwd_fold", *swa_bwd_fold_work(partial, k))
        return dk, dv
    if dk.numel():
        b, hkv, s, d = k.shape
        c_strides = (ctypes.c_int64 * 6)(*dk.stride()[:3], *dv.stride()[:3])
        with torch.cuda.device(k.device):
            _build.launch("swa_bwd_fold", "swa_bwd", _FOLD_ARGTYPES,
                          partial.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                          _build.DTYPE_CODES[k.dtype],
                          ctypes.addressof(c_strides), b, hkv, s, d,
                          partial.shape[1], _build.stream_handle(k.device),
                          entry="swa_bwd_fold")
    return dk, dv


def swa_bwd_dkdv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 *, window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA (or meta) tensors only: launches ``swa_bwd_dkdv`` with
    :func:`swa_bwd_dq`'s ``lse`` and ``delta`` -> (dk, dv) in k's and v's
    layouts: the kernel writes partial sums (:func:`swa_bwd_dkdv_partial`)
    and ``swa_bwd_fold`` adds them (:func:`swa_bwd_fold`)."""
    return swa_bwd_fold(swa_bwd_dkdv_partial(q, k, v, dout, lse, delta,
                                             window=window), k, v)


def swa_bwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, dout: torch.Tensor, *, window: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`swa_kernel`'s output ``out`` for q, k, v, with
    ``dout`` its gradient (out's shape and type), each in its input's
    memory layout.  On CUDA tensors launches ``swa_bwd_dq``, then
    ``swa_bwd_dkdv`` and ``swa_bwd_fold``; on CPU ones runs
    :func:`swa_bwd_ref`."""
    if window < 1:
        raise ValueError(f"swa_bwd: window must be >= 1, got {window}")
    if q.device.type == "cpu":
        _check_bwd(q, k, v, out=out, dout=dout)
        return swa_bwd_ref(q, k, v, dout, window=window)
    dq, lse, delta = swa_bwd_dq(q, k, v, out, dout, window=window)
    dk, dv = swa_bwd_dkdv(q, k, v, dout, lse, delta, window=window)
    return dq, dk, dv
