"""Wrapper of the hand-written CUDA kernel K6 in ``csrc/swa.cu``, which
replaces ``repro.kernels.swa.kernel``'s ``swa_pallas``.

bfloat16 runs on the tensor cores: one block of two warpgroups per (batch,
query head, 128-query tile) computes QKᵀ and P·V with ``wgmma`` out of bf16
tiles in shared memory (Q, and a two-stage ring of 64-key K/V tiles filled
by ``cp.async``, all in the 128-byte swizzle).  float32 runs on the CUDA
cores, one block of 8 warps per 64 queries walking 32-key tiles, because
its 2e-5 limit rules out bf16 and TF32 products.  Both mask by the true
sequence length, so nothing is padded, and both read q, k, v and write the
output through (batch, head, position) strides, so a (B, S, H, D) tensor
viewed as (B, H, S, D) goes in without a copy and the output takes q's
layout.  Shared memory is :func:`smem_bytes`.  On a CPU tensor the wrapper
runs the plain version, :func:`swa_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.swa.ref import swa_ref

F32_BLOCK_Q, F32_BLOCK_K, F32_WARPS = 64, 32, 8   # kBQ, kBK, kWarps in swa.cu
WG_BLOCK_Q, WG_BLOCK_K = 128, 64                  # kWQ, kWK in swa.cu
MAX_HEAD_DIM = 256
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_size_t,
             ctypes.c_void_p]


def smem_bytes(head_dim: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of one block, laid out as swa.cu uses it: for
    bf16, Q and two (K, V) stages with D zero-filled to 64, 128 or 256, and
    1024 bytes to align the swizzled tiles; for f32, Q, Kᵀ, V and the
    probability strips."""
    if dtype == torch.bfloat16:
        dp = next(p for p in (64, 128, 256) if head_dim <= p)
        return 2 * (WG_BLOCK_Q + 4 * WG_BLOCK_K) * dp + 1024
    dp = (head_dim + 3) // 4 * 4
    return 4 * (F32_BLOCK_Q * dp + dp * (F32_BLOCK_K + 1) + F32_BLOCK_K * dp
                + F32_WARPS * (F32_BLOCK_Q // F32_WARPS) * F32_BLOCK_K)


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    """The kernel takes any (batch, head, position) strides, but a unit
    stride along D."""
    return t if t.stride(-1) == 1 else t.contiguous()


def swa_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               window: int) -> torch.Tensor:
    """q: (B, Hq, S, D), k/v: (B, Hkv, S, D), float32/bfloat16 -> (B, Hq, S, D)
    in q's memory layout.  Launches K6 on a CUDA tensor; runs
    :func:`swa_ref` on a CPU one."""
    dtype_code = _build.check_grid(q, 4, "swa", strided=True)
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
    _build.check_no_grad("swa", q, k, v)
    if d > MAX_HEAD_DIM:
        raise ValueError(f"swa kernel takes head_dim <= {MAX_HEAD_DIM}, got {d}")
    smem = smem_bytes(d, q.dtype)
    _build.require_smem(f"swa at head_dim {d}", smem, q.device)
    q, k, v = _unit_last(q), _unit_last(k), _unit_last(v)
    out = torch.empty_like(q)           # q's layout where q is dense
    if out.numel() == 0:
        return out
    tensors = (q, k, v, out)
    strides = [st for t in tensors for st in t.stride()[:3]]
    vec = int(d % 8 == 0 and all(st % 8 == 0 for st in strides)
              and all(t.data_ptr() % 16 == 0 for t in tensors))
    c_strides = (ctypes.c_int64 * 12)(*strides)
    with torch.cuda.device(q.device):
        _build.launch("swa", "swa", _ARGTYPES, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), dtype_code,
                      ctypes.addressof(c_strides), b, hq, hkv, s, d,
                      min(window, s), 1.0 / (d ** 0.5), vec, smem,
                      _build.stream_handle(q.device))
    return out
