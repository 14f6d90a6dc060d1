"""Wrapper of the hand-written CUDA kernel K6 in ``csrc/swa.cu``, which
replaces ``repro.kernels.swa.kernel``'s ``swa_pallas``.

One block of 256 threads per (batch, query head, 64-query tile) walks the
32-key tiles of its band with an online softmax in float32; the kernel masks
by the true sequence length, so nothing is padded.  Its shared memory is
:func:`smem_bytes` (140,288 B at D = 256).  On a CPU tensor the wrapper runs
the plain version, :func:`swa_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.swa.ref import swa_ref

BLOCK_Q, BLOCK_K, WARPS = 64, 32, 8     # kBQ, kBK, kWarps in swa.cu
MAX_HEAD_DIM = 256
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_size_t, ctypes.c_void_p]


def smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one block, laid out as swa.cu uses it."""
    dp = (head_dim + 3) // 4 * 4
    return 4 * (BLOCK_Q * dp + dp * (BLOCK_K + 1) + BLOCK_K * dp
                + WARPS * (BLOCK_Q // WARPS) * BLOCK_K)


def swa_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               window: int) -> torch.Tensor:
    """q: (B, Hq, S, D), k/v: (B, Hkv, S, D), float32/bfloat16 -> (B, Hq, S, D).
    Launches K6 on a CUDA tensor; runs :func:`swa_ref` on a CPU one."""
    dtype_code = _build.check_grid(q, 4, "swa")
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
    smem = smem_bytes(d)
    _build.require_smem(f"swa at head_dim {d}", smem, q.device)
    k, v = k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        _build.launch("swa", "swa", _ARGTYPES, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), dtype_code, b, hq, hkv, s,
                      d, min(window, s), 1.0 / (d ** 0.5), smem,
                      _build.stream_handle(q.device))
    return out
