"""Wrapper of the hand-written CUDA kernel K5 in ``csrc/conv1d.cu``, which
replaces ``repro.kernels.conv1d.kernel``'s ``conv1d_pallas``.

One thread per channel walks ``SEQ_TILE`` sequence positions with the K
taps and the K-1 previous inputs in registers; the kernel zero-fills before
position 0 and reads its left halo from the previous tile's rows itself, so
nothing is padded.  It sums in float32 and stores in ``x.dtype``; the bias is
added by ``ops.causal_conv1d``.  On a CPU tensor the wrapper runs the plain
version, :func:`conv1d_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv1d.ref import conv1d_ref

MAX_TAPS = 32      # the widest register window conv1d.cu is instantiated for
SEQ_TILE = 64      # sequence positions per thread (kSeqTile in conv1d.cu)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
             ctypes.c_void_p]


def conv1d_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C) float32/bfloat16, w: (K, C) of the same type -> (B, S, C)
    in ``x.dtype``, no bias.  Launches K5 on a CUDA tensor; runs
    :func:`conv1d_ref` on a CPU one."""
    dtype_code = _build.check_grid(x, 3, "conv1d")
    if w.dim() != 2 or w.shape[1] != x.shape[2] or w.dtype != x.dtype:
        raise ValueError(f"conv1d takes taps (K, {x.shape[2]}) of type "
                         f"{x.dtype}, got {tuple(w.shape)} {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"conv1d: taps on {w.device}, input on {x.device}")
    if x.device.type == "cpu":
        return conv1d_ref(x, w)
    _build.check_no_grad("conv1d", x, w)
    kk = w.shape[0]
    if not 1 <= kk <= MAX_TAPS:
        raise ValueError(f"conv1d kernel takes 1 to {MAX_TAPS} taps, got {kk}")
    w = w.contiguous()
    b, s, c = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        _build.launch("conv1d", "conv1d", _ARGTYPES, x.data_ptr(),
                      w.data_ptr(), out.data_ptr(), dtype_code, b, s, c, kk,
                      _build.stream_handle(x.device))
    return out
