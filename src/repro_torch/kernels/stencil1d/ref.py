"""Torch oracle for the batched 1D star stencil (port of
``repro.kernels.stencil1d.ref``), and the plain version the K1/K2 wrappers
run on CPU tensors.

Semantics: ``out[b, i] = sum_k coeffs[k] * x[b, i - r + k]`` for positions with
full support after ``timesteps`` fused sweeps; everything else is zero (the
paper's boundary-drop discipline).  Matches ``repro_torch.core.reference``
for batch=1.  bf16/f16 inputs are summed in float32 and rounded back to the
input type after every sweep.
"""
from __future__ import annotations

import torch

from repro_torch.core.reference import _shift, acc_dtype


def stencil1d_ref(x: torch.Tensor, coeffs: tuple[float, ...],
                  timesteps: int = 1) -> torch.Tensor:
    """x: (..., N) -> (..., N); stencil along the last axis."""
    r = (len(coeffs) - 1) // 2
    n = x.shape[-1]
    acc = acc_dtype(x.dtype)
    idx = torch.arange(n, device=x.device)
    out = x
    for t in range(1, timesteps + 1):
        xo = out.to(acc)
        o = torch.zeros(out.shape, dtype=acc, device=x.device)
        for k, c in enumerate(coeffs):
            if c == 0.0:
                continue
            o = o + c * _shift(xo, k - r, -1)
        valid = (idx >= r * t) & (idx < n - r * t)
        out = torch.where(valid, o, 0.0).to(x.dtype)
    return out
