"""The plain reference of the benchmark's star stencils, in plain PyTorch.

One call of the port's star ops (``stencil1d``, ``stencil2d``,
``stencil3d``) with ``timesteps`` T on fields over the last N axes:
sweep ``t`` (1-based) of the call writes

    out[p] = sum over axes a, offsets k in [-r_a, r_a] of c_a[k + r_a] * in[p + k e_a]

at every point ``p`` at least ``r_a * t`` from each face of axis ``a``, and
zero elsewhere; the next sweep reads that output.  The reference works in
the precision of its input (the benchmark hands it float64) and knows
nothing of the program's tiles, kernels or outputs.
"""
from __future__ import annotations

import torch


def star_sweep(x: torch.Tensor, coeffs, t: int) -> torch.Tensor:
    """Sweep ``t`` of a call over the last ``len(coeffs)`` axes of ``x``."""
    nd = len(coeffs)
    shape = x.shape[-nd:]
    rs = [(len(c) - 1) // 2 for c in coeffs]
    inner = tuple(slice(r * t, n - r * t) for r, n in zip(rs, shape))
    out = torch.zeros_like(x)
    dst = out[(..., *inner)]
    for ax, (r, cs) in enumerate(zip(rs, coeffs)):
        for k, c in enumerate(cs):
            if c == 0.0:
                continue
            src = list(inner)
            s = inner[ax]
            src[ax] = slice(s.start + k - r, s.stop + k - r)
            dst.add_(x[(..., *src)], alpha=float(c))
    return out


def star_call(x: torch.Tensor, coeffs, timesteps: int) -> torch.Tensor:
    """One call of the op: ``timesteps`` sweeps, sweep ``t`` zero within
    ``r * t`` of every face."""
    for t in range(1, timesteps + 1):
        x = star_sweep(x, coeffs, t)
    return x


def star_chunk(x: torch.Tensor, coeffs, timesteps: int, calls: int,
               axis: int, index: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``calls`` calls in a row, each output the next call's input: the last
    output, and the plane ``index`` along ``axis`` of every call's output,
    stacked (the receiver lines a chunk records)."""
    planes = []
    for _ in range(calls):
        x = star_call(x, coeffs, timesteps)
        planes.append(x.select(axis, index))
    return x, torch.stack(planes)


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest gap between ``got`` and ``want``, as a share of the largest
    ``|want|``; infinite where ``got`` is not finite or ``want`` is all zero."""
    scale = want.abs().max().item()
    diff = (got.to(want.dtype) - want).abs().max().item()
    if not (scale > 0 and diff == diff and diff != float("inf")):
        return float("inf")
    return diff / scale
