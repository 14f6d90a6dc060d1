"""Torch oracle for the batched 2D star stencil (port of
``repro.kernels.stencil2d.ref``), and the plain version the K3 wrapper runs
on CPU tensors.

``out[..., j, i] = sum_a cy[a] * x[..., j-ry+a, i] + sum_b cx[b] * x[..., j, i-rx+b]``
on fully-supported positions after ``timesteps`` fused sweeps; zero elsewhere.
Axis convention follows the paper: axis -2 = y (rows, ``j``), axis -1 = x
(cols, ``i``).  cy carries the (single) centre coefficient; cx's centre entry
is normally zero (see core.spec).
"""
from __future__ import annotations

import torch

from repro_torch.core.reference import _shift, acc_dtype


def stencil2d_ref(x: torch.Tensor, cy: tuple[float, ...], cx: tuple[float, ...],
                  timesteps: int = 1) -> torch.Tensor:
    ry = (len(cy) - 1) // 2
    rx = (len(cx) - 1) // 2
    ny, nx = x.shape[-2], x.shape[-1]
    acc = acc_dtype(x.dtype)
    jj = torch.arange(ny, device=x.device)[:, None]
    ii = torch.arange(nx, device=x.device)[None, :]
    out = x
    for t in range(1, timesteps + 1):
        xo = out.to(acc)
        o = torch.zeros(out.shape, dtype=acc, device=x.device)
        for a, c in enumerate(cy):
            if c != 0.0:
                o = o + c * _shift(xo, a - ry, -2)
        for b, c in enumerate(cx):
            if c != 0.0:
                o = o + c * _shift(xo, b - rx, -1)
        valid = ((jj >= ry * t) & (jj < ny - ry * t) &
                 (ii >= rx * t) & (ii < nx - rx * t))
        out = torch.where(valid, o, 0.0).to(x.dtype)
    return out
