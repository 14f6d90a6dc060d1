"""Torch oracle for the batched 3D star stencil (port of
``repro.kernels.stencil3d.ref``), and the plain version of one K4 launch.

``out[..., z, y, x] = sum_a cz[a]·in[z-rz+a, y, x] + sum_b cy[b]·in[z, y-ry+b, x]
                      + sum_c cx[c]·in[z, y, x-rx+c]``
on fully-supported positions after ``timesteps`` fused sweeps; zero rim.
cz carries the centre coefficient; cy/cx centres are normally zero.
"""
from __future__ import annotations

import torch

from repro_torch.core.reference import _shift, acc_dtype


def stencil3d_sweep_ref(x: torch.Tensor, cz: tuple[float, ...],
                        cy: tuple[float, ...], cx: tuple[float, ...],
                        step: int = 1) -> torch.Tensor:
    """Sweep number ``step`` (1-based): one star sweep summed in float32 for
    bf16/f16 inputs, zero within ``r·step`` of every face, cast to
    ``x.dtype`` — what one launch of the 3D kernel computes."""
    rz, ry, rx = ((len(c) - 1) // 2 for c in (cz, cy, cx))
    nz, ny, nx = x.shape[-3], x.shape[-2], x.shape[-1]
    acc = acc_dtype(x.dtype)
    xo = x.to(acc)
    o = torch.zeros(x.shape, dtype=acc, device=x.device)
    for axis, (r, coeffs) in zip((-3, -2, -1), ((rz, cz), (ry, cy), (rx, cx))):
        for k, c in enumerate(coeffs):
            if c != 0.0:
                o = o + c * _shift(xo, k - r, axis)
    zz = torch.arange(nz, device=x.device)[:, None, None]
    yy = torch.arange(ny, device=x.device)[None, :, None]
    xx = torch.arange(nx, device=x.device)[None, None, :]
    t = step
    valid = ((zz >= rz * t) & (zz < nz - rz * t) &
             (yy >= ry * t) & (yy < ny - ry * t) &
             (xx >= rx * t) & (xx < nx - rx * t))
    return torch.where(valid, o, 0.0).to(x.dtype)


def stencil3d_ref(x: torch.Tensor, cz: tuple[float, ...], cy: tuple[float, ...],
                  cx: tuple[float, ...], timesteps: int = 1) -> torch.Tensor:
    out = x
    for t in range(1, timesteps + 1):
        out = stencil3d_sweep_ref(out, cz, cy, cx, t)
    return out
