"""Torch oracle for star stencils (any rank, any radius, fused timesteps).

The port of ``repro.core.reference``: the semantic ground truth the port's
kernels are tested against, on whatever device the input tensor lies.

Boundary convention: outputs are computed only where the stencil has full
support; the ``radius``-wide rim of the output grid is zero.  This matches the
paper's data-filtering discipline (boundary values are *dropped*, §III-A) and
keeps single-device and halo-exchanged results bit-comparable.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.spec import StencilSpec


def _shift(x: torch.Tensor, offset: int, axis: int) -> torch.Tensor:
    """x shifted by ``offset`` along ``axis`` with zero fill (roll minus wrap):
    ``y[..., i, ...] = x[..., i + offset, ...]`` where that index exists."""
    if offset == 0:
        return x
    y = torch.zeros_like(x)
    keep = x.shape[axis] - abs(offset)
    if keep <= 0:
        return y
    if offset > 0:  # tap at i+offset -> pull data left
        y.narrow(axis, 0, keep).copy_(x.narrow(axis, offset, keep))
    else:
        y.narrow(axis, -offset, keep).copy_(x.narrow(axis, 0, keep))
    return y


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The kernel oracles' summation type: float32 for bf16/f16 inputs."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def _interior_mask(shape: tuple[int, ...], radii: tuple[int, ...],
                   steps: int) -> np.ndarray:
    mask = np.ones(shape, dtype=bool)
    for ax, r in enumerate(radii):
        if r * steps == 0:
            continue
        idx = np.arange(shape[ax])
        ok = (idx >= r * steps) & (idx < shape[ax] - r * steps)
        mask &= np.expand_dims(ok, tuple(i for i in range(len(shape)) if i != ax))
    return mask


def stencil_sweep(x: torch.Tensor, spec: StencilSpec) -> torch.Tensor:
    """One star-stencil sweep; no boundary masking (callers mask).  Sums in
    ``x.dtype`` (unlike the kernel oracles, bf16 is not promoted)."""
    acc = torch.zeros_like(x)
    for ax, (r, coeffs) in enumerate(zip(spec.radii, spec.coeffs)):
        for k, c in enumerate(coeffs):
            if c == 0.0:
                continue
            acc = acc + c * _shift(x, k - r, ax)
    return acc


def stencil_reference(x: torch.Tensor, spec: StencilSpec) -> torch.Tensor:
    """``spec.timesteps`` fused sweeps with support-only outputs.

    After step t, only points with distance >= r*(t+1) from every face hold
    valid values; everything else is zeroed so that invalid values never
    propagate into the valid region's support.

    Returns a tensor of ``spec.grid_shape`` whose interior (shrunk by
    r*timesteps per face) is valid and whose rim is zero.
    """
    out = x
    for t in range(spec.timesteps):
        out = stencil_sweep(out, spec)
        mask = torch.from_numpy(
            _interior_mask(spec.grid_shape, spec.radii, t + 1)).to(x.device)
        out = torch.where(mask, out, torch.zeros_like(out))
    return out


def stencil_reference_np(x: np.ndarray, spec: StencilSpec) -> np.ndarray:
    """numpy twin of :func:`stencil_reference` (no torch involvement)."""
    out = x.astype(np.float64 if spec.dtype == "float64" else np.float32)
    for t in range(spec.timesteps):
        acc = np.zeros_like(out)
        for ax, (r, coeffs) in enumerate(zip(spec.radii, spec.coeffs)):
            for k, c in enumerate(coeffs):
                if c == 0.0:
                    continue
                acc += c * np.asarray(_np_shift(out, k - r, ax))
        mask = _interior_mask(spec.grid_shape, spec.radii, t + 1)
        out = np.where(mask, acc, 0.0)
    return out


def _np_shift(x: np.ndarray, offset: int, axis: int) -> np.ndarray:
    if offset == 0:
        return x
    y = np.zeros_like(x)
    src = [slice(None)] * x.ndim
    dst = [slice(None)] * x.ndim
    if offset > 0:
        src[axis] = slice(offset, None)
        dst[axis] = slice(0, x.shape[axis] - offset)
    else:
        src[axis] = slice(0, x.shape[axis] + offset)
        dst[axis] = slice(-offset, None)
    y[tuple(dst)] = x[tuple(src)]
    return y
