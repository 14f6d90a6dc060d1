"""Stencil problem specification.

The paper (§II-B, §III) works with *star* stencils: an output point depends on
the input point at the same location plus ``radius`` neighbours in each
direction *along each axis* (no diagonal taps).  A (2r+1)-point 1D stencil has
taps ``in[i-r] .. in[i+r]``; the 5-point 2D Jacobian has taps along x and y.

``StencilSpec`` is the single source of truth consumed by:
  * the torch oracle              (core/reference.py)
  * the tile planner              (core/mapping/blocks.py)
  * the CUDA kernels              (kernels/stencil1d, kernels/stencil2d)

A copy of ``repro.core.spec``: that module is numpy-only, but importing it
pulls in jax through ``repro.core``'s package init, so the port keeps its own.
:func:`spec_from_fields` rebuilds a spec from another package's fields.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

_ITEMSIZE = {"float32": 4, "float64": 8, "bfloat16": 2}


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """A star stencil over an N-D grid.

    Attributes:
      grid_shape: input grid extents, e.g. ``(194400,)`` or ``(449, 960)``.
        Axis order is row-major (y before x for 2D, matching the paper's
        ``in[j][i]`` indexing: axis 0 = j/y, axis 1 = i/x).
      radii: per-axis radius ``r``; taps span ``[-r, +r]`` on each axis.
      coeffs: per-axis tap coefficients, each of length ``2*r+1``.  The centre
        tap of every axis multiplies the centre point; following the paper's
        separable formulation the centre contribution is counted **once** (the
        first axis keeps its centre coefficient; subsequent axes have their
        centre coefficient forced to zero at construction if ``share_center``).
      dtype: numpy dtype string for the data ("float32"/"float64"/"bfloat16").
      timesteps: number of fused time-steps (§IV); 1 = single sweep.
    """

    grid_shape: tuple[int, ...]
    radii: tuple[int, ...]
    coeffs: tuple[tuple[float, ...], ...]
    dtype: str = "float32"
    timesteps: int = 1

    def __post_init__(self):
        if len(self.grid_shape) != len(self.radii):
            raise ValueError("grid_shape and radii rank mismatch")
        if len(self.coeffs) != len(self.radii):
            raise ValueError("coeffs and radii rank mismatch")
        for r, c in zip(self.radii, self.coeffs):
            if len(c) != 2 * r + 1:
                raise ValueError(f"axis with radius {r} needs {2*r+1} coeffs, got {len(c)}")
        if self.timesteps < 1:
            raise ValueError("timesteps must be >= 1")
        for n, r in zip(self.grid_shape, self.radii):
            if n <= 2 * r * self.timesteps:
                raise ValueError(
                    f"grid extent {n} too small for radius {r} x {self.timesteps} steps")

    # ----- derived quantities -------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.grid_shape)

    @property
    def points(self) -> int:
        """Number of taps: (2*r0+1) + sum_axis>0 (2*r+1 - 1) for star stencils."""
        n = 2 * self.radii[0] + 1
        for r in self.radii[1:]:
            n += 2 * r  # centre tap shared with axis 0
        return n

    @property
    def interior_shape(self) -> tuple[int, ...]:
        """Output region with full support (one time-step)."""
        return tuple(n - 2 * r for n, r in zip(self.grid_shape, self.radii))

    @property
    def interior_shape_fused(self) -> tuple[int, ...]:
        """Output region with full support after ``timesteps`` fused sweeps."""
        t = self.timesteps
        return tuple(n - 2 * r * t for n, r in zip(self.grid_shape, self.radii))

    @property
    def bytes_per_elem(self) -> int:
        return _ITEMSIZE.get(self.dtype) or np.dtype(self.dtype).itemsize

    @property
    def flops_per_output(self) -> int:
        """MULs+MACs per output point, counted the paper's way (§VI).

        A (2r+1)-pt 1D stencil = 1 MUL + 2r MAC = (2*(2r)+1) flops.
        A 2D star with rx=ry=r = 1 MUL + 4r MAC = (2*(4r)+1) flops
        (paper: 49-pt, r=12 -> 48 MAC + 1 MUL -> 97 flops).
        """
        macs = sum(2 * r for r in self.radii)
        return 2 * macs + 1

    @property
    def macs_per_worker(self) -> int:
        """MAC-chain length of one compute worker (MUL counted as a MAC PE slot)."""
        return sum(2 * r for r in self.radii) + 1

    def total_flops(self, timesteps: int | None = None) -> int:
        """Flops of ``timesteps`` fused sweeps: each sweep computes only the
        outputs with full support, so sweep ``k`` covers the interior shrunk
        by ``r*(k+1)`` per face (matches ``arithmetic_intensity_fused``)."""
        t = self.timesteps if timesteps is None else timesteps
        if t < 1:
            raise ValueError(f"timesteps must be >= 1, got {t}")
        return self.flops_per_output * sum(
            math.prod(tuple(max(0, n - 2 * r * (k + 1))
                            for n, r in zip(self.grid_shape, self.radii)))
            for k in range(t))

    def arithmetic_intensity(self) -> float:
        """Flops/byte exactly as §VI computes it: interior flops over one full
        read + one full write of the grid (single sweep)."""
        bytes_moved = 2 * math.prod(self.grid_shape) * self.bytes_per_elem
        return self.total_flops(1) / bytes_moved

    def arithmetic_intensity_fused(self) -> float:
        """AI of the ``timesteps``-fused sweep (§IV beyond-paper): T sweeps of
        flops (:meth:`total_flops`) for one read + one write."""
        bytes_moved = 2 * math.prod(self.grid_shape) * self.bytes_per_elem
        return self.total_flops() / bytes_moved


# --- the paper's two benchmark stencils (§VI) --------------------------------
def paper_stencil_1d(n: int = 194400, rx: int = 8, dtype: str = "float64") -> StencilSpec:
    """17-pt 1D stencil, grid 194400, rx=8 (paper §VI 'Stencil 1D')."""
    rng = np.random.default_rng(0)
    coeffs = tuple(float(c) for c in rng.normal(size=2 * rx + 1) / (2 * rx + 1))
    return StencilSpec((n,), (rx,), (coeffs,), dtype=dtype)


def paper_stencil_2d(ny: int = 449, nx: int = 960, r: int = 12,
                     dtype: str = "float64") -> StencilSpec:
    """49-pt 2D star stencil, grid 960x449, rx=ry=12 (oil/gas seismic, §VI)."""
    rng = np.random.default_rng(1)
    cy = rng.normal(size=2 * r + 1) / (4 * r + 1)
    cx = rng.normal(size=2 * r + 1) / (4 * r + 1)
    cx[r] = 0.0  # centre tap counted once, on axis 0
    return StencilSpec((ny, nx), (r, r),
                       (tuple(map(float, cy)), tuple(map(float, cx))), dtype=dtype)


def heat_2d(ny: int, nx: int, alpha: float = 0.1, dtype: str = "float32") -> StencilSpec:
    """5-pt Jacobi heat step: u += alpha * laplacian(u)."""
    cy = (alpha, 1.0 - 4.0 * alpha, alpha)
    cx = (alpha, 0.0, alpha)
    return StencilSpec((ny, nx), (1, 1), (cy, cx), dtype=dtype)


def heat_3d(nz: int, ny: int, nx: int, alpha: float = 0.1,
            dtype: str = "float32") -> StencilSpec:
    """7-pt Jacobi heat step: u += alpha * laplacian(u) over (z, y, x)."""
    cz = (alpha, 1.0 - 6.0 * alpha, alpha)
    cyx = (alpha, 0.0, alpha)
    return StencilSpec((nz, ny, nx), (1, 1, 1), (cz, cyx, cyx), dtype=dtype)


def star_3d(nz: int, ny: int, nx: int, r: int = 2, seed: int = 2,
            dtype: str = "float64") -> StencilSpec:
    """(6r+1)-pt 3D star with random coefficients (centre counted on axis 0)."""
    rng = np.random.default_rng(seed)
    cz, cy, cx = (rng.normal(size=2 * r + 1) / (6 * r + 1) for _ in range(3))
    cy[r] = 0.0
    cx[r] = 0.0
    return StencilSpec((nz, ny, nx), (r, r, r),
                       (tuple(map(float, cz)), tuple(map(float, cy)),
                        tuple(map(float, cx))), dtype=dtype)


def spec_from_fields(grid_shape, radii, coeffs, dtype: str = "float32",
                     timesteps: int = 1) -> StencilSpec:
    """A :class:`StencilSpec` from plain fields, e.g. those of a
    ``repro.core.spec.StencilSpec`` (``dataclasses.asdict`` gives them)."""
    return StencilSpec(tuple(int(n) for n in grid_shape),
                       tuple(int(r) for r in radii),
                       tuple(tuple(float(c) for c in cs) for cs in coeffs),
                       dtype=str(dtype), timesteps=int(timesteps))
