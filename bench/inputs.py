"""The inputs of a run, made from its seed: the taps of a configuration and
the fields a cell starts from.

Taps are drawn symmetric about the centre, as a central-difference seismic
or diffusion stencil's are, with the centre counted once, on the first axis
(the cx and cy centres are zero, as ``repro_torch.core.spec`` has them).
They are then scaled so that one step, with its rim held at zero, has the
configuration's spectral radius, just under 1: an explicit scheme run just
inside its stability limit, with a little damping.  Tens of thousands of
chained steps then neither overflow nor reach subnormal values, and still
no chunk returns its input: the slowest mode shrinks by ``radius ** 32``
in 32 steps, so a call that skipped its work would show.  With the rim masked,
a step is the Kronecker sum of one banded symmetric Toeplitz matrix per
axis over that axis's interior, so its eigenvalues are sums of theirs.
The taps are rounded to float32, the type the kernels take, so the program
and the reference get the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch


def axis_eigen_range(c: np.ndarray, n: int) -> tuple[float, float]:
    """Least and greatest eigenvalue of one axis's step on its interior of
    ``n - 2r`` points: the symmetric band matrix with ``c[r + k]`` on
    diagonal ``k``."""
    r = (len(c) - 1) // 2
    m = n - 2 * r
    a = np.zeros((m, m))
    i = np.arange(m)
    for k in range(-r, r + 1):
        j = i[max(0, -k):m - max(0, k)]
        a[j, j + k] = c[r + k]
    w = np.linalg.eigvalsh(a)
    return float(w[0]), float(w[-1])


def star_taps(grid, radii, radius: float,
              seed: int) -> tuple[tuple[float, ...], ...]:
    """Symmetric taps per axis for fields of ``grid``, drawn from ``seed``,
    scaled to the spectral radius ``radius`` and rounded to float32."""
    rng = np.random.default_rng([int(seed), 1])
    taps = []
    for ax, r in enumerate(radii):
        half = rng.normal(size=r + 1)
        c = np.concatenate([half[:0:-1], half])
        if ax:
            c[r] = 0.0
        taps.append(c)
    lo, hi = (sum(v) for v in zip(*(axis_eigen_range(c, n)
                                    for c, n in zip(taps, grid))))
    rho = max(hi, -lo)
    return tuple(tuple(float(v) for v in (c * radius / rho).astype(np.float32))
                 for c in taps)


def fields(shape, dtype: torch.dtype, seed: int,
           device: torch.device) -> torch.Tensor:
    """Standard normal fields of ``shape`` from ``seed``, made on the device
    in one call, in float32, then cast to ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    x = torch.randn(tuple(shape), generator=gen, device=device,
                    dtype=torch.float32)
    return x.to(dtype)


def check_fractions(seed: int, n: int) -> list[float]:
    """Where in the window the ``n`` chunks compared besides the first
    begin, as sorted shares of the window, drawn from ``seed``."""
    return sorted(np.random.default_rng([int(seed), 2]).uniform(size=n).tolist())


def check_sample(seed: int, batch: int, chunks: int, per_chunk: int) -> list[list[int]]:
    """For each of ``chunks`` compared chunks, the ``per_chunk`` fields of
    the batch (all of them where the batch is smaller) whose outputs and
    receiver lines are compared, sorted, drawn from ``seed`` without
    repeats within a chunk."""
    rng = np.random.default_rng([int(seed), 3])
    n = min(per_chunk, batch)
    return [sorted(rng.choice(batch, size=n, replace=False).tolist())
            for _ in range(chunks)]
