"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU (sm_90a) and ``nvcc``: a CUDA kernel has no CPU mode, so
every test here skips on a host without a card.  On the card, run
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
Tolerances: ``TOL`` of ``tests/test_kernels.py`` (f32 2e-5, bf16 3e-2).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, stencil1d, stencil2d, stencil3d
from repro_torch.kernels.stencil1d.ref import stencil1d_ref
from repro_torch.kernels.stencil2d.ref import stencil2d_ref
from repro_torch.kernels.stencil3d.ref import stencil3d_ref

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs an NVIDIA GPU: the CUDA kernels have no "
                              "CPU mode"),
]

TOL = {"float32": 2e-5, "bfloat16": 3e-2}

# the sweeps of tests/test_kernels.py, plus ragged and wider cases
CASES_1D = [
    (4, 256, 1, 1, "vpu", "float32"),
    (4, 256, 2, 1, "mxu", "float32"),
    (2, 384, 8, 1, "vpu", "float32"),
    (2, 384, 3, 2, "vpu", "float32"),
    (2, 384, 3, 2, "mxu", "float32"),
    (1, 200, 1, 3, "vpu", "float32"),
    (3, 1000, 5, 2, "vpu", "float32"),
    (2, 256, 2, 1, "vpu", "bfloat16"),
    (2, 256, 2, 2, "mxu", "bfloat16"),
    (7, 5003, 8, 3, "mxu", "float32"),
    (5, 4099, 12, 2, "vpu", "float32"),
    (9, 777, 2, 1, "mxu", "bfloat16"),
    (2, 3000, 4, 40, "vpu", "float32"),     # halo 160 wider than a 128 tile
    (2, 3000, 4, 40, "mxu", "float32"),
]
CASES_2D = [
    (1, 64, 128, 1, 1, 1, "float32"),
    (2, 64, 128, 2, 3, 1, "float32"),
    (1, 48, 96, 1, 1, 2, "float32"),
    (1, 72, 160, 2, 2, 3, "float32"),
    (2, 40, 140, 3, 1, 1, "float32"),
    (1, 64, 128, 1, 1, 2, "bfloat16"),
    (3, 113, 240, 12, 12, 4, "float32"),
]
CASES_3D = [
    (1, 16, 16, 128, 1, 1, 1, 1, "float32"),
    (2, 16, 32, 128, 2, 1, 3, 1, "float32"),
    (1, 24, 16, 128, 1, 2, 1, 2, "float32"),
    (1, 16, 16, 128, 1, 1, 1, 1, "bfloat16"),
    (2, 37, 19, 70, 2, 2, 2, 3, "float32"),
]


@pytest.fixture
def dev():
    return torch.device("cuda")


def _x(rng, shape, dtype, dev):
    a = rng.normal(size=shape).astype(np.float32)
    return torch.from_numpy(a).to(dev, getattr(torch, dtype))


def _close(y, want, atol):
    torch.cuda.synchronize()
    assert y.dtype == want.dtype and y.shape == want.shape
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol)


@pytest.mark.parametrize("b,n,r,t,variant,dtype", CASES_1D)
def test_stencil1d_kernel(dev, rng, b, n, r, t, variant, dtype):
    coeffs = tuple((rng.normal(size=2 * r + 1) / (2 * r + 1)).tolist())
    x = _x(rng, (b, n), dtype, dev)
    before = _build.LAUNCHES.get(f"stencil1d_{variant}", 0)
    y = stencil1d(x, coeffs, timesteps=t, backend="cuda", variant=variant)
    assert _build.LAUNCHES[f"stencil1d_{variant}"] == before + 1
    _close(y, stencil1d_ref(x, coeffs, t), TOL[dtype])
    y = stencil1d(x, coeffs, timesteps=t, backend="cuda", variant=variant,
                  block=(min(b, 8), 128))
    _close(y, stencil1d_ref(x, coeffs, t), TOL[dtype])


@pytest.mark.parametrize("b,ny,nx,ry,rx,t,dtype", CASES_2D)
def test_stencil2d_kernel(dev, rng, b, ny, nx, ry, rx, t, dtype):
    cy = tuple((rng.normal(size=2 * ry + 1) / (2 * ry + 1)).tolist())
    cx = rng.normal(size=2 * rx + 1) / (2 * rx + 1)
    cx[rx] = 0.0
    cx = tuple(cx.tolist())
    x = _x(rng, (b, ny, nx), dtype, dev)
    before = _build.LAUNCHES.get("stencil2d", 0)
    y = stencil2d(x, cy, cx, timesteps=t, backend="cuda")
    assert _build.LAUNCHES["stencil2d"] == before + 1
    _close(y, stencil2d_ref(x, cy, cx, t), TOL[dtype])
    y = stencil2d(x, cy, cx, timesteps=t, backend="cuda", block=(8, 128))
    _close(y, stencil2d_ref(x, cy, cx, t), TOL[dtype])


@pytest.mark.parametrize("b,nz,ny,nx,rz,ry,rx,t,dtype", CASES_3D)
def test_stencil3d_kernel(dev, rng, b, nz, ny, nx, rz, ry, rx, t, dtype):
    cz = tuple((rng.normal(size=2 * rz + 1) / (2 * rz + 1)).tolist())
    cy = rng.normal(size=2 * ry + 1) / (2 * ry + 1)
    cy[ry] = 0.0
    cx = rng.normal(size=2 * rx + 1) / (2 * rx + 1)
    cx[rx] = 0.0
    cy, cx = tuple(cy.tolist()), tuple(cx.tolist())
    x = _x(rng, (b, nz, ny, nx), dtype, dev)
    want = stencil3d_ref(x, cz, cy, cx, t)
    before = _build.LAUNCHES.get("stencil3d", 0)
    y = stencil3d(x, cz, cy, cx, timesteps=t, backend="cuda")
    assert _build.LAUNCHES["stencil3d"] == before + t
    _close(y, want, TOL[dtype])
    for block in (None, (8, 16, 128), (5, 3, 32)):
        _close(stencil3d(x, cz, cy, cx, timesteps=t, backend="cuda",
                         block=block), want, TOL[dtype])


def test_block_too_large_raises(dev):
    x = torch.zeros(1, 64, 128, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        stencil2d(x, (0.1,) * 25, (0.1,) * 25, timesteps=1, block=(512, 1024))


def test_zero_and_centre_taps(dev, rng):
    """Zero taps inside a chain are skipped and every axis's centre tap is
    applied, in the kernels as in the plain versions."""
    c1 = (0.1, 0.0, 0.5, 0.0, 0.2)
    x = _x(rng, (3, 1000), "float32", dev)
    for variant in ("vpu", "mxu"):
        _close(stencil1d(x, c1, timesteps=2, backend="cuda", variant=variant),
               stencil1d_ref(x, c1, 2), TOL["float32"])
    cy, cx = (0.2, 0.3, 0.1), (0.05, 0.25, 0.0, 0.1, 0.05)
    x = _x(rng, (2, 70, 90), "float32", dev)
    _close(stencil2d(x, cy, cx, timesteps=3, backend="cuda"),
           stencil2d_ref(x, cy, cx, 3), TOL["float32"])
    cz, cy, cx = (0.1, 0.3, 0.1), (0.05, 0.2, 0.05), (0.0, 0.1, 0.1, 0.1, 0.0)
    x = _x(rng, (2, 20, 30, 40), "float32", dev)
    _close(stencil3d(x, cz, cy, cx, timesteps=2, backend="cuda"),
           stencil3d_ref(x, cz, cy, cx, 2), TOL["float32"])
