"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU (sm_90a) and ``nvcc``: a CUDA kernel has no CPU mode, so
every test here skips on a host without a card.  On the card, run
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
Tolerances: ``TOL`` of ``tests/test_kernels.py`` (f32 2e-5, bf16 3e-2;
conv1d bf16 8e-2, ``tests/test_kernels.py:122``: the kernel path adds the
bias after its cast to bf16, the plain version before it).
"""
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # hosts where hypothesis can't be installed
    from repro_torch.testing.minihyp import given, settings, strategies as st

from repro_torch.configs import ShapeSpec, get_reduced_config, list_archs
from repro_torch.kernels import (_build, causal_conv1d,
                                 sliding_window_attention, stencil1d,
                                 stencil2d, stencil3d)
from repro_torch.kernels.conv1d import kernel as k5
from repro_torch.kernels.conv1d.ref import conv1d_bwd_ref, conv1d_ref
from repro_torch.kernels.stencil1d.ref import stencil1d_ref
from repro_torch.kernels.stencil2d.kernel import CLOCK_FIELDS, stencil2d_work
from repro_torch.kernels.stencil2d.ops import plan_2d_blocks
from repro_torch.kernels.stencil2d.ref import stencil2d_ref
from repro_torch.kernels.stencil3d.kernel import instance, stencil3d_work
from repro_torch.kernels.stencil3d.ops import DEFAULT_BLOCK, fit_block
from repro_torch.kernels.stencil3d.ref import stencil3d_ref
from repro_torch.telemetry import Telemetry, recording
from repro_torch.kernels.swa.ops import swa_plain
from repro_torch.kernels.swa.kernel import swa_bwd_kernel
from repro_torch.kernels.swa.ref import swa_bwd_ref
from repro_torch.models.registry import build_model, input_arrays
from repro_torch.serving.serve_step import make_prefill

pytestmark = pytest.mark.cuda

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
    # K2 on the tensor cores: the r = 8 instance at T = 1 and T = 4 in both
    # types; batches that are not a multiple of 16 (an mma's rows); odd n
    # (rows not 16-byte aligned) at r = 8; the instance's other radii (r = 5
    # with K = 24, r = 1 with K = 16); the generic instance at r = 13
    (5, 4096, 8, 1, "mxu", "float32"),
    (5, 4096, 8, 1, "mxu", "bfloat16"),
    (3, 3000, 8, 4, "mxu", "float32"),
    (3, 3000, 8, 4, "mxu", "bfloat16"),
    (37, 1000, 8, 1, "mxu", "float32"),
    (19, 777, 8, 2, "mxu", "bfloat16"),
    (4, 1001, 5, 2, "mxu", "float32"),
    (2, 640, 1, 3, "mxu", "bfloat16"),
    (18, 2000, 13, 2, "mxu", "float32"),
    (3, 1500, 13, 1, "mxu", "bfloat16"),
    # more tiles than resident blocks (at the (8, 128) block), so each
    # persistent block walks several tiles and the last round is partial
    (1100, 1000, 8, 1, "mxu", "float32"),
    (300, 2000, 8, 2, "mxu", "bfloat16"),
    # K1's register window: the r = 8 instance at T = 1 and T = 4 in both
    # types; batches that are not a multiple of the tile's rows (4); odd n
    # (rows not 16-byte aligned) at r = 8; the generic instance at r = 13
    # (and at r = 8 with a zero tap in test_stencil1d_vpu_skips_zero_taps)
    (5, 4096, 8, 1, "vpu", "float32"),
    (5, 4096, 8, 1, "vpu", "bfloat16"),
    (3, 3000, 8, 4, "vpu", "float32"),
    (3, 3000, 8, 4, "vpu", "bfloat16"),
    (37, 1000, 8, 1, "vpu", "float32"),
    (19, 777, 8, 2, "vpu", "bfloat16"),
    (4, 1001, 8, 1, "vpu", "float32"),
    (18, 2000, 13, 2, "vpu", "float32"),
    (3, 1500, 13, 1, "vpu", "bfloat16"),
    # more tiles than resident blocks (at the (8, 128) block), so each
    # persistent block walks several tiles and the last round is partial
    (1100, 1000, 8, 1, "vpu", "float32"),
    (600, 2000, 8, 2, "vpu", "bfloat16"),
]
CASES_2D = [
    (1, 64, 128, 1, 1, 1, "float32"),
    (2, 64, 128, 2, 3, 1, "float32"),
    (1, 48, 96, 1, 1, 2, "float32"),
    (1, 72, 160, 2, 2, 3, "float32"),
    (2, 40, 140, 3, 1, 1, "float32"),
    (1, 64, 128, 1, 1, 2, "bfloat16"),
    (3, 113, 240, 12, 12, 4, "float32"),
    # the paper's radius on ragged grids (neither axis a multiple of the
    # tile; 517 also not of the 16-byte chunk), bf16 at T = 1 and T = 4
    (2, 301, 517, 12, 12, 1, "bfloat16"),
    (1, 150, 333, 12, 12, 4, "bfloat16"),
    (1, 200, 968, 12, 12, 1, "float32"),
]
CASES_3D = [
    (1, 16, 16, 128, 1, 1, 1, 1, "float32"),
    (2, 16, 32, 128, 2, 1, 3, 1, "float32"),
    (1, 24, 16, 128, 1, 2, 1, 2, "float32"),
    (1, 16, 16, 128, 1, 1, 1, 1, "bfloat16"),
    (2, 37, 19, 70, 2, 2, 2, 3, "float32"),
    # the compile-time instances (1, 1, 1) and (2, 2, 2) on grids ragged
    # against the tile, nx odd (rows not 16-byte aligned), batch 3, T = 3
    # in f32 and T = 2 in bf16; nz < 2rz + 1; the generic instance at
    # (2, 1, 3) in bf16 and at rz = 4 and 5; a last z chunk of one plane
    # (nz = 33 against the default chunk of 32), in both kinds of instance
    (3, 41, 37, 131, 2, 2, 2, 1, "float32"),
    (1, 35, 45, 257, 1, 1, 1, 3, "float32"),
    (2, 29, 33, 136, 2, 2, 2, 2, "bfloat16"),
    (1, 23, 21, 77, 2, 2, 2, 1, "bfloat16"),
    (2, 3, 20, 64, 2, 2, 2, 1, "float32"),
    (1, 4, 9, 40, 2, 1, 3, 1, "float32"),
    (3, 30, 27, 101, 2, 1, 3, 2, "bfloat16"),
    (1, 26, 21, 90, 4, 1, 2, 1, "float32"),
    (2, 33, 30, 60, 5, 5, 5, 1, "float32"),
    (1, 33, 20, 72, 2, 2, 2, 1, "bfloat16"),
    (2, 33, 13, 40, 3, 1, 2, 2, "float32"),
]

# (b, s, c, k, dtype): the sweep of tests/test_kernels.py, then ragged
# channels, a sequence shorter than the halo, the widest taps, model widths
CASES_CONV = [
    (2, 128, 64, 4, "float32"),
    (1, 100, 48, 7, "float32"),
    (3, 256, 128, 2, "float32"),
    (1, 64, 16, 16, "float32"),
    (2, 128, 64, 4, "bfloat16"),
    (1, 37, 5, 32, "float32"),
    (2, 3, 200, 4, "float32"),
    (1, 1, 9, 1, "float32"),
    (2, 4099, 2560, 4, "bfloat16"),
    (2, 1000, 2560, 4, "float32"),
]
# (b, hq, hkv, s, d, window, dtype): the sweep of tests/test_kernels.py, then
# S < window, window 1, ragged S, head dims that are not multiples of 32 or
# 4, and the model's MQA at D = 256
CASES_SWA = [
    (1, 4, 4, 256, 32, 64, "float32"),
    (2, 8, 2, 256, 64, 128, "float32"),
    (1, 2, 1, 300, 32, 100, "float32"),
    (1, 4, 4, 512, 32, 512, "float32"),
    (2, 6, 3, 128, 16, 1, "float32"),
    (1, 4, 2, 256, 32, 96, "bfloat16"),
    (1, 10, 1, 1000, 256, 2048, "float32"),
    (2, 10, 1, 777, 256, 128, "bfloat16"),
    (1, 4, 2, 130, 40, 1, "float32"),
    (1, 2, 2, 50, 18, 7, "float32"),
    (1, 3, 1, 1, 256, 5, "float32"),
    (1, 10, 1, 2113, 256, 2048, "float32"),
    (1, 10, 1, 2113, 256, 2048, "bfloat16"),
    # the tensor-core path: head dims that are not multiples of 16 (D = 18
    # also not of 8: element-wise loads), the prefill's S = 4096 with
    # window 2048, and windows that reach past S
    (1, 4, 2, 300, 18, 64, "bfloat16"),
    (2, 4, 2, 333, 40, 100, "bfloat16"),
    (1, 10, 1, 4096, 256, 2048, "bfloat16"),
    (1, 4, 2, 500, 64, 600, "bfloat16"),
    (1, 4, 1, 300, 256, 300, "bfloat16"),
    # the f32 tensor-core path's edges: S not a multiple of its 32-key or
    # 64-query tiles, window 1 and past S, D = 1, 4, 18 (4-byte loads), 100,
    # 129 and 256 (Dp 64, 128, 256), GQA 5:1, and the prefill's shape
    (1, 2, 1, 97, 100, 40, "float32"),
    (1, 2, 1, 97, 4, 1, "float32"),
    (2, 2, 1, 70, 1, 16, "float32"),
    (1, 5, 1, 333, 18, 64, "float32"),
    (1, 4, 2, 200, 129, 500, "float32"),
    (1, 5, 1, 2113, 256, 300, "float32"),
    (2, 10, 1, 4096, 256, 2048, "float32"),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _x(rng, shape, dtype, dev):
    a = rng.normal(size=shape).astype(np.float32)
    return torch.from_numpy(a).to(dev, getattr(torch, dtype))


def _close(y, want, atol, rtol=1e-7):
    torch.cuda.synchronize()
    assert y.dtype == want.dtype and y.shape == want.shape
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol,
                               rtol=rtol)


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


@pytest.mark.parametrize("b,ny,nx,ry,rx,t,dtype", CASES_2D + [
    (4, 449, 960, 12, 12, 1, "float32")])
def test_stencil2d_clocked_instance(dev, rng, b, ny, nx, ry, rx, t, dtype):
    """K3's clocked instance (``recording(clocks=True)``) writes the main
    instance's outputs bit for bit, counts as ``stencil2d_clocked`` alone,
    and its blocks' device count of the bytes their loads requested equals
    the loads of ``stencil2d_work``; the work tally adds the formula."""
    cy = tuple((rng.normal(size=2 * ry + 1) / (2 * ry + 1)).tolist())
    cx = rng.normal(size=2 * rx + 1) / (2 * rx + 1)
    cx[rx] = 0.0
    cx = tuple(cx.tolist())
    x = _x(rng, (b, ny, nx), dtype, dev)
    main = stencil2d(x, cy, cx, timesteps=t, backend="cuda")
    before = dict(_build.LAUNCHES)
    work = list(_build.WORK.get("stencil2d_clocked", [0, 0, 0]))
    tel = Telemetry()
    with recording(tel, clocks=True) as rec:
        clocked = stencil2d(x, cy, cx, timesteps=t, backend="cuda")
    torch.cuda.synchronize()
    assert torch.equal(clocked, main)
    assert _build.LAUNCHES["stencil2d"] == before["stencil2d"]
    assert _build.LAUNCHES["stencil2d_clocked"] == \
        before.get("stencil2d_clocked", 0) + 1
    by, bx = plan_2d_blocks(ny, nx, ry, rx, t, _build.smem_per_block(dev))
    taps = sum(c != 0.0 for c in cy) + sum(c != 0.0 for c in cx)
    ops, nbytes = stencil2d_work(b, ny, nx, ry, rx, t, by, bx,
                                 x.element_size(), taps)
    assert _build.WORK["stencil2d_clocked"] == [work[0] + 1, work[1] + ops,
                                                work[2] + nbytes]
    c = rec.clocks["stencil2d_clocked"]
    assert set(c) == set(CLOCK_FIELDS)
    assert c["bytes"] == nbytes - b * ny * nx * x.element_size()
    assert c["blocks"] == b * -(-ny // by) * -(-nx // bx)
    assert all(c[p] > 0 for p in ("issue", "wait", "sum", "store"))
    names = [s["name"] for s in tel.spans]
    assert names.count("launch.stencil2d_clocked") == 1


@pytest.mark.parametrize("b,nz,ny,nx,rz,ry,rx,t,dtype", CASES_3D[:6])
def test_stencil3d_launches_add_their_work(dev, rng, b, nz, ny, nx, rz, ry,
                                           rx, t, dtype):
    """Each of K4's T launches adds ``stencil3d_work`` to the work tally, in
    the compile-time instances (the star pattern: y and x centres zero) and
    the generic one."""
    cz = tuple((rng.normal(size=2 * rz + 1) / (2 * rz + 1)).tolist())
    cy = rng.normal(size=2 * ry + 1) / (2 * ry + 1)
    cx = rng.normal(size=2 * rx + 1) / (2 * rx + 1)
    cy[ry] = cx[rx] = 0.0
    cy, cx = tuple(cy.tolist()), tuple(cx.tolist())
    x = _x(rng, (b, nz, ny, nx), dtype, dev)
    work = list(_build.WORK.get("stencil3d", [0, 0, 0]))
    stencil3d(x, cz, cy, cx, timesteps=t, backend="cuda")
    queued = instance(cz, cy, cx) > 0
    block = fit_block(DEFAULT_BLOCK, (rz, ry, rx), x.element_size(),
                      _build.smem_per_block(dev), queued)
    taps = sum(v != 0.0 for c in (cz, cy, cx) for v in c)
    ops, nbytes = stencil3d_work(b, nz, ny, nx, rz, ry, rx, *block,
                                 x.element_size(), queued, taps)
    assert _build.WORK["stencil3d"] == [work[0] + t, work[1] + t * ops,
                                        work[2] + t * nbytes]


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
    for block in ("plan", (8, 16, 128), (5, 4, 32)):
        _close(stencil3d(x, cz, cy, cx, timesteps=t, backend="cuda",
                         block=block), want, TOL[dtype])


def test_stencil3d_refuses_blocks_and_radii_it_does_not_take(dev, rng):
    """K4's tile is by x bx columns in 4 x 4 micro-tiles (by a multiple of 4,
    bx of 8, at most 256 threads), and its tap struct holds 64 taps per axis:
    rz = 31 runs through the generic instance, rz = 32 is refused; neither
    refusal launches."""
    c3 = (0.1, 0.2, 0.1)
    x = _x(rng, (1, 70, 8, 16), "float32", dev)
    cz = tuple((rng.normal(size=63) / 63).tolist())
    _close(stencil3d(x, cz, c3, c3, backend="cuda", block=(16, 4, 8)),
           stencil3d_ref(x, cz, c3, c3, 1), TOL["float32"])
    before = _build.LAUNCHES.get("stencil3d", 0)
    for block in ((5, 3, 32), (4, 8, 12), (0, 8, 32), (4, 64, 128)):
        with pytest.raises(ValueError, match="must be"):
            stencil3d(x, c3, c3, c3, backend="cuda", block=block)
    with pytest.raises(ValueError, match="radius <= 31"):
        stencil3d(x, (0.01,) * 65, c3, c3, backend="cuda", block=(16, 4, 8))
    assert _build.LAUNCHES.get("stencil3d", 0) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rz,ry,rx,star", [
    (1, 1, 1, True), (2, 2, 2, True),
    (1, 1, 1, False), (2, 2, 2, False), (2, 1, 3, False)])
def test_stencil3d_zero_interior_taps(dev, rng, dtype, rz, ry, rx, star):
    """Zero taps are skipped: the y and x centres of the star pattern in
    both compile-time instances, and zero taps inside every chain of the
    generic instance, which also runs r = 1 and 2 off the star pattern and
    sums their non-zero y and x centres.  An infinite input point reaches
    the outputs behind a zero tap as 0 * inf = nan unless the tap is
    skipped, as the plain version skips it."""
    cz, cy, cx = (rng.normal(size=2 * r + 1) / 13 for r in (rz, ry, rx))
    if star:
        cy[ry] = cx[rx] = 0.0
    else:
        cz[0] = cy[-1] = cx[0] = 0.0
    cz, cy, cx = (tuple(c.tolist()) for c in (cz, cy, cx))
    x = _x(rng, (2, 29, 37, 75), dtype, dev)
    x[1, 14, 18, 40] = float("inf")
    _close(stencil3d(x, cz, cy, cx, timesteps=2, backend="cuda"),
           stencil3d_ref(x, cz, cy, cx, 2), TOL[dtype])


def test_block_too_large_raises(dev):
    x = torch.zeros(1, 64, 128, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        stencil2d(x, (0.1,) * 25, (0.1,) * 25, timesteps=1, block=(512, 1024))


def test_stencil2d_radius_limit(dev, rng):
    """The kernel's tap struct holds 128 taps per axis: r = 63 runs through
    the compacted-tap instance, r = 64 is refused before any launch."""
    cy = tuple((rng.normal(size=127) / 127).tolist())
    cx = tuple((rng.normal(size=3) / 3).tolist())
    x = _x(rng, (1, 200, 300), "float32", dev)
    _close(stencil2d(x, cy, cx, backend="cuda"), stencil2d_ref(x, cy, cx, 1),
           TOL["float32"])
    before = _build.LAUNCHES.get("stencil2d", 0)
    with pytest.raises(ValueError, match="radius <= 63"):
        stencil2d(x, (0.01,) * 129, cx, backend="cuda")
    assert _build.LAUNCHES.get("stencil2d", 0) == before


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


@pytest.mark.parametrize("b,s,c,k,dtype", CASES_CONV)
def test_conv1d_kernel(dev, rng, b, s, c, k, dtype):
    x, w, bias = (_x(rng, shape, dtype, dev) for shape in ((b, s, c), (k, c),
                                                          (c,)))
    before = _build.LAUNCHES.get("conv1d", 0)
    y = causal_conv1d(x, w, bias, backend="cuda")
    assert _build.LAUNCHES["conv1d"] == before + 1
    # bf16, one quantum (at most 2^-7 |y|) beside the absolute limit:
    # - with bias, the op rounds twice (after the kernel, after the bias),
    #   the plain version once: 0.125 apart at |y| ~ 16, where
    #   tests/test_kernels.py's 8e-2 alone would fail;
    # - without bias, both round once, but the kernel sums with fmaf and the
    #   plain version rounds each product first, so the float32 sums differ
    #   in their last bits and may land on either side of a bf16 rounding.
    rtol = 2 ** -7 if dtype == "bfloat16" else 0.0
    _close(y, conv1d_ref(x, w, bias), 8e-2 if dtype == "bfloat16" else
           TOL[dtype], rtol)
    _close(causal_conv1d(x, w, backend="cuda"), conv1d_ref(x, w), TOL[dtype],
           rtol)


def _device_kernels(fn):
    """(fn's result, the names of the device kernels it launched), from
    torch.profiler.  The host sleeps a few ms on either side of fn inside
    the profiled window, so that fn's one short kernel lies well inside it:
    a window that held nothing but that kernel once came back empty."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.005)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(0.005)
    names = [e.key for e in prof.key_averages()
             if e.device_type.name == "CUDA" for _ in range(e.count)]
    return out, names


def _conv1d_close(y, x, w, bias, dtype):
    """K5 against the plain version, with the limits of test_conv1d_kernel."""
    rtol = 2 ** -7 if dtype == "bfloat16" else 0.0
    atol = 8e-2 if dtype == "bfloat16" and bias is not None else TOL[dtype]
    _close(y, conv1d_ref(x, w, bias), atol, rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_conv1d_vector_instances(dev, rng, k, dtype):
    """K = 1-4 at 16-byte rows run the vector instance of their K, with and
    without the bias."""
    x, w, bias = (_x(rng, shape, dtype, dev)
                  for shape in ((2, 300, 256), (k, 256), (256,)))
    assert k5.launch_plan(x, w).instance == k
    for b in (bias, None):
        y, names = _device_kernels(lambda: causal_conv1d(x, w, b,
                                                         backend="cuda"))
        assert len(names) == 1 and "conv1d_vec_kernel" in names[0], names
        _conv1d_close(y, x, w, b, dtype)


def _misaligned(rng, shape, dtype, dev):
    """A contiguous tensor whose storage starts one element past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    buf = _x(rng, (n + 1,), dtype, dev)
    return buf[1:].view(shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("what", ["ragged channels", "misaligned input"])
def test_conv1d_generic_instance_where_vectors_do_not_fit(dev, rng, what,
                                                          dtype):
    """Rows that are not whole 16-byte chunks, or an input off a 16-byte
    boundary, run the generic instance; the launcher refuses a vector
    instance forced onto them."""
    c = 258 if what == "ragged channels" else 256   # 258 * 2, 258 * 4 % 16
    shape = (2, 300, c)
    x = (_x(rng, shape, dtype, dev) if what == "ragged channels"
         else _misaligned(rng, shape, dtype, dev))
    w, bias = _x(rng, (4, c), dtype, dev), _x(rng, (c,), dtype, dev)
    assert x.is_contiguous()
    assert k5.launch_plan(x, w).instance == 0
    y, names = _device_kernels(lambda: causal_conv1d(x, w, bias,
                                                     backend="cuda"))
    assert len(names) == 1 and "conv1d_generic_kernel" in names[0], names
    _conv1d_close(y, x, w, bias, dtype)
    before = _build.LAUNCHES.get("conv1d", 0)
    with pytest.raises(RuntimeError, match="failed to launch"):
        k5.conv1d_kernel(x, w, launch=k5.Plan(4, 64, 256, 8))
    assert _build.LAUNCHES.get("conv1d", 0) == before


# (b, s, c, k, dtype, launch): S shorter than K; S not a multiple of the run
# or of the rows in flight; several runs a row, so the halo is read at every
# run and batch boundary; the generic instance at short runs
CASES_CONV_RUNS = [
    (2, 2, 256, 4, "float32", None),
    (3, 3, 64, 4, "bfloat16", None),
    (3, 1001, 128, 4, "bfloat16", k5.Plan(4, 16, 64, 8)),
    (3, 130, 128, 3, "float32", k5.Plan(3, 32, 128, 4)),
    (5, 77, 256, 2, "bfloat16", k5.Plan(2, 8, 256, 2)),
    (2, 500, 64, 1, "float32", k5.Plan(1, 64, 32, 1)),
    (4, 203, 72, 4, "float32", k5.Plan(4, 24, 96, 8)),
    (3, 130, 100, 5, "float32", k5.Plan(0, 16, 64, 1)),
    (3, 130, 100, 4, "bfloat16", k5.Plan(0, 7, 32, 1)),
]


@pytest.mark.parametrize("b,s,c,k,dtype,launch", CASES_CONV_RUNS)
def test_conv1d_runs_and_batch_boundaries(dev, rng, b, s, c, k, dtype,
                                          launch):
    """Every row's last K-1 inputs are infinite, so a halo read across a
    batch boundary shows in the next row's first outputs."""
    x, w, bias = (_x(rng, shape, dtype, dev)
                  for shape in ((b, s, c), (k, c), (c,)))
    halo = min(k - 1, s)
    if halo:
        x[:, -halo:] = float("inf")
    y = k5.conv1d_kernel(x, w, bias, launch=launch)
    assert bool(torch.isfinite(y[:, :s - halo]).all())
    _conv1d_close(y, x, w, bias, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [3, 5, 9])
def test_conv1d_skips_padded_slots(dev, rng, k, dtype):
    """An infinite input reaches only the K outputs whose taps read it; the
    generic instance's padded window slots (K = 5 in 8 slots, K = 9 in 16)
    would carry it further as 0 * inf = nan."""
    x, w, bias = (_x(rng, shape, dtype, dev)
                  for shape in ((2, 200, 64), (k, 64), (64,)))
    x[1, 100, 7] = float("inf")
    y = causal_conv1d(x, w, bias, backend="cuda")
    assert bool(torch.isfinite(y[1, 100 + k:, 7]).all())
    assert bool(torch.isfinite(y[0]).all())
    _conv1d_close(y, x, w, bias, dtype)


@pytest.mark.parametrize("bias_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [2560, 258])
def test_conv1d_fused_bias_is_bit_exact(dev, rng, c, dtype, bias_dtype):
    """The op with its bias fused has the bits of the kernel followed by
    the bias added in f32 and cast, as the op computed it before: at the
    model's width (vector instance) and at ragged channels (generic)."""
    x = _x(rng, (2, 1000, c), dtype, dev) * 8
    w = _x(rng, (4, c), dtype, dev)
    bias = _x(rng, (c,), bias_dtype, dev) * 8
    want = (k5.conv1d_kernel(x, w).float() + bias.float()).to(x.dtype)
    assert torch.equal(causal_conv1d(x, w, bias, backend="cuda"), want)


def test_conv1d_op_launches_one_kernel(dev, rng):
    """causal_conv1d at the model's width, bias fused: one device kernel."""
    x = _x(rng, (1, 512, 2560), "bfloat16", dev)
    w = _x(rng, (4, 2560), "bfloat16", dev)
    bias = _x(rng, (2560,), "bfloat16", dev)
    with torch.inference_mode():
        _, names = _device_kernels(lambda: causal_conv1d(x, w, bias))
    assert len(names) == 1 and "conv1d_vec_kernel" in names[0], names


@pytest.mark.parametrize("b,hq,hkv,s,d,w,dtype", CASES_SWA)
def test_swa_kernel(dev, rng, b, hq, hkv, s, d, w, dtype):
    q = _x(rng, (b, hq, s, d), dtype, dev)
    k = _x(rng, (b, hkv, s, d), dtype, dev)
    v = _x(rng, (b, hkv, s, d), dtype, dev)
    before = _build.LAUNCHES.get("swa", 0)
    y = sliding_window_attention(q, k, v, window=w, backend="cuda")
    assert _build.LAUNCHES["swa"] == before + 1
    _close(y, swa_plain(q, k, v, window=w), TOL[dtype])


@pytest.mark.parametrize("d,dtype", [(256, "bfloat16"), (40, "bfloat16"),
                                     (18, "bfloat16"), (256, "float32")])
def test_swa_kernel_reads_strided_views(dev, rng, d, dtype):
    """(B, S, H, D) tensors viewed as (B, H, S, D), as the model passes
    them: no copy, the output in q's layout, the plain version's values."""
    q = _x(rng, (2, 700, 4, d), dtype, dev).transpose(1, 2)
    k = _x(rng, (2, 700, 2, d), dtype, dev).transpose(1, 2)
    v = _x(rng, (2, 700, 2, d), dtype, dev).transpose(1, 2)
    y = sliding_window_attention(q, k, v, window=300, backend="cuda")
    assert y.stride() == q.stride()
    _close(y, swa_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                        window=300), TOL[dtype])


def test_swa_f32_forward_is_deterministic_at_the_model_shape(dev, rng):
    """Two f32 forward calls at RecurrentGemma-2B's prefill shape ((2, 4096)
    tokens, 10 query heads over 1 KV head, D = 256, window 2048, the
    (B, S, H, D) views the model passes) give equal bits: every sum runs in
    a fixed order, and the two warps that share rows take the same bits of
    the running max."""
    q, k, v = (_x(rng, (2, 4096, h, 256), "float32", dev).transpose(1, 2)
               for h in (10, 1, 1))
    first = sliding_window_attention(q, k, v, window=2048, backend="cuda")
    again = sliding_window_attention(q, k, v, window=2048, backend="cuda")
    torch.cuda.synchronize()
    assert first.stride() == q.stride()
    assert torch.equal(first, again)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 4])
def test_stencil2d_zero_interior_taps_at_radius_12(dev, rng, dtype, t):
    """Zero taps inside both chains of the compile-time r = 12 instance are
    skipped, on a grid that is ragged against the tile: an infinite input
    point reaches the outputs behind a zero tap as 0 * inf = nan unless the
    tap is skipped, as the plain version skips it."""
    cy = rng.normal(size=25) / 49
    cx = rng.normal(size=25) / 49
    cy[5] = cx[12] = cx[20] = 0.0
    cy, cx = tuple(cy.tolist()), tuple(cx.tolist())
    x = _x(rng, (2, 181, 403), dtype, dev)
    x[0, 90, 200] = float("inf")
    _close(stencil2d(x, cy, cx, timesteps=t, backend="cuda"),
           stencil2d_ref(x, cy, cx, t), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,t,zeros", [
    (8, 1, (3, 13)), (8, 3, (0, 8)), (5, 2, (1,)), (8, 2, ())])
def test_stencil1d_vpu_skips_zero_taps(dev, rng, dtype, r, t, zeros):
    """K1 skips zero taps: r = 8 with a zero tap runs the generic instance
    over the compacted taps, as does r = 5; all 17 non-zero run the
    compile-time instance.  An infinite input point reaches the outputs
    behind a zero tap as 0 * inf = nan unless the tap is skipped, as the
    plain version skips it; one inside the rim leaves the rim zero."""
    c = rng.normal(size=2 * r + 1) / (2 * r + 1)
    c[list(zeros)] = 0.0
    c = tuple(c.tolist())
    x = _x(rng, (3, 1500), dtype, dev)
    x[1, 700] = float("inf")
    x[2, 3] = float("inf")
    _close(stencil1d(x, c, timesteps=t, backend="cuda", variant="vpu"),
           stencil1d_ref(x, c, t), TOL[dtype])


# -- the backward of K5 and K6 -------------------------------------------------
# (b, s, c, k, dtype, bias, strided): the model's shape, the vector and the
# generic instance (ragged channels, K = 7), one and many runs and blocks of
# runs, a strided input, K = 1, a sequence shorter than the taps
CASES_CONV_BWD = [
    (1, 4096, 2560, 4, "bfloat16", True, False),
    (1, 4096, 2560, 4, "float32", True, False),
    (2, 300, 64, 4, "float32", False, False),
    (2, 300, 64, 4, "bfloat16", True, True),
    (3, 77, 258, 3, "float32", True, True),
    (1, 100, 48, 7, "bfloat16", False, False),
    (2, 5, 16, 4, "float32", True, False),
    (3, 1000, 264, 1, "bfloat16", True, False),
    (2, 333, 40, 1, "float32", False, True),
    (3, 2, 64, 4, "bfloat16", True, False),
]
# (b, hq, hkv, s, d, window, dtype, strided): MQA and GQA, S not a multiple
# of a tile, window >= S and < S, the model's shape and views; then bf16 at
# the edges of its tiling (128-query dq blocks, 64-key tiles, the group
# split into parts): S = 65 and 4097, windows 63, 64 and 65, groups 10:1
# and 3:1, D = 40 zero-filled to 64, and D = 20, whose rows are not 16-byte
# aligned (the scalar load path); then f32 at D = 256 with S not a multiple
# of 64 (the model's views, parts of the group), and D = 18, whose rows are
# not 16-byte aligned
CASES_SWA_BWD = [
    (1, 10, 1, 4096, 256, 2048, "bfloat16", True),
    (1, 10, 1, 1000, 256, 2048, "float32", True),
    (2, 4, 2, 300, 64, 100, "float32", False),
    (2, 4, 2, 300, 64, 100, "bfloat16", True),
    (1, 6, 3, 77, 40, 500, "float32", False),
    (1, 2, 1, 130, 32, 1, "bfloat16", False),
    (1, 3, 1, 1, 256, 5, "float32", False),
    (2, 8, 8, 257, 128, 64, "bfloat16", False),
    (1, 10, 1, 65, 256, 64, "bfloat16", True),
    (1, 10, 1, 4097, 256, 63, "bfloat16", True),
    (1, 3, 1, 4097, 64, 65, "bfloat16", False),
    (2, 6, 2, 300, 40, 64, "bfloat16", True),
    (1, 3, 1, 200, 20, 65, "bfloat16", False),
    (1, 10, 1, 1000, 256, 300, "float32", True),
    (1, 3, 1, 70, 18, 65, "float32", True),
]


def _grad_ok(kernel, dtype, got, want, upstream):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    torch.cuda.synchronize()
    good, err, rel = chip_smoke.grad_error(kernel, getattr(torch, dtype),
                                           got, want, upstream)
    assert good, (kernel, dtype, err, rel)


def _flipped_dx(dy, w):
    """dx as K5 on the time-reversed gradient: the bits the backward keeps."""
    return k5.conv1d_kernel(dy.flip(1).contiguous(), w).flip(1)


@pytest.mark.parametrize("b,s,c,k,dtype,bias,strided", CASES_CONV_BWD)
def test_conv1d_backward_matches_plain_version(dev, rng, b, s, c, k, dtype,
                                               bias, strided):
    """dx, dw and db (one launch of conv1d_bwd, none of K5) through the op's
    autograd against the vector-Jacobian product of the plain version,
    within chip_smoke.py's GRAD_TOL, dx also bit for bit against K5 on the
    flipped gradient; with only x, or only w and b, needing a gradient it
    launches once too and gives the same bits."""
    x = _x(rng, (b, s, 2 * c if strided else c), dtype, dev)
    x = x[..., ::2] if strided else x
    w = _x(rng, (k, c), dtype, dev)
    bb = _x(rng, (c,), dtype, dev) if bias else None
    dy = _x(rng, (b, s, c), dtype, dev)
    leaves = [t.clone().requires_grad_() for t in (x, w)]
    if bias:
        leaves.append(bb.clone().requires_grad_())
    y = causal_conv1d(*leaves, backend="cuda")
    before = {n: _build.LAUNCHES.get(n, 0) for n in ("conv1d", "conv1d_bwd")}
    got = torch.autograd.grad(y, leaves, dy)
    assert _build.LAUNCHES.get("conv1d", 0) == before["conv1d"]
    assert _build.LAUNCHES["conv1d_bwd"] == before["conv1d_bwd"] + 1
    want = conv1d_bwd_ref(x, w, bb, dy)
    for g, ww in zip(got, want):
        assert g.dtype == ww.dtype
        _grad_ok("conv1d", dtype, g, ww, dy)
    assert torch.equal(got[0], _flipped_dx(dy, w))
    # the wrapper on the view itself gives the op's bits
    direct = k5.conv1d_bwd(x, dy, w, bb)
    for g, d in zip(got, direct):
        assert torch.equal(g, d)
    # only x, then only w (and b), needing a gradient: one launch each
    xr = x.clone().requires_grad_()
    before = _build.LAUNCHES["conv1d_bwd"]
    (dx,) = torch.autograd.grad(causal_conv1d(xr, w, bb), [xr], dy)
    assert _build.LAUNCHES["conv1d_bwd"] == before + 1
    assert torch.equal(dx, got[0])
    wb = [w.clone().requires_grad_()] + ([bb.clone().requires_grad_()]
                                         if bias else [])
    only = torch.autograd.grad(causal_conv1d(x, *wb), wb, dy)
    assert _build.LAUNCHES["conv1d_bwd"] == before + 2
    for g, d in zip(only, got[1:]):
        assert torch.equal(g, d)
    assert k5.conv1d_bwd(x, dy, w, bb, need_wb=False)[1:] == (None, None)
    assert k5.conv1d_bwd(x, dy, w, bb, need_x=False)[0] is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_backward_is_deterministic_at_the_model_shape(dev, rng, dtype):
    """Two backward calls at RecurrentGemma-2B's training shape ((1, 4096)
    tokens, lru_width 2560, 4 taps) give equal bits: dw's and db's sums run
    in an order fixed by the shapes, with no atomics."""
    x, dy = (_x(rng, (1, 4096, 2560), dtype, dev) for _ in range(2))
    w, bb = _x(rng, (4, 2560), dtype, dev), _x(rng, (2560,), dtype, dev)
    first = k5.conv1d_bwd(x, dy, w, bb)
    again = k5.conv1d_bwd(x, dy, w, bb)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("b,s,c,k,dtype,bias",
                         [case[:-1] for case in CASES_CONV_BWD])
def test_conv1d_backward_bits_equal_the_emulation(dev, rng, b, s, c, k,
                                                  dtype, bias):
    """The kernel's dx, dw and db equal, bit for bit, the CPU emulation of
    its order of operations (tests/test_torch_tiles.py) under the plan it
    launched: the partition and the sums depend on the shapes alone."""
    from test_torch_tiles import emulate_k5_bwd
    x = _x(rng, (b, s, c), dtype, dev)
    w = _x(rng, (k, c), dtype, dev)
    bb = _x(rng, (c,), dtype, dev) if bias else None
    dy = _x(rng, (b, s, c), dtype, dev)
    got = k5.conv1d_bwd(x, dy, w, bb)
    plan = k5.plan_bwd(b, s, c, k, x.element_size(), True)
    want = emulate_k5_bwd(*(None if t is None else t.cpu()
                            for t in (x, dy, w, bb)), plan)
    for g, ww in zip(got, want):
        if ww is None:
            assert g is None
        else:
            assert torch.equal(g.cpu(), ww)


@pytest.mark.parametrize("b,hq,hkv,s,d,w,dtype,strided", CASES_SWA_BWD)
def test_swa_backward_matches_plain_version(dev, rng, b, hq, hkv, s, d, w,
                                            dtype, strided):
    """dq, dk, dv (swa_bwd_dq, swa_bwd_dkdv, swa_bwd_fold, one launch each)
    through the op's autograd against the vector-Jacobian product of
    swa_ref, within chip_smoke.py's GRAD_TOL; strided: (B, S, H, D) tensors
    viewed as (B, H, S, D), as the model passes them."""
    def make(h):
        if strided:
            return _x(rng, (b, s, h, d), dtype, dev).transpose(1, 2)
        return _x(rng, (b, h, s, d), dtype, dev)
    q, k, v, dout = make(hq), make(hkv), make(hkv), make(hq)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    before = {n: _build.LAUNCHES.get(n, 0) for n in ("swa_bwd_dq",
                                                    "swa_bwd_dkdv",
                                                    "swa_bwd_fold")}
    out = sliding_window_attention(*leaves, window=w, backend="cuda")
    got = torch.autograd.grad(out, leaves, dout)
    for n in before:
        assert _build.LAUNCHES[n] == before[n] + 1
    want = swa_bwd_ref(q, k, v, dout, window=w)
    for g, ww, t in zip(got, want, (q, k, v)):
        assert g.shape == t.shape and g.dtype == t.dtype
        _grad_ok("swa", dtype, g, ww, dout)


def test_swa_backward_is_deterministic_at_the_model_shape(dev, rng):
    """Two backward calls at RecurrentGemma-2B's shape in bf16 and in f32
    ((1, 4096) tokens, 10 query heads over 1 KV head, D = 256, window 2048,
    the (B, S, H, D) views the model passes) give equal bits: every sum
    runs in a fixed order, with no atomics, and the split of the group's
    heads into parts depends on the shapes alone."""
    for dtype in ("bfloat16", "float32"):
        q, k, v, dout = (_x(rng, (1, 4096, h, 256), dtype, dev).transpose(
            1, 2) for h in (10, 1, 1, 10))
        out = sliding_window_attention(q, k, v, window=2048, backend="cuda")
        first = swa_bwd_kernel(q, k, v, out, dout, window=2048)
        again = swa_bwd_kernel(q, k, v, out, dout, window=2048)
        torch.cuda.synchronize()
        for a, b in zip(first, again):
            assert torch.equal(a, b), dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradient_through_checkpoint(dev, dtype):
    """RecurrentGemma reduced on the card: the loss's gradients under remat
    "full" and "dots" (torch.utils.checkpoint, which recomputes the kernels'
    forward) equal those without, bit for bit, and every backward kernel
    launches."""
    from repro_torch.models.transformer import xent_loss
    import dataclasses
    cfg = dataclasses.replace(get_reduced_config("recurrentgemma-2b"),
                              dtype=dtype)
    model = build_model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    toks = input_arrays(cfg, ShapeSpec("t", 64, 2, "train"), seed=1,
                        device=dev)["tokens"]
    params = [p for p in model.parameters()]
    grads = {}
    for remat in ("none", "full", "dots"):
        _build.reset_launches()
        logits, _ = model(toks, remat=remat)
        loss = xent_loss(logits[:, :-1], toks[:, 1:])
        grads[remat] = torch.autograd.grad(loss, params)
        for n in ("conv1d", "conv1d_bwd", "swa", "swa_bwd_dq",
                  "swa_bwd_dkdv", "swa_bwd_fold"):
            assert _build.LAUNCHES.get(n, 0) > 0, (remat, n)
    for remat in ("full", "dots"):
        for a, g in zip(grads["none"], grads[remat]):
            assert torch.equal(a, g), remat


# -- the LM families at reduced depth -----------------------------------------
MODEL_TOL = 5e-4      # tests/test_models.py's bar for decode against forward


@pytest.mark.parametrize("arch", list_archs())
def test_family_prefill_and_decode_on_the_card(dev, arch):
    """Each family's reduced config on the card: ``make_prefill`` against
    the same weights on the CPU, and decode token by token against the
    forward (chip_smoke.py's ``decode_error``), both within 5e-4."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    cfg = get_reduced_config(arch)
    cpu = build_model(cfg, device="cpu")
    cpu.init(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    batch = input_arrays(cfg, ShapeSpec("smoke", 24, 2, "prefill"), seed=0,
                         device="cpu")
    want = make_prefill(cpu, cfg)(batch)
    got = make_prefill(gpu, cfg)({k: v.to(dev) for k, v in batch.items()})
    _close(got, want, MODEL_TOL, rtol=0)
    inp = {k: v.to(dev) for k, v in input_arrays(
        cfg, ShapeSpec("smoke", 8, 2, "prefill"), seed=1,
        device="cpu").items()}
    err = chip_smoke.decode_error(gpu, cfg, inp["tokens"], inp.get("frames"))
    assert err < MODEL_TOL, err


# -- K7: the batched cycle engine ---------------------------------------------
def _k7_plans():
    """Ragged lanes: 65 to 1,665 nodes; bounded, unbounded and doomed
    queues; imux re-interleave and filter-heavy program plans."""
    from repro_torch.core import map_nd, paper_stencil_2d
    from repro_torch.core.spec import heat_2d
    from repro_torch.program import hdiff_program, lower, two_stage_heat
    heat = heat_2d(48, 96, dtype="float64")
    return [map_nd(heat, workers=4),                                  # N 65
            map_nd(paper_stencil_2d(ny=40, nx=96), workers=16),       # 1665
            map_nd(heat, workers=3, auto_capacity=True),
            map_nd(heat_2d(18, 24, dtype="float64"), workers=4,
                   queue_capacity=1),                                 # deadlock
            map_nd(heat_2d(18, 24, dtype="float64"), workers=8),      # 98 cycles
            lower(two_stage_heat(24, 32), workers={"heat1": 2, "heat2": 4}),
            lower(hdiff_program(24, 32), workers=4)]


def _k7_matrix():
    """_k7_plans and the lanes of tests/test_torch_engine_batch.py's
    emulation that it lacks: one with 40 memory nodes (K7's arbiter keeps
    up to 32 in registers and more in shared memory) and a re-interleave
    whose imux nodes take two ports."""
    from repro_torch.core import StencilSpec, map_nd
    from repro_torch.core.spec import heat_2d
    from repro_torch.program import lower, two_stage_heat
    small = heat_2d(18, 24, dtype="float64")
    line = StencilSpec((960,), (1,), ((0.25, 0.5, 0.25),), dtype="float64")
    return _k7_plans() + [map_nd(small, workers=2),
                          map_nd(small, workers=3, auto_capacity=True),
                          map_nd(line, workers=20),
                          lower(two_stage_heat(24, 32),       # 2-port imux
                                workers={"heat1": 4, "heat2": 2})]


def _k7_lanes(plans):
    from repro_torch.core import CGRA
    from repro_torch.core.engine.common import mem_elems_per_cycle
    from repro_torch.core.engine.compile import compiled_for
    return [(compiled_for(p), mem_elems_per_cycle(p.spec, CGRA, 1.0))
            for p in plans]


def _same_carry(cp, got, want):
    nN, nE = cp.n_nodes, cp.n_edges
    for k, n in (("qlen", nE), ("maxocc", nE), ("fires", nN),
                 ("active", nN)):
        assert np.array_equal(got[k][:n], want[k][:n]), k
    assert got["qlen"][nE] == want["qlen"][nE]
    for k in ("credit", "cycles", "status"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("max_cycles", [10 ** 6, 150])
def test_simbatch_matches_plain_version(dev, max_cycles):
    """One launch of K7 over ragged lanes gives the plain version's final
    carry in every field: finished, deadlocked and timed-out lanes side by
    side (at max_cycles = 150 every lane still live is cut there)."""
    from repro_torch.kernels.simbatch.kernel import simbatch
    from repro_torch.kernels.simbatch.ref import simbatch_plain
    lanes = _k7_lanes(_k7_plans())
    before = _build.LAUNCHES.get("simbatch", 0)
    got = simbatch(lanes, max_cycles, dev)
    assert _build.LAUNCHES["simbatch"] == before + 1
    want = simbatch_plain(lanes, max_cycles, dev)
    for (cp, _), g, w in zip(lanes, got, want):
        _same_carry(cp, g, w)
    status = [int(g["status"]) for g in got]
    assert status == ([1, 1, 1, 2, 1, 1, 1] if max_cycles > 150
                      else [0, 0, 0, 2, 1, 0, 0])


@pytest.fixture(scope="module")
def k7_plain():
    """``max_cycles -> (lanes, the plain version's carries)`` on the card,
    each computed once for the module (~1.7 ms a cycle)."""
    from repro_torch.kernels.simbatch.ref import simbatch_plain
    done = {}

    def get(max_cycles):
        if max_cycles not in done:
            lanes = _k7_lanes(_k7_matrix())
            done[max_cycles] = lanes, simbatch_plain(lanes, max_cycles,
                                                     "cuda")
        return done[max_cycles]
    return get


@pytest.mark.parametrize("items", [1, 4, 32])
@pytest.mark.parametrize("max_cycles", [10 ** 6, 150])
def test_simbatch_instances_match_plain_version(dev, k7_plain, items,
                                                max_cycles):
    """Each ITEMS instance, forced on every lane it holds, gives the plain
    version's final carry in every field: ragged lanes up to the paper's
    w = 16 (1,665 nodes, 2,432 edges: past 1,024 threads at ITEMS 1,
    which refuses it), 40 memory nodes, a deadlock and lanes cut at
    max_cycles = 150."""
    from repro_torch.kernels.simbatch import kernel as k7
    lanes, want = k7_plain(max_cycles)
    held = [i for i, (cp, _) in enumerate(lanes)
            if k7.lane_threads(cp.n_nodes, cp.n_edges, len(cp.mem_ids), items)
            <= k7.INSTANCES[items]]
    refused = [lanes[i][0].n_nodes for i in range(len(lanes))
               if i not in held]
    assert refused == ([1665] if items == 1 else [])
    if refused:
        with pytest.raises(ValueError, match="cannot hold"):
            k7.pack(lanes, items=items)
    d = k7.upload(k7.pack([lanes[i] for i in held], items=items), dev)
    k7.launch(d, max_cycles)
    torch.cuda.synchronize()
    assert d.packed.items == items
    for i, g in zip(held, k7.unpack(d)):
        _same_carry(lanes[i][0], g, want[i])


def _k7_input(plan, seed):
    rng = np.random.default_rng(seed)
    if hasattr(plan, "pack_inputs"):               # a program plan
        return plan.pack_inputs({f: rng.normal(size=plan.program.grid_shape)
                                 for f in plan.program.in_fields})
    return rng.normal(size=plan.spec.grid_shape)


def test_simbatch_results_equal_the_vector_engine(dev):
    """simulate_batch on the card against the vector engine: every
    observable, the deadlock as a value with the same message."""
    from repro_torch.core import CGRA
    from repro_torch.core.simulator import simulate_batch

    def items():
        return [(p, _k7_input(p, i)) for i, p in enumerate(_k7_plans())]

    got = simulate_batch(items(), CGRA, device=dev)
    want = simulate_batch(items(), CGRA, engine="vector")
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        if isinstance(b, Exception):
            assert type(a) is type(b) and str(a) == str(b)
            assert a.cycles == b.cycles
            continue
        assert (a.cycles, a.fires, a.loads, a.stores, a.flops,
                a.max_queue_total) == (b.cycles, b.fires, b.loads, b.stores,
                                       b.flops, b.max_queue_total)
        assert a.output.tobytes() == b.output.tobytes()


def test_simbatch_barrier_instance_runs(dev):
    from repro_torch.kernels.simbatch.kernel import barrier_ms
    assert 0 < barrier_ms(128, 3000, dev) < 1e3


@st.composite
def _spec_1d(draw):
    """``spec_1d`` of tests/test_property.py: r 1-4, n up to 160."""
    from repro_torch.core.spec import StencilSpec
    r = draw(st.integers(1, 4))
    n = draw(st.integers(max(8 * r + 2, 24), 160))
    coeffs = tuple(
        draw(st.lists(st.floats(-1, 1, allow_nan=False, width=32),
                      min_size=2 * r + 1, max_size=2 * r + 1)))
    return StencilSpec((n,), (r,), (coeffs,), dtype="float32")


def test_kernel_matches_oracle_property(dev):
    """tests/test_property.py's "kernel == oracle" on the card: K1 (vpu) and
    K2 (mxu) with ``backend="cuda"`` (nothing can fall back), the same
    strategies, settings, block and atol, against ``stencil1d_ref``.  The
    property runs inside the test, as ``dev`` cannot feed a hypothesis
    test."""
    @given(_spec_1d(), st.integers(0, 2 ** 31 - 1), st.integers(1, 2),
           st.sampled_from(["vpu", "mxu"]))
    @settings(max_examples=25, deadline=None)
    def prop(spec, seed, t, variant):
        rng = np.random.default_rng(seed)
        (n,) = spec.grid_shape
        if spec.radii[0] * t * 2 >= n:
            return
        x = torch.tensor(rng.normal(size=(1, n)), dtype=torch.float32,
                         device=dev)
        name = f"stencil1d_{variant}"
        before = _build.LAUNCHES.get(name, 0)
        y = stencil1d(x, spec.coeffs[0], timesteps=t, backend="cuda",
                      variant=variant, block=(1, 128))
        assert _build.LAUNCHES[name] == before + 1
        yr = stencil1d_ref(x, spec.coeffs[0], timesteps=t)
        np.testing.assert_allclose(y.cpu().numpy(), yr.cpu().numpy(),
                                   atol=1e-4)

    prop()


# ---- the multi-device slice: gloo ranks sharing the card --------------------
# (grid, radii, timesteps, mesh shape): grids ragged against the kernels'
# tiles; 2D and 3D split once along each mesh axis in turn
CASES_DIST = [
    ((2002,), (8,), 3, (2,)),
    ((74, 106), (2, 3), 2, (2, 1)),
    ((74, 106), (12, 12), 2, (1, 2)),
    ((18, 26, 45), (1, 1, 2), 2, (2, 1)),
    ((18, 26, 45), (2, 2, 2), 2, (1, 2)),
]


def _dist_spec(grid, radii, t, seed):
    from repro_torch.core.spec import StencilSpec
    rng = np.random.default_rng(seed)
    coeffs = tuple(tuple((rng.normal(size=2 * r + 1) / (2 * r + 1)).tolist())
                   for r in radii)
    return StencilSpec(grid, radii, coeffs, timesteps=t), rng.normal(
        size=grid).astype(np.float32)


def _distributed_rank() -> dict:
    """One of 2 gloo ranks on the card: each case of ``CASES_DIST`` through
    ``distributed_stencil{1,2,3}d`` on CUDA shards, and ``int8_psum`` on a
    CUDA tensor; its parts of each output and its launches per case."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed import halo
    from repro_torch.distributed.collectives import int8_psum
    from repro_torch.distributed.sharding import (PartitionSpec,
                                                  make_mesh_compat,
                                                  placements, shard_offsets)
    out = {"cases": []}
    for i, (grid, radii, t, mesh_shape) in enumerate(CASES_DIST):
        spec, x = _dist_spec(grid, radii, t, i)
        axes = ("data",) if len(grid) == 1 else ("pod", "data")
        mesh = make_mesh_compat(mesh_shape, axes)
        build = (lambda s: halo.distributed_stencil1d(s, mesh, "data"),
                 lambda s: halo.distributed_stencil2d(s, mesh, axes),
                 lambda s: halo.distributed_stencil3d(s, mesh, axes)
                 )[len(grid) - 1]
        place = placements(PartitionSpec(*axes), mesh)
        xd = distribute_tensor(torch.from_numpy(x).cuda(), mesh, place,
                               src_data_rank=None)
        _build.reset_launches()
        y = build(spec)(xd).to_local()
        assert y.is_cuda
        out["cases"].append((shard_offsets(y.shape, mesh, place,
                                           mesh.get_coordinate()),
                             y.cpu().numpy(), dict(_build.LAUNCHES)))
    mesh = make_mesh_compat((2,), ("d",))
    rank = mesh.get_coordinate()[0]
    xq = np.random.default_rng(9).normal(size=(2, 1000)).astype(np.float32)
    y = int8_psum(torch.from_numpy(xq[rank]).cuda(), mesh.get_group("d"))
    assert y.is_cuda
    out["psum"] = y.cpu().numpy()
    return out


@pytest.fixture(scope="module")
def distributed_world():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.launch.mesh import run_local_world
    return run_local_world(_distributed_rank, 2, timeout=600)


@pytest.mark.parametrize("i", range(len(CASES_DIST)))
def test_distributed_stencil_matches_single_device_op(dev, distributed_world,
                                                      i):
    """Each rank's shard swept by K1/K3/K4 on the card; the gathered grid
    within 2e-5 of the same op on the whole grid."""
    grid, radii, t, mesh_shape = CASES_DIST[i]
    spec, x = _dist_spec(grid, radii, t, i)
    got = np.full(grid, np.nan, np.float32)
    for r in distributed_world:
        start, a, launches = r["cases"][i]
        got[tuple(slice(s, s + n) for s, n in zip(start, a.shape))] = a
        kernel = ("stencil1d_vpu", "stencil2d", "stencil3d")[len(grid) - 1]
        assert launches.get(kernel, 0) == (t if len(grid) == 3 else 1)
    from repro_torch.distributed.halo import sweep
    want = sweep(torch.from_numpy(x).to(dev), spec).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL["float32"])


def test_int8_psum_on_cuda_tensors(dev, distributed_world):
    xq = np.random.default_rng(9).normal(size=(2, 1000)).astype(np.float32)
    true = xq.sum(axis=0)
    y0, y1 = (r["psum"] for r in distributed_world)
    assert np.array_equal(y0, y1)
    assert np.abs(y0 - true).max() / np.abs(true).max() < 0.05
