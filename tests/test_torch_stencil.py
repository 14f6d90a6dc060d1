"""Parity of the PyTorch port's stencil slice with the JAX package, on CPU.

Inputs come from a numpy seed and are handed to both packages.  The JAX
kernels run as ``tests/test_kernels.py`` runs them (Pallas ``interpret`` on
CPU); the port runs its plain versions, which are what its kernel wrappers
execute for CPU tensors.  Tolerances are the ``TOL`` table of
``tests/test_kernels.py``: f32 2e-5 (summation order and FMA contraction),
bf16 3e-2 (about one bf16 quantum at the outputs' magnitude).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import mapping as jmapping  # noqa: E402
from repro.core import reference as jreference  # noqa: E402
from repro.core import spec as jspec  # noqa: E402
from repro.kernels.stencil1d.ops import stencil1d as jstencil1d  # noqa: E402
from repro.kernels.stencil1d.ops import stencil1d_from_spec as jstencil1d_from_spec  # noqa: E402
from repro.kernels.stencil1d.ref import stencil1d_ref as jstencil1d_ref  # noqa: E402
from repro.kernels.stencil2d.ops import stencil2d as jstencil2d  # noqa: E402
from repro.kernels.stencil2d.ops import stencil2d_from_spec as jstencil2d_from_spec  # noqa: E402
from repro.kernels.stencil2d.ref import stencil2d_ref as jstencil2d_ref  # noqa: E402
from repro.kernels.stencil3d.ops import stencil3d as jstencil3d  # noqa: E402
from repro.kernels.stencil3d.ref import stencil3d_ref as jstencil3d_ref  # noqa: E402
from repro_torch.core import mapping as tmapping  # noqa: E402
from repro_torch.core import reference as treference  # noqa: E402
from repro_torch.core import spec as tspec  # noqa: E402
from repro_torch.kernels import (stencil1d, stencil1d_from_spec, stencil2d,  # noqa: E402
                                 stencil2d_from_spec, stencil3d)
from repro_torch.kernels.stencil1d.ref import stencil1d_ref  # noqa: E402
from repro_torch.kernels.stencil2d.ref import stencil2d_ref  # noqa: E402
from repro_torch.kernels.stencil3d.ref import stencil3d_ref  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 3e-2}

# the shape/dtype sweeps of tests/test_kernels.py
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
]
CASES_2D = [
    (1, 64, 128, 1, 1, 1, "float32"),
    (2, 64, 128, 2, 3, 1, "float32"),
    (1, 48, 96, 1, 1, 2, "float32"),
    (1, 72, 160, 2, 2, 3, "float32"),
    (2, 40, 140, 3, 1, 1, "float32"),
    (1, 64, 128, 1, 1, 2, "bfloat16"),
]
CASES_3D = [
    (1, 16, 16, 128, 1, 1, 1, 1, "float32"),
    (2, 16, 32, 128, 2, 1, 3, 1, "float32"),
    (1, 24, 16, 128, 1, 2, 1, 2, "float32"),
    (1, 16, 16, 128, 1, 1, 1, 1, "bfloat16"),
]


def _pair(rng, shape, dtype):
    """The same seeded values as a jax array and a torch tensor."""
    a = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def _close(y_torch, y_jax, atol):
    np.testing.assert_allclose(y_torch.float().numpy(),
                               np.asarray(y_jax, np.float32), atol=atol)


def _coeffs_1d(rng, r):
    return tuple((rng.normal(size=2 * r + 1) / (2 * r + 1)).tolist())


def _coeffs_2d(rng, ry, rx):
    cy = tuple((rng.normal(size=2 * ry + 1) / (2 * ry + 1)).tolist())
    cx = rng.normal(size=2 * rx + 1) / (2 * rx + 1)
    cx[rx] = 0.0
    return cy, tuple(cx.tolist())


def _coeffs_3d(rng, rz, ry, rx):
    cz = tuple((rng.normal(size=2 * rz + 1) / (2 * rz + 1)).tolist())
    cy = rng.normal(size=2 * ry + 1) / (2 * ry + 1)
    cy[ry] = 0.0
    cx = rng.normal(size=2 * rx + 1) / (2 * rx + 1)
    cx[rx] = 0.0
    return cz, tuple(cy.tolist()), tuple(cx.tolist())


# -- oracles: torch refs vs jnp refs -----------------------------------------
@pytest.mark.parametrize("b,n,r,t,variant,dtype", CASES_1D)
def test_stencil1d_oracle(rng, b, n, r, t, variant, dtype):
    coeffs = _coeffs_1d(rng, r)
    xj, xt = _pair(rng, (b, n), dtype)
    _close(stencil1d_ref(xt, coeffs, t), jstencil1d_ref(xj, coeffs, timesteps=t),
           TOL[dtype])


@pytest.mark.parametrize("b,ny,nx,ry,rx,t,dtype", CASES_2D)
def test_stencil2d_oracle(rng, b, ny, nx, ry, rx, t, dtype):
    cy, cx = _coeffs_2d(rng, ry, rx)
    xj, xt = _pair(rng, (b, ny, nx), dtype)
    _close(stencil2d_ref(xt, cy, cx, t), jstencil2d_ref(xj, cy, cx, timesteps=t),
           TOL[dtype])


@pytest.mark.parametrize("b,nz,ny,nx,rz,ry,rx,t,dtype", CASES_3D)
def test_stencil3d_oracle(rng, b, nz, ny, nx, rz, ry, rx, t, dtype):
    cz, cy, cx = _coeffs_3d(rng, rz, ry, rx)
    xj, xt = _pair(rng, (b, nz, ny, nx), dtype)
    _close(stencil3d_ref(xt, cz, cy, cx, t),
           jstencil3d_ref(xj, cz, cy, cx, timesteps=t), TOL[dtype])


# -- ops: the port's ops on CPU vs repro's ops through the Pallas kernels ----
@pytest.mark.parametrize("b,n,r,t,variant,dtype", CASES_1D)
def test_stencil1d_ops(rng, b, n, r, t, variant, dtype):
    coeffs = _coeffs_1d(rng, r)
    xj, xt = _pair(rng, (b, n), dtype)
    block = (min(b, 8), 128)
    y = stencil1d(xt, coeffs, timesteps=t, variant=variant, block=block)
    yj = jstencil1d(xj, coeffs, timesteps=t, backend="pallas", variant=variant,
                    block=block)
    assert y.dtype == xt.dtype and y.shape == xt.shape
    _close(y, yj, TOL[dtype])


@pytest.mark.parametrize("b,ny,nx,ry,rx,t,dtype", CASES_2D)
def test_stencil2d_ops(rng, b, ny, nx, ry, rx, t, dtype):
    cy, cx = _coeffs_2d(rng, ry, rx)
    xj, xt = _pair(rng, (b, ny, nx), dtype)
    y = stencil2d(xt, cy, cx, timesteps=t, block=(8, 128))
    yj = jstencil2d(xj, cy, cx, timesteps=t, backend="pallas", block=(8, 128))
    assert y.dtype == xt.dtype and y.shape == xt.shape
    _close(y, yj, TOL[dtype])


@pytest.mark.parametrize("b,nz,ny,nx,rz,ry,rx,t,dtype", CASES_3D)
def test_stencil3d_ops(rng, b, nz, ny, nx, rz, ry, rx, t, dtype):
    cz, cy, cx = _coeffs_3d(rng, rz, ry, rx)
    xj, xt = _pair(rng, (b, nz, ny, nx), dtype)
    y = stencil3d(xt, cz, cy, cx, timesteps=t)
    yj = jstencil3d(xj, cz, cy, cx, timesteps=t, backend="pallas",
                    block=(8, 16, 128))
    assert y.dtype == xt.dtype and y.shape == xt.shape
    _close(y, yj, TOL[dtype])


def test_ops_flatten_leading_dims(rng):
    coeffs = _coeffs_1d(rng, 2)
    xj, xt = _pair(rng, (2, 3, 256), "float32")
    _close(stencil1d(xt, coeffs, timesteps=2),
           jstencil1d(xj, coeffs, timesteps=2, backend="pallas"), TOL["float32"])


# -- core reference ----------------------------------------------------------
SPECS = {
    "paper_1d": lambda d: jspec.paper_stencil_1d(n=4096, dtype=d),
    "paper_2d": lambda d: jspec.paper_stencil_2d(ny=113, nx=240, dtype=d),
    "heat_2d_t3": lambda d: dataclasses.replace(jspec.heat_2d(64, 96, dtype=d),
                                                timesteps=3),
    "star_3d": lambda d: jspec.star_3d(16, 24, 128, r=2, dtype=d),
}


def _port_spec(jax_spec):
    return tspec.spec_from_fields(**dataclasses.asdict(jax_spec))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_stencil_reference(rng, name):
    js = SPECS[name]("float32")
    xj, xt = _pair(rng, js.grid_shape, "float32")
    _close(treference.stencil_reference(xt, _port_spec(js)),
           jreference.stencil_reference(xj, js), TOL["float32"])


@pytest.mark.parametrize("name", sorted(SPECS))
def test_stencil_reference_np(rng, name):
    js = SPECS[name]("float64")
    x = rng.normal(size=js.grid_shape)
    np.testing.assert_array_equal(treference.stencil_reference_np(x, _port_spec(js)),
                                  jreference.stencil_reference_np(x, js))


# -- copied modules ----------------------------------------------------------
@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_fields_and_derived(name):
    for dtype in ("float32", "float64", "bfloat16"):
        js = SPECS[name](dtype)
        ts = _port_spec(js)
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
        for attr in ("ndim", "points", "interior_shape", "interior_shape_fused",
                     "bytes_per_elem", "flops_per_output", "macs_per_worker"):
            assert getattr(ts, attr) == getattr(js, attr), attr
        assert ts.total_flops() == js.total_flops()
        assert ts.arithmetic_intensity() == js.arithmetic_intensity()
        assert ts.arithmetic_intensity_fused() == js.arithmetic_intensity_fused()


def test_spec_constructors_identical():
    pairs = [
        (tspec.paper_stencil_1d(), jspec.paper_stencil_1d()),
        (tspec.paper_stencil_2d(), jspec.paper_stencil_2d()),
        (tspec.heat_2d(32, 48), jspec.heat_2d(32, 48)),
        (tspec.heat_3d(16, 16, 32), jspec.heat_3d(16, 16, 32)),
        (tspec.star_3d(64, 64, 256, r=2, dtype="float32"),
         jspec.star_3d(64, 64, 256, r=2, dtype="float32")),
    ]
    for ts, js in pairs:
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("budget,lane", [(8 * 1024 * 1024, 128), (232_448, 32),
                                         (48 * 1024, 32), (4096, 128)])
def test_plan_blocks_identical(name, budget, lane):
    js = SPECS[name]("float32")
    ts = _port_spec(js)
    assert (tmapping.minimal_working_set_bytes(ts)
            == jmapping.minimal_working_set_bytes(js))
    try:
        want = dataclasses.asdict(jmapping.plan_blocks(js, budget, lane))
    except ValueError:
        with pytest.raises(ValueError):
            tmapping.plan_blocks(ts, budget, lane)
        return
    assert dataclasses.asdict(tmapping.plan_blocks(ts, budget, lane)) == want


# -- the whole slice: spec -> port ops vs the JAX kernels and oracle ----------
@pytest.mark.parametrize("name", sorted(SPECS))
def test_slice_end_to_end(rng, name):
    js = SPECS[name]("float32")
    ts = _port_spec(js)
    xj, xt = _pair(rng, js.grid_shape, "float32")
    if js.ndim == 1:
        y = stencil1d_from_spec(xt, ts)
        yj = jstencil1d_from_spec(xj, js, backend="pallas")
    elif js.ndim == 2:
        y = stencil2d_from_spec(xt, ts)
        yj = jstencil2d_from_spec(xj, js, backend="pallas")
    else:
        y = stencil3d(xt, *ts.coeffs, timesteps=ts.timesteps)
        yj = jstencil3d(xj, *js.coeffs, timesteps=js.timesteps,
                        backend="pallas")
    assert y.shape == xt.shape and torch.isfinite(y).all()
    _close(y, yj, TOL["float32"])
    _close(y, jreference.stencil_reference(xj, js), TOL["float32"])


def test_zero_and_centre_taps(rng):
    """Zero taps inside a chain and non-zero centre taps on every axis."""
    c1 = (0.1, 0.0, 0.5, 0.0, 0.2)
    xj, xt = _pair(rng, (3, 1000), "float32")
    for variant in ("vpu", "mxu"):
        _close(stencil1d(xt, c1, timesteps=2, variant=variant),
               jstencil1d(xj, c1, timesteps=2, backend="pallas",
                          variant=variant), TOL["float32"])
    cy, cx = (0.2, 0.3, 0.1), (0.05, 0.25, 0.0, 0.1, 0.05)
    xj, xt = _pair(rng, (2, 70, 90), "float32")
    _close(stencil2d(xt, cy, cx, timesteps=3),
           jstencil2d(xj, cy, cx, timesteps=3, backend="pallas"), TOL["float32"])
    cz, cy, cx = (0.1, 0.3, 0.1), (0.05, 0.2, 0.05), (0.0, 0.1, 0.1, 0.1, 0.0)
    xj, xt = _pair(rng, (2, 20, 30, 40), "float32")
    _close(stencil3d(xt, cz, cy, cx, timesteps=2),
           jstencil3d(xj, cz, cy, cx, timesteps=2, backend="pallas",
                      block=(8, 16, 128)), TOL["float32"])


# Keywords of the reference ops that the port's ops drop by design: they size
# Pallas blocks and a VMEM budget, and the hand-written kernels pick their own
# tiles from the card's shared memory (ROADMAP Queue 3).  A keyword the port
# took and ignored would hide that.
DROPPED_KEYWORDS = {
    "causal_conv1d": {"block_s", "block_c"},
    "sliding_window_attention": {"block"},
    "stencil3d": {"vmem_budget_bytes"},
}


@pytest.mark.parametrize("module,name", [
    ("stencil1d", "stencil1d"), ("stencil1d", "stencil1d_from_spec"),
    ("stencil2d", "stencil2d"), ("stencil2d", "stencil2d_from_spec"),
    ("stencil3d", "stencil3d"), ("conv1d", "causal_conv1d"),
    ("swa", "sliding_window_attention"),
])
def test_op_keywords_match_the_reference(module, name):
    """Each public op takes the reference op's parameters, in its order,
    less the recorded set of dropped tile keywords: a new difference fails
    here until it is recorded."""
    import importlib
    import inspect
    ref = importlib.import_module(f"repro.kernels.{module}.ops")
    port = importlib.import_module(f"repro_torch.kernels.{module}.ops")
    want = [p for p in inspect.signature(getattr(ref, name)).parameters
            if p not in DROPPED_KEYWORDS.get(name, set())]
    assert list(inspect.signature(getattr(port, name)).parameters) == want
    assert DROPPED_KEYWORDS.get(name, set()) <= set(
        inspect.signature(getattr(ref, name)).parameters)
