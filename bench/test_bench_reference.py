"""The plain reference against an independent NumPy loop over every point,
rim included, and the yardstick's arithmetic; the taps from the seed."""
import math

import numpy as np
import pytest
import torch

from bench import inputs, reference, yardstick


def numpy_call(x: np.ndarray, coeffs, timesteps: int) -> np.ndarray:
    """One call, point by point: sweep t writes the points at least r*t from
    every face and zero elsewhere."""
    nd = len(coeffs)
    rs = [(len(c) - 1) // 2 for c in coeffs]
    shape = x.shape[-nd:]
    for t in range(1, timesteps + 1):
        out = np.zeros_like(x)
        for p in np.ndindex(*shape):
            if any(i < r * t or i >= n - r * t for i, r, n in zip(p, rs, shape)):
                continue
            acc = np.zeros(x.shape[:-nd])
            for ax, (r, cs) in enumerate(zip(rs, coeffs)):
                for k, c in enumerate(cs):
                    q = list(p)
                    q[ax] += k - r
                    acc = acc + c * x[(..., *q)]
            out[(..., *p)] = acc
        x = out
    return x


@pytest.mark.parametrize("timesteps", [1, 4])
@pytest.mark.parametrize("grid,radii", [((22, 19), (2, 1)),
                                        ((11, 12, 13), (1, 1, 1))],
                         ids=["2d", "3d"])
def test_reference_matches_numpy_loop(grid, radii, timesteps):
    rng = np.random.default_rng(3)
    coeffs = [tuple(rng.normal(size=2 * r + 1)) for r in radii]
    x = rng.normal(size=(2, *grid))
    want = numpy_call(x, coeffs, timesteps)
    got = reference.star_call(torch.from_numpy(x), coeffs, timesteps).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # the rim of the last sweep is zero, the point inside it is not
    r0 = radii[0] * timesteps
    assert not got[:, :r0].any() and got[:, r0].any()


def test_chunk_chains_calls():
    coeffs = [(0.2, 0.5, 0.2), (0.1, 0.0, 0.1)]
    x = torch.randn(1, 12, 13, dtype=torch.float64)
    first = reference.star_call(x, coeffs, 2)
    once = reference.star_call(first, coeffs, 2)
    out, planes = reference.star_chunk(x, coeffs, 2, 2, -2, 4)
    assert torch.equal(out, once)
    assert torch.equal(planes, torch.stack([first[:, 4], once[:, 4]]))


def test_gap():
    want = torch.tensor([0.0, 2.0, -4.0], dtype=torch.float64)
    assert reference.gap(want.float(), want) == 0.0
    assert reference.gap(torch.tensor([0.0, 2.0, -3.0]), want) == 0.25
    assert reference.gap(torch.tensor([0.0, float("nan"), -4.0]), want) == math.inf
    assert reference.gap(want, torch.zeros(3, dtype=torch.float64)) == math.inf


@pytest.mark.parametrize("shape,ms", [((256, 449, 960), 0.2635),
                                      ((1, 512, 512, 512), 0.3205)],
                         ids=["2d", "3d"])
def test_least_call_is_the_bytes_bound(shape, ms):
    nd = len(shape) - 1
    coeffs = [(1.0,) * 25 if nd == 2 else (1.0,) * 5] * nd
    least, by = yardstick.least_call(shape, "float32", coeffs, 1, "sxm")
    assert by == "bytes"
    assert least * 1e3 == pytest.approx(ms, abs=5e-5)


def test_ops_bound_is_the_lesser_of_fp32_and_3xtf32():
    s, by = yardstick.ops_bound(1e12, "float32", "sxm")
    assert by == "3xTF32 tensor cores"
    assert s == pytest.approx(3e12 / 494.5e12)
    assert yardstick.ops_bound(1e12, "bfloat16", "pcie")[0] == 1e12 / 756e12
    # at T = 16 the 49-point star's operations pass its bytes
    coeffs = [(1.0,) * 25, (1.0,) * 12 + (0.0,) + (1.0,) * 12]
    t, by = yardstick.least_call((256, 449, 960), "float32", coeffs, 16, "sxm")
    assert by.startswith("operations")
    assert yardstick.star_taps(coeffs) == 49


@pytest.mark.parametrize("grid,radii", [((30, 41), (3, 2)),
                                        ((9, 10, 11), (1, 1, 1))],
                         ids=["2d", "3d"])
def test_taps_have_the_stated_spectral_radius(grid, radii):
    taps = inputs.star_taps(grid, radii, 0.9998, 2**31 + 99)
    assert taps == inputs.star_taps(grid, radii, 0.9998, 2**31 + 99)
    assert taps != inputs.star_taps(grid, radii, 0.9998, 5)
    for ax, (c, r) in enumerate(zip(taps, radii)):
        assert c == c[::-1] and (c[r] == 0.0) == (ax > 0)
        assert all(v == float(np.float32(v)) for v in c)
    # the rim-masked step as a matrix over the interior, one column a point
    inner = [slice(r, n - r) for r, n in zip(radii, grid)]
    m = math.prod(n - 2 * r for r, n in zip(radii, grid))
    basis = torch.zeros(m, *grid, dtype=torch.float64)
    basis[(slice(None), *inner)] = torch.eye(m).reshape(m, *basis[(0, *inner)].shape)
    cols = reference.star_call(basis, taps, 1)[(slice(None), *inner)].reshape(m, m)
    assert torch.linalg.eigvalsh(cols).abs().max().item() == pytest.approx(
        0.9998, abs=1e-6)


def test_check_fractions_from_the_seed():
    f = inputs.check_fractions(2**33 + 1, 2)
    assert f == sorted(f) and all(0 <= v < 1 for v in f)
    assert f == inputs.check_fractions(2**33 + 1, 2)


class _Ev:
    def __init__(self, name, start_us, end_us, device="CUDA", annotation=False):
        self.name, self.is_user_annotation = name, annotation
        self.device_type = type("D", (), {"name": device})
        self.time_range = type("T", (), {"start": start_us, "end": end_us})


def test_device_ops_gaps_and_annotations():
    events = [_Ev("k", 0, 100), _Ev("k", 150, 250), _Ev("copy", 240, 260),
              _Ev("bench.issue", 0, 250), _Ev("ann", 0, 400, annotation=True),
              _Ev("bench.issue", 255, 400, device="CPU"),
              _Ev("k", 400, 500)]
    assert yardstick.device_ops(events) == {
        "k": [pytest.approx(300e-6), 3], "copy": [pytest.approx(20e-6), 1]}
    iv = yardstick.device_intervals(events)
    assert iv == [(0.0, 100e-6), (150e-6, 260e-6), (400e-6, 500e-6)]
    spans = [("bench.issue", 255e-6, 400e-6)]
    assert yardstick.idle_gaps(iv, spans) == [
        ["bench.issue", pytest.approx(140e-6)],
        ["between spans", pytest.approx(50e-6)]]
