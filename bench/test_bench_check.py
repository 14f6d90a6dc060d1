"""The comparison that decides ``correct``, driven through whole runs on
the CPU at small sizes (the op runs the port's plain version there): a
sound run is correct; the control, the program's own bfloat16 path, is
not; nor is a run whose timed path is broken underneath, once for each
fault a one-chip stencil cell can have.  The per-layer readers on a
reading made by hand."""
import importlib

import pytest
import torch

from bench import harness

CPU = torch.device("cpu")
SMALL = {"seismic2d-r12.shots16384-t1": ((40, 56), 2),
         "star3d-r2.grids52-t1": ((14, 16, 18), 1)}
D2 = "seismic2d-r12.shots16384-t1"
SEED = 2**31 + 12345


def small_run(name: str, dtype: str | None = None) -> dict:
    grid, batch = SMALL[name]
    cell = harness.load_cell(name, grid=grid, batch=batch)
    return harness.run(cell, SEED, 0.3, False, CPU, dtype=dtype)


@pytest.mark.parametrize("name", SMALL)
def test_a_sound_run_is_correct(name):
    r = small_run(name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    checks = r["checks"]
    assert list(r)[-1] == "checks"
    assert 0 <= checks["chunk_err"]["value"] < checks["chunk_err"]["limit"]
    assert checks["receiver_diffs"]["value"] == 0
    assert set(r["metrics"]) == {"gpts_per_s", "chunk_ms_p95", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())


@pytest.mark.parametrize("name", SMALL)
def test_the_bfloat16_control_is_not_correct(name):
    r = small_run(name, dtype="bfloat16")
    assert not r["correct"]
    assert r["checks"]["chunk_err"]["value"] > 10 * r["checks"]["chunk_err"]["limit"]


def unchanged(op):
    return lambda x, *taps, timesteps: x


def half_left_out(op):
    def call(x, *taps, timesteps):
        y = op(x, *taps, timesteps=timesteps)
        b = y.shape[0] // 2 if y.shape[0] > 1 else None
        if b:
            y[b:] = x[b:]           # half of the shots never stepped
        else:
            y[..., y.shape[-3] // 2:, :, :] = x[..., x.shape[-3] // 2:, :, :]
        return y
    return call


def one_value_altered(op):
    def call(x, *taps, timesteps):
        y = op(x, *taps, timesteps=timesteps)
        flat = y.view(-1)
        flat[flat.numel() // 2 + 3] += flat.abs().max()
        return y
    return call


@pytest.mark.parametrize("fault", [unchanged, half_left_out, one_value_altered])
@pytest.mark.parametrize("name", SMALL)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    config = harness.load("configs", harness.load("workloads", name)["config"])
    module = importlib.import_module(config["op"]["module"])
    fn = config["op"]["function"]
    monkeypatch.setattr(module, fn, fault(getattr(module, fn)))
    r = small_run(name)
    assert not r["correct"] and r["failed"] >= 1


@pytest.mark.parametrize("step", [-1, 0], ids=["last", "first"])
def test_a_receiver_line_that_differs_is_not_correct(step, monkeypatch):
    """A line recorded that is not the plane of the output it came from:
    the chunk's last line fails the exact link, an earlier one the
    reference's gap."""
    copy = harness.Loop.chunk

    def chunk(self, k, call_s, annotate):
        marks = copy(self, k, call_s, annotate)
        self.lines[k % 3][step, 0] += 1.0
        return marks

    monkeypatch.setattr(harness.Loop, "chunk", chunk)
    r = small_run(D2)
    assert not r["correct"]
    if step == -1:
        assert r["checks"]["receiver_diffs"]["value"] > 0
    else:
        assert r["checks"]["chunk_err"]["value"] > r["checks"]["chunk_err"]["limit"]


def test_each_step_is_recorded_and_sent_once_a_chunk():
    """After a chunk the host holds the receiver line of every call of it,
    each the plane of that call's output."""
    grid, batch = SMALL[D2]
    cell = harness.load_cell(D2, grid=grid, batch=batch)
    taps = ((0.1,) * 25, (0.05,) * 12 + (0.0,) + (0.05,) * 12)
    x = torch.randn(batch, *grid)
    loop = harness.Loop(cell, taps, x.clone())
    loop.chunk(0, None, False)
    axis, index = cell.receiver
    want = x
    for i in range(cell.calls):
        want = loop.call(want)
        assert torch.equal(loop.lines[0][i], want.select(axis, index))
    assert torch.equal(loop.x, want)


def test_a_sample_of_the_fields_is_held():
    """Where the batch is larger than the sample, the held fields are those
    the seed drew, taken from the stream as the chunk began and ended."""
    grid = SMALL[D2][0]
    cell = harness.load_cell(D2, grid=grid, batch=5)
    cell.traffic = {**cell.traffic, "check_fields": 2}
    r = harness.run(cell, SEED, 0.3, False, CPU)
    assert r["correct"]
    sample = harness.inputs.check_sample(SEED, 5, cell.traffic["check_chunks"], 2)
    assert all(len(f) == 2 for f in sample) and len({tuple(f) for f in sample}) > 1
    taps = harness.inputs.star_taps(cell.config["grid"], cell.config["radii"],
                                    cell.config["spectral_radius"],
                                    cell.config["taps_seed"])
    x0 = harness.inputs.fields(cell.shape, torch.float32, SEED, CPU)
    loop = harness.Loop(cell, taps, x0.clone())
    loop.reserve(sample)
    win = loop.run(chunks=1, hold_at=[])
    (h,) = win.held
    assert h.fields == sample[0] and h.line_before is None
    assert torch.equal(h.x_in, x0[sample[0]])
    assert h.lines.shape == (cell.calls, 2, grid[1])


def test_a_fault_in_fields_outside_the_sample_goes_unseen_by_design(monkeypatch):
    """The comparison reads the sampled fields only: a fault confined to
    the others is not seen (PERF.md gives the odds for a fault in a share
    of the fields); one in a sampled field is."""
    grid = SMALL[D2][0]
    cell = harness.load_cell(D2, grid=grid, batch=4)
    cell.traffic = {**cell.traffic, "check_chunks": 1, "check_fields": 1}
    (fields,) = harness.inputs.check_sample(SEED, 4, 1, 1)
    module = importlib.import_module(cell.config["op"]["module"])
    op = getattr(module, cell.config["op"]["function"])
    for bad, seen in ((fields[0], True), ((fields[0] + 1) % 4, False)):
        def call(x, *taps, timesteps, bad=bad):
            y = op(x, *taps, timesteps=timesteps)
            y[bad] = x[bad]
            return y
        monkeypatch.setattr(module, cell.config["op"]["function"], call)
        r = harness.run(cell, SEED, 0.1, False, CPU)
        assert r["correct"] is not seen


def reading() -> harness.Reading:
    cell = harness.load_cell(D2)
    win = harness.Window(wall_s=2.0, calls=1000, chunk_ms=[16.0] * 31,
                         call_s=[40e-6] * 1000, launches=1000, held=[])
    prof = harness.Profile(wall_s=0.5, calls=960,
                           kernels={"void stencil2d_kernel<float, 12>(...)": [0.48, 960],
                                    "Memcpy DtoH (Device -> Pinned)": [0.003, 30]},
                           busy_s=0.49, gaps=[])
    return harness.Reading(cell, least_call_s=0.25e-3, window=win, profile=prof)


@pytest.mark.parametrize("name,want", [
    ("host_us_per_call", 40.0), ("launches_per_step", 1.0),
    ("k3_roofline_frac", 50.0), ("k4_roofline_frac", None),
    ("device_idle_frac", 2.0)])
def test_readers(name, want):
    got = harness.load_metric(name).read(reading())
    assert got == (None if want is None else pytest.approx(want))


def test_readers_find_nothing_without_a_trace():
    r = reading()
    r.profile = None
    for name in ("k3_roofline_frac", "device_idle_frac"):
        assert harness.load_metric(name).read(r) is None


def test_p95_by_nearest_rank():
    assert harness.p95(list(range(1, 101))) == 95
    assert harness.p95([3.0]) == 3.0
