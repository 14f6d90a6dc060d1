"""The port's CGRA model on its own: no jax needed, so it also runs where
the port runs.

- The paper's §VI / §VIII arithmetic (the numbers
  ``tests/test_paper_validation.py`` pins on the reference), on the port.
- Interp against vector within the port: every observable bit-identical.
- ``examples/quickstart_torch.py --device cpu`` end to end.
- The batched device engine is not ported: ``engine="jax"`` and
  ``simulate_batch`` raise ``NotImplementedError``.
- ``H100_SXM`` / ``H100_PCIE`` hold the datasheet peaks ``chip_smoke.py``
  bounds its kernels with.
"""
import dataclasses
import importlib.util
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from repro_torch.analysis import StaticDeadlock, verify_plan
from repro_torch.core import (CGRA, H100_PCIE, H100_SXM, V100, SimDeadlock,
                              analyze, crossover_timesteps, map_1d, map_2d,
                              map_3d, simulate)
from repro_torch.core.reference import stencil_reference_np
from repro_torch.core.roofline import (select_workers, worker_demand_gflops,
                                       workers_demanded)
from repro_torch.core.simulator import ENGINES, simulate_batch
from repro_torch.core.spec import (StencilSpec, heat_2d, heat_3d,
                                   paper_stencil_1d, paper_stencil_2d)
from repro_torch.fabric import FabricTopology, place, route

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# paper §VI / §VIII numbers (tests/test_paper_validation.py, on the port)
# ---------------------------------------------------------------------------
def test_arithmetic_intensities_and_cgra_peak():
    # paper: (16*2+1)*(194400-16)/((194400+194400)*8) = 2.06
    assert abs(paper_stencil_1d().arithmetic_intensity() - 2.06) < 0.01
    # paper: (48*2+1)*((449-24)*(960-24))/((2*960*449)*8) = 5.59
    assert abs(paper_stencil_2d().arithmetic_intensity() - 5.59) < 0.01
    assert abs(CGRA.peak_gflops - 614.4) < 1e-9      # 2*256*1.2


def test_1d_roofline_and_worker_selection():
    r = analyze(paper_stencil_1d(), CGRA)
    assert abs(r.bw_bound_gflops - 206.2) < 0.5      # paper: 206
    assert r.workers == 6                            # paper: 6 workers
    assert abs(r.worker_demand_gflops - 237.6) < 0.1  # paper: 237.6
    assert r.bound == "memory"


def test_2d_roofline_and_worker_fit():
    s = paper_stencil_2d()
    r = analyze(s, CGRA)
    assert s.macs_per_worker == 49                   # 48 MAC + 1 MUL
    assert r.workers == 5                            # paper: 5 fit
    assert abs(worker_demand_gflops(s, CGRA, 5) - 582.0) < 0.1
    assert abs(r.achievable_gflops - 559.5) < 1.0    # paper: 559


def test_table1_speedup_ratios_and_v100_peak():
    """16 CGRA tiles vs V100, with the paper's own %-of-peak figures."""
    cgra16 = CGRA.scaled(16)
    s1, s2 = paper_stencil_1d(), paper_stencil_2d()
    cgra_1d = analyze(s1, cgra16).achievable_gflops * 0.91
    v100_1d = analyze(s1, V100).achievable_gflops * 0.90
    assert abs(cgra_1d / v100_1d - 1.9) < 0.1        # paper: 1.9x
    cgra_2d = analyze(s2, cgra16).achievable_gflops * 0.78
    v100_2d = analyze(s2, V100).achievable_gflops * 0.48
    assert abs(cgra_2d / v100_2d - 3.03) < 0.15      # paper: 3.03x
    assert abs(v100_2d / 1000 - 2.3) < 0.05          # paper: 2.3 TFLOPS
    assert abs(analyze(s2, V100).achievable_gflops / 1000 - 4.8) < 0.1


def test_fusion_crossover_and_uncapped_paper_workers():
    assert crossover_timesteps(paper_stencil_1d(), CGRA, workers=6) == 3
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert select_workers(paper_stencil_1d(), CGRA) == 6
        assert select_workers(paper_stencil_2d(), CGRA) == 5
    for s, w in ((paper_stencil_1d(), 6), (paper_stencil_2d(), 5)):
        r = analyze(s, CGRA)
        assert not r.capped and r.workers_demanded == w


def test_select_workers_cap_warns_and_reports():
    tiny = dataclasses.replace(CGRA, name="cgra_tiny", num_macs=64)
    s = paper_stencil_2d()
    need = workers_demanded(s, tiny)
    assert need > 1
    with pytest.warns(RuntimeWarning, match="exceeds the 1 that physically"):
        assert select_workers(s, tiny) == 1
    r = analyze(s, tiny)
    assert r.capped and r.workers == 1 and r.workers_demanded == need
    assert not analyze(s, tiny, workers=1).capped


@pytest.mark.parametrize("machine", [H100_SXM, H100_PCIE])
def test_h100_roofline_is_memory_bound_for_the_paper_cases(machine):
    """No PE model: the worker count is the bandwidth demand, uncapped."""
    for s in (paper_stencil_1d(dtype="float32"),
              paper_stencil_2d(dtype="float32")):
        r = analyze(s, machine)
        assert r.bound == "memory" and not r.capped
        assert r.achievable_gflops == machine.bw_gbps * r.arithmetic_intensity
        assert r.workers == r.workers_demanded == workers_demanded(s, machine)


# ---------------------------------------------------------------------------
# interp against vector within the port
# ---------------------------------------------------------------------------
def _view(plan, res):
    return (res.cycles, res.fires, res.loads, res.stores, res.flops,
            res.max_queue_total, res.gflops, res.fabric,
            res.output.tobytes(), {n.name: n.fires for n in plan.dfg.nodes})


def _both(mk_plan, x, routed=False, **kw):
    views = []
    for engine in ("interp", "vector"):
        plan = mk_plan()
        fab = (route(place(plan, FabricTopology.mesh(16, 16), seed=0))
               if routed else None)
        views.append(_view(plan, simulate(plan, x, CGRA, fabric=fab,
                                          engine=engine, **kw)))
    return views


INTERP_VECTOR = [
    ("quickstart", lambda: StencilSpec((6000,), (2,),
                                       ((0.1, 0.2, 0.4, 0.2, 0.1),),
                                       dtype="float64"), map_1d, 6, False),
    ("paper_1d_2400", lambda: paper_stencil_1d(n=2400), map_1d, 6, False),
    ("1d_240_routed", lambda: StencilSpec((240,), (2,),
                                          ((0.1, 0.2, 0.4, 0.2, 0.1),),
                                          dtype="float64"), map_1d, 4, True),
    ("paper_2d_30x48", lambda: paper_stencil_2d(ny=30, nx=48, r=12), map_2d,
     8, False),
    ("paper_2d_30x48_routed", lambda: paper_stencil_2d(ny=30, nx=48, r=12),
     map_2d, 8, True),
    ("heat_3d", lambda: heat_3d(10, 12, 16, dtype="float64"), map_3d, 8,
     False),
    ("heat_3d_routed", lambda: heat_3d(10, 12, 16, dtype="float64"), map_3d,
     8, True),
]


@pytest.mark.parametrize("name,mk,mapper,w,routed", INTERP_VECTOR)
def test_interp_equals_vector(rng, name, mk, mapper, w, routed):
    spec = mk()
    x = rng.normal(size=spec.grid_shape)
    a, b = _both(lambda: mapper(spec, workers=w), x, routed=routed)
    assert a == b
    np.testing.assert_allclose(np.frombuffer(b[8]).reshape(spec.grid_shape),
                               stencil_reference_np(x, spec), atol=1e-9)


def test_routed_output_equals_ideal_and_is_no_faster(rng):
    spec = paper_stencil_1d(n=2400)
    x = rng.normal(size=2400)
    ideal = simulate(map_1d(spec, workers=6), x, CGRA, engine="vector")
    plan = map_1d(spec, workers=6)
    rf = route(place(plan, FabricTopology.mesh(16, 16), seed=0))
    routed = simulate(plan, x, CGRA, fabric=rf, engine="vector")
    assert routed.output.tobytes() == ideal.output.tobytes()
    assert routed.cycles >= ideal.cycles


def test_deadlock_interp_equals_vector_and_carries_repair(rng):
    spec = heat_2d(18, 24, dtype="float64")
    x = rng.normal(size=spec.grid_shape)
    got = []
    for engine in ("interp", "vector"):
        with pytest.raises(SimDeadlock) as ei:
            simulate(map_2d(spec, workers=3, queue_capacity=1), x, CGRA,
                     max_cycles=200_000, engine=engine)
        e = ei.value
        got.append((str(e), e.cycles, e.stall_summary,
                    e.suggested_capacities))
    assert got[0] == got[1] and got[1][3]
    with pytest.raises(StaticDeadlock) as ei:
        simulate(map_2d(spec, workers=3, queue_capacity=1), x, CGRA,
                 verify="static")
    assert isinstance(ei.value, SimDeadlock) and ei.value.cycles == 0
    assert verify_plan(map_2d(spec, workers=3, auto_capacity=True)).ok()


# ---------------------------------------------------------------------------
# the example entry point, and what is not ported
# ---------------------------------------------------------------------------
def test_quickstart_torch_on_cpu(capsys, tmp_path):
    path = ROOT / "examples" / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    dot = tmp_path / "stencil1d.dot"
    mod.main(["--device", "cpu", "--dot", str(dot)])
    out = capsys.readouterr().out
    assert "w*=6" in out
    assert "matches oracle: True (loads == grid size: True)" in out
    errs = [float(line.rsplit(":", 1)[1]) for line in out.splitlines()
            if "max err vs" in line]
    assert len(errs) == 2 and max(errs) < 2e-5
    assert dot.read_text().startswith('digraph "stencil1d_6000_r2_w6_t1"')


def test_device_engine_is_not_ported(rng):
    """The reference's device engine is not ported under its name: "jax"
    is no engine of the port, for ``simulate`` and ``simulate_batch``
    alike (the port's device engine is "cuda")."""
    spec = StencilSpec((120,), (1,), ((0.25, 0.5, 0.25),), dtype="float64")
    plan, x = map_1d(spec, workers=3), rng.normal(size=120)
    assert "jax" not in ENGINES and "cuda" in ENGINES
    with pytest.raises(ValueError, match="unknown engine"):
        simulate(plan, x, CGRA, engine="jax")
    with pytest.raises(ValueError, match="unknown engine"):
        simulate_batch([(plan, x)], CGRA, engine="jax")


def test_cuda_engine_matches_vector(rng):
    """``simulate_batch`` runs every engine of the port (the "cuda" one as
    K7's plain version on the CPU), and ``simulate(engine="cuda")`` is a
    batch of one: each equals the vector engine."""
    spec = StencilSpec((120,), (1,), ((0.25, 0.5, 0.25),), dtype="float64")
    plan, x = map_1d(spec, workers=3), rng.normal(size=120)
    want = simulate(plan, x, CGRA, engine="vector")
    for engine in ENGINES:
        (got,) = simulate_batch([(plan, x)], CGRA, engine=engine,
                                device="cpu")
        assert got.cycles == want.cycles
        assert got.output.tobytes() == want.output.tobytes()
    got = simulate(plan, x, CGRA, engine="cuda", device="cpu")
    assert (got.cycles, got.fires) == (want.cycles, want.fires)


def test_h100_machines_match_chip_smoke_peaks():
    """Byte and FP32 columns of chip_smoke.PEAKS, in bytes/s and flop/s."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    for part, m in (("sxm", H100_SXM), ("pcie", H100_PCIE)):
        bw, fp32, _bf16, _tf32 = chip_smoke.PEAKS[part]
        assert (bw, fp32) == (m.bw_gbps * 1e9, m.peak_gflops * 1e9)
        assert m.num_macs == 0 and m.link_gbps == 0.0
    assert (H100_SXM.bw_gbps, H100_SXM.peak_gflops, H100_SXM.clock_ghz) == (
        3350.0, 67_000.0, 1.98)
    assert (H100_PCIE.bw_gbps, H100_PCIE.peak_gflops,
            H100_PCIE.clock_ghz) == (2000.0, 51_000.0, 1.755)
