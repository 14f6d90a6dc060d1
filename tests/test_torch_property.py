"""The property sweep of ``tests/test_property.py`` on the PyTorch port:
its 12 properties, with the same strategies and settings, run against
``repro_torch`` on the CPU with no jax.

Stencil invariants:
  * linearity: S(ax + by) == a S(x) + b S(y)
  * shift equivariance in the interior
  * constant-field response = sum(coeffs) * c on the interior
  * kernel == oracle on arbitrary shapes/radii (on the CPU the kernel
    wrapper runs K1's plain version; the card instance, K1 and K2 with
    ``backend="cuda"``, is in ``tests/test_torch_cuda.py``)
Mapping invariants (the paper's interleave/filter algebra):
  * reader streams partition the grid exactly
  * every filter's keep-window lies inside its reader stream
  * sync expectations sum to the interior size
Explorer invariants (repro_torch.explore):
  * a Pareto front is internally non-dominated and covers its inputs
  * the measured best never loses to any measured point on cycles
Static-verifier soundness (repro_torch.analysis.static_verify), and the lint
CLI (``python -m repro_torch.analysis.lint``) over the port's walkthroughs.

Runs under real ``hypothesis`` when installed; otherwise under the port's
deterministic shim :mod:`repro_torch.testing.minihyp`, so the sweep never
silently skips.
"""
import dataclasses
import io
from pathlib import Path

import numpy as np
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # containers where hypothesis can't be installed
    from repro_torch.testing.minihyp import given, settings, strategies as st

from repro_torch.core import CGRA, simulate
from repro_torch.core.mapping import map_1d, map_nd
from repro_torch.core.reference import stencil_reference_np
from repro_torch.core.spec import StencilSpec
from repro_torch.kernels.stencil1d.ops import stencil1d
from repro_torch.kernels.stencil1d.ref import stencil1d_ref

ROOT = Path(__file__).resolve().parents[1]
# the port's walkthroughs: the examples with a lint_plans() hook (the
# training example has none)
EXAMPLES = sorted(str(p) for p in (ROOT / "examples").glob("*_torch.py")
                  if "def lint_plans" in p.read_text())

SET = dict(max_examples=25, deadline=None)


@st.composite
def spec_1d(draw):
    r = draw(st.integers(1, 4))
    n = draw(st.integers(max(8 * r + 2, 24), 160))
    coeffs = tuple(
        draw(st.lists(st.floats(-1, 1, allow_nan=False, width=32),
                      min_size=2 * r + 1, max_size=2 * r + 1)))
    return StencilSpec((n,), (r,), (coeffs,), dtype="float32")


@given(spec_1d(), st.integers(0, 2 ** 31 - 1))
@settings(**SET)
def test_linearity(spec, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=spec.grid_shape).astype(np.float32)
    y = rng.normal(size=spec.grid_shape).astype(np.float32)
    a, b = 1.7, -0.4
    lhs = stencil_reference_np(a * x + b * y, spec)
    rhs = a * stencil_reference_np(x, spec) + b * stencil_reference_np(y, spec)
    np.testing.assert_allclose(lhs, rhs, atol=1e-4)


@given(spec_1d(), st.integers(1, 5), st.integers(0, 2 ** 31 - 1))
@settings(**SET)
def test_shift_equivariance_interior(spec, shift, seed):
    rng = np.random.default_rng(seed)
    (n,) = spec.grid_shape
    (r,) = spec.radii
    x = rng.normal(size=n).astype(np.float32)
    xs = np.roll(x, shift)
    y, ys = stencil_reference_np(x, spec), stencil_reference_np(xs, spec)
    lo, hi = r + shift, n - r
    np.testing.assert_allclose(ys[lo:hi], y[lo - shift:hi - shift], atol=1e-4)


@given(spec_1d(), st.floats(-3, 3, allow_nan=False, width=32))
@settings(**SET)
def test_constant_field(spec, c):
    (n,) = spec.grid_shape
    (r,) = spec.radii
    y = stencil_reference_np(np.full(n, c, np.float32), spec)
    expect = c * sum(spec.coeffs[0])
    np.testing.assert_allclose(y[r:n - r], expect, atol=1e-3)
    assert np.all(y[:r] == 0) and np.all(y[n - r:] == 0)


@given(spec_1d(), st.integers(0, 2 ** 31 - 1), st.integers(1, 2))
@settings(**SET)
def test_kernel_matches_oracle(spec, seed, t):
    rng = np.random.default_rng(seed)
    (n,) = spec.grid_shape
    if spec.radii[0] * t * 2 >= n:
        return
    x = torch.tensor(rng.normal(size=(1, n)), dtype=torch.float32)
    y = stencil1d(x, spec.coeffs[0], timesteps=t, block=(1, 128))
    yr = stencil1d_ref(x, spec.coeffs[0], timesteps=t)
    np.testing.assert_allclose(y.numpy(), yr.numpy(), atol=1e-4)
    # and the numpy oracle of the same spec, fused T times
    want = stencil_reference_np(x[0].numpy(),
                                dataclasses.replace(spec, timesteps=t))
    np.testing.assert_allclose(y[0].numpy(), want, atol=1e-4)


@st.composite
def spec_nd_and_workers(draw):
    """Random rank-1/2/3 specs with legal workers/timesteps for map_nd."""
    d = draw(st.integers(1, 3))
    t = draw(st.integers(1, 2))
    w = draw(st.integers(1, 4))
    radii = tuple(draw(st.integers(1, 2)) for _ in range(d))
    shape = []
    for b, r in enumerate(radii):
        if b == d - 1:
            # inner extent: multiple of w (rank>=2), interior >= w workers
            lo = -(-(2 * r * t + w) // w)
            n = w * draw(st.integers(lo, lo + 4)) if d > 1 else \
                draw(st.integers(2 * r * t + w, 2 * r * t + w + 20))
        else:
            n = draw(st.integers(2 * r * t + 1, 2 * r * t + 7))
        shape.append(n)
    coeffs = tuple(
        tuple(draw(st.lists(st.floats(-1, 1, allow_nan=False, width=32),
                            min_size=2 * r + 1, max_size=2 * r + 1)))
        for r in radii)
    spec = StencilSpec(tuple(shape), radii, coeffs, dtype="float64",
                       timesteps=t)
    return spec, w


@given(spec_nd_and_workers(), st.integers(0, 2 ** 31 - 1))
@settings(max_examples=15, deadline=None)
def test_map_nd_exact_and_auto_capacity_liveness(sw, seed):
    """map_nd over random rank-1/2/3 specs: the simulated output equals the
    oracle and the analytic min-capacities (auto_capacity=True) never
    deadlock — the §III-B mandatory-buffering bound is *sufficient*."""
    spec, w = sw
    rng = np.random.default_rng(seed)
    x = rng.normal(size=spec.grid_shape)
    plan = map_nd(spec, workers=w, auto_capacity=True)
    res = simulate(plan, x, CGRA, max_cycles=2_000_000)   # deadlock -> raise
    np.testing.assert_allclose(res.output, stencil_reference_np(x, spec),
                               atol=1e-9)
    # reader streams partition the grid; writers partition the fused interior
    seen = sorted(i for loads in plan.reader_loads for i in loads)
    assert seen == list(range(int(np.prod(spec.grid_shape))))
    assert sum(plan.sync_expect) == int(np.prod(spec.interior_shape_fused))


@st.composite
def program_dag(draw):
    """Random 2-to-4-op rank-1/2 stencil-program DAGs: chains with fan-out
    into stencil and combine consumers, margins kept inside the grid."""
    from repro_torch.program import CombineOp, StencilOp, StencilProgram

    d = draw(st.integers(1, 2))
    w = draw(st.integers(1, 3))
    # inner extent divisible by any w in 1..3; room for total margin <= 4
    shape = (draw(st.integers(11, 14)), 24)[-d:]
    n_ops = draw(st.integers(2, 4))
    ops, fields, margin = [], ["f0"], {"f0": 0}
    for i in range(n_ops):
        # bias toward recent fields so chains get deep enough to need skew
        src = draw(st.sampled_from(fields[-2:]))
        out = f"f{i + 1}"
        kind = draw(st.sampled_from(["stencil", "stencil", "combine"]))
        if kind == "combine" and len(fields) >= 2:
            other = draw(st.sampled_from(fields))
            c1, c2 = (draw(st.floats(-1, 1, allow_nan=False, width=32))
                      for _ in range(2))
            ops.append(CombineOp(f"op{i}", (src, other), (c1, c2), out))
            margin[out] = max(margin[src], margin[other])
        else:
            budget = 4 - margin[src]
            if budget < 1:
                break
            radii = tuple(draw(st.integers(0 if d > 1 else 1,
                                           min(2, budget)))
                          for _ in range(d))
            if not any(radii):
                radii = (1,) * d
            coeffs = tuple(
                tuple(draw(st.lists(
                    st.floats(-1, 1, allow_nan=False, width=32),
                    min_size=2 * r + 1, max_size=2 * r + 1)))
                for r in radii)
            spec = StencilSpec(shape, radii, coeffs, dtype="float64")
            ops.append(StencilOp(f"op{i}", spec, src, out))
            margin[out] = margin[src] + max(radii)
        fields.append(out)
    if not any(isinstance(op, StencilOp) for op in ops):
        r1 = (1,) * d
        spec = StencilSpec(shape, r1, ((0.5, -1.0, 0.5),) * d,
                           dtype="float64")
        ops.append(StencilOp("opx", spec, fields[-1], "fx"))
    return StencilProgram("fuzz", ops, grid_shape=shape,
                          dtype="float64"), w


@given(program_dag(), st.integers(0, 2 ** 31 - 1))
@settings(max_examples=15, deadline=None)
def test_program_dag_exact_and_auto_capacity_liveness(pw, seed):
    """Random stencil-program DAGs: the fused pipeline's outputs equal the
    composed oracle and the analytic capacities (per-op mandatory buffering
    + inter-operator skew) never deadlock."""
    from repro_torch.program import (lower, program_reference_np,
                                     simulate_program)

    prog, w = pw
    rng = np.random.default_rng(seed)
    inputs = {f: rng.normal(size=prog.grid_shape)
              for f in prog.in_fields}
    plan = lower(prog, workers=w, auto_capacity=True)
    res, fields = simulate_program(plan, inputs, CGRA,
                                   max_cycles=2_000_000)  # deadlock -> raise
    ref = program_reference_np(prog, inputs)
    for f in prog.out_fields:
        np.testing.assert_allclose(fields[f], ref[f], atol=1e-9)
    # external inputs are loaded exactly once each, fan-out or not
    assert res.loads == len(prog.in_fields) * int(
        np.prod(prog.grid_shape))


@given(st.integers(24, 200), st.integers(1, 4), st.integers(1, 6))
@settings(**SET)
def test_mapping_interleave_algebra(n, r, w):
    if n <= 2 * r:
        return
    coeffs = tuple([1.0 / (2 * r + 1)] * (2 * r + 1))
    spec = StencilSpec((n,), (r,), (coeffs,), dtype="float64")
    plan = map_1d(spec, workers=w)
    # reader streams partition [0, n)
    seen = sorted(i for loads in plan.reader_loads for i in loads)
    assert seen == list(range(n))
    # writers partition the interior
    outs = sorted(i for ws in plan.writer_stores for i in ws)
    assert outs == list(range(r, n - r))
    # sync expectations match writer loads
    assert plan.sync_expect == [len(ws) for ws in plan.writer_stores]
    # every filter keep-window fits its source stream (0^m 1^n 0^p wellformed)
    for nd in plan.dfg.nodes:
        if nd.op == "filter":
            src_len = len(plan.reader_loads[0])  # streams differ by <=1
            assert nd.params["m"] + nd.params["n"] <= src_len + 1


# ---------------------------------------------------------------------------
# explorer invariants (repro_torch.explore)
# ---------------------------------------------------------------------------
@given(st.lists(st.tuples(st.integers(0, 40), st.integers(0, 40),
                          st.integers(0, 40)), min_size=0, max_size=40))
@settings(**SET)
def test_pareto_front_sound_and_complete(points):
    """The front is internally non-dominated, and every input point is
    either on the front or dominated by a front member."""
    from repro_torch.explore import (assert_non_dominated, dominates,
                                     pareto_front)

    front = pareto_front(points)
    assert_non_dominated(front)
    front_set = set(front)
    for p in points:
        assert p in front_set or any(dominates(f, p) for f in front)


@st.composite
def explore_case(draw):
    """Tiny random 1D specs + a random worker ladder for the explorer."""
    from repro_torch.core.spec import StencilSpec

    r = draw(st.integers(1, 2))
    n = draw(st.integers(4 * r + 8, 4 * r + 40))
    coeffs = tuple(
        draw(st.lists(st.floats(-1, 1, allow_nan=False, width=32),
                      min_size=2 * r + 1, max_size=2 * r + 1)))
    spec = StencilSpec((n,), (r,), (coeffs,), dtype="float64")
    workers = tuple(sorted({draw(st.integers(1, 4)) for _ in range(3)}))
    return spec, workers


@given(explore_case())
@settings(max_examples=8, deadline=None)
def test_explorer_front_non_dominated(case):
    """Fuzz the whole tuner loop: the returned Pareto front must be
    internally non-dominated and the best() pick must never lose to any
    measured point on the leading (cycles) objective."""
    from repro_torch.core import CGRA
    from repro_torch.explore import (EvalPoint, SpaceOptions,
                                     assert_non_dominated, explore)

    spec, workers = case
    res = explore(spec, CGRA, options=SpaceOptions(workers=workers),
                  verify=True)
    assert res.front, "explorer returned an empty front"
    assert_non_dominated(res.front, key=EvalPoint.objectives)
    assert res.best().cycles == min(p.cycles for p in res.points)
    if res.analytic is not None:
        assert res.best().cycles <= res.analytic.cycles


# ---------------------------------------------------------------------------
# static-verifier soundness (repro_torch.analysis.static_verify)
# ---------------------------------------------------------------------------
def _static_roundtrip(plan, x, max_cycles=2_000_000):
    """The soundness oracle: whatever the verifier claims must match what
    the engine does, and a suggested bump must always yield completion."""
    from repro_torch.analysis import apply_suggested_capacities, verify_plan
    from repro_torch.core.engine.common import SimDeadlock

    rep = verify_plan(plan)
    try:
        simulate(plan, x, CGRA, max_cycles=max_cycles)
        engine = "complete"
    except SimDeadlock as e:
        engine = "timeout" if e.timed_out else "deadlock"
    if rep.verdict == "safe":
        # the one unforgivable error: "safe" on a plan that deadlocks
        assert engine == "complete", (rep.describe(), engine)
    elif rep.verdict == "deadlock":
        assert engine == "deadlock", (rep.describe(), engine)
        if rep.suggested_capacities:
            assert apply_suggested_capacities(
                plan, rep.suggested_capacities) > 0
            assert verify_plan(plan).verdict == "safe"
            simulate(plan, x, CGRA, max_cycles=max_cycles)  # must complete
    # verdict "unknown" makes no claim — nothing to check


@given(spec_nd_and_workers(), st.integers(1, 3), st.integers(0, 2 ** 31 - 1))
@settings(max_examples=15, deadline=None)
def test_static_verdict_sound_on_random_specs(sw, cap, seed):
    """Random rank-1/2/3 specs under deliberately under-provisioned fixed
    capacities: the static verdict always matches the engine, and the
    repair hint always completes."""
    from repro_torch.core.mapping import map_nd

    spec, w = sw
    x = np.random.default_rng(seed).normal(size=spec.grid_shape)
    _static_roundtrip(map_nd(spec, workers=w, queue_capacity=cap), x)


@given(program_dag(), st.integers(1, 3), st.integers(0, 2 ** 31 - 1))
@settings(max_examples=15, deadline=None)
def test_static_verdict_sound_on_random_programs(pw, cap, seed):
    """Random stencil-program DAGs (fan-out, combines, skew buffers) under
    starved capacities: same soundness contract as the spec sweep."""
    from repro_torch.program import lower

    prog, w = pw
    rng = np.random.default_rng(seed)
    plan = lower(prog, workers=w, queue_capacity=cap)
    x = plan.pack_inputs({f: rng.normal(size=prog.grid_shape)
                          for f in prog.in_fields})
    _static_roundtrip(plan, x)


@given(spec_nd_and_workers(), st.integers(0, 2 ** 31 - 1))
@settings(max_examples=10, deadline=None)
def test_verify_static_preflight_matches_engine(sw, seed):
    """simulate(verify="static") either raises StaticDeadlock (and the
    suggested bump completes) or simulates to the oracle-exact result —
    never a dynamic deadlock slipping past the pre-flight."""
    from repro_torch.analysis import StaticDeadlock, apply_suggested_capacities
    from repro_torch.core.mapping import map_nd

    spec, w = sw
    x = np.random.default_rng(seed).normal(size=spec.grid_shape)
    plan = map_nd(spec, workers=w, queue_capacity=1)
    try:
        res = simulate(plan, x, CGRA, max_cycles=2_000_000, verify="static")
    except StaticDeadlock as e:
        assert e.cycles == 0
        if e.suggested_capacities:
            plan2 = map_nd(spec, workers=w, queue_capacity=1)
            assert apply_suggested_capacities(
                plan2, e.suggested_capacities) > 0
            res = simulate(plan2, x, CGRA, max_cycles=2_000_000,
                           verify="static")
        else:
            return
    np.testing.assert_allclose(res.output, stencil_reference_np(x, spec),
                               atol=1e-9)


# ---------------------------------------------------------------------------
# the lint CLI over the port's walkthroughs, and the seismic walkthrough
# ---------------------------------------------------------------------------
def test_lint_cli_walks_the_port_examples():
    """tests/test_static_verify.py:342 on the port: its five walkthroughs
    yield the reference's 7 plans, two of them routed, all clean."""
    from repro_torch.analysis.lint import lint_paths, main

    assert len(EXAMPLES) == 5
    out = io.StringIO()
    n_plans, n_failed = lint_paths(EXAMPLES, out=out)
    assert (n_plans, n_failed) == (7, 0), out.getvalue()
    assert out.getvalue().count("(routed)") == 2
    assert main(EXAMPLES + ["--strict"]) == 0
    assert main([str(ROOT / "src" / "repro_torch" / "analysis")]) == 1


def test_lint_cli_fails_a_broken_hook(tmp_path):
    """A hook that raises is a finding; a deadlocking plan fails --strict
    only."""
    from repro_torch.analysis.lint import lint_paths, main

    bad = tmp_path / "broken.py"
    bad.write_text("def lint_plans():\n    raise RuntimeError('boom')\n")
    out = io.StringIO()
    assert lint_paths([str(tmp_path)], out=out) == (0, 1)
    assert "FAIL — lint_plans() raised RuntimeError: boom" in out.getvalue()
    bad.write_text(
        "from repro_torch.core import map_2d\n"
        "from repro_torch.core.spec import heat_2d\n"
        "def lint_plans():\n"
        "    yield map_2d(heat_2d(18, 24, dtype='float64'), workers=3,\n"
        "                 queue_capacity=1)\n")
    out = io.StringIO()
    assert lint_paths([str(bad)], out=out) == (1, 1)
    assert "FAIL" in out.getvalue() and "deadlock" in out.getvalue()
    assert main([str(bad)]) == 0
    assert main([str(bad), "--strict"]) == 1


def test_seismic_walkthrough_on_the_cpu(capsys):
    """The seismic walkthrough with K3's plain version: the 1/16-grid
    simulation is exact, K3's stand-in within the f32 bar of the oracle,
    and the fused-timestep roofline is the H100 SXM's."""
    import importlib.util

    path = ROOT / "examples" / "seismic_stencil2d_torch.py"
    spec = importlib.util.spec_from_file_location("_seismic_walkthrough",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert res["exact"] and res["max_abs_err"] <= 2e-5
    assert res["blocks"] == [128, 128]
    assert out[0] == ("[roofline] AI=5.59 -> 559 GFLOPS on CGRA (w*=5); "
                      "paper: 559 GFLOPS, 5 workers")
    assert out[1].startswith(f"[simulate] cycles={res['cycles']} ")
    assert "exact=True" in out[1]
    assert [line.split()[-1] for line in out[-3:]] == \
        ["(memory)", "(compute)", "(compute)"]
    assert all("H100 SXM" in line for line in out[-3:])
