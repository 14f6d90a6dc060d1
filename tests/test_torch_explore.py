"""Parity of the port's program graphs (``repro_torch.program``), its
auto-tuner (``repro_torch.explore``) and its batched engine's plain version
with the JAX package's, on the same inputs.

Each test builds the same spec or program in both packages and asserts the
observables equal: simulated program plans bit for bit, the program oracle
(numpy twin bit for bit, torch twin against the jnp one within the f32
``TOL`` of ``tests/test_kernels.py``), the tuner's cache keys, fronts and
failures (the port's batched stage 1 on ``device="cpu"`` and its
sequential one against the reference's sequential one), the padded tables
of ``lower`` and the final carries of the reference's ``_sweep`` (run
under ``jax.enable_x64(True)``) against the port's plain version.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.core as j_core  # noqa: E402
import repro.explore as j_explore  # noqa: E402
import repro.program as j_program  # noqa: E402
import repro_torch.core as t_core  # noqa: E402
import repro_torch.explore as t_explore  # noqa: E402
import repro_torch.program as t_program  # noqa: E402
from repro.core.engine import jax_engine  # noqa: E402
from repro.core.engine.compile import compiled_for as j_compiled_for  # noqa: E402
from repro_torch.core.engine import cuda_engine  # noqa: E402
from repro_torch.core.engine.compile import compiled_for as t_compiled_for  # noqa: E402
from repro_torch.kernels.simbatch.ref import (CARRY, simbatch_plain,  # noqa: E402
                                              stack_tables, sweep)

TOL_F32 = 2e-5      # tests/test_kernels.py's TOL for float32


def _spec(pkg, spec):
    """The spec in ``pkg`` (``j_core`` or ``t_core``) from plain fields."""
    return pkg.StencilSpec(**dataclasses.asdict(spec))


def _two_out(pkg, prog_mod):
    lap = prog_mod.StencilOp("lap", pkg.heat_2d(20, 24, dtype="float64"),
                             "inp", "lapf")
    mix = prog_mod.CombineOp("mix", ("inp", "lapf"), (1.0, -4.0), "mixf")
    return prog_mod.StencilProgram("twoout", [lap, mix],
                                   outputs=["lapf", "mixf"],
                                   grid_shape=(20, 24), dtype="float64")


def _timestepped(pkg, prog_mod):
    spec = dataclasses.replace(pkg.heat_2d(20, 28, dtype="float64"),
                               timesteps=2)
    return prog_mod.StencilProgram(
        "tstep", [prog_mod.StencilOp("h2", spec, "u", "v"),
                  prog_mod.StencilOp("h1", pkg.heat_2d(20, 28,
                                                      dtype="float64"),
                                     "v", "w")])


PROGRAMS = {
    "two_stage_heat": (lambda pkg, pm: pm.two_stage_heat(24, 32), 4),
    "hdiff": (lambda pkg, pm: pm.hdiff_program(24, 32), 4),
    "remux": (lambda pkg, pm: pm.two_stage_heat(24, 32),
              {"heat1": 2, "heat2": 4}),
    "multi_output": (_two_out, 4),
    "timestepped": (_timestepped, 2),
}


def _fingerprint(plan, res):
    return (res.cycles, res.fires, res.loads, res.stores, res.flops,
            res.max_queue_total, res.output.tobytes(),
            {n.name: n.fires for n in plan.dfg.nodes})


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_plans_simulate_identically(name):
    """The port lowers each program to the reference's DFG, and the vector
    engine and the cuda engine's plain version simulate it to the
    reference's observables, bit for bit."""
    mk, workers = PROGRAMS[name]
    j_prog, t_prog = mk(j_core, j_program), mk(t_core, t_program)
    assert t_prog.in_fields == j_prog.in_fields
    assert t_prog.margins() == j_prog.margins()
    rng = np.random.default_rng(3)
    ins = {f: rng.normal(size=j_prog.grid_shape) for f in j_prog.in_fields}
    j_plan = j_program.lower(j_prog, workers=workers)
    x = j_plan.pack_inputs(ins)
    want = _fingerprint(j_plan, j_core.simulate(j_plan, x, j_core.CGRA,
                                                engine="vector"))
    for engine, kw in (("vector", {}), ("cuda", {"device": "cpu"})):
        t_plan = t_program.lower(t_prog, workers=workers)
        assert np.array_equal(t_plan.pack_inputs(ins), x)
        got = t_core.simulate(t_plan, x, t_core.CGRA, engine=engine, **kw)
        assert _fingerprint(t_plan, got) == want, engine
    fields = t_plan.unpack_outputs(got.output)
    ref = t_program.program_reference_np(t_prog, ins)
    for f in t_prog.out_fields:
        np.testing.assert_allclose(fields[f], ref[f], atol=1e-9)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_reference_matches(name):
    """numpy twins bit for bit; the torch twin against the jnp one in f32
    within TOL, dtype following the inputs."""
    mk, _workers = PROGRAMS[name]
    j_prog, t_prog = mk(j_core, j_program), mk(t_core, t_program)
    rng = np.random.default_rng(4)
    ins = {f: rng.normal(size=j_prog.grid_shape) for f in j_prog.in_fields}
    a = j_program.program_reference_np(j_prog, ins)
    b = t_program.program_reference_np(t_prog, ins)
    assert {k: v.tobytes() for k, v in a.items()} == \
        {k: v.tobytes() for k, v in b.items()}
    j = j_program.program_reference(
        j_prog, {f: jnp.asarray(v, jnp.float32) for f, v in ins.items()})
    t = t_program.program_reference(
        t_prog, {f: torch.tensor(v, dtype=torch.float32)
                 for f, v in ins.items()})
    for f in t_prog.out_fields:
        assert t[f].dtype == torch.float32
        assert np.abs(t[f].numpy() - np.asarray(j[f])).max() <= TOL_F32
        assert np.abs(t[f].numpy() - b[f]).max() <= 1e-4


def test_mapping_config_key_equal_for_equal_scopes():
    scope = {"target": "t", "engine": "vector", "n": 3}
    cfgs = [(j_explore.MappingConfig(workers=w, temporal=t, capacity=c,
                                     tile=tile),
             t_explore.MappingConfig(workers=w, temporal=t, capacity=c,
                                     tile=tile))
            for w, t, c, tile in ((2, 1, "auto", None),
                                  (4, 2, "unbounded", (8, 16)),
                                  (3, 1, 5, None))]
    for j, t in cfgs:
        assert t.canonical() == j.canonical()
        for ideal in (True, False):
            assert t.key(scope, ideal=ideal) == j.key(scope, ideal=ideal)
    fab = cfgs[0][1].with_fabric((12, 12, "mesh"), 1, 2)
    assert fab.key(scope, ideal=False) == cfgs[0][0].with_fabric(
        (12, 12, "mesh"), 1, 2).key(scope, ideal=False)


def small_1d(pkg, n=60, r=1):
    coeffs = tuple([1.0 / (2 * r + 1)] * (2 * r + 1))
    return pkg.StencilSpec((n,), (r,), (coeffs,), dtype="float64")


# test_explore.py's small cases: (target, explore keywords)
EXPLORE_CASES = {
    "ideal_1d": (lambda pkg, pm: small_1d(pkg),
                 dict(options=dict(workers=(1, 2, 3, 4)), verify=True)),
    "temporal": (lambda pkg, pm: small_1d(pkg, 80),
                 dict(options=dict(workers=(2, 3), temporal=(1, 2)),
                      workload_timesteps=2, verify=True)),
    "budget": (lambda pkg, pm: small_1d(pkg),
               dict(options=dict(workers=(1, 2, 3, 4)),
                    budget=dict(max_evals=1))),
    "static_gate": (lambda pkg, pm: pkg.heat_2d(10, 20, dtype="float64"),
                    dict(options=dict(workers=(2,), capacities=(1, "auto")))),
    "deadlock_no_gate": (lambda pkg, pm: pkg.heat_2d(10, 20,
                                                     dtype="float64"),
                         dict(options=dict(workers=(2,),
                                           capacities=(1, "auto")),
                              static_verify=False)),
    "timeout": (lambda pkg, pm: small_1d(pkg, 120),
                dict(options=dict(workers=(2,)),
                     budget=dict(sim_max_cycles=5))),
    "program": (lambda pkg, pm: pm.two_stage_heat(12, 24),
                dict(options=dict(workers=(2, 4)), verify=True)),
    "star3d": (lambda pkg, pm: pkg.star_3d(8, 10, 12, r=1),
               dict(options=dict(workers=(1, 2, 4)))),
    "routed": (lambda pkg, pm: pkg.heat_2d(12, 24, dtype="float64"),
               dict(options=dict(workers=(2, 4),
                                 fabrics=((12, 12, "mesh"),),
                                 place_seeds=(0, 1)),
                    budget=dict(routed_finalists=2))),
}


def _explore(pkg, pm, ex, name, batch_size=None, **extra):
    mk, kw = EXPLORE_CASES[name]
    kw = dict(kw)
    opts = kw.pop("options")
    budget = dict(kw.pop("budget", {}))
    if batch_size:
        budget["batch_size"] = batch_size
    return ex.explore(mk(pkg, pm), pkg.CGRA,
                      options=ex.SpaceOptions(**opts),
                      budget=ex.Budget(**budget), cache=ex.EvalCache(),
                      **kw, **extra)


def _summary(res, stall_table: bool = True):
    """Everything a tuner run reports.  ``stall_table=False`` drops the
    stall attribution from failure reasons: the sequential path simulates
    under a telemetry sink, whose table covers the run, while a batched
    lane's is the final cycle's (as the vector engine's without a sink)."""
    def pts(points):
        return sorted((str(sorted(p.config.canonical().items(), key=str)),
                       p.cycles, p.pes, p.max_channel_load, p.routed,
                       p.sim_cycles) for p in points)
    fails = sorted((str(sorted(f["config"].items(), key=str)),
                    f["reason"] if stall_table
                    else f["reason"].split("; stall attribution")[0],
                    str(f.get("suggested_capacities")))
                   for f in res.failures)
    stats = {k: res.stats[k] for k in ("n_configs", "n_pruned", "n_kept",
                                       "n_measured", "n_failures",
                                       "n_budget_skipped", "static_pruned",
                                       "sim_cycles_total")}
    return (pts(res.ideal_points), pts(res.points), pts(res.front),
            None if res.analytic is None else res.analytic.objectives(),
            fails, stats, res.prune.as_dict())


@pytest.mark.parametrize("name", sorted(EXPLORE_CASES))
def test_explore_matches_reference(name):
    """Fronts, points, failures and counts of the port's tuner equal the
    reference's sequential ones, sequential and batched (plain version on
    the CPU) alike."""
    want = _summary(_explore(j_core, j_program, j_explore, name))
    seq = _summary(_explore(t_core, t_program, t_explore, name))
    assert seq == want
    bat = _summary(_explore(t_core, t_program, t_explore, name,
                            batch_size=4, device="cpu"), stall_table=False)
    assert bat == _summary(_explore(j_core, j_program, j_explore, name),
                           stall_table=False)


def test_cache_replays_across_packages_and_misses_across_engines(tmp_path):
    """A cache the reference's sequential tuner filled replays in full into
    the port's sequential tuner (equal keys for equal scopes), and misses in
    full for the port's batched stage 1 (its own engine scope)."""
    path = tmp_path / "evals.json"
    j_cache = j_explore.EvalCache(path)
    j_res = j_explore.explore(small_1d(j_core), j_core.CGRA,
                              options=j_explore.SpaceOptions(
                                  workers=(1, 2, 3)), cache=j_cache)
    n = j_res.stats["n_measured"]
    assert n > 0
    seq = t_explore.explore(small_1d(t_core), t_core.CGRA,
                            options=t_explore.SpaceOptions(workers=(1, 2, 3)),
                            cache=t_explore.EvalCache(path))
    assert seq.stats["n_measured"] == 0 and seq.stats["n_cached"] == n
    bat = t_explore.explore(small_1d(t_core), t_core.CGRA,
                            options=t_explore.SpaceOptions(workers=(1, 2, 3)),
                            budget=t_explore.Budget(batch_size=8),
                            cache=t_explore.EvalCache(path), device="cpu")
    assert bat.stats["n_measured"] == n and bat.stats["n_cached"] == 0
    assert sorted(p.objectives() for p in bat.ideal_points) == \
        sorted(p.objectives() for p in j_res.ideal_points)


def _lane_plans(pkg, pm):
    spec = pkg.heat_2d(24, 48, dtype="float64")
    return [pkg.map_2d(spec, workers=4),
            pkg.map_2d(spec, workers=2, auto_capacity=True),
            pkg.map_2d(pkg.heat_2d(18, 24, dtype="float64"), workers=4,
                       queue_capacity=1),                       # deadlocks
            pm.lower(pm.two_stage_heat(24, 32),
                     workers={"heat1": 2, "heat2": 4})]         # imux


@pytest.mark.parametrize("max_cycles", [10 ** 6, 120])
def test_lower_and_sweep_match_reference(max_cycles):
    """The port's ``lower`` builds the reference's padded tables at the
    reference's dims, its plain version's final carries on them equal the
    reference's ``_sweep`` (jax in 64-bit mode for the float64 credit),
    lane for lane, and ``simbatch_plain`` at the port's own (unrounded)
    dims gives the same carries."""
    j_cps = [j_compiled_for(p) for p in _lane_plans(j_core, j_program)]
    t_cps = [t_compiled_for(p) for p in _lane_plans(t_core, t_program)]
    epcs = [10.0 / 0.96 * 0.8] * len(t_cps)
    dims = jax_engine.shared_dims(j_cps)
    own = cuda_engine.shared_dims(t_cps)
    assert all(a <= b for a, b in zip(own, dims)) and own != dims
    assert own == tuple(map(max, zip(*(jax_engine._natural_dims(cp)
                                       for cp in j_cps))))
    j_low = [jax_engine.lower(cp, dims) for cp in j_cps]
    t_low = [cuda_engine.lower(cp, dims) for cp in t_cps]
    for a, b in zip(j_low, t_low):
        assert a.tables.keys() == b.tables.keys()
        for k in a.tables:
            assert np.asarray(a.tables[k]).dtype == np.asarray(
                b.tables[k]).dtype, k
            assert np.array_equal(a.tables[k], b.tables[k]), k
    stacked = {k: np.stack([lp.tables[k] for lp in j_low])
               for k in j_low[0].tables}
    stacked["epc"] = np.asarray(epcs, dtype=np.float64)
    stacked["cap4"] = 4.0 * stacked["epc"]
    with jax.enable_x64(True):
        out = jax_engine._sweep({k: jnp.asarray(v) for k, v in stacked.items()},
                                jnp.int32(max_cycles))
        want = [np.asarray(a) for a in out]
    got = [a.numpy() for a in sweep(stack_tables(t_low, epcs, "cpu"),
                                     max_cycles)]
    for j in range(len(CARRY)):
        assert np.array_equal(got[j], want[j]), CARRY[j]
    mine = simbatch_plain(list(zip(t_cps, epcs)), max_cycles, "cpu")
    for i, (cp, lane) in enumerate(zip(t_cps, mine)):
        nE, nN = cp.n_edges, cp.n_nodes
        for j, k in enumerate(CARRY):
            a, b = np.asarray(lane[k]), np.asarray(want[j][i])
            if k in ("qlen", "maxocc"):
                a, b = a[:nE], b[:nE]
            elif k in ("active", "fires"):
                a, b = a[:nN], b[:nN]
            assert np.array_equal(a, b), (i, k)
    assert [int(w) for w in want[6]] == (
        [1, 1, 2, 1] if max_cycles > 120 else [0, 0, 2, 0])
    assert int(want[5][0]) == 295 or max_cycles <= 120
