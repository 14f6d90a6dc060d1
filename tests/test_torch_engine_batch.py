"""The port's batched cycle engine (``engine="cuda"``, K7) against its
vector engine, bit for bit, on the CPU: the plain version of K7
(``kernels/simbatch/ref.py``) runs here, ``device="cpu"``.

The matrix is ``tests/test_jax_engine.py``'s: single-op mappings of every
rank, temporal layers, program pipelines (the imux re-interleave and
several outputs included), bounded queues, derated memory bandwidth, the
failure paths (deadlock, ``max_cycles``) as values, the batched entry
point with mixed shapes, and the tuner's batched stage 1 with its own
cache scope.  Every observable must be identical: cycles, per-op and
per-node fires, loads, stores, flops, ``max_queue_total`` and output
bits.  K7's own layout and phases are held to the plain version through a
Python emulation of ``csrc/simbatch.cu``.  No jax needed.
"""
import numpy as np
import pytest

from repro_torch.core import CGRA, SimDeadlock, map_1d, map_2d, map_3d, simulate
from repro_torch.core.engine.common import mem_elems_per_cycle
from repro_torch.core.engine.compile import compiled_for
from repro_torch.core.simulator import simulate_batch
from repro_torch.core.spec import (StencilSpec, heat_2d, heat_3d,
                                   paper_stencil_2d)
from repro_torch.kernels.simbatch import kernel as k7
from repro_torch.kernels.simbatch.ref import simbatch_plain
from repro_torch.program import (CombineOp, StencilOp, StencilProgram,
                                 hdiff_program, lower, two_stage_heat)

ENGINES = ("vector", "cuda")


def _coeffs(rng, r):
    return tuple((rng.normal(size=2 * r + 1) / (2 * r + 1)).tolist())


def run_both(mk_plan, x, **kw):
    """Simulate a freshly-built plan once per engine (ideal mode only —
    the cuda engine cannot route)."""
    return [(plan, simulate(plan, x, CGRA, engine=engine,
                            **({"device": "cpu"} if engine == "cuda" else {}),
                            **kw))
            for engine in ENGINES
            for plan in (mk_plan(),)]


def assert_identical(case):
    (plan_v, a), (plan_c, b) = case
    assert a.cycles == b.cycles
    assert a.fires == b.fires
    assert (a.loads, a.stores, a.flops) == (b.loads, b.stores, b.flops)
    assert a.max_queue_total == b.max_queue_total
    assert a.output.shape == b.output.shape
    assert a.output.tobytes() == b.output.tobytes()      # bit-identical
    fa = {n.name: n.fires for n in plan_v.dfg.nodes}
    fb = {n.name: n.fires for n in plan_c.dfg.nodes}
    assert fa == fb


@pytest.mark.parametrize("n,r,w", [(120, 1, 3), (240, 2, 4), (510, 8, 6)])
def test_1d_identical(rng, n, r, w):
    spec = StencilSpec((n,), (r,), (_coeffs(rng, r),), dtype="float64")
    assert_identical(run_both(lambda: map_1d(spec, workers=w),
                              rng.normal(size=n)))


def test_2d_identical(rng):
    spec = paper_stencil_2d(ny=30, nx=48, r=12)
    assert_identical(run_both(lambda: map_2d(spec, workers=8),
                              rng.normal(size=(30, 48))))


def test_3d_identical(rng):
    spec = heat_3d(10, 12, 16, dtype="float64")
    assert_identical(run_both(lambda: map_3d(spec, workers=8),
                              rng.normal(size=(10, 12, 16))))


def test_temporal_identical(rng):
    spec = StencilSpec((360,), (2,), (_coeffs(rng, 2),), dtype="float64",
                       timesteps=3)
    assert_identical(run_both(lambda: map_1d(spec, workers=3),
                              rng.normal(size=360)))


def test_bounded_queues_identical(rng):
    """auto_capacity plans exercise the bounded-queue (out_ok) path."""
    spec = heat_2d(18, 24, dtype="float64")
    assert_identical(run_both(
        lambda: map_2d(spec, workers=3, auto_capacity=True),
        rng.normal(size=(18, 24))))


def test_mem_efficiency_identical(rng):
    spec = StencilSpec((300,), (3,), (_coeffs(rng, 3),), dtype="float64")
    assert_identical(run_both(lambda: map_1d(spec, workers=5),
                              rng.normal(size=300), mem_efficiency=0.8))


@pytest.mark.parametrize("mk", [lambda: two_stage_heat(24, 32),
                                lambda: hdiff_program(24, 32)])
def test_program_identical(mk):
    prog = mk()
    rng = np.random.default_rng(1)
    ins = {f: rng.normal(size=prog.grid_shape) for f in prog.in_fields}
    x = lower(prog, workers=4).pack_inputs(ins)
    assert_identical(run_both(lambda: lower(prog, workers=4), x))


def test_program_remux_identical():
    """Mismatched per-op worker counts insert the imux re-interleave."""
    prog = two_stage_heat(24, 32)
    rng = np.random.default_rng(1)
    ins = {f: rng.normal(size=prog.grid_shape) for f in prog.in_fields}
    workers = {"heat1": 2, "heat2": 4}
    x = lower(prog, workers=workers).pack_inputs(ins)
    assert_identical(run_both(lambda: lower(prog, workers=workers), x))


def test_program_multi_output_identical():
    """Fan-out + two output fields: several cmp completion nodes."""
    lap = StencilOp("lap", heat_2d(20, 24, dtype="float64"), "inp", "lapf")
    mix = CombineOp("mix", ("inp", "lapf"), (1.0, -4.0), "mixf")
    prog = StencilProgram("twoout", [lap, mix], outputs=["lapf", "mixf"],
                          grid_shape=(20, 24), dtype="float64")
    rng = np.random.default_rng(2)
    ins = {f: rng.normal(size=prog.grid_shape) for f in prog.in_fields}
    x = lower(prog, workers=4).pack_inputs(ins)
    assert_identical(run_both(lambda: lower(prog, workers=4), x))


def test_deadlock_and_timeout_identical(rng):
    """Failure paths: message text, cycle count and flags must match the
    vector engine byte for byte."""
    spec = heat_2d(18, 24, dtype="float64")
    x = rng.normal(size=(18, 24))

    def deadlock(engine):
        with pytest.raises(SimDeadlock) as ei:
            simulate(map_2d(spec, workers=4, queue_capacity=1), x, CGRA,
                     engine=engine, device="cpu")
        return str(ei.value), ei.value.cycles, ei.value.timed_out

    assert deadlock("vector") == deadlock("cuda")

    def timeout(engine):
        with pytest.raises(SimDeadlock) as ei:
            simulate(map_2d(spec, workers=4), x, CGRA, engine=engine,
                     max_cycles=50, device="cpu")
        return str(ei.value), ei.value.cycles, ei.value.timed_out

    msg, cycles, timed_out = timeout("cuda")
    assert timeout("vector") == (msg, cycles, timed_out)
    assert "exceeded max_cycles=50" in msg and timed_out


def test_unsupported_paths_raise(rng):
    """The cuda engine is ideal-mode only: fabric and telemetry raise, and
    an unknown device is refused."""
    from repro_torch.fabric import FabricTopology, place, route
    from repro_torch.telemetry import Telemetry
    spec = heat_2d(18, 24, dtype="float64")
    x = rng.normal(size=(18, 24))
    plan = map_2d(spec, workers=4)
    rf = route(place(plan, FabricTopology.mesh(16, 16), seed=0))
    with pytest.raises(NotImplementedError):
        simulate(plan, x, CGRA, fabric=rf, engine="cuda", device="cpu")
    with pytest.raises(NotImplementedError):
        simulate(map_2d(spec, workers=4), x, CGRA, engine="cuda",
                 telemetry=Telemetry(), device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        simulate(map_2d(spec, workers=4), x, CGRA, engine="jax")
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        simulate(map_2d(spec, workers=4), x, CGRA, engine="cuda",
                 device="meta")


def test_stale_and_routed_lanes_come_back_as_values(rng):
    """Stale tables and routed plans are refused per lane, as values, and
    their siblings still run."""
    from repro_torch.core.engine.cuda_engine import (CudaLoweringError,
                                                     run_compiled_batch)
    from repro_torch.fabric import FabricTopology, place, route
    from repro_torch.core.engine.compile import compile_plan
    spec = heat_2d(18, 24, dtype="float64")
    x = rng.normal(size=(18, 24)).reshape(-1)
    epc = mem_elems_per_cycle(spec, CGRA, 1.0)
    stale = map_2d(spec, workers=4)
    cp_stale = compiled_for(stale)
    next(stale.dfg.edges()).capacity = 7         # mutate after compiling
    routed = map_2d(spec, workers=4)
    cp_routed = compile_plan(routed, route(place(
        routed, FabricTopology.mesh(16, 16), seed=0)))
    good = compiled_for(map_2d(spec, workers=4))
    out = [np.zeros(18 * 24) for _ in range(3)]
    res = run_compiled_batch([(cp_stale, x, out[0], epc),
                              (cp_routed, x, out[1], epc),
                              (good, x, out[2], epc)], device="cpu")
    assert isinstance(res[0], CudaLoweringError) and "stale" in str(res[0])
    assert isinstance(res[1], CudaLoweringError) and "ideal-mode" in str(res[1])
    ref = simulate(map_2d(spec, workers=4), x.reshape(18, 24), CGRA,
                   engine="vector")
    assert res[2].cycles == ref.cycles
    assert out[2].tobytes() == ref.output.reshape(-1).tobytes()


# ---------------------------------------------------------------------------
# padded-batch correctness
# ---------------------------------------------------------------------------
def test_batch_mixed_sizes_matches_sequential(rng):
    """A batch mixing node/edge counts must produce per-config results
    identical to B independent vector runs — including a deadlocking
    config, whose lane reports the deadlock as a value without poisoning
    its siblings."""
    spec = heat_2d(18, 24, dtype="float64")
    x = rng.normal(size=(18, 24))

    def mk_items():
        return [(map_2d(spec, workers=2), x),
                (map_2d(spec, workers=4, queue_capacity=1), x),  # deadlocks
                (map_2d(spec, workers=8), x),
                (map_2d(spec, workers=3, auto_capacity=True), x)]

    got_c = simulate_batch(mk_items(), CGRA, engine="cuda", device="cpu")
    got_v = simulate_batch(mk_items(), CGRA, engine="vector")
    assert len(got_c) == len(got_v) == 4
    for i, (a, b) in enumerate(zip(got_c, got_v)):
        if i == 1:
            assert isinstance(a, SimDeadlock)
            assert isinstance(b, SimDeadlock)
            assert str(a) == str(b) and a.cycles == b.cycles
            assert not a.timed_out
            assert a.suggested_capacities == b.suggested_capacities
        else:
            assert (a.cycles, a.fires, a.loads, a.stores, a.flops,
                    a.max_queue_total) == (b.cycles, b.fires, b.loads,
                                           b.stores, b.flops,
                                           b.max_queue_total)
            assert a.output.tobytes() == b.output.tobytes()


def test_batch_of_one_matches_single(rng):
    spec = heat_2d(18, 24, dtype="float64")
    x = rng.normal(size=(18, 24))
    (res,) = simulate_batch([(map_2d(spec, workers=4), x)], CGRA,
                            engine="cuda", device="cpu")
    ref = simulate(map_2d(spec, workers=4), x, CGRA, engine="vector")
    assert res.cycles == ref.cycles
    assert res.output.tobytes() == ref.output.tobytes()


# ---------------------------------------------------------------------------
# K7's layout and phases, emulated: pack() + the kernel's loop in Python
# ---------------------------------------------------------------------------
def emulate_k7(p: k7.Packed, max_cycles: int) -> list[dict]:
    """``csrc/simbatch.cu`` line for line in Python over :func:`k7.pack`'s
    tables: the three phases a cycle (eligibility; arbiter and commits;
    edges) with the kernel's flags, bits and credit arithmetic."""
    lanes = []
    for b in range(len(p.lanes)):
        (no, eo, io, oo, ko, po, mo, nN, nE, n_mem, n_cmp,
         _threads) = (int(v) for v in p.lanes[b, :12])
        nodes = p.node_info[no:no + nN + 1].tolist()
        edges = p.edge_info[eo:eo + nE + 1].tolist()
        ins, outs = p.in_flat[io:].tolist(), p.out_flat[oo:].tolist()
        kbits, pats = p.keep[ko:].tolist(), p.pat[po:].tolist()
        mems = p.mem_flat[mo:mo + n_mem].tolist()
        epc, cap4 = p.rates[b].tolist()
        qlen, maxocc = [0] * nE + [1 << 29], [0] * (nE + 1)
        fires, sel, flags = [0] * (nN + 1), [nE] * (nN + 1), [0] * (nN + 1)
        active = [n < nN and bool(nodes[n][0] & k7.F_ACTIVE0)
                  for n in range(nN + 1)]
        cmpsum = cycles = status = 0
        credit = 0.0

        def commit(n, kind, fired):
            nonlocal cmpsum
            f, fr, sync = flags[n], fires[n], kind & k7.F_SYNC
            gate = not sync or (fr + 1 == nodes[n][2] and f & 8)
            emits = bool(fired and gate and not f & 16)
            fires[n] = fr + fired
            active[n] = (active[n] and fires[n] < nodes[n][1]
                         and not (emits and sync))
            flags[n] = (2 if fired else 0) | (4 if emits else 0)
            cmpsum += bool(fired and kind & k7.F_CMP)
            return fired

        while status == 0 and cycles < max_cycles:
            for n in range(nN):                        # 1. eligibility
                f = 0
                if active[n]:
                    kind, _lim, _se, i0, ic, o0, oc, a0, a1 = nodes[n]
                    in_ok = out_ok = True
                    drop = False
                    if kind & k7.F_IMUX:
                        port = pats[a0 + fires[n] % a1]
                        sel[n] = ins[i0 + port] if port < ic else nE
                        in_ok = qlen[sel[n]] > 0
                    else:
                        in_ok = all(qlen[ins[k]] > 0 for k in range(i0, i0 + ic))
                    out_ok = all(qlen[outs[k]] < edges[outs[k]][3]
                                 for k in range(o0, o0 + oc))
                    if kind & k7.F_FLT:
                        bit = a0 + min(max(fires[n], 0), a1 - 1)
                        drop = not (kbits[bit >> 5] >> (bit & 31)) & 1
                    elig = in_ok and (out_ok or drop or kind & k7.F_OUTOPT)
                    f = (1 if elig else 0) | (8 if out_ok else 0) \
                        | (16 if drop else 0)
                flags[n] = f
            cycles += 1                                # 2. arbiter, commits
            credit = min(credit + epc, cap4)
            allowed = int(np.floor(credit))
            rot = cycles % max(n_mem, 1)
            el = [bool(flags[m] & 1) for m in mems]
            total, p_rot = sum(el), sum(el[:rot])
            any_fired = 0
            for j, m in enumerate(mems):
                pj = sum(el[:j])
                before = pj - p_rot if j >= rot else total - p_rot + pj
                any_fired |= commit(m, k7.F_MEM, int(el[j] and before < allowed))
            credit = credit - float(min(total, max(allowed, 0)))
            for n in range(nN):
                if not nodes[n][0] & k7.F_MEM:
                    any_fired |= commit(n, nodes[n][0], flags[n] & 1)
            status = 1 if cmpsum >= n_cmp else (0 if any_fired else 2)
            for e in range(nE):                        # 3. edges
                src, dst, ef, _cap = edges[e]
                popped = int(bool(flags[dst] & 2)
                             and (bool(ef & 2) or sel[dst] == e))
                if flags[src] & 4:
                    occ = qlen[e] + 1 - int(bool(ef & 1) and popped)
                    maxocc[e] = max(maxocc[e], occ)
                    qlen[e] += 1 - popped
                else:
                    qlen[e] -= popped
        lanes.append(dict(qlen=qlen, maxocc=maxocc, fires=fires,
                          active=active, credit=credit, cycles=cycles,
                          status=status))
    return lanes


def _k7_lanes():
    spec = heat_2d(18, 24, dtype="float64")
    plans = [map_2d(spec, workers=2),
             map_2d(spec, workers=4, queue_capacity=1),      # deadlocks
             map_2d(spec, workers=3, auto_capacity=True),
             lower(two_stage_heat(24, 32), workers={"heat1": 2, "heat2": 4}),
             lower(hdiff_program(24, 32), workers=4)]
    return [(compiled_for(p), mem_elems_per_cycle(p.spec, CGRA, 0.8))
            for p in plans]


@pytest.mark.parametrize("max_cycles", [10 ** 6, 37])
def test_k7_emulated_equals_plain_version(max_cycles):
    """pack()'s unpadded layout through the kernel's phases gives the plain
    version's final carry in every field, for finished, deadlocked and
    timed-out lanes, imux and filter-heavy program plans among them."""
    lanes = _k7_lanes()
    got = emulate_k7(k7.pack(lanes), max_cycles)
    want = simbatch_plain(lanes, max_cycles, "cpu")
    for (cp, _), g, w in zip(lanes, got, want):
        nN, nE = cp.n_nodes, cp.n_edges
        for k, n in (("qlen", nE), ("maxocc", nE), ("fires", nN),
                     ("active", nN)):
            assert np.array_equal(np.asarray(g[k][:n]), w[k][:n]), k
        assert g["qlen"][nE] == w["qlen"][nE] == 1 << 29
        assert (g["credit"], g["cycles"], g["status"]) == (
            w["credit"], w["cycles"], w["status"])
    assert {int(w["status"]) for w in want} == (
        {1, 2} if max_cycles > 37 else {0, 2})


def test_pack_layout():
    """Offsets, thread counts and shared memory of the packed batch."""
    lanes = _k7_lanes()
    p = k7.pack(lanes)
    for i, (cp, epc) in enumerate(lanes):
        assert p.lanes[i, 7:11].tolist() == [cp.n_nodes, cp.n_edges,
                                             len(cp.mem_ids), cp.n_cmp]
        assert p.lanes[i, 11] == k7.plan_threads(cp.n_nodes, cp.n_edges)
        assert p.rates[i].tolist() == [epc, 4.0 * epc]
    assert p.lanes[1:, 0].tolist() == np.cumsum(
        [cp.n_nodes + 1 for cp, _ in lanes])[:-1].tolist()
    assert len(p.node_info) == sum(cp.n_nodes + 1 for cp, _ in lanes)
    assert p.threads == max(p.lanes[:, 11]) and p.threads % 32 == 0
    assert p.edge_info.dtype == np.int32 and p.edge_info.shape[1] == 4


@pytest.mark.parametrize("nodes,edges,threads", [
    (33, 40, 32), (65, 80, 64), (521, 760, 384), (1665, 2432, 1024)])
def test_plan_threads(nodes, edges, threads):
    """A thread owns about two nodes or edges; a 65-node lane holds 64
    threads at its barriers, not 1024."""
    assert k7.plan_threads(nodes, edges) == threads


def test_smem_of_the_widest_paper_lane_fits_the_h100():
    """The paper's 2D grid at w = 16: 1,665 nodes, 2,432 edges, 32 memory
    nodes, about 36 KB of the 227 KB a block may use."""
    from repro_torch.kernels import _build
    need = k7.smem_bytes(1665, 2432, 32)
    assert need == 4 * 2 * 2433 + 4 * 2 * 1666 + 2 * 1666 + 4 + 4
    assert need < _build.H100_SMEM_PER_BLOCK


# ---------------------------------------------------------------------------
# explore integration: Budget.batch_size on the plain version
# ---------------------------------------------------------------------------
def test_explore_batched_stage1_matches_sequential():
    from repro_torch.explore import Budget, SpaceOptions, explore
    spec = heat_2d(18, 24, dtype="float64")
    opts = SpaceOptions(fabrics=())
    seq = explore(spec, CGRA, options=opts, budget=Budget(), verify=True)
    bat = explore(spec, CGRA, options=opts, budget=Budget(batch_size=8),
                  verify=True, device="cpu")
    key = lambda p: sorted(p.config.canonical().items(),      # noqa: E731
                           key=str)
    s = {str(key(p)): (p.cycles, p.pes) for p in seq.ideal_points}
    b = {str(key(p)): (p.cycles, p.pes) for p in bat.ideal_points}
    assert s == b and s
    assert seq.best().objectives() == bat.best().objectives()


def test_explore_batched_respects_max_evals():
    from repro_torch.explore import Budget, SpaceOptions, explore
    spec = heat_2d(18, 24, dtype="float64")
    res = explore(spec, CGRA, options=SpaceOptions(fabrics=()),
                  budget=Budget(max_evals=3, batch_size=8), device="cpu")
    assert res.stats["n_measured"] <= 3
    assert res.stats["n_budget_skipped"] > 0


def test_cache_cross_engine_miss():
    """Batched-cuda results are keyed under the cuda engine + semantics
    version, so a sequential vector run on the same cache re-measures
    every config."""
    from repro_torch.explore import Budget, EvalCache, SpaceOptions, explore
    spec = heat_2d(18, 24, dtype="float64")
    opts = SpaceOptions(fabrics=())
    cache = EvalCache(None)
    bat = explore(spec, CGRA, options=opts, budget=Budget(batch_size=8),
                  cache=cache, device="cpu")
    n = bat.stats["n_measured"]
    assert n > 0
    entries_after_batch = len(cache)
    bat2 = explore(spec, CGRA, options=opts, budget=Budget(batch_size=8),
                   cache=cache, device="cpu")
    assert bat2.stats["n_measured"] == 0
    assert len(cache) == entries_after_batch
    seq = explore(spec, CGRA, options=opts, budget=Budget(), cache=cache)
    assert seq.stats["n_measured"] == n
    assert len(cache) == 2 * entries_after_batch
    key = lambda p: str(sorted(p.config.canonical().items(),  # noqa: E731
                               key=str))
    assert ({key(p): p.cycles for p in bat.ideal_points}
            == {key(p): p.cycles for p in seq.ideal_points})


def test_engine_semantics_registry():
    """ENGINE_SEMANTICS names every engine and mirrors the cuda module."""
    from repro_torch.core.engine import ENGINE_SEMANTICS, cuda_engine
    from repro_torch.core.simulator import ENGINES as ALL_ENGINES
    assert set(ENGINE_SEMANTICS) == set(ALL_ENGINES) == {"interp", "vector",
                                                          "cuda"}
    assert ENGINE_SEMANTICS["cuda"] == cuda_engine.SEMANTICS == "cuda-batch/v1"
