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
def emulate_k7(p: k7.Packed, max_cycles: int, check=None) -> list[dict]:
    """``csrc/simbatch.cu`` line for line in Python over :func:`k7.pack`'s
    tables: thread ``t >= 32`` owns the node slots ``t - 32 + i * (T -
    32)`` (``p.order``: the non-memory nodes) and every thread the edges
    ``t + i * T`` (``i < p.items``), with their records and state in its
    "registers" (dicts keyed by ``(t, i)``); warp 0 is the memory arbiter.
    Shared memory holds the imux edges' lengths, ``sel``, the memory
    slots, ``flags`` and the ``starved``/``blocked`` bytes.  A cycle is the
    node phase (every non-memory node decided and committed; warp 0's
    ballots and rotated prefix), then the edge phase.  ``check(lane,
    starved, blocked, qlen)`` runs at the start of every node phase."""
    lanes = []
    for b in range(len(p.lanes)):
        no, eo, ko, po, mo_, oo, nN, nE, n_mem, T = (
            int(v) for v in p.lanes[b, :10])
        nodes = p.node_info[no:no + nN + 1].tolist()
        kbits, pats = p.keep[ko:].tolist(), p.pat[po:].tolist()
        mems = p.mem_flat[mo_:mo_ + n_mem].tolist()
        order = p.order[oo:oo + nN - n_mem].tolist()
        assert sorted(order + mems) == list(range(nN))
        epc, cap4 = p.rates[b].tolist()
        W = T - 32
        owned = [(t, i) for t in range(T) for i in range(p.items)]
        # registers
        nid, nd, fires, aux, act, ed, ql, mo = ({} for _ in range(8))
        for t, i in owned:
            k, e = t - 32 + i * W, t + i * T
            own = t >= 32 and k < len(order)
            nid[t, i] = order[k] if own else nN
            nd[t, i] = nodes[nid[t, i]] if own else [k7.F_MEM, 0, 0, 0]
            kind, _lim, a0, _a1 = nd[t, i]
            fires[t, i] = 0
            act[t, i] = bool(kind & k7.F_ACTIVE0)
            aux[t, i] = (pats[a0] if kind & k7.F_IMUX else
                         kbits[a0 >> 5] if kind & k7.F_FLT else 0)
            ed[t, i] = (p.edge_info[eo + e].tolist() if e < nE
                        else [0, 0, 0, 0])
            ql[t, i] = mo[t, i] = 0
        assert sorted(n for n in nid.values() if n < nN) == sorted(order)
        # shared memory
        qlen = [0] * nE + [1 << 29]
        sel, flags = [nE] * (nN + 1), [0] * (nN + 1)
        starved, blocked = [0] * (nN + 1), [0] * (nN + 1)
        mnode = list(mems)
        mleft = [max(nodes[n][1], 1) if nodes[n][0] & k7.F_ACTIVE0 else 0
                 for n in mems]
        for t, i in owned:                     # the bytes from qlen = 0
            if t + i * T < nE:
                src, dst, ef, cap = ed[t, i]
                if ef & k7.E_POP_STATIC:
                    starved[dst] = 1
                if 0 >= cap:
                    blocked[src] = 1
        cycles = status = 0
        credit = 0.0
        while status == 0 and cycles < max_cycles:
            if check is not None:
                lens = [0] * nE
                for t, i in owned:
                    if t + i * T < nE:
                        lens[t + i * T] = ql[t, i]
                check(b, starved, blocked, lens)
            cycles += 1
            any_fired = pending = 0
            for t, i in owned:                 # 1. nodes
                n = nid[t, i]
                kind, limit, a0, a1 = nd[t, i]
                if kind & k7.F_MEM:
                    continue
                f = 0
                if act[t, i]:
                    in_ok = (qlen[aux[t, i]] > 0 if kind & k7.F_IMUX
                             else not starved[n])
                    out_ok = not blocked[n]
                    kk = a0 + min(fires[t, i], a1 - 1)
                    drop = bool(kind & k7.F_FLT) and not (
                        aux[t, i] >> (kk & 31)) & 1
                    fired = in_ok and (out_ok or drop
                                       or bool(kind & k7.F_OUTOPT))
                    sync = bool(kind & k7.F_SYNC)
                    emits = fired and not drop and (
                        not sync or (fires[t, i] + 1 == a0 and out_ok))
                    if fired:
                        fires[t, i] += 1
                        f2 = fires[t, i]
                        if kind & k7.F_IMUX:
                            sel[n] = aux[t, i]
                            aux[t, i] = pats[a0 + f2 % a1]
                        elif kind & k7.F_FLT:
                            k2 = a0 + min(f2, a1 - 1)
                            if k2 >> 5 != kk >> 5:
                                aux[t, i] = kbits[k2 >> 5]
                        any_fired = 1
                    act[t, i] = fires[t, i] < limit and not (emits and sync)
                    f = (1 if fired else 0) | (2 if emits else 0)
                starved[n] = blocked[n] = 0
                flags[n] = f
                if kind & k7.F_CMP:
                    pending |= fires[t, i] == 0
            credit = min(credit + epc, cap4)   # 1. warp 0: the arbiter
            allowed = int(np.floor(credit))
            rot = cycles % max(n_mem, 1)
            el = []
            for j in range(n_mem):
                n = mnode[j]
                el.append(mleft[j] > 0 and not starved[n]
                          and not blocked[n])
                starved[n] = blocked[n] = 0
            words = [sum(1 << lane for lane in range(32)
                         if w * 32 + lane < n_mem and el[w * 32 + lane])
                     for w in range(-(-n_mem // 32))]
            total = sum(bin(w).count("1") for w in words)
            p_rot = (sum(bin(w).count("1") for w in words[:rot >> 5])
                     + bin(words[rot >> 5] & ((1 << (rot & 31)) - 1)).count(
                         "1") if words else 0)
            for j in range(n_mem):
                w, lane = divmod(j, 32)
                fire = 0
                if el[j]:
                    pj = (sum(bin(x).count("1") for x in words[:w])
                          + bin(words[w] & ((1 << lane) - 1)).count("1"))
                    before = pj - p_rot if j >= rot else total - p_rot + pj
                    fire = int(before < allowed)
                mleft[j] -= fire
                flags[mnode[j]] = 3 if fire else 0
                any_fired |= fire
            credit = credit - float(min(total, max(allowed, 0)))
            for t, i in owned:                 # 2. edges
                e = t + i * T
                if e >= nE:
                    continue
                src, dst, ef, cap = ed[t, i]
                popped = int(bool(flags[dst] & 1) and (
                    bool(ef & k7.E_POP_STATIC) or sel[dst] == e))
                q = ql[t, i]
                if flags[src] & 2:
                    occ = q + 1 - int(bool(ef & k7.E_POP_FIRST) and popped)
                    mo[t, i] = max(mo[t, i], occ)
                    q += 1
                q -= popped
                ql[t, i] = q
                if not ef & k7.E_POP_STATIC:
                    qlen[e] = q
                elif q == 0:
                    starved[dst] = 1
                if q >= cap:
                    blocked[src] = 1
            status = 1 if not pending else 0 if any_fired else 2
        out = {"qlen": [0] * nE + [1 << 29], "maxocc": [0] * (nE + 1),
               "fires": [0] * (nN + 1), "active": [False] * (nN + 1)}
        for t, i in owned:
            n, e = nid[t, i], t + i * T
            if not nd[t, i][0] & k7.F_MEM:
                out["fires"][n], out["active"][n] = fires[t, i], act[t, i]
            if e < nE:
                out["qlen"][e], out["maxocc"][e] = ql[t, i], mo[t, i]
        for j, n in enumerate(mnode):
            lim = nodes[n][1]
            start = max(lim, 1) if nodes[n][0] & k7.F_ACTIVE0 else 0
            out["fires"][n], out["active"][n] = start - mleft[j], mleft[j] > 0
        lanes.append(dict(out, credit=credit, cycles=cycles, status=status))
    return lanes


def _k7_lanes():
    spec = heat_2d(18, 24, dtype="float64")
    line = StencilSpec((960,), (1,), ((0.25, 0.5, 0.25),), dtype="float64")
    plans = [map_2d(spec, workers=2),
             map_2d(spec, workers=4, queue_capacity=1),      # deadlocks
             map_2d(spec, workers=3, auto_capacity=True),
             lower(two_stage_heat(24, 32), workers={"heat1": 2, "heat2": 4}),
             lower(two_stage_heat(24, 32),                   # 2-port imux
                   workers={"heat1": 4, "heat2": 2}),
             lower(hdiff_program(24, 32), workers=4),
             map_1d(line, workers=20)]                       # 40 memory nodes
    return [(compiled_for(p), mem_elems_per_cycle(p.spec, CGRA, 0.8))
            for p in plans]


@pytest.mark.parametrize("max_cycles", [10 ** 6, 37])
def test_k7_emulated_equals_plain_version(max_cycles):
    """pack()'s unpadded layout through the kernel's phases, under each
    ITEMS instance that holds the lanes, gives the plain version's final
    carry in every field, for finished, deadlocked and timed-out lanes,
    imux and filter-heavy program plans among them."""
    lanes = _k7_lanes()
    want = simbatch_plain(lanes, max_cycles, "cpu")
    for items in sorted(k7.INSTANCES):
        got = emulate_k7(k7.pack(lanes, items=items), max_cycles)
        for (cp, _), g, w in zip(lanes, got, want):
            nN, nE = cp.n_nodes, cp.n_edges
            for k, n in (("qlen", nE), ("maxocc", nE), ("fires", nN),
                         ("active", nN)):
                assert np.array_equal(np.asarray(g[k][:n]), w[k][:n]), (
                    items, k)
            assert g["qlen"][nE] == w["qlen"][nE] == 1 << 29
            assert (g["credit"], g["cycles"], g["status"]) == (
                w["credit"], w["cycles"], w["status"]), items
    assert {int(w["status"]) for w in want} == (
        {1, 2} if max_cycles > 37 else {0, 2})


@pytest.mark.parametrize("max_cycles", [10 ** 6, 37])
def test_k7_starved_blocked_bytes_track_qlen(max_cycles):
    """At the start of every node phase each node's starved byte is "some
    in-edge of a non-imux node is empty" and its blocked byte "some
    out-edge is at capacity", recomputed from the queue lengths and the
    capacities: bounded queues, imux remux programs, deadlock and timeout."""
    lanes = _k7_lanes()
    p = k7.pack(lanes)
    seen = [0] * len(lanes)

    def check(b, starved, blocked, lens):
        eo, nN, nE = (int(p.lanes[b, k7.LANE_FIELDS.index(k)])
                      for k in ("edge_off", "nodes", "edges"))
        want_s, want_b = [0] * (nN + 1), [0] * (nN + 1)
        for e, (src, dst, ef, cap) in enumerate(
                p.edge_info[eo:eo + nE].tolist()):
            if ef & k7.E_POP_STATIC and lens[e] == 0:
                want_s[dst] = 1
            if lens[e] >= cap:
                want_b[src] = 1
        assert starved == want_s and blocked == want_b
        seen[b] += 1

    got = emulate_k7(p, max_cycles, check)
    assert seen == [int(g["cycles"]) for g in got]
    assert any(any(cp.cap[:cp.n_edges] < 1 << 20) for cp, _ in lanes)
    assert any(len(cp.imux_ids) for cp, _ in lanes)


def test_pack_layout():
    """Offsets, the instance, thread counts, node slots and shared memory
    of the packed batch."""
    lanes = _k7_lanes()
    p = k7.pack(lanes)
    col = {k: i for i, k in enumerate(k7.LANE_FIELDS)}
    for i, (cp, epc) in enumerate(lanes):
        n_mem = len(cp.mem_ids)
        assert p.lanes[i, col["nodes"]:col["threads"]].tolist() == [
            cp.n_nodes, cp.n_edges, n_mem]
        assert p.lanes[i, col["threads"]] == k7.lane_threads(
            cp.n_nodes, cp.n_edges, n_mem, p.items)
        assert p.rates[i].tolist() == [epc, 4.0 * epc]
        oo = p.lanes[i, col["order_off"]]
        order = p.order[oo:oo + cp.n_nodes - n_mem].tolist()
        assert sorted(order + cp.mem_ids.tolist()) == list(range(cp.n_nodes))
    assert p.lanes[1:, 0].tolist() == np.cumsum(
        [cp.n_nodes + 1 for cp, _ in lanes])[:-1].tolist()
    assert len(p.node_info) == sum(cp.n_nodes + 1 for cp, _ in lanes)
    assert p.items == 1
    assert p.threads == max(p.lanes[:, col["threads"]]) and p.threads % 32 == 0
    assert p.smem == max(k7.smem_bytes(cp.n_nodes, cp.n_edges,
                                       len(cp.mem_ids)) for cp, _ in lanes)
    assert p.node_info.dtype == p.edge_info.dtype == np.int32
    assert p.node_info.shape[1] == p.edge_info.shape[1] == 4


@pytest.mark.parametrize("nodes,edges,n_mem,items,threads", [
    (33, 40, 4, 1, 64), (65, 80, 8, 1, 96), (521, 760, 10, 1, 768),
    (1665, 2432, 32, 4, 608)])
def test_plan_threads(nodes, edges, n_mem, items, threads):
    """Warp 0 arbitrates and every other thread owns one node, and every
    thread one edge, up to 1,024 threads; a 65-node lane holds 96 threads
    at its barriers, not 1024, and the paper's w = 16 lane needs ITEMS 4."""
    got = k7.plan(nodes, edges, n_mem)
    assert (got.items, got.threads) == (items, threads)


def test_smem_of_the_widest_paper_lane_fits_the_h100():
    """The paper's 2D grid at w = 16: 1,665 nodes, 2,432 edges, 32 memory
    nodes, about 23 KB of the 227 KB a block may use."""
    from repro_torch.kernels import _build
    need = k7.smem_bytes(1665, 2432, 32)
    assert need == 4 * 2433 + 8 * 1666 + 8 * 32 + 4
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
