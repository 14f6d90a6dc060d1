"""Parity of the port's CGRA model with the JAX package's, bit for bit.

The CGRA model is host numpy in both packages: the §VI roofline, the
mapper's DFG, the interp/vector cycle simulators, the static verifier and
fabric place/route.  Each test builds its spec in ``repro`` from numpy-seeded
fields, hands the same fields to the port (``spec_from_fields``), runs the
function of the same name in both, and asserts every observable equal:
cycles, per-op and per-node fires, loads/stores/flops, stall summaries,
output bits, reports, placements and routes.  The simulation matrix is
``tests/test_engine.py``'s without program graphs (not ported yet).
"""
import dataclasses
import types
import warnings

import numpy as np
import pytest

pytest.importorskip("jax")

import repro.analysis as j_analysis  # noqa: E402
import repro.core as j_core  # noqa: E402
import repro.core.roofline as j_roofline  # noqa: E402
import repro.core.spec as j_spec  # noqa: E402
import repro.core.temporal as j_temporal  # noqa: E402
import repro.fabric as j_fabric  # noqa: E402
import repro.telemetry as j_telemetry  # noqa: E402
import repro_torch.analysis as t_analysis  # noqa: E402
import repro_torch.core as t_core  # noqa: E402
import repro_torch.core.roofline as t_roofline  # noqa: E402
import repro_torch.core.temporal as t_temporal  # noqa: E402
import repro_torch.fabric as t_fabric  # noqa: E402
import repro_torch.telemetry as t_telemetry  # noqa: E402
from repro_torch.core.spec import spec_from_fields  # noqa: E402

REF = types.SimpleNamespace(core=j_core, roofline=j_roofline,
                            temporal=j_temporal, fabric=j_fabric,
                            analysis=j_analysis, telemetry=j_telemetry)
PORT = types.SimpleNamespace(core=t_core, roofline=t_roofline,
                             temporal=t_temporal, fabric=t_fabric,
                             analysis=t_analysis, telemetry=t_telemetry)


def _coeffs(rng, r):
    return tuple((rng.normal(size=2 * r + 1) / (2 * r + 1)).tolist())


def _port_spec(spec):
    """The port's spec from the reference spec's fields."""
    out = spec_from_fields(**dataclasses.asdict(spec))
    assert dataclasses.asdict(out) == dataclasses.asdict(spec)
    return out


def _specs(spec):
    return [(REF, spec), (PORT, _port_spec(spec))]


def _fields(obj):
    """A report or record as plain data (dataclasses of either package)."""
    return dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else obj


# ---------------------------------------------------------------------------
# §VI roofline and §IV temporal planner
# ---------------------------------------------------------------------------
ROOF_SPECS = [
    lambda: j_spec.paper_stencil_1d(),
    lambda: j_spec.paper_stencil_2d(),
    lambda: j_spec.paper_stencil_1d(dtype="float32"),
    lambda: j_spec.heat_3d(64, 64, 64, dtype="float64"),
    lambda: j_spec.star_3d(32, 32, 64, r=2),
    lambda: dataclasses.replace(j_spec.paper_stencil_2d(), timesteps=4),
]


@pytest.mark.parametrize("mk", ROOF_SPECS)
@pytest.mark.parametrize("machine", ["CGRA", "V100"])
def test_roofline_identical(mk, machine):
    spec = mk()
    got = []
    for pkg, s in _specs(spec):
        m = getattr(pkg.roofline, machine)
        rep = pkg.roofline.analyze(s, m)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            w = pkg.roofline.select_workers(s, m)
        got.append((_fields(m), _fields(rep), rep.ridge_ai,
                    pkg.roofline.analyze(s, m, workers=3).__repr__(),
                    pkg.roofline.worker_fit(s, m),
                    pkg.roofline.workers_demanded(s, m), w,
                    pkg.roofline.worker_demand_gflops(s, m, 5),
                    _fields(m.scaled(16)),
                    pkg.roofline.analyze(s, m.scaled(16)).__repr__()))
    assert got[0] == got[1]


def test_select_workers_cap_warning_identical():
    spec = j_spec.paper_stencil_2d()
    msgs = []
    for pkg, s in _specs(spec):
        tiny = dataclasses.replace(pkg.roofline.CGRA, name="cgra_tiny",
                                   num_macs=64)
        with pytest.warns(RuntimeWarning) as rec:
            w = pkg.roofline.select_workers(s, tiny)
        msgs.append((w, str(rec[0].message),
                     _fields(pkg.roofline.analyze(s, tiny))))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("mk,w", [(lambda: j_spec.paper_stencil_1d(), 6),
                                  (lambda: j_spec.paper_stencil_2d(), 5),
                                  (lambda: j_spec.heat_2d(64, 64), 4)])
def test_temporal_identical(mk, w):
    spec = mk()
    got = []
    for pkg, s in _specs(spec):
        got.append((pkg.temporal.crossover_timesteps(s, pkg.roofline.CGRA, w),
                    pkg.temporal.crossover_timesteps(s, pkg.roofline.V100, w),
                    [_fields(p) for p in pkg.temporal.fusion_report(
                        s, pkg.roofline.CGRA, w)],
                    pkg.temporal.vmem_working_set(s, (16,) * s.ndim, 3)))
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# the mapper: DFG structure and emitters
# ---------------------------------------------------------------------------
def _param_repr(v):
    return None if callable(v) else repr(v)


def dfg_view(plan):
    """Everything of a plan's DFG but object identities."""
    g = plan.dfg
    nodes = [(n.nid, n.op, n.name, n.stage, n.worker,
              sorted((k, _param_repr(v)) for k, v in n.params.items()),
              [(e.src.nid, e.dst_port) for e in n.in_edges],
              [(e.dst.nid, e.dst_port, e.capacity) for e in n.out_edges])
             for n in g.nodes]
    edges = [(e.eid, e.src.nid, e.dst.nid, e.dst_port, e.capacity)
             for e in g.finalize()]
    eids = {id(e): e.eid for e in g.finalize()}     # min_capacities' keys
    meta = (plan.workers, plan.reader_loads, plan.writer_stores,
            plan.sync_expect, plan.pe_counts, plan.mac_pes,
            {eids[k]: v for k, v in plan.min_capacities.items()}, plan.notes, g.name, g.pe_counts(),
            g.mac_pes(), [n.nid for n in g.topo_order()])
    return nodes, edges, meta, g.to_assembly(), g.to_dot()


MAP_CASES = [
    ("map_1d", lambda: j_spec.StencilSpec((120,), (1,), ((0.25, 0.5, 0.25),),
                                          dtype="float64"), {"workers": 3}),
    ("map_1d", lambda: j_spec.paper_stencil_1d(n=2400), {"workers": 6}),
    ("map_1d", lambda: j_spec.StencilSpec(
        (360,), (2,), ((0.1, 0.2, 0.4, 0.2, 0.1),), dtype="float64",
        timesteps=3), {"workers": 3}),
    ("map_2d", lambda: j_spec.paper_stencil_2d(ny=30, nx=48, r=12),
     {"workers": 8}),
    ("map_2d", lambda: j_spec.heat_2d(18, 24, dtype="float64"),
     {"workers": 3, "auto_capacity": True}),
    ("map_2d", lambda: j_spec.heat_2d(18, 24, dtype="float64"),
     {"workers": 3, "queue_capacity": 1}),
    ("map_3d", lambda: j_spec.heat_3d(10, 12, 16, dtype="float64"),
     {"workers": 8}),
    ("map_nd", lambda: j_spec.star_3d(8, 10, 12, r=2), {"workers": 4}),
]


@pytest.mark.parametrize("fn,mk,kw", MAP_CASES)
def test_mapped_dfg_identical(fn, mk, kw):
    spec = mk()
    views = [dfg_view(getattr(pkg.core, fn)(s, **kw))
             for pkg, s in _specs(spec)]
    assert views[0] == views[1]


@pytest.mark.parametrize("kw,match", [({"workers": 7}, "unowned"),
                                      ({"workers": 40}, "outputless")])
def test_mapper_errors_identical(kw, match):
    spec = j_spec.heat_2d(16, 24, dtype="float64")
    msgs = []
    for pkg, s in _specs(spec):
        with pytest.raises(ValueError) as ei:
            pkg.core.map_2d(s, **kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# simulate: the tests/test_engine.py matrix (single-op plans)
# ---------------------------------------------------------------------------
def sim_view(plan, res):
    per_node = {n.name: n.fires for n in plan.dfg.nodes}
    return (res.cycles, res.fires, res.loads, res.stores, res.flops,
            res.max_queue_total, res.mac_pes, res.gflops,
            res.pct_of_roofline, res.pct_of_compute_peak, res.fabric,
            res.output.shape, res.output.dtype, res.output.tobytes(),
            per_node, res.summary())


def run_both(spec, mk_plan, x, *, routed=False, wpc=1, engine="vector",
             telemetry=False, **kw):
    """Simulate the same plan in the reference and the port (each with its
    own fresh plan and routes); returns the two views."""
    views = []
    for pkg, s in _specs(spec):
        plan = mk_plan(pkg, s)
        fab = None
        if routed:
            topo = pkg.fabric.FabricTopology.mesh(16, 16, words_per_cycle=wpc)
            fab = pkg.fabric.route(pkg.fabric.place(plan, topo, seed=0))
        tel = pkg.telemetry.Telemetry() if telemetry else None
        res = pkg.core.simulate(plan, x, pkg.core.CGRA, fabric=fab,
                                engine=engine, telemetry=tel, **kw)
        view = sim_view(plan, res)
        if telemetry:
            acct = pkg.telemetry.attribute(tel, res)
            view += (tel.totals(), tel.stall_summary(), acct.as_dict(),
                     pkg.telemetry.render_attribution(acct))
        views.append(view)
    return views


def _map(fn, **kw):
    return lambda pkg, s: getattr(pkg.core, fn)(s, **kw)


@pytest.mark.parametrize("routed", [False, True])
@pytest.mark.parametrize("n,r,w", [(120, 1, 3), (240, 2, 4), (510, 8, 6)])
def test_simulate_1d_identical(rng, n, r, w, routed):
    spec = j_spec.StencilSpec((n,), (r,), (_coeffs(rng, r),), dtype="float64")
    a, b = run_both(spec, _map("map_1d", workers=w), rng.normal(size=n),
                    routed=routed)
    assert a == b


@pytest.mark.parametrize("routed", [False, True])
def test_simulate_2d_identical(rng, routed):
    spec = j_spec.paper_stencil_2d(ny=30, nx=48, r=12)
    a, b = run_both(spec, _map("map_2d", workers=8),
                    rng.normal(size=(30, 48)), routed=routed)
    assert a == b


@pytest.mark.parametrize("routed", [False, True])
def test_simulate_3d_identical(rng, routed):
    spec = j_spec.heat_3d(10, 12, 16, dtype="float64")
    a, b = run_both(spec, _map("map_3d", workers=8),
                    rng.normal(size=(10, 12, 16)), routed=routed)
    assert a == b


@pytest.mark.parametrize("engine", ["interp", "vector"])
def test_simulate_temporal_identical(rng, engine):
    spec = j_spec.StencilSpec((360,), (2,), (_coeffs(rng, 2),),
                              dtype="float64", timesteps=3)
    a, b = run_both(spec, _map("map_1d", workers=3), rng.normal(size=360),
                    engine=engine)
    assert a == b


@pytest.mark.parametrize("engine", ["interp", "vector"])
def test_simulate_bounded_queues_identical(rng, engine):
    spec = j_spec.heat_2d(18, 24, dtype="float64")
    a, b = run_both(spec, _map("map_2d", workers=3, auto_capacity=True),
                    rng.normal(size=(18, 24)), engine=engine)
    assert a == b


def test_simulate_mem_efficiency_identical(rng):
    spec = j_spec.StencilSpec((300,), (3,), (_coeffs(rng, 3),),
                              dtype="float64")
    a, b = run_both(spec, _map("map_1d", workers=5), rng.normal(size=300),
                    mem_efficiency=0.8)
    assert a == b


def test_simulate_wpc2_fabric_identical(rng):
    spec = j_spec.paper_stencil_2d(ny=30, nx=48, r=12)
    a, b = run_both(spec, _map("map_2d", workers=8),
                    rng.normal(size=(30, 48)), routed=True, wpc=2)
    assert a == b


@pytest.mark.parametrize("engine", ["interp", "vector"])
def test_simulate_telemetry_identical(rng, engine):
    """Per-node timelines, stall attribution and link bookings, routed."""
    spec = j_spec.heat_2d(18, 24, dtype="float64")
    a, b = run_both(spec, _map("map_2d", workers=3, auto_capacity=True),
                    rng.normal(size=(18, 24)), routed=True, engine=engine,
                    telemetry=True)
    assert a == b


def _deadlock_view(pkg, s, x, engine, telemetry=False, **kw):
    plan = pkg.core.map_2d(s, workers=3, queue_capacity=1)
    tel = pkg.telemetry.Telemetry() if telemetry else None
    with pytest.raises(pkg.core.SimDeadlock) as ei:
        pkg.core.simulate(plan, x, pkg.core.CGRA, engine=engine,
                          telemetry=tel, **kw)
    e = ei.value
    return (type(e).__name__, str(e), e.cycles, e.timed_out, e.stall_summary,
            e.suggested_capacities)


@pytest.mark.parametrize("telemetry", [False, True])
@pytest.mark.parametrize("engine", ["interp", "vector"])
def test_deadlock_identical(rng, engine, telemetry):
    """The same cycle, blocked nodes, stall summary and capacity repair."""
    spec = j_spec.heat_2d(18, 24, dtype="float64")
    x = rng.normal(size=(18, 24))
    views = [_deadlock_view(pkg, s, x, engine, telemetry,
                            max_cycles=200_000)
             for pkg, s in _specs(spec)]
    assert views[0] == views[1]
    assert views[1][5]                       # the repair hint is there
    assert "deadlock at cycle" in views[1][1]


def test_static_preflight_identical(rng):
    spec = j_spec.heat_2d(18, 24, dtype="float64")
    x = rng.normal(size=(18, 24))
    views = []
    for pkg, s in _specs(spec):
        plan = pkg.core.map_2d(s, workers=3, queue_capacity=1)
        with pytest.raises(pkg.analysis.StaticDeadlock) as ei:
            pkg.core.simulate(plan, x, pkg.core.CGRA, verify="static")
        # the port's StaticDeadlock is the port's SimDeadlock
        assert isinstance(ei.value, pkg.core.SimDeadlock)
        views.append((str(ei.value), ei.value.cycles,
                      ei.value.suggested_capacities,
                      _fields(ei.value.report)))
    assert views[0] == views[1]


@pytest.mark.parametrize("engine", ["interp", "vector"])
def test_max_cycles_identical(rng, engine):
    spec = j_spec.StencilSpec((120,), (1,), ((0.25, 0.5, 0.25),),
                              dtype="float64")
    x = rng.normal(size=120)
    views = []
    for pkg, s in _specs(spec):
        plan = pkg.core.map_1d(s, workers=3)
        with pytest.raises(pkg.core.SimDeadlock) as ei:
            pkg.core.simulate(plan, x, pkg.core.CGRA, max_cycles=10,
                              engine=engine)
        e = ei.value
        views.append((str(e), e.cycles, e.timed_out, e.stall_summary,
                      e.suggested_capacities))
    assert views[0] == views[1]
    assert "exceeded max_cycles=10" in views[1][0]


# ---------------------------------------------------------------------------
# the static verifier
# ---------------------------------------------------------------------------
VERIFY_CASES = [
    ("heat2d_cap1", lambda pkg, s: pkg.core.map_2d(s, workers=3,
                                                   queue_capacity=1),
     lambda: j_spec.heat_2d(18, 24, dtype="float64")),
    ("heat3d_cap1", lambda pkg, s: pkg.core.map_3d(s, workers=4,
                                                   queue_capacity=1),
     lambda: j_spec.heat_3d(8, 10, 12, dtype="float64")),
    ("heat2d_auto", lambda pkg, s: pkg.core.map_2d(s, workers=3,
                                                   auto_capacity=True),
     lambda: j_spec.heat_2d(18, 24, dtype="float64")),
    ("heat2d_unbounded", lambda pkg, s: pkg.core.map_2d(s, workers=3),
     lambda: j_spec.heat_2d(18, 24, dtype="float64")),
    ("paper1d", lambda pkg, s: pkg.core.map_1d(s, workers=6),
     lambda: j_spec.paper_stencil_1d(n=2400)),
]


@pytest.mark.parametrize("routed", [False, True])
@pytest.mark.parametrize("name,mk_plan,mk_spec", VERIFY_CASES)
def test_verify_plan_identical(name, mk_plan, mk_spec, routed):
    views = []
    for pkg, s in _specs(mk_spec()):
        plan = mk_plan(pkg, s)
        fab = None
        if routed:
            fab = pkg.fabric.route(pkg.fabric.place(
                plan, pkg.fabric.FabricTopology.mesh(16, 16), seed=0))
        rep = pkg.analysis.verify_plan(plan, fabric=fab,
                                       machine=pkg.core.CGRA)
        bound = pkg.analysis.throughput_bound(plan, fabric=fab,
                                              machine=pkg.core.CGRA)
        lints = [_fields(f) for f in pkg.analysis.lint_plan(plan, fab)]
        hint = pkg.analysis.suggest_capacity_fix(plan)
        grown = (pkg.analysis.apply_suggested_capacities(plan, hint)
                 if hint else 0)
        views.append((_fields(rep), rep.describe(), rep.ok(), _fields(bound),
                      lints, hint, grown, dfg_view(plan)[1]))
    assert views[0] == views[1]


def test_quiescence_certificate_identical():
    spec = j_spec.heat_2d(18, 24, dtype="float64")
    views = []
    for pkg, s in _specs(spec):
        plan = pkg.core.map_2d(s, workers=3, queue_capacity=64)
        plan.min_capacities = {}
        views.append(_fields(pkg.analysis.verify_plan(plan)))
    assert views[0] == views[1]
    assert views[1]["certificate"] == "quiescence"


# ---------------------------------------------------------------------------
# fabric: placement, routes, exports
# ---------------------------------------------------------------------------
FABRIC_CASES = [
    (lambda: j_spec.paper_stencil_1d(n=2400), "map_1d", 6, (16, 16), {}),
    (lambda: j_spec.paper_stencil_2d(ny=30, nx=48, r=12), "map_2d", 8,
     (16, 16), {}),
    (lambda: j_spec.heat_3d(10, 12, 16, dtype="float64"), "map_3d", 8,
     (16, 16), {}),
    (lambda: j_spec.heat_2d(18, 24, dtype="float64"), "map_2d", 3, (8, 8),
     {"torus": True}),
    (lambda: j_spec.heat_2d(18, 24, dtype="float64"), "map_2d", 3, (12, 12),
     {"words_per_cycle": 2}),
]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("mk,fn,w,shape,topo_kw", FABRIC_CASES)
def test_place_and_route_identical(mk, fn, w, shape, topo_kw, seed):
    views = []
    for pkg, s in _specs(mk()):
        plan = getattr(pkg.core, fn)(s, workers=w)
        f = pkg.fabric
        kw = dict(topo_kw)
        topo = (f.FabricTopology.torus_grid(*shape, **kw)
                if kw.pop("torus", False) else
                f.FabricTopology.mesh(*shape, **kw))
        pl = f.place(plan, topo, seed=seed)
        rf = f.route(pl)
        grown = f.apply_routed_capacities(rf)
        views.append((repr(topo), pl.coords, pl.seed, pl.weighted_hops(),
                      pl.pes_used(), rf.routes, rf.channel_load,
                      rf.traffic_load, rf.stats(), rf.link_names(),
                      rf.words_per_cycle(), grown,
                      f.placed_assembly(rf), f.placed_dot(rf),
                      dfg_view(plan)[1]))
    assert views[0] == views[1]


def test_place_restarts_identical():
    spec = j_spec.paper_stencil_2d(ny=30, nx=48, r=12)
    views = []
    for pkg, s in _specs(spec):
        plan = pkg.core.map_2d(s, workers=4)
        topo = pkg.fabric.FabricTopology.mesh(16, 16)
        pl = pkg.fabric.place(plan, topo, seed=1, restarts=3)
        views.append((pl.coords, pl.seed, pl.weighted_hops()))
    assert views[0] == views[1]


def test_placement_overflow_identical():
    spec = j_spec.paper_stencil_2d(ny=30, nx=48, r=12)
    msgs = []
    for pkg, s in _specs(spec):
        plan = pkg.core.map_2d(s, workers=8)
        with pytest.raises(pkg.fabric.PlacementError) as ei:
            pkg.fabric.place(plan, pkg.fabric.FabricTopology.mesh(4, 4))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_xy_route_identical():
    routes = []
    for pkg in (REF, PORT):
        topo = pkg.fabric.FabricTopology.torus_grid(6, 6)
        routes.append([pkg.fabric.xy_route(topo, (0, 0), dst)
                       for dst in [(5, 5), (3, 1), (0, 4), (2, 0)]])
    assert routes[0] == routes[1]
