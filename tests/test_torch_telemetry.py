"""Parity of the port's observability (``repro_torch.telemetry``'s trace,
report and metrics; ``repro_torch.analysis.lint``; ``repro_torch.testing.
minihyp``) with the JAX package's, on the same seeded runs.

Each run is made in both packages from the same spec and seed and its
observables compared: Perfetto trace events event for event (tuner spans
apart from their wall-clock fields), the text report, history records with
their fingerprints, minihyp's drawn examples and the walkthroughs' lint
text.  The reference's ``validate_trace`` rejections and crash-proofing
stubs (``tests/test_telemetry.py``) run on the port's functions.
"""
import functools
import importlib.util
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import repro.analysis as j_analysis  # noqa: E402
import repro.core as j_core  # noqa: E402
import repro.explore as j_explore  # noqa: E402
import repro.fabric as j_fabric  # noqa: E402
import repro.program as j_program  # noqa: E402
import repro.telemetry as j_tel  # noqa: E402
import repro.telemetry.metrics as j_metrics  # noqa: E402
import repro.testing.minihyp as j_minihyp  # noqa: E402
import repro_torch.analysis as t_analysis  # noqa: E402
import repro_torch.core as t_core  # noqa: E402
import repro_torch.explore as t_explore  # noqa: E402
import repro_torch.fabric as t_fabric  # noqa: E402
import repro_torch.program as t_program  # noqa: E402
import repro_torch.telemetry as t_tel  # noqa: E402
import repro_torch.telemetry.metrics as t_metrics  # noqa: E402
import repro_torch.testing.minihyp as t_minihyp  # noqa: E402
from repro_torch.telemetry.report import (bottleneck_table,  # noqa: E402
                                          utilization_grid)

ROOT = Path(__file__).resolve().parents[1]
J = (j_core, j_fabric, j_program, j_tel)
T = (t_core, t_fabric, t_program, t_tel)
WALL_KEYS = ("ts", "dur")          # a span's wall clock in a trace event


def _ideal_1d(pkgs, engine="vector"):
    core, _, _, tel_mod = pkgs
    spec = core.StencilSpec((120,), (1,), ((0.25, 0.5, 0.25),),
                            dtype="float64")
    x = np.random.default_rng(0).normal(size=120)
    tel = tel_mod.Telemetry()
    core.simulate(core.map_1d(spec, workers=3), x, core.CGRA, engine=engine,
                  telemetry=tel)
    return tel


def _routed_paper_2d(pkgs, engine="vector"):
    """tests/test_telemetry.py:173's run: the routed paper 2D stencil."""
    core, fabric, _, tel_mod = pkgs
    plan = core.map_2d(core.paper_stencil_2d(ny=30, nx=48, r=12), workers=8)
    fab = fabric.route(fabric.place(plan, fabric.FabricTopology.mesh(16, 16),
                                    seed=0))
    tel = tel_mod.Telemetry()
    core.simulate(plan, np.random.default_rng(0).normal(size=(30, 48)),
                  core.CGRA, fabric=fab, engine=engine, telemetry=tel)
    return tel


def _routed_program(pkgs, engine="vector"):
    """tests/test_telemetry.py:211's run: the routed two-stage heat DAG."""
    core, fabric, program, tel_mod = pkgs
    prog = program.two_stage_heat(24, 32)
    rng = np.random.default_rng(2)
    ins = {f: rng.normal(size=prog.grid_shape) for f in prog.in_fields}
    plan = program.lower(prog, workers=4)
    fab = fabric.route(fabric.place(plan, fabric.FabricTopology.mesh(16, 16),
                                    seed=0))
    tel = tel_mod.Telemetry()
    core.simulate(plan, plan.pack_inputs(ins), core.CGRA, fabric=fab,
                  engine=engine, telemetry=tel)
    return tel


RUNS = {"ideal_1d": _ideal_1d, "routed_paper_2d": _routed_paper_2d,
        "routed_program": _routed_program}


@functools.lru_cache(maxsize=None)
def _tel(run: str, side: str, engine: str):
    """One sink per run, package (``"j"`` or ``"t"``) and engine, shared by
    the tests below: the exporters only read it."""
    return RUNS[run](J if side == "j" else T, engine)


def test_all_equals_reference():
    assert t_tel.__all__ == j_tel.__all__
    assert t_metrics.__all__ == j_metrics.__all__
    assert t_analysis.__all__ == j_analysis.__all__


@pytest.mark.parametrize("run,engine", [
    ("ideal_1d", "interp"), ("ideal_1d", "vector"),
    ("routed_paper_2d", "vector"), ("routed_program", "vector")])
def test_trace_events_equal_reference(run, engine):
    """The simulation tracks event for event, in the same order."""
    want = j_tel.trace_events(_tel(run, "j", engine))
    got = t_tel.trace_events(_tel(run, "t", engine))
    assert got == want
    assert t_tel.validate_trace(got) == j_tel.validate_trace(want) > 0


@pytest.mark.parametrize("run", sorted(RUNS))
def test_report_text_equals_reference(run):
    j, t = _tel(run, "j", "vector"), _tel(run, "t", "vector")
    assert t_tel.render_report(t) == j_tel.render_report(j)
    assert utilization_grid(t) == j_tel.utilization_grid(j)
    for k in (3, 10):
        assert bottleneck_table(t, k) == j_tel.bottleneck_table(j, k)


def test_write_trace_roundtrips_from_disk(tmp_path):
    """The written object equals the reference's but for ``metadata.tool``,
    and validates from disk (tests/test_telemetry.py:173)."""
    j_obj = j_tel.write_trace(_tel("routed_paper_2d", "j", "vector"),
                              str(tmp_path / "j.json"))
    path = tmp_path / "t.json"
    obj = t_tel.write_trace(_tel("routed_paper_2d", "t", "vector"),
                            str(path))
    assert obj["metadata"].pop("tool") == "repro_torch.telemetry"
    assert j_obj["metadata"].pop("tool") == "repro.telemetry"
    assert obj == j_obj
    n = t_tel.validate_trace(obj)
    reread = json.loads(path.read_text())
    assert t_tel.validate_trace(reread) == n > 0
    body = [e["ts"] for e in reread["traceEvents"] if e["ph"] != "M"]
    assert body == sorted(body)
    groups = {e["args"]["name"] for e in reread["traceEvents"]
              if e["ph"] == "M" and e["name"] == "process_name"}
    assert any(g.startswith("PE(") for g in groups)


# -- the reference's validate_trace rejections (tests/test_telemetry.py) ----
def test_validate_trace_rejects_garbage():
    with pytest.raises(ValueError):
        t_tel.validate_trace({"traceEvents": [{"ph": "X"}]})
    with pytest.raises(ValueError, match="not monotonic"):
        t_tel.validate_trace({"traceEvents": [
            {"ph": "X", "name": "a", "pid": 1, "tid": 1, "ts": 5, "dur": 1,
             "cat": "c"},
            {"ph": "X", "name": "b", "pid": 1, "tid": 1, "ts": 4, "dur": 1,
             "cat": "c"}]})


@pytest.mark.parametrize("event,match", [
    ({"ph": "Q", "pid": 1, "name": "a", "ts": 0}, "unknown phase"),
    ({"ph": "X", "pid": 1, "name": "a", "ts": -1, "dur": 1}, "bad ts"),
    ({"ph": "X", "pid": 1, "name": "a", "ts": 1.5, "dur": 1}, "bad ts"),
    ({"ph": "X", "pid": 1, "name": "a", "ts": 1, "dur": -1}, "bad dur"),
    ({"ph": "C", "pid": 2, "name": "a", "ts": 1}, "counter without args"),
])
def test_validate_trace_rejects_what_the_reference_rejects(event, match):
    for validate in (j_tel.validate_trace, t_tel.validate_trace):
        with pytest.raises(ValueError, match=match):
            validate({"traceEvents": [event]})


def test_validate_trace_overlapping_exclusive_intervals():
    overlap = [
        {"ph": "X", "name": "fire", "pid": 10, "tid": 0, "ts": 1, "dur": 5,
         "cat": "fire"},
        {"ph": "X", "name": "input_starved", "pid": 10, "tid": 0, "ts": 3,
         "dur": 2, "cat": "stall"}]
    with pytest.raises(ValueError, match="overlapping exclusive intervals"):
        t_tel.validate_trace({"traceEvents": overlap})
    ok = [dict(overlap[0]), {**overlap[1], "tid": 1}]
    assert t_tel.validate_trace({"traceEvents": ok}) == 2
    spans = [{**overlap[0], "cat": "tuner"}, {**overlap[1], "cat": "tuner"}]
    assert t_tel.validate_trace({"traceEvents": spans}) == 2


def test_validate_trace_unknown_link_id():
    decl = {"ph": "M", "pid": 2, "ts": 0, "name": "process_name",
            "args": {"name": "links (contended)", "links": 3}}
    sample = {"ph": "C", "pid": 2, "ts": 1, "name": "link x",
              "args": {"words": 1, "lid": 7}}
    with pytest.raises(ValueError, match="unknown link id 7"):
        t_tel.validate_trace({"traceEvents": [decl, sample]})
    with pytest.raises(ValueError, match="unknown link id 7"):
        t_tel.validate_trace({"traceEvents": [sample]})
    assert t_tel.validate_trace({"traceEvents": [
        decl, {**sample, "args": {"words": 1, "lid": 2}}]}) == 1


def test_report_crash_proofing_stubs():
    """tests/test_telemetry.py:622: a sink that never saw a run renders
    stubs, the reference's text, instead of raising."""
    j, t = j_tel.Telemetry(), t_tel.Telemetry()
    assert "no run attached" in utilization_grid(t)
    assert "no stalls recorded" in bottleneck_table(t)
    assert "no run attached" in t_tel.render_report(t)
    assert t_tel.render_report(t) == j_tel.render_report(j)
    assert utilization_grid(t) == j_tel.utilization_grid(j)
    assert bottleneck_table(t) == j_tel.bottleneck_table(j)
    assert t_tel.trace_events(t) == j_tel.trace_events(j) == []
    t.span("lonely", cat="tuner", t0=0.5, dur=0.25)
    assert "(1 span(s))" in t_tel.render_report(t)

    spec = t_core.StencilSpec((60,), (1,), ((0.25, 0.5, 0.25),),
                              dtype="float64")
    tel2 = t_tel.Telemetry()
    t_core.simulate(t_core.map_1d(spec, workers=1),
                    np.random.default_rng(0).normal(size=60), t_core.CGRA,
                    engine="vector", telemetry=tel2)
    if not tel2.stall_totals.sum():
        assert "(no stalls recorded)" in bottleneck_table(tel2)


# -- tuner spans ------------------------------------------------------------
def _search(core, ex, tmp_path, tag, **kw):
    tel = (j_tel if core is j_core else t_tel).Telemetry()
    res = ex.explore(
        core.heat_2d(18, 24, dtype="float64"), core.CGRA,
        options=ex.SpaceOptions(workers=(2, 3), capacities=("auto",)),
        cache=str(tmp_path / f"{tag}.json"), telemetry=tel, **kw)
    return res, tel


def _no_wall(events):
    """Span events without their wall-clock fields, in a canonical order
    (the trace sorts spans by their wall-clock ts)."""
    out = [{k: v for k, v in e.items() if k not in WALL_KEYS}
           for e in events]
    return sorted(out, key=lambda e: json.dumps(e, sort_keys=True))


def test_explore_spans_equal_reference(tmp_path):
    """tests/test_telemetry.py:344's sequential search: the same spans, in
    the same order, apart from wall fields; then a replay from the same
    cache gives only cached outcomes in both packages."""
    j_res, j_t = _search(j_core, j_explore, tmp_path, "j")
    t_res, t_t = _search(t_core, t_explore, tmp_path, "t")
    strip = [{k: v for k, v in s.items() if k not in ("t0", "dur")}
             for s in t_t.spans]
    assert strip == [{k: v for k, v in s.items() if k not in ("t0", "dur")}
                     for s in j_t.spans]
    want, got = j_tel.trace_events(j_t), t_tel.trace_events(t_t)
    assert [e for e in got if e["ph"] == "M"] == \
        [e for e in want if e["ph"] == "M"]
    assert _no_wall(got) == _no_wall(want)
    evals = [s for s in t_t.spans if s["track"].startswith("search/")
             and s["track"] != "search/prune"]
    assert len(evals) == t_res.stats["n_measured"] == \
        j_res.stats["n_measured"] > 0
    assert t_tel.validate_trace(got) >= len(evals)
    _, t_t2 = _search(t_core, t_explore, tmp_path, "t")
    assert {s["args"]["outcome"] for s in t_t2.spans
            if s["track"] != "search/prune"} == {"cached"}


def test_batched_stage1_records_a_span_per_measured_lane(tmp_path):
    """The batched stage 1 (K7's plain version on the CPU) records one
    ``measured`` span per lane, and the trace validates."""
    res, tel = _search(t_core, t_explore, tmp_path, "b",
                       budget=t_explore.Budget(batch_size=8), device="cpu")
    measured = [s for s in tel.spans if s["args"].get("outcome") ==
                "measured"]
    assert len(measured) == res.stats["n_measured"] > 0
    assert all(s["args"]["batched"] and s["track"] == "search/ideal"
               for s in measured)
    path = tmp_path / "b.trace.json"
    t_tel.write_trace(tel, str(path))
    n = t_tel.validate_trace(json.loads(path.read_text()))
    assert n == len(tel.spans)


# -- history records ----------------------------------------------------------
BENCH = sorted(p.name for p in ROOT.glob("BENCH_pr*.json"))


@pytest.mark.parametrize("name", BENCH)
def test_history_records_equal_reference(name, tmp_path):
    art = json.loads((ROOT / name).read_text())
    want = j_metrics.case_records(art, source=name, ts=1723118400.0)
    got = t_metrics.case_records(art, source=name, ts=1723118400.0)
    assert got == want and got
    assert [r["fingerprint"] for r in got] == [r["fingerprint"] for r in want]
    # a history one package writes, the other reads, byte for byte
    tp, jp = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    assert t_metrics.append_history(str(tp), got) == len(got)
    j_metrics.append_history(str(jp), want)
    assert tp.read_bytes() == jp.read_bytes()
    assert j_metrics.load_history(str(tp)) == t_metrics.load_history(str(jp))
    recs = t_metrics.load_history(str(tp))
    for r in recs:
        assert t_metrics.record_problem(r) == j_metrics.record_problem(r)
        line = t_metrics.history_for(recs, r["schema"], r["config"],
                                     r["case"])
        assert line == j_metrics.history_for(recs, r["schema"], r["config"],
                                             r["case"])
        for key in r["counters"]:
            assert t_metrics.trend_values(line, key, last=2) == \
                j_metrics.trend_values(line, key, last=2)


def test_committed_history_loads_as_the_reference_loads_it():
    path = str(ROOT / t_metrics.DEFAULT_HISTORY)
    recs = t_metrics.load_history(path)
    assert recs == j_metrics.load_history(path) and recs
    assert [t_metrics.record_problem(r) for r in recs] == \
        [j_metrics.record_problem(r) for r in recs]
    assert t_metrics.HISTORY_VERSION == j_metrics.HISTORY_VERSION


def test_history_unknown_record_shapes():
    """tests/test_telemetry.py:568's record shapes, on the port's helpers."""
    for rec in ({"v": 1, "counters": {}, "walls": {}}, {"v": 99}, {"v": 1},
                {"v": 1, "counters": None}, {"v": "1", "walls": {}}):
        assert t_metrics.record_problem(rec) == j_metrics.record_problem(rec)
    assert t_metrics.record_problem({"v": 1, "counters": None}) \
        == "'counters' is not a mapping"
    recs = [{"walls": {"wall_s": 0.31}}, {"walls": None},
            {"walls": {"wall_s": 9.9}}, {"counters": {"x": 1}}]
    assert t_metrics.trend_values(recs, "wall_s", kind="walls") == \
        j_metrics.trend_values(recs, "wall_s", kind="walls") == [0.31, 9.9]
    nested = {"a": {"b": {"c": 1}, "d": [1, 2]}, "e": 2.5}
    assert t_metrics.flatten_case(nested) == j_metrics.flatten_case(nested)
    assert t_metrics.fingerprint("s", "c", "k", {"grid": [1, 2]}) == \
        j_metrics.fingerprint("s", "c", "k", {"grid": [1, 2]})


# -- minihyp ------------------------------------------------------------------
def _draws(mh, n=6):
    st = mh.strategies

    @st.composite
    def pair(draw, lo):
        a = draw(st.integers(lo, 9))
        return a, draw(st.lists(st.floats(-1, 1, width=32), min_size=a,
                                max_size=a + 2))

    seen = []

    @mh.given(pair(2), st.sampled_from("xyz"), st.booleans(),
              st.tuples(st.integers(0, 3), st.floats(0, 1)))
    @mh.settings(max_examples=n, deadline=None)
    def probe(*values):
        seen.append(values)

    probe()
    return seen, probe


def test_minihyp_draws_the_reference_examples(monkeypatch):
    monkeypatch.delenv("REPRO_MINIHYP_EXAMPLES", raising=False)
    want, j_fn = _draws(j_minihyp)
    got, t_fn = _draws(t_minihyp)
    assert got == want and len(got) == 6
    assert t_fn.minihyp and not t_fn.__signature__.parameters
    for i in (0, 7):
        assert t_minihyp._example_rng("q.f", i).random() == \
            j_minihyp._example_rng("q.f", i).random()


def test_minihyp_reports_the_falsifying_example():
    st = t_minihyp.strategies

    @t_minihyp.given(st.integers(0, 10))
    @t_minihyp.settings(max_examples=5)
    def never(v):
        raise ValueError("no")

    with pytest.raises(AssertionError, match="minihyp falsified .*args=\\["):
        never()
    with pytest.raises(ValueError):
        t_minihyp.integers(3, 2)
    with pytest.raises(ValueError):
        t_minihyp.sampled_from([])


# -- the walkthroughs' lint text ---------------------------------------------
EXAMPLES = ["quickstart", "fabric_heat1d", "hdiff_program", "heat3d_fabric",
            "seismic_stencil2d"]


def _load(path: Path):
    name = f"_lint_parity_{path.stem}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules.pop(name, None)
    return mod


def _describe(analysis, mod):
    out = []
    for item in mod.lint_plans():
        plan, fabric = item if isinstance(item, tuple) else (item, None)
        out.append((fabric is not None,
                    analysis.verify_plan(plan, fabric=fabric).describe()))
    return out


@pytest.mark.parametrize("name", EXAMPLES)
def test_walkthrough_lint_text_equals_reference(name):
    want = _describe(j_analysis, _load(ROOT / "examples" / f"{name}.py"))
    got = _describe(t_analysis, _load(ROOT / "examples" / f"{name}_torch.py"))
    assert got == want and got


def test_lint_cli_output_equals_reference():
    """The port's CLI over ``examples/*_torch.py`` prints the reference's
    lines over the reference's examples, file names aside."""
    from repro.analysis.lint import lint_paths as j_lint
    from repro_torch.analysis.lint import lint_paths as t_lint
    j_out, t_out = io.StringIO(), io.StringIO()
    ex = ROOT / "examples"
    assert j_lint([str(ex / f"{n}.py") for n in EXAMPLES], out=j_out) == \
        t_lint([str(ex / f"{n}_torch.py") for n in EXAMPLES], out=t_out) == \
        (7, 0)
    want = sorted(j_out.getvalue().replace(".py[", "_torch.py[").splitlines())
    assert sorted(t_out.getvalue().splitlines()) == want


def test_walkthroughs_print_the_reference_lines(capsys):
    """The host-only walkthroughs print the reference's lines."""
    for name in ("fabric_heat1d", "hdiff_program", "heat3d_fabric"):
        ref = _load(ROOT / "examples" / f"{name}.py")
        # fabric_heat1d.py writes a dot file to a fixed path: its module
        # global ``open`` (found before the builtin) keeps it in memory
        ref.open = lambda *a, **k: io.StringIO()
        ref.main()
        want = capsys.readouterr().out
        _load(ROOT / "examples" / f"{name}_torch.py").main(
            *(([],) if name == "fabric_heat1d" else ()))
        got = capsys.readouterr().out
        if name == "fabric_heat1d":      # the reference writes a dot file
            want = want.split("\nfloorplan dot written")[0]
        assert got == want

