"""The port's multi-pod dry run and what it stands on, on the CPU, no jax:
``python -m repro_torch.launch.dryrun`` on the production single mesh,
the fake backend's transport rule, K5's and K6's meta branches,
``TpuRooflineTerms``, and the batch's data group on a mesh with ``pod``
(a 4-rank gloo world training one step).

Tolerances, set before the runs:
- the (pod=2, data=2, model=1) world's loss within ``LOSS_RTOL`` 1e-5 of
  one device's, relative (float32 activations; the ranks' row means are
  summed in another order), and its first Adam moments, the averaged
  gradient times 1 - beta1, within 1e-5 of their largest magnitude;
- a CPU input into K5's and K6's wrappers: the plain version's bits;
- ``MemoryCounter``: bytes exact.  The hand case, x (4, 8) times W
  (8, 16), f32, summed, W's gradient: x (128 B) and W (512 B) are the
  arguments; the forward makes x @ W (256 B) and its sum (4 B), and x @ W
  dies once summed (the product's backward saves x alone), so 260 B live
  at its peak; the backward adds the seed gradient ``ones_like`` (4 B),
  viewed as (4, 16) by the sum's backward, and W's gradient x^T @ g (512
  B) while the seed lives, 520 B, the step's peak.  The conversion case,
  x (4, 8, 16) bf16, with and without ``inference_mode`` (under which
  ``aten.to`` and ``aten.reshape`` reach the counter whole, ops that may
  alias): x to bf16 is x and adds nothing, x to f32 a copy of 2,048 B,
  x^T reshaped flat a copy of 1,024 B, x reshaped flat a view: 3,072 B.
  Reduced tinyllama-1.1b's train and decode steps run no kernel on the
  CPU, so the count on meta and on CPU tensors is the same to the byte.
- ``hlo_lines``: a cell's count of aten ops the same with
  ``MemoryCounter`` and without it, which dispatches none of its own.
"""
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.analysis import rooflines
from repro_torch.configs import get_reduced_config
from repro_torch.core.roofline import TpuRooflineTerms
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.collectives import wire_device
from repro_torch.distributed.sharding import (DEFAULT_RULES, make_mesh_compat,
                                              mesh_context)
from repro_torch.kernels import _build
from repro_torch.kernels.conv1d.kernel import (conv1d_bwd, conv1d_bwd_work,
                                              conv1d_kernel, conv1d_work)
from repro_torch.kernels.conv1d.ops import causal_conv1d
from repro_torch.kernels.conv1d.ref import conv1d_bwd_ref, conv1d_ref
from repro_torch.kernels.stencil2d.kernel import stencil2d_kernel
from repro_torch.kernels.swa.kernel import (band_pairs, bwd_parts, swa_bwd_dq,
                                            swa_bwd_dkdv_partial, swa_bwd_fold,
                                            swa_bwd_fold_work, swa_bwd_kernel,
                                            swa_bwd_work, swa_kernel,
                                            swa_work)
from repro_torch.kernels.swa.ops import sliding_window_attention
from repro_torch.kernels.swa.ref import swa_bwd_ref, swa_ref
from repro_torch.kernels.conv1d.kernel import bwd_groups, plan_bwd
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh, run_local_world
from repro_torch.models.registry import build_model
from repro_torch.serving.serve_step import make_decode_step
from repro_torch.train.optim import OptConfig, init_opt_state
from repro_torch.train.train_step import make_train_step

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD_TIMEOUT_S = 300
CLI_TIMEOUT_S = 240
LOSS_RTOL = 1e-5
TL, RG = "tinyllama-1.1b", "recurrentgemma-2b"
# (arch, shape) -> what the CLI's record must say on the single mesh
CLI_CELLS = {
    (TL, "prefill_32k"): {"ok": True, "launches": None},
    (RG, "train_4k"): {"ok": True, "launches": {
        "conv1d": 36, "swa": 16, "conv1d_bwd": 18, "swa_bwd_dq": 8,
        "swa_bwd_dkdv": 8, "swa_bwd_fold": 8}},
    ("granite-moe-1b-a400m", "prefill_32k"): {"ok": True, "launches": None},
    ("rwkv6-7b", "prefill_32k"): {"ok": True, "launches": None},
    ("whisper-tiny", "prefill_32k"): {"ok": True, "launches": None},
    ("qwen2-vl-2b", "prefill_32k"): {"ok": True, "launches": None},
    (TL, "decode_32k"): {"ok": True, "launches": None},
}


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The CLI on each of CLI_CELLS, all started at once: (records by
    cell, stdout by cell, the output directory)."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = {cell: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cell[0], "--shape", cell[1], "--mesh", "single", "--out",
         str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for cell in CLI_CELLS}
    stdout = {}
    try:
        for cell, p in procs.items():
            stdout[cell], err = p.communicate(timeout=CLI_TIMEOUT_S)
            assert p.returncode == 0, err
    finally:
        for p in procs.values():
            p.kill()
    recs = {cell: json.loads((out / f"{cell[0]}__{cell[1]}__single.json")
                             .read_text()) for cell in CLI_CELLS}
    return recs, stdout, out


@pytest.mark.parametrize("cell", list(CLI_CELLS), ids="__".join)
def test_cli_cell(cli, cell):
    """Positive flops and bytes, the roofline at 256 chips and the K5/K6
    launches the wrappers counted on meta (printed by the CLI)."""
    recs, stdout, _ = cli
    rec, want = recs[cell], CLI_CELLS[cell]
    assert rec["ok"] is want["ok"]
    assert rec["chips"] == 256 and rec["mesh"] == "single"
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["collective_counts"]["all-reduce"] > 0
    assert rec["roofline"]["chips"] == 256
    assert rec["roofline"]["step_time_s"] == max(
        rec["roofline"][k] for k in ("compute_s", "memory_s", "collective_s"))
    assert rec["scan_correction"] == {"applied": False}
    line = [ln for ln in stdout[cell].splitlines() if "-> OK" in ln][0]
    if want["launches"] is None:
        assert "launches" not in line
    else:
        assert json.loads(line.split(" launches ", 1)[1]) == want["launches"]


def test_a_raising_cell_is_written_as_failed(monkeypatch, tmp_path, capsys):
    """``main`` writes a cell whose ``run_cell`` raises as the reference
    writes one (ok false, the error, the trace's tail) and goes on to the
    next mesh."""
    def boom(arch, shape, mesh, **_):
        raise NotImplementedError(f"{arch} x {shape} on {mesh}")
    monkeypatch.setattr(dryrun, "run_cell", boom)
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", TL, "--shape", "train_4k", "--mesh", "both",
        "--out", str(tmp_path)])
    dryrun.main()
    for mk in ("single", "multi"):
        rec = json.loads((tmp_path / f"{TL}__train_4k__{mk}.json")
                         .read_text())
        assert set(rec) == {"arch", "shape", "mesh", "ok", "error", "trace"}
        assert rec["ok"] is False and rec["mesh"] == mk
        assert rec["error"] == f"NotImplementedError: {TL} x train_4k on {mk}"
        assert "NotImplementedError" in rec["trace"]
    assert capsys.readouterr().out.count("-> FAIL NotImplementedError") == 2


def test_rooflines_cli_prints_both_tables(cli, capsys, monkeypatch,
                                         tmp_path):
    """The CLI's records and a failed one, which ``main`` writes for a
    ``run_cell`` that raises (no registered cell raises): both tables,
    the failed cell as FAIL with its error."""
    _, _, out = cli
    for rec in out.glob("*.json"):
        shutil.copy(rec, tmp_path)

    def boom(arch, shape, mesh, **_):
        raise NotImplementedError(f"{arch} x {shape} on {mesh}")
    monkeypatch.setattr(dryrun, "run_cell", boom)
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "qwen2-vl-2b", "--shape", "train_4k", "--out",
        str(tmp_path)])
    dryrun.main()
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["rooflines", "--dir", str(tmp_path)])
    rooflines.main()
    text = capsys.readouterr().out
    assert "### Dry-run (single-pod)" in text and "### Roofline" in text
    assert f"| {RG} | train_4k | single | 256 |" in text
    assert f"| {TL} | decode_32k | single | 256 |" in text
    assert "FAIL: NotImplementedError" in text and "FAIL: ValueError" not in text


def test_fake_backend_transport():
    """Over the fake backend a payload stays where it is (host or meta);
    any other pairing raises; the collectives the dry run places accept
    meta payloads."""
    with dryrun.fake_world(8):
        group = dist.group.WORLD
        for dev in ("cpu", "meta"):
            assert wire_device(group, torch.device(dev)) == torch.device(dev)
        with pytest.raises(ValueError, match="no transport for cuda"):
            wire_device(group, torch.device("cuda"))
        axis = tp.Axis("world", group, 0, 8)
        x = torch.empty(3, 5, device="meta")
        assert tp._reduce(x, axis).device.type == "meta"
        parts = tp.gather_over(x, axis)
        assert len(parts) == 8 and parts[0].shape == (3, 5)
        assert tp.max_over(x, axis).is_meta
    assert not dist.is_initialized()


@pytest.mark.parametrize("cell", [c for c in CLI_CELLS if c[1] == "train_4k"],
                         ids="__".join)
def test_train_cells_carry_the_fsdp_collectives(cli, cell):
    """Laid out by ``DEFAULT_RULES``, a train cell gathers its weights over
    ``data`` and reduce-scatters their gradients."""
    rec = cli[0][cell]
    assert rec["collective_counts"]["all-gather"] > 0
    assert rec["collective_counts"]["reduce-scatter"] > 0


def test_infer_layout_places_no_fsdp_gather():
    """Under ``--infer-layout`` (``INFERENCE_RULES``: no FSDP) a train cell
    gathers no weight and reduce-scatters nothing, and a rank holds more
    parameter bytes than under ``DEFAULT_RULES``."""
    small = {"num_layers": 1, "d_model": 256, "num_heads": 16,
             "num_kv_heads": 16, "d_ff": 512, "vocab_size": 1024}
    fsdp = dryrun.run_cell(TL, "train_4k", "single", overrides=small)
    infer = dryrun.run_cell(TL, "train_4k", "single", overrides=small,
                            infer_layout=True)
    assert fsdp["ok"] and infer["ok"]
    assert fsdp["collective_counts"]["all-gather"] > 0
    assert "all-gather" not in infer["collective_counts"]
    assert "reduce-scatter" not in infer["collective_counts"]
    assert infer["param_bytes_per_device"] > fsdp["param_bytes_per_device"]


def test_data_axis_follows_the_batch_rule():
    """The batch's group: "data" on (16, 16); "pod" and "data" flattened
    into 32 ranks on (2, 16, 16); the trainer's 2-axis meshes unchanged."""
    for multi, name, size in ((False, "data", 16), (True, "pod_data", 32)):
        with dryrun.fake_world(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi, device="cpu")
            axis = tp.data_axis(mesh)
            assert (axis.name, axis.rank, axis.size) == (name, 0, size)
            with mesh_context(mesh):
                assert tp.data_axis() == axis
                assert tp.model_axis().size == 16
    assert tp.data_axis() is None


def _step(model, cfg, batch):
    params = dict(model.named_parameters())
    opt = OptConfig(warmup_steps=1)
    state = init_opt_state(params, opt)
    state, metrics = make_train_step(model, cfg, opt, remat="none")(
        state, batch)
    return float(metrics["loss"]), {n: m.clone() for n, m in state.m.items()}


def _pod_batch(cfg) -> dict:
    rng = np.random.default_rng(3)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(8, 32)))
    return {"tokens": tokens, "labels": tokens}


def pod_rank(seed: int) -> dict:
    """One rank of a (pod=2, data=2, model=1) gloo world: its rows of the
    global batch by the batch's group, one train step."""
    torch.set_num_threads(1)
    cfg = get_reduced_config(TL)
    mesh = make_mesh_compat((2, 2, 1), ("pod", "data", "model"), "cpu")
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(seed))
    batch = _pod_batch(cfg)
    with mesh_context(mesh):
        axis = tp.data_axis()
        rows = batch["tokens"].shape[0] // axis.size
        local = {k: v[axis.rank * rows:(axis.rank + 1) * rows]
                 for k, v in batch.items()}
        loss, m = _step(model, cfg, local)
    return {"axis": (axis.name, axis.rank, axis.size),
            "coord": mesh.get_coordinate(), "loss": loss, "m": m}


def test_pod_and_data_average_the_gradients():
    """Four ranks holding different rows: the loss and the averaged
    gradient (Adam's first moment) are one device's on the whole batch."""
    out = run_local_world(pod_rank, 4, 0, timeout=WORLD_TIMEOUT_S)
    cfg = get_reduced_config(TL)
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    loss, m = _step(model, cfg, _pod_batch(cfg))
    for r, got in enumerate(out):
        pod, data, _ = got["coord"]
        assert got["axis"] == ("pod_data", 2 * pod + data, 4)
        assert abs(got["loss"] - loss) <= LOSS_RTOL * abs(loss)
        for n, want in m.items():
            scale = want.abs().max().item()
            assert (got["m"][n] - want).abs().max().item() <= 1e-5 * scale, n


def pod_fsdp_rank(seed: int) -> dict:
    """:func:`pod_rank` with the parameters and moments laid out by
    ``DEFAULT_RULES`` (FSDP over ``data`` alone): the loss and the first
    moments, gathered whole."""
    torch.set_num_threads(1)
    cfg = get_reduced_config(TL)
    mesh = make_mesh_compat((2, 2, 1), ("pod", "data", "model"), "cpu")
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(seed))
    layout = tp.parameter_layout(model, mesh, DEFAULT_RULES)
    tp.shard_parameters(model, layout, mesh)
    batch = _pod_batch(cfg)
    with mesh_context(mesh):
        axis = tp.data_axis()
        rows = batch["tokens"].shape[0] // axis.size
        local = {k: v[axis.rank * rows:(axis.rank + 1) * rows]
                 for k, v in batch.items()}
        tp.reset_wire()
        loss, m = _step(model, cfg, local)
        wire = tp.wire_bytes()
    return {"loss": loss, "wire": wire,
            "split": sum(p.shape != s.shape for p, s in zip(
                model.parameters(), model.specs().values())),
            "m": {n: tp.whole_of(t, mesh, layout[n]) for n, t in m.items()}}


def test_pod_and_data_average_fsdp_gradients():
    """The same world with FSDP over ``data``: a gathered weight's gradient
    leaves the backward pass summed over ``data`` and is summed over
    ``pod`` alone, then divided by pod·data = 4, so the loss and the first
    moments are one device's; the flattened (pod, data) group carries
    only the other leaves' gradients."""
    out = run_local_world(pod_fsdp_rank, 4, 0, timeout=WORLD_TIMEOUT_S)
    cfg = get_reduced_config(TL)
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    loss, m = _step(model, cfg, _pod_batch(cfg))
    for got in out:
        assert got["split"] == 30          # 4 layers' 7 weights, the tables
        assert set(got["wire"]) == {"data", "pod", "pod_data"}
        assert abs(got["loss"] - loss) <= LOSS_RTOL * abs(loss)
        for n, want in m.items():
            scale = want.abs().max().item()
            assert (got["m"][n] - want).abs().max().item() <= 1e-5 * scale, n


def _k5_args(device, dtype=torch.float32):
    g = torch.Generator().manual_seed(1)
    x, w, b, dy = (torch.randn(s, generator=g).to(device, dtype)
                   for s in ((2, 24, 16), (4, 16), (16,), (2, 24, 16)))
    return x, w, b, dy


def _k6_args(device, dtype=torch.float32):
    g = torch.Generator().manual_seed(2)
    q, k, v, do = (torch.randn(s, generator=g).to(device, dtype)
                   for s in ((1, 4, 40, 16), (1, 2, 40, 16), (1, 2, 40, 16),
                             (1, 4, 40, 16)))
    return q, k, v, do


def _like(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_meta_branch(dtype):
    """Meta in, meta out of the plain version's shapes and types, nothing
    launched, the launch and its work counted; autograd through the op
    counts the forward and the one backward launch."""
    cx, cw, cb, cdy = _k5_args("cpu", dtype)
    mx, mw, mb, mdy = (t.to("meta") for t in (cx, cw, cb, cdy))
    _build.reset_meta()
    before = dict(_build.LAUNCHES)
    y = conv1d_kernel(mx, mw, mb)
    assert y.is_meta and _like(y, conv1d_ref(cx, cw, cb))
    grads = conv1d_bwd(mx, mdy, mw, mb)
    for g, want in zip(grads, conv1d_bwd_ref(cx, cw, cb, cdy)):
        assert g.is_meta and _like(g, want)
    assert _build.meta_work() == {
        "conv1d": dict(zip(("ops", "bytes"), conv1d_work(mx, mw, mb)),
                       launches=1),
        "conv1d_bwd": dict(zip(("ops", "bytes"),
                               conv1d_bwd_work(mx, mw, mb)), launches=1)}
    assert conv1d_work(mx, mw)[0] == 2 * 4 * mx.numel()
    assert conv1d_bwd_work(mx, mw, mb)[0] == (4 * 4 + 1) * mx.numel()
    _build.reset_meta()
    leaves = [t.detach().requires_grad_() for t in (mx, mw, mb)]
    out = causal_conv1d(*leaves)
    torch.autograd.grad(out, leaves, mdy)
    assert {k: w["launches"] for k, w in _build.meta_work().items()} == {
        "conv1d": 1, "conv1d_bwd": 1}
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_meta_branch(dtype):
    cq, ck, cv, cdo = _k6_args("cpu", dtype)
    mq, mk, mv, mdo = (t.to("meta") for t in (cq, ck, cv, cdo))
    window = 9
    _build.reset_meta()
    before = dict(_build.LAUNCHES)
    o = swa_kernel(mq, mk, mv, window=window)
    assert o.is_meta and _like(o, swa_ref(cq, ck, cv, window=window))
    dq, lse, delta = swa_bwd_dq(mq, mk, mv, o, mdo, window=window)
    assert _like(dq, cq) and lse.shape == delta.shape == (1, 4, 40)
    part = swa_bwd_dkdv_partial(mq, mk, mv, mdo, lse, delta, window=window)
    parts = bwd_parts(1, 2, 40, 2, dtype)
    assert part.is_meta and part.shape == (2, parts, 1, 2, 40, 16)
    dk, dv = swa_bwd_fold(part, mk, mv)
    for g, want in zip(swa_bwd_kernel(mq, mk, mv, o, mdo, window=window),
                       swa_bwd_ref(cq, ck, cv, cdo, window=window)):
        assert g.is_meta and _like(g, want)
    assert _like(dk, ck) and _like(dv, cv)
    pairs = band_pairs(40, window) * 1 * 4 * 2 * 16
    assert swa_work(mq, mk, window)[0] == 2 * pairs
    assert swa_bwd_work("swa_bwd_dq", mq, mk, window)[0] == 3 * pairs
    assert swa_bwd_work("swa_bwd_dkdv", mq, mk, window)[0] == 4 * pairs
    assert swa_bwd_fold_work(part, mk) == (
        part.numel(), 4 * part.numel() + 2 * mk.numel() * mk.element_size())
    work = _build.meta_work()
    assert {k: w["launches"] for k, w in work.items()} == {
        "swa": 1, "swa_bwd_dq": 2, "swa_bwd_dkdv": 2, "swa_bwd_fold": 2}
    assert work["swa_bwd_dkdv"]["ops"] == 2 * 4 * pairs
    _build.reset_meta()
    leaves = [t.detach().requires_grad_() for t in (mq, mk, mv)]
    out = sliding_window_attention(leaves[0], leaves[1], leaves[2],
                                   window=window)
    torch.autograd.grad(out, leaves, mdo)
    assert {k: w["launches"] for k, w in _build.meta_work().items()} == {
        "swa": 1, "swa_bwd_dq": 1, "swa_bwd_dkdv": 1, "swa_bwd_fold": 1}
    assert _build.LAUNCHES == before


def test_cpu_inputs_keep_the_plain_versions_bits():
    """The meta branch leaves the CPU path as it was: the wrappers' bits
    are the plain versions', and nothing is tallied."""
    x, w, b, dy = _k5_args("cpu")
    q, k, v, do = _k6_args("cpu")
    _build.reset_meta()
    assert torch.equal(conv1d_kernel(x, w, b), conv1d_ref(x, w, b))
    for g, want in zip(conv1d_bwd(x, dy, w, b), conv1d_bwd_ref(x, w, b, dy)):
        assert torch.equal(g, want)
    assert torch.equal(swa_kernel(q, k, v, window=9),
                       swa_ref(q, k, v, window=9))
    for g, want in zip(swa_bwd_kernel(q, k, v, swa_ref(q, k, v, window=9),
                                      do, window=9),
                       swa_bwd_ref(q, k, v, do, window=9)):
        assert torch.equal(g, want)
    assert _build.meta_work() == {}


def test_stencil_kernels_refuse_meta():
    """K1-K4 have no meta branch (no dry-run cell reaches them)."""
    with pytest.raises(ValueError, match="unsupported device meta"):
        stencil2d_kernel(torch.empty(1, 16, 16, device="meta"),
                         (0.1, 0.6, 0.1), (0.1, 0.0, 0.1))


def test_roofline_terms_on_fixed_inputs():
    t = TpuRooflineTerms(flops=989e12 * 4, hbm_bytes=3.35e12 * 2,
                         collective_bytes=450e9 * 8, chips=2)
    assert (t.peak_flops_per_chip, t.hbm_bw_per_chip,
            t.link_bw_per_chip) == (989e12, 3.35e12, 450e9)
    assert math.isclose(t.compute_s, 2.0) and math.isclose(t.memory_s, 1.0)
    assert math.isclose(t.collective_s, 4.0)
    assert t.dominant == "collective" and math.isclose(t.step_time_s, 4.0)
    assert t.as_dict()["dominant"] == "collective"
    assert TpuRooflineTerms(1e15, 1.0, 0.0, 1).dominant == "compute"
    assert TpuRooflineTerms(1.0, 1e13, 0.0, 1).dominant == "memory"


MEMORY_KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "peak_memory_in_bytes",
               "generated_code_size_in_bytes")


@pytest.mark.parametrize("cell", list(CLI_CELLS), ids="__".join)
def test_cli_memory_analysis(cli, cell):
    """Every record carries the reference's five keys as ints, peak =
    argument + temp, the arguments at least the held parameters."""
    mem = cli[0][cell]["memory_analysis"]
    assert tuple(mem) == MEMORY_KEYS
    assert all(type(v) is int for v in mem.values())
    assert mem["peak_memory_in_bytes"] == (mem["argument_size_in_bytes"]
                                           + mem["temp_size_in_bytes"])
    assert mem["argument_size_in_bytes"] > \
        cli[0][cell]["param_bytes_per_device"]
    assert mem["temp_size_in_bytes"] > 0 and mem["output_size_in_bytes"] > 0
    assert mem["generated_code_size_in_bytes"] == 0


def test_rooflines_prints_every_peak(cli, capsys, monkeypatch):
    """Every ok row of the dry-run table names its peak in bytes."""
    _, _, out = cli
    monkeypatch.setattr(sys, "argv", ["rooflines", "--dir", str(out),
                                      "--what", "dryrun"])
    rooflines.main()
    rows = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.endswith("| OK |")]
    assert len(rows) == len(CLI_CELLS)
    for row in rows:
        cell = row.split(" | ")
        rec = cli[0][(cell[0].strip("| "), cell[1])]
        assert cell[6] == rooflines.fmt_bytes(
            rec["memory_analysis"]["peak_memory_in_bytes"])
        assert cell[6] != "-"


def _hand_step(device: str, backward: bool):
    x = torch.ones(4, 8, device=device)
    w = torch.ones(8, 16, device=device, requires_grad=True)

    def step():
        loss = (x @ w).sum()
        return torch.autograd.grad(loss, [w]) if backward else loss
    return step, (x, w)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("backward,temp", [(False, 260), (True, 520)])
def test_memory_counter_hand_count(device, backward, temp):
    """The hand case of the module's docstring, forward alone and with the
    backward pass, whose gradients the counter sees."""
    step, args = _hand_step(device, backward)
    _, mem = dryrun.count_memory(step, args)
    assert mem == {"argument_size_in_bytes": 640,
                   "output_size_in_bytes": 512 if backward else 4,
                   "temp_size_in_bytes": temp,
                   "peak_memory_in_bytes": 640 + temp,
                   "generated_code_size_in_bytes": 0}


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("inference", [False, True])
def test_memory_counter_counts_conversions(device, inference):
    """The conversion case of the module's docstring: a copy that an op
    which may alias makes counts, the input it hands back does not."""
    x = torch.ones(4, 8, 16, dtype=torch.bfloat16, device=device)
    mode = torch.inference_mode if inference else contextlib.nullcontext

    def step():
        with mode():
            return (x.to(torch.bfloat16), x.float(),
                    x.transpose(0, 2).reshape(-1), x.reshape(-1))
    out, mem = dryrun.count_memory(step, (x,))
    assert out[0] is x and out[3].untyped_storage() is x.untyped_storage()
    assert mem["temp_size_in_bytes"] == 2048 + 1024
    assert mem["output_size_in_bytes"] == 1024 + 2048 + 1024 + 1024


class _NoMemoryCount(contextlib.nullcontext):
    """Stands for ``MemoryCounter`` in ``run_cell``: no mode at all."""
    peak = 0

    def __init__(self, args=()):
        super().__init__()


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_hlo_lines_hold_no_memory_count(monkeypatch, shape):
    """A reduced cell's ``hlo_lines``, flops and bytes are those of its
    step run with no ``MemoryCounter``."""
    small = {"num_layers": 1, "d_model": 256, "num_heads": 16,
             "num_kv_heads": 4, "d_ff": 512, "vocab_size": 1024}
    counted = dryrun.run_cell(TL, shape, "single", overrides=small)
    monkeypatch.setattr(dryrun, "MemoryCounter", _NoMemoryCount)
    bare = dryrun.run_cell(TL, shape, "single", overrides=small)
    for key in ("hlo_lines", "flops_per_device", "bytes_per_device"):
        assert counted[key] == bare[key], key
    assert counted["memory_analysis"]["temp_size_in_bytes"] > 0
    assert bare["memory_analysis"]["temp_size_in_bytes"] == 0


def test_memory_counter_skips_views_and_old_storages():
    """A view, an in-place op and a storage made before the step add
    nothing; a fresh tensor counts once however many views it has."""
    old = torch.empty(8, 8, device="meta")

    def step():
        old.add_(1)
        v = old[2:].t()
        fresh = torch.empty(3, 5, device="meta")
        return v, fresh, fresh.view(15), fresh[1]
    with dryrun.MemoryCounter() as counter:
        out = step()
    assert counter.peak == counter.live == 60
    del out
    assert counter.live == 0


def _reduced_step(kind: str, device: str):
    cfg = get_reduced_config(TL)
    model = build_model(cfg, device=device)
    if device == "cpu":
        model.init(torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    tokens = torch.zeros((2, 64), dtype=torch.int32, device=device)
    if kind == "train":
        opt = OptConfig()
        state = init_opt_state(params, opt)
        fn = make_train_step(model, cfg, opt, remat="dots")
        batch = {"tokens": tokens, "labels": tokens.clone()}
        return (lambda: fn(state, batch)), (params, state, batch), params
    cache = model.init_cache(2, 64)
    fn = make_decode_step(model, cfg)
    one = tokens[:, :1].clone()
    return (lambda: fn(cache, one, 0)), (params, cache, one), ()


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_memory_meta_equals_cpu(kind):
    """Reduced tinyllama-1.1b's step counted on meta and on CPU tensors:
    the same five numbers, to the byte."""
    counts = [dryrun.count_memory(*_reduced_step(kind, dev))[1]
              for dev in ("meta", "cpu")]
    assert counts[0] == counts[1]
    assert counts[0]["temp_size_in_bytes"] > 0


def test_k5_backward_meta_holds_its_workspace():
    """``conv1d_bwd`` on meta allocates the card's f32 per-group sums,
    (groups, K + 1, C) of the aligned plan, beside dx, dw and db."""
    x, w, b, dy = (t.to("meta") for t in _k5_args("cpu"))
    _, mem = dryrun.count_memory(lambda: conv1d_bwd(x, dy, w, b),
                                 (x, w, b, dy))
    groups = bwd_groups(plan_bwd(2, 24, 16, 4, 4, True), 2, 24)
    part = groups * (4 + 1) * 16 * 4
    assert mem["temp_size_in_bytes"] == _build.nbytes(x, w, b) + part
    assert mem["output_size_in_bytes"] == _build.nbytes(x, w, b)


@pytest.mark.parametrize("unit_d", [True, False])
def test_k6_meta_copies_as_the_card(unit_d):
    """``swa_kernel`` on meta holds copies of q, k and v where their D
    stride is not 1, as its card branch does; head-transposed views of
    (B, S, H, D), the model's, are read in place."""
    q, k, v = (torch.empty(1, 40, h, 16, device="meta").transpose(1, 2)
               for h in (4, 2, 2))
    if not unit_d:
        q, k, v = (t.transpose(2, 3).contiguous().transpose(2, 3)
                   for t in (q, k, v))
    _, mem = dryrun.count_memory(lambda: swa_kernel(q, k, v, window=9),
                                 (q, k, v))
    copies = 0 if unit_d else _build.nbytes(q, k, v)
    assert mem["temp_size_in_bytes"] == q.numel() * 4 + copies
