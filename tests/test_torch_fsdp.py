"""FSDP over ``data``: parameters and AdamW moments laid out by
``DEFAULT_RULES`` (each ``"fsdp"`` dim over ``data`` besides the model
splits), gathered a layer at a time, gradients reduce-scattered, on the
CPU, no jax in this file.

One gloo world of (data 2, model 2) runs, for reduced tinyllama-1.1b,
recurrentgemma-2b, granite-moe-1b-a400m, rwkv6-7b, whisper-tiny and
qwen2-vl-2b (batch 4, seq 32, remat "dots"), the same work twice from
the same weights: laid out with FSDP off (the trainer's rules) and with
FSDP on.  Each run: the prefill logits, ``DECODE_STEPS`` greedy decode
steps (whisper's cross K/V primed from the whole model), then one
``make_train_step`` (lr 1e-2, clip 1.0); the step's averaged gradients
(as ``tensor_parallel.mean_grads_over_data`` hands them to the
optimizer), the updated parameters, the logits and the tokens gathered
whole.  tinyllama also steps with int8 and top-k compression.
tinyllama's and whisper's weights are the reference's
``init(PRNGKey(0))`` (``convert``), written by
``tests/fsdp_reference_step.py`` in a subprocess, which then runs the
reference's ``make_train_step`` jitted with ``in_shardings`` by
``DEFAULT_RULES`` on 4 fake host devices; the other four families' are
the port's seeded init.

Bars, set before the first run: FSDP on against off, the loss, every
gradient and every updated parameter within ``RTOL`` 1e-5 relative to
the leaf's largest element, the prefill and decode logits within
``LOGITS_TOL`` 1e-5 (rwkv6's at ``torch_rwkv_cases.bar`` of its float32
floor, measured here as the split tests measure it: FSDP changes no
product's shape, but a gathered weight is another buffer, and the CPU's
float32 products may sum it in another order; the first run gave 2.5e-5
on its decode logits) and the tokens equal; the port's FSDP loss within
``REF_RTOL`` 1e-5 of the reference's, relative.  A gradient summed over
``data`` twice, or divided by ``D`` twice, is off by a factor of 2.

``WIRE`` over ``data`` in reduced tinyllama's FSDP step, worked out from
the shapes before the first run (d 64, 4 heads of 16, 2 KV heads, d_ff
160, vocabulary 512 untied, 4 layers; a rank holds half of every weight
over ``model`` and half of that over ``data``; f32): the all-gathers of
``embed`` and ``unembed`` (the rank's 256 vocabulary rows by 64, 65,536 B
each) and of each layer's seven weights, wq 64·2·16·4 = 8,192, wk and wv
4,096 each, wo 8,192, the MLP's three 64·80·4 = 20,480 each, 86,016 B a
layer, twice under remat (forward and recompute): 819,200 B in 58 calls;
the reduce-scatters of their gradients, once a forward gather, in f32,
475,136 B in 30 calls; the all-reduces of the 576 norm-scale elements'
gradients (2,304 B), the loss's and the aux loss's means and the norm's
sum over ``data`` (4 B each): 2,316 B in 4 calls.  In all
``WIRE_FSDP`` 1,296,652 B in 92 calls; FSDP off (``WIRE_OFF``): every
gradient's 119,360 local elements, 477,440 B, the loss and the aux loss:
477,448 B in 3 calls.  The ``model`` axis carries the same either way.
"""
import dataclasses
import importlib.util
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import (DEFAULT_RULES, mesh_context,
                                              named_sharding, tree_shardings)
from repro_torch.launch.dryrun import param_bytes_per_device
from repro_torch.launch.mesh import make_local_mesh, run_local_world
from repro_torch.models import params as pr
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import build_model
from repro_torch.serving.serve_step import make_decode_step
from repro_torch.train.optim import OptConfig, init_opt_state
from repro_torch.train.train_step import make_train_step
from torch_rwkv_cases import bar, products_in_parts

REPO = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT_S = 300
REF_TIMEOUT_S = 300
RTOL = 1e-5
LOGITS_TOL = 1e-5
REF_RTOL = 1e-5
SEED = 0
BATCH, SEQ = 4, 32
DECODE_STEPS, CACHE_LEN = 4, 16
ARCHS = ("tinyllama-1.1b", "recurrentgemma-2b", "granite-moe-1b-a400m",
         "rwkv6-7b", "whisper-tiny", "qwen2-vl-2b")
REF_ARCHS = ("tinyllama-1.1b", "whisper-tiny")
RWKV = "rwkv6-7b"
# case -> (arch, gradient compression)
CASES = {**{a: (a, "none") for a in ARCHS},
         "tinyllama-1.1b/int8": ("tinyllama-1.1b", "int8"),
         "tinyllama-1.1b/topk": ("tinyllama-1.1b", "topk")}
LAYOUTS = {"off": None, "fsdp": DEFAULT_RULES}
WIRE_FSDP = {"bytes": 1_296_652, "calls": 92}
WIRE_OFF = {"bytes": 477_448, "calls": 3}


def _batch(cfg) -> dict:
    """The global batch: seeded tokens, whisper's frames too (numpy)."""
    rng = np.random.default_rng(SEED)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (BATCH, SEQ)).astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = (rng.normal(size=(BATCH, cfg.encoder_seq,
                                          cfg.d_model)) * 0.02
                         ).astype(np.float32)
    return out


def _primed_cache(model, cfg) -> dict:
    """whisper's whole decode cache: the self caches empty, the cross K/V
    the whole model's ``_cross_kv`` of seeded frames."""
    rng = np.random.default_rng(SEED + 2)
    frames = torch.from_numpy(rng.standard_normal(
        (BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    with torch.inference_mode():
        cache = model.init_cache(BATCH, CACHE_LEN)
        enc = model.encode(frames)
        kv = [model._cross_kv(bp, enc) for bp in model.dec]
    cache["cross_k"] = torch.stack([k for k, _ in kv])
    cache["cross_v"] = torch.stack([v for _, v in kv])
    return cache


def _decode(model, cfg, tokens: torch.Tensor, batch: int, cache=None):
    """``DECODE_STEPS`` greedy steps of ``tokens``' first columns from
    ``cache`` (``init_cache``'s where None): (logits, tokens)."""
    step = make_decode_step(model, cfg)
    if cache is None:
        cache = model.init_cache(batch, CACHE_LEN)
    logits, toks = [], []
    with torch.inference_mode():
        for t in range(DECODE_STEPS):
            nxt, lg, cache = step(cache, tokens[:, t:t + 1], t)
            logits.append(lg)
            toks.append(nxt)
    return torch.cat(logits, 1), torch.cat(toks, 1)


def _run(arch: str, compression: str, state: dict, mesh, rules) -> dict:
    """One layout's prefill, decode and train step on this rank, every
    result gathered whole."""
    cfg = get_reduced_config(arch)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state)
    primed = _primed_cache(model, cfg) if cfg.family == "audio" else None
    layout = tp.parameter_layout(model, mesh, rules)
    tp.shard_parameters(model, layout, mesh)
    glob = {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in _batch(cfg).items()}
    batch = {k: tp.shard_of(v, mesh, named_sharding(
        tuple(v.shape), ("batch",) + (None,) * (v.dim() - 1), mesh))
        for k, v in glob.items()}
    rows = named_sharding((BATCH, SEQ), ("batch", None), mesh)
    cols = named_sharding((BATCH, SEQ, cfg.vocab_size),
                          ("batch", None, "vocab"), mesh)
    params = dict(model.named_parameters())
    opt = OptConfig(lr=1e-2, warmup_steps=1, compression=compression)
    seen = {}
    mean = tp.mean_grads_over_data

    def keep(grads, axis, summed=frozenset()):
        out = mean(grads, axis, summed)
        seen.update(out)
        return out
    with mesh_context(mesh):
        with torch.no_grad():
            if cfg.family == "audio":
                logits = model(batch["tokens"], batch["frames"])[0]
            else:
                logits = model(batch["tokens"])[0]
        dec, toks = _decode(model, cfg, batch["tokens"], BATCH,
                            primed and tp.shard_cache(primed, mesh))
        state = init_opt_state(params, opt)
        train = make_train_step(model, cfg, opt, remat="dots")
        tp.mean_grads_over_data = keep
        tp.reset_wire()
        try:
            _, metrics = train(state, batch)
        finally:
            tp.mean_grads_over_data = mean
        wire = tp.wire_bytes()
    dcols = named_sharding((BATCH, DECODE_STEPS, cfg.vocab_size),
                           ("batch", None, "vocab"), mesh)
    drows = named_sharding((BATCH, DECODE_STEPS), ("batch", None), mesh)
    specs = model.specs()
    structs = pr.shape_tree(specs, cfg.param_dtype)
    return {
        "loss": float(metrics["loss"]),
        "logits": tp.whole_of(logits, mesh, cols),
        "decode": tp.whole_of(dec, mesh, dcols),
        "tokens": tp.whole_of(toks, mesh, drows),
        "grads": {n: tp.whole_of(g, mesh, layout[n])
                  for n, g in seen.items()},
        "params": {n: tp.whole_of(p.detach(), mesh, layout[n])
                   for n, p in params.items()},
        "wire": wire,
        "held": sum(p.numel() * p.element_size() for p in params.values()),
        "moments": sum(t.numel() * t.element_size()
                       for t in [*state.m.values(), *state.v.values()]),
        "placed": param_bytes_per_device(structs, tree_shardings(
            structs, pr.logical_tree(specs), mesh,
            rules or {**DEFAULT_RULES, **tp.FSDP_OFF}), mesh)}


def _unit(mesh) -> dict:
    """One (8, 6) parameter with spec ("fsdp", None) held as (4, 6) a
    rank: its FSDP gradient of ``sum(gather_fsdp(w) * x)`` with ``x`` the
    data rank's own, through ``mean_grads_over_data`` as the step takes
    it, and the wire over ``data``; the whole mean of ``x`` is what one
    device would give."""
    spec = pr.Spec((8, 6), ("fsdp", None))
    data = tp.mesh_axis("data", mesh)
    x = torch.arange(48, dtype=torch.float32).view(8, 6) * (data.rank + 1)
    w = torch.zeros(4, 6, requires_grad=True)
    with mesh_context(mesh):
        tp.reset_wire()
        whole = tp.gather_fsdp(w, spec)
        (g,) = torch.autograd.grad((whole * x).sum(), [w])
        g = tp.mean_grads_over_data({"w": g}, tp.data_axis(),
                                    frozenset({"w"}))["w"]
        wire = tp.wire_bytes()
    return {"grad": tp.gather_cat(g, data, 0), "wire": wire,
            "whole_shape": tuple(whole.shape)}


def rank_fsdp(cases: dict, states: dict) -> dict:
    """Every case in this rank, with FSDP off and on, then the unit
    gradient."""
    torch.set_num_threads(1)
    mesh = make_local_mesh(2, 2, device="cpu")
    out = {name: {k: _run(arch, comp, states[arch], mesh, rules)
                  for k, rules in LAYOUTS.items()}
           for name, (arch, comp) in cases.items()}
    out["unit"] = _unit(mesh)
    return out


def _wait_for(path: Path, proc, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while not path.exists():
        if proc.poll() is not None and not path.exists():
            raise RuntimeError(f"the reference step exited "
                               f"{proc.returncode}: "
                               f"{proc.stderr.read()[-3000:]}")
        if time.monotonic() > deadline:
            proc.kill()
            raise TimeoutError(f"{path} not written in {timeout} s")
        time.sleep(0.2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the world's ranks, the reference's steps or None, the whole
    weights): the reference compiles its steps while the world runs from
    its weights."""
    tmp = tmp_path_factory.mktemp("fsdp")
    torch.set_num_threads(2)
    states = {}
    for arch in ARCHS:
        model = build_model(get_reduced_config(arch), device="cpu")
        model.init(torch.Generator().manual_seed(SEED))
        states[arch] = model.state_dict()
    if importlib.util.find_spec("jax") is None:
        return run_local_world(rank_fsdp, 4, CASES, states,
                               timeout=WORLD_TIMEOUT_S), None, states
    batches = {a: _batch(get_reduced_config(a)) for a in REF_ARCHS}
    with open(tmp / "batches.pkl", "wb") as f:
        pickle.dump(batches, f)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "fsdp_reference_step.py"),
         str(tmp), str(tmp / "batches.pkl")], env=env, cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        _wait_for(tmp / "params.pkl", proc, REF_TIMEOUT_S)
        with open(tmp / "params.pkl", "rb") as f:
            jparams = pickle.load(f)
        states |= {a: from_jax_params(get_reduced_config(a), jparams[a])
                   for a in REF_ARCHS}
        ranks = run_local_world(rank_fsdp, 4, CASES, states,
                                timeout=WORLD_TIMEOUT_S)
        _wait_for(tmp / "steps.pkl", proc, REF_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    with open(tmp / "steps.pkl", "rb") as f:
        return ranks, pickle.load(f), states


@pytest.fixture(scope="module")
def floors(runs):
    """rwkv6's float32 floor at M = 2: how far the whole model's prefill
    and decode logits move with every product summed in 2 parts."""
    cfg = get_reduced_config(RWKV)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(runs[2][RWKV])
    tokens = torch.from_numpy(_batch(cfg)["tokens"]).long()

    def both():
        with torch.no_grad():
            return model(tokens)[0], _decode(model, cfg, tokens, BATCH)[0]
    plain = both()
    with products_in_parts(2):
        parts = both()
    return {k: (a - b).abs().max().item()
            for k, a, b in zip(("logits", "decode"), plain, parts)}


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / (scale or 1.0)


@pytest.mark.parametrize("name", list(CASES))
def test_fsdp_step_matches_fsdp_off(name, runs):
    """The loss, every averaged gradient and every updated parameter."""
    tol = RTOL
    for rank in runs[0]:
        off, on = rank[name]["off"], rank[name]["fsdp"]
        assert abs(on["loss"] - off["loss"]) <= tol * abs(off["loss"]), name
        assert set(on["grads"]) == set(off["grads"]) == set(off["params"])
        worst = max(_rel(on["grads"][n], g) for n, g in off["grads"].items())
        moved = max(_rel(on["params"][n], p)
                    for n, p in off["params"].items())
        print(f"{name}: loss {on['loss']!r} / {off['loss']!r}, gradients "
              f"{worst:.3e}, parameters {moved:.3e}")
        assert worst <= tol, (name, worst)
        assert moved <= tol, (name, moved)


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_prefill_and_decode_match_fsdp_off(arch, runs, floors):
    for rank in runs[0]:
        off, on = rank[arch]["off"], rank[arch]["fsdp"]
        for key in ("logits", "decode"):
            err = (on[key] - off[key]).abs().max().item()
            tol = bar(LOGITS_TOL, floors[key]) if arch == RWKV else \
                LOGITS_TOL
            print(f"{arch} {key}: {err:.3e} (bar {tol:.3e})")
            assert on[key].shape == off[key].shape
            assert err <= tol, (arch, key, err, tol)
        assert torch.equal(on["tokens"], off["tokens"]), arch


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_holds_the_rules_bytes(arch, runs):
    """Each rank's parameter bytes are what ``DEFAULT_RULES`` place on it
    (``dryrun.param_bytes_per_device``), the moments twice that in f32,
    and less than FSDP off's."""
    for rank in runs[0]:
        off, on = rank[arch]["off"], rank[arch]["fsdp"]
        assert on["held"] == on["placed"] and off["held"] == off["placed"]
        assert on["moments"] == 2 * on["held"]      # f32 parameters
        assert on["held"] < off["held"]


def test_fsdp_wire_from_the_shapes(runs):
    for rank in runs[0]:
        on = rank["tinyllama-1.1b"]["fsdp"]["wire"]
        off = rank["tinyllama-1.1b"]["off"]["wire"]
        assert on["data"] == WIRE_FSDP, on
        assert off["data"] == WIRE_OFF, off
        assert on["model"] == off["model"]


def test_fsdp_gradient_is_summed_once_and_divided_once(runs):
    """The gathered parameter's gradient, each data rank's ``x`` (rank
    d's is ``(d + 1)·arange``), leaves the backward pass reduce-scattered
    (the sum, 3·arange) and the step divides it by D = 2 once: the mean,
    1.5·arange, as one device's gradient of the mean loss.  Summed again
    over ``data`` it would be 3·arange, divided twice 0.75·arange."""
    want = torch.arange(48, dtype=torch.float32).view(8, 6) * 1.5
    for rank in runs[0]:
        unit = rank["unit"]
        assert unit["whole_shape"] == (8, 6)
        assert torch.equal(unit["grad"], want), unit["grad"]
        # the gather (8·6·4 B) and the reduce-scatter (the same, f32) only
        assert unit["wire"] == {"data": {"bytes": 384, "calls": 2}}


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_fsdp_loss_matches_the_reference_fsdp_step(arch, runs):
    ranks, ref = runs[:2]
    if ref is None:
        pytest.skip("jax is not installed: no reference step")
    want = ref[arch]
    assert want["all_gathers"] > 0      # the reference's step is FSDP's
    for rank in ranks:
        got = rank[arch]["fsdp"]["loss"]
        print(f"{arch}: port {got!r}, reference {want['loss']!r}")
        assert abs(got - want["loss"]) <= REF_RTOL * abs(want["loss"])


def test_a_data_split_parameter_outside_its_mesh_raises():
    spec = pr.Spec((8, 6), ("fsdp", None))
    whole = torch.zeros(8, 6)
    assert tp.gather_fsdp(whole, spec) is whole
    with pytest.raises(ValueError, match="data axis of 2"):
        tp.gather_fsdp(torch.zeros(4, 6), spec)


def test_unshard_nests_as_the_specs():
    cfg = dataclasses.replace(get_reduced_config("tinyllama-1.1b"),
                              num_layers=1)
    model = build_model(cfg, device="meta")
    got = tp.unshard(model.layers[0])
    assert set(got) == {"ln1", "ln2", "attn", "mlp"}
    assert got["attn"]["wq"] is model.layers[0].attn["wq"]
