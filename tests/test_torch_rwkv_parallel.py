"""RWKV-6 split over the ``model`` axis, on the CPU, no jax: gloo worlds
from ``run_local_world``, each rank holding its slice of reduced rwkv6-7b's
weights (``tensor_parallel.shard_parameters`` under the trainer's rules),
running the forward pass and the train loss's gradients on the same
tokens; held to the whole model's in this process.

The layouts, as the rules place them (reduced rwkv6: 4 heads of 16, d 64,
d_ff 160, vocabulary 512, 4 layers):
- ``heads_1x2`` and ``heads_1x4``: ``wr``/``wk``/``wv``/``wg``'s columns,
  ``wo``'s rows and ``u``'s heads split 2 or 4 ways (2 or 1 whole heads a
  rank), ``cm_wk``'s columns and ``cm_wv``'s rows over ``d_ff`` (80 or
  40), ``cm_wr``'s columns over d (32 or 16), the vocabulary over the
  ranks;
- ``dff161_1x2``: ``d_ff`` 161, which 2 does not divide: the channel mix's
  value half whole on each rank and on the replicated path, its
  receptance split.  A ``copy_in`` on the value half's path there would
  sum its gradient twice, which the gradient comparison sees.
A mid-head split (2 heads of 32 at M = 4: d splits, the heads do not)
raises ``ValueError`` in each rank, naming the heads.

Tolerances: the loss within ``LOSS_TOL`` 1e-5 of the whole model's
(float32; a split product sums its parts in another order), set before
the runs.  The logits (gathered over the vocabulary) and each parameter's
gradient (gathered whole; relative to that leaf's largest element, so a
gradient summed once too few or too many times over the ranks is off by
a factor of 2 or more) are held to 1e-5 (``LOGITS_TOL``, ``GRAD_RTOL``,
the other split tests' bar) or to ``FLOOR_FACTOR`` (3) times this
model's float32 floor at the case's M, where that is larger.  The floor
is the whole model in this process with every product's contraction
summed in M parts (``torch_rwkv_cases.products_in_parts``: a split's
reassociation, no collective), measured per case by the ``floors``
fixture.  It sits above 1e-5: at M = 4 the split's logits differed by
3.5e-5 from the whole model's, and the whole model in 2 or 4 parts moves
its logits by 2.8e-5 and 3.2e-5 and its gradients by up to 5.3e-5
relative (the WKV state grows to ~56 and the 4 layers compound it), so
1e-5 cannot be met in float32.  ``test_the_bars_sit_above_the_f32_floor``
holds each floor under ``LOGITS_FLOOR_MAX`` 5e-5 and ``GRAD_FLOOR_MAX``
1e-4, so a change that worsens the model's conditioning fails there
instead of widening the bars unseen.

Bytes and calls over ``model`` in one step (the loss's forward and
backward, remat off), worked out from the shapes before the first run;
B = 2, S = 32, T = B·S = 64 tokens, every payload float32, an all-reduce
counted by its payload and an all-gather by the whole it gathers:
- forward: the embedding's rows T·d·4 = 16,384 B; a layer's ``wo`` partial
  sums 16,384, the value half's partial sums 16,384 and the receptance's
  gather 16,384; the cross entropy's max, sum of exponentials and target
  logit, B·(S-1)·4 = 248 each: 16,384 + 4·49,152 + 744 = 213,736 B in
  1 + 4·3 + 3 = 16 calls;
- backward: the logits' input's gradient 16,384 B; a layer's time-mix
  input 16,384, the two mixed inputs of the channel mix 16,384 each, and
  the time mix's replicated parameters' gradients: ``mu_x`` 256, ``mu``
  1,280, ``tm_w1`` 40,960, ``tm_w2`` 40,960, ``w0`` 256, ``w_lora1``
  16,384, ``w_lora2`` 16,384, ``ln_x_scale`` 256 (116,736 B): 16,384 +
  4·165,888 = 679,936 B in 1 + 4·11 = 45 calls;
- in all ``WIRE_STEP["heads_1x2"]``: 893,672 B in 61 calls.  With the
  value half whole (``dff161_1x2``) a layer drops its value half's sum and
  its ``xk`` gradient: 893,672 − 4·32,768 = 762,600 B in 61 − 8 = 53
  calls.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import mesh_context, named_sharding
from repro_torch.launch.dryrun import StepCounter
from repro_torch.launch.mesh import make_local_mesh, run_local_world
from repro_torch.models import rwkv6
from repro_torch.models.registry import build_model
from repro_torch.train.train_step import make_loss_fn
from torch_rwkv_cases import bar, products_in_parts

WORLD_TIMEOUT_S = 300
LOGITS_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_RTOL = 1e-5
LOGITS_FLOOR_MAX = 5e-5
GRAD_FLOOR_MAX = 1e-4
SEED = 0
ARCH = "rwkv6-7b"
BATCH, SEQ = 2, 32
# name -> (model ranks, config overrides)
CASES = {
    "heads_1x2": (2, {}),
    "dff161_1x2": (2, {"d_ff": 161}),
    "heads_1x4": (4, {}),
}
MID_HEAD = {"num_heads": 2, "head_dim": 32}          # at M = 4
# name -> (bytes, calls) over model in one step, from the shapes
WIRE_STEP = {"heads_1x2": (893_672, 61), "dff161_1x2": (762_600, 53)}
LAYOUT_LEAVES = ("wr", "wo", "u", "cm_wk", "cm_wv", "cm_wr", "w0")


def _model(overrides: dict):
    cfg = dataclasses.replace(get_reduced_config(ARCH), **overrides)
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(SEED))
    return cfg, model


def _tokens(cfg) -> torch.Tensor:
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, SEQ)))


def _run(model, cfg, tokens):
    """(logits, loss, each parameter's gradient of the train loss, the
    loss's forward and backward's bytes and calls a mesh axis)."""
    with torch.no_grad():
        logits, _ = model(tokens)
    tp.reset_wire()
    total, (loss, _) = make_loss_fn(model, cfg)({"tokens": tokens})
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(total, list(params.values()))
    return (logits, float(loss.detach()), dict(zip(params, grads)),
            tp.wire_bytes())


def rank_rwkv(cases: dict, mid_head: bool) -> dict:
    """Every case of one world in this rank: the logits and gradients
    gathered whole, the loss, the step's bytes and calls over ``model``,
    the first layer's local shapes; with ``mid_head``, the error of the
    forward pass at ``MID_HEAD``."""
    torch.set_num_threads(1)
    out = {}
    for name, (m, overrides) in cases.items():
        cfg, model = _model(overrides)
        mesh = make_local_mesh(1, m, device="cpu")
        layout = tp.parameter_layout(model, mesh)
        tp.shard_parameters(model, layout, mesh)
        with mesh_context(mesh):
            logits, loss, grads, wire = _run(model, cfg, _tokens(cfg))
        cols = named_sharding(tuple(logits.shape), ("batch", None, "vocab"),
                              mesh)
        out[name] = {
            "logits": tp.whole_of(logits, mesh, cols), "loss": loss,
            "grads": {n: tp.whole_of(g, mesh, layout[n])
                      for n, g in grads.items()},
            "wire": wire,
            "shapes": {k: tuple(model.layers[0].rwkv[k].shape)
                       for k in LAYOUT_LEAVES}}
    if mid_head:
        cfg, model = _model(MID_HEAD)
        mesh = make_local_mesh(1, 4, device="cpu")
        tp.shard_parameters(model, tp.parameter_layout(model, mesh), mesh)
        try:
            with mesh_context(mesh), torch.no_grad():
                model(_tokens(cfg))
            out["mid_head"] = None
        except ValueError as e:
            out["mid_head"] = str(e)
    return out


@pytest.fixture(scope="module")
def worlds():
    torch.set_num_threads(2)
    return {m: run_local_world(
        rank_rwkv, m, {n: c for n, c in CASES.items() if c[0] == m},
        m == 4, timeout=WORLD_TIMEOUT_S) for m in (2, 4)}


@pytest.fixture(scope="module")
def whole():
    torch.set_num_threads(2)
    out = {}
    for name, (_, overrides) in CASES.items():
        cfg, model = _model(overrides)
        out[name] = _run(model, cfg, _tokens(cfg))
    return out


@pytest.fixture(scope="module")
def floors(whole):
    """Each case's float32 floor: how far the whole model's logits, loss
    and gradients (the largest over the leaves, relative to each leaf's
    largest element) move with every product summed in the case's M
    parts."""
    out = {}
    for name, (m, overrides) in CASES.items():
        want_logits, want_loss, want_grads, _ = whole[name]
        cfg, model = _model(overrides)
        with products_in_parts(m):
            logits, loss, grads, _ = _run(model, cfg, _tokens(cfg))
        out[name] = {
            "logits": (logits - want_logits).abs().max().item(),
            "loss": abs(loss - want_loss),
            "grads": max((grads[n] - w).abs().max().item()
                         / w.abs().max().item()
                         for n, w in want_grads.items())}
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_split_rwkv_forward_matches_the_whole_model(name, worlds, whole,
                                                    floors):
    want_logits, want_loss = whole[name][:2]
    tol = bar(LOGITS_TOL, floors[name]["logits"])
    for rank in worlds[CASES[name][0]]:
        got = rank[name]
        assert got["logits"].shape == want_logits.shape
        err = (got["logits"] - want_logits).abs().max().item()
        print(f"{name}: logits {err:.3e} (bar {tol:.3e})")
        assert err <= tol, (name, err, tol)
        assert abs(got["loss"] - want_loss) <= LOSS_TOL, name


@pytest.mark.parametrize("name", list(CASES))
def test_split_rwkv_gradients_match_the_whole_model(name, worlds, whole,
                                                    floors):
    want = whole[name][2]
    tol = bar(GRAD_RTOL, floors[name]["grads"])
    for rank in worlds[CASES[name][0]]:
        got = rank[name]["grads"]
        assert set(got) == set(want)
        worst = 0.0
        for n, w in want.items():
            assert got[n].shape == w.shape, n
            scale = w.abs().max().item()
            err = (got[n] - w).abs().max().item()
            worst = max(worst, err / scale)
            assert err <= tol * scale, (name, n, err, scale, tol)
        print(f"{name}: gradients {worst:.3e} relative (bar {tol:.3e})")


@pytest.mark.parametrize("name", list(CASES))
def test_split_rwkv_layout_is_the_rules(name, worlds):
    """Whole heads a rank (``wr``'s columns, ``wo``'s rows, ``u``'s
    heads); ``d_ff`` split where M divides it; the receptance over d; the
    decay's ``w0`` whole (replicated, sliced in the layer)."""
    m, overrides = CASES[name]
    cfg = dataclasses.replace(get_reduced_config(ARCH), **overrides)
    d, h, n, f = (cfg.d_model, cfg.num_heads, cfg.resolved_head_dim,
                  cfg.d_ff)
    fl = f // m if f % m == 0 else f
    want = {"wr": (d, d // m), "wo": (d // m, d), "u": (h // m, n),
            "cm_wk": (d, fl), "cm_wv": (fl, d), "cm_wr": (d, d // m),
            "w0": (d,)}
    for rank in worlds[m]:
        assert rank[name]["shapes"] == want


@pytest.mark.parametrize("name", list(WIRE_STEP))
def test_split_rwkv_step_wire_is_the_shapes(name, worlds):
    nbytes, calls = WIRE_STEP[name]
    for rank in worlds[CASES[name][0]]:
        assert rank[name]["wire"] == {"model": {"bytes": nbytes,
                                                "calls": calls}}


@pytest.mark.parametrize("parts", [2, 4])
def test_the_bars_sit_above_the_f32_floor(parts, floors):
    """The floors that set the bars of the cases at M = ``parts``: seen
    (above zero) and no higher than this file's docstring reports."""
    for name, (m, _) in CASES.items():
        if m != parts:
            continue
        floor = floors[name]
        print(f"{name}: logits {floor['logits']:.3e}, loss "
              f"{floor['loss']:.3e}, gradients {floor['grads']:.3e} "
              "relative")
        assert 0 < floor["logits"] <= LOGITS_FLOOR_MAX, (name, floor)
        assert 0 < floor["grads"] <= GRAD_FLOOR_MAX, (name, floor)
        assert floor["loss"] <= LOSS_TOL / 2, (name, floor)


def test_a_mid_head_split_raises(worlds):
    """2 heads of 32 over 4 ranks: the rules split ``wr``'s 64 columns 4
    ways (16 a rank, half a head) and leave ``u`` whole; the layer
    refuses rather than run the recurrence on half heads."""
    for rank in worlds[4]:
        msg = rank["mid_head"]
        assert msg is not None and "2 heads" in msg and "4 ranks" in msg, msg


def test_a_split_wr_outside_its_mesh_raises():
    cfg, model = _model({})
    p = {k: v.detach() for k, v in model.layers[0].rwkv.items()}
    p["wr"] = p["wr"].narrow(1, 0, cfg.d_model // 2)
    x = torch.zeros(1, 4, cfg.d_model)
    with pytest.raises(ValueError, match="model axis"):
        rwkv6.rwkv_time_mix(p, x, cfg)


def _wkv_inputs(s: int, device) -> list[torch.Tensor]:
    b, h, n = 2, 4, 16
    rng = np.random.default_rng(SEED)
    shapes = [(b, s, h, n)] * 4 + [(h, n), (b, h, n, n)]
    out = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
           for sh in shapes]
    out[3] = torch.sigmoid(out[3])                         # a decay in (0, 1)
    return [t.to(device) for t in out]


def _dispatched(s: int) -> int:
    counter = StepCounter()
    with counter:
        rwkv6._wkv_scan(*_wkv_inputs(s, "meta"))
    return counter.ops


def test_wkv_scan_on_meta_runs_one_step():
    """On meta the loop runs one step alone, whatever S: the dry run
    counts the body once and adds the other S - 1 steps analytically.
    Its output reads every input, the decay too, so the backward of the
    products that make them is counted."""
    assert _dispatched(8) == _dispatched(4096) > 0
    ins = [t.requires_grad_() for t in _wkv_inputs(4096, "meta")]
    o, s = rwkv6._wkv_scan(*ins)
    assert o.shape == ins[0].shape and s.shape == (2, 4, 16, 16)
    grads = torch.autograd.grad(o.sum(), ins, allow_unused=True)
    assert all(g is not None for g in grads)


def test_wkv_scan_on_cpu_is_the_loop():
    """On CPU tensors every step runs: bit for bit a plain loop's."""
    r, k, v, w, u, s0 = _wkv_inputs(37, "cpu")
    s, outs = s0, []
    for t in range(r.shape[1]):
        kv = k[:, t, ..., :, None] * v[:, t, ..., None, :]
        outs.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                                 s + u[None, :, :, None] * kv))
        s = w[:, t, ..., None] * s + kv
    o, s_fin = rwkv6._wkv_scan(r, k, v, w, u, s0)
    assert torch.equal(o, torch.stack(outs, dim=1))
    assert torch.equal(s_fin, s)
