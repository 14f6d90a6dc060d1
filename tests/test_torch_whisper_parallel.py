"""The encoder-decoder (whisper) split over the ``model`` axis, on the CPU,
no jax: gloo worlds from ``run_local_world``, each rank holding its slice
of reduced whisper-tiny's weights (``tensor_parallel.shard_parameters``
under the trainer's rules), running the forward pass and the train loss's
gradients on the same tokens and frames; held to the whole model's in
this process.

The layouts, as the rules place them (reduced whisper: d 64, 4 heads of
16, MHA, d_ff 128, vocabulary 512, 2 + 2 layers, 32 frames):
- ``heads_1x2`` and ``heads_1x4`` (remat "none") and their ``_dots``
  twins (remat "dots"): every attention's ``wq``/``wk``/``wv``/``wo``
  over heads (2 or 1 a rank), the cross-attention's too, so each rank
  makes its heads' cross K/V from the encoder output; the MLPs over
  ``d_ff`` (64 or 32); the tied vocabulary over the ranks (256 or 128
  rows);
- ``prodlike_1x2``: 3 heads of 16 (``num_heads=3, num_kv_heads=3,
  head_dim=16``), 31 frames and a vocabulary of 515, none of which 2
  divides: the attention, the cross K/V and the vocabulary whole on each
  rank and only the MLPs split, as whisper-tiny's 6 heads, 1500 frames
  and 51,865 rows lie on the 16-rank production meshes;
- ``gqa_1x4``: 2 KV heads (``num_kv_heads=2``), which 4 does not divide:
  ``wq`` and ``wo`` over the 4 heads, ``wk``/``wv`` whole, so each rank
  makes every KV head's cross K/V and attends the one its query head
  reads (``tensor_parallel.kv_select``); ``wk``/``wv`` enter the split
  region, so their partial gradients are summed.

Tolerances, set before the runs: the loss within ``LOSS_TOL`` 1e-5 of the
whole model's; the logits (gathered over the vocabulary) within
``LOGITS_TOL`` 1e-5; each parameter's gradient (gathered whole) within
``GRAD_RTOL`` 1e-5 of the whole model's, relative to that leaf's largest
element: a gradient summed once too few or too many times over the ranks
is off by a factor of 2 or more.

Bytes and calls over ``model`` in one step (the loss's forward and
backward, remat "none"), worked out from the shapes before the first run;
B = 2, S = 16, T = 32 frames, every payload float32, an all-reduce
counted by its payload:
- ``heads_1x2`` forward: an encoder layer's ``wo`` and MLP partial sums,
  B·T·d·4 = 16,384 B each (2 layers: 65,536 in 4 calls); the embedding's
  rows B·S·d·4 = 8,192; a decoder layer's self ``wo``, cross ``wo`` and
  MLP partial sums, 8,192 each (2 layers: 49,152 in 6 calls); the cross
  entropy's max, sum of exponentials and target logit, B·(S-1)·4 = 120
  each: 123,240 B in 14 calls;
- backward: the logits' input's gradient 8,192; a decoder layer's self
  attention's, cross-attention's and MLP's inputs, 8,192 each (49,152 in
  6 calls); the encoder output's gradient, once for both layers' cross
  K/V, 16,384 (one ``copy_in`` a layer would make it 2 calls); an
  encoder layer's attention and MLP inputs, 16,384 each (65,536 in 4
  calls); no replicated parameter inside a split region (whisper has no
  q/k/v bias or qk-norm): 139,264 B in 12 calls;
- in all ``WIRE_STEP["heads_1x2"]``: 262,504 B in 26 calls.
- ``prodlike_1x2``: only the MLPs' partial sums forward, B·31·d·4 =
  15,872 B an encoder layer and 8,192 a decoder layer, and their inputs'
  gradients backward, the same: 2·(2·15,872 + 2·8,192) = 96,256 B in 8
  calls; the cross entropy runs whole (515 columns on each rank).

A cross K/V cache holding a slice of the encoder's frames, as
``tensor_parallel.shard_cache`` records it, decoded outside a mesh of
that split, raises.  A whole cross K/V of fewer frames than
``encoder_seq`` (24 of 32), decoded with no mesh, gives the forward's
logits within ``DECODE_TOL`` 5e-4 (the decode bar of
``tests/test_torch_families.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import mesh_context, named_sharding
from repro_torch.launch.mesh import make_local_mesh, run_local_world
from repro_torch.models.registry import build_model
from repro_torch.train.train_step import make_loss_fn

WORLD_TIMEOUT_S = 300
LOGITS_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_RTOL = 1e-5
DECODE_TOL = 5e-4
SEED = 0
ARCH = "whisper-tiny"
BATCH, SEQ = 2, 16
PRODLIKE = {"num_heads": 3, "num_kv_heads": 3, "head_dim": 16,
            "encoder_seq": 31, "vocab_size": 515}
# name -> (model ranks, config overrides, remat)
CASES = {
    "heads_1x2": (2, {}, "none"),
    "heads_1x2_dots": (2, {}, "dots"),
    "prodlike_1x2": (2, PRODLIKE, "none"),
    "prodlike_1x2_dots": (2, PRODLIKE, "dots"),
    "heads_1x4": (4, {}, "none"),
    "heads_1x4_dots": (4, {}, "dots"),
    "gqa_1x4": (4, {"num_kv_heads": 2}, "none"),
}
# name -> (bytes, calls) over model in one step, from the shapes
WIRE_STEP = {"heads_1x2": (262_504, 26), "prodlike_1x2": (96_256, 8)}
LAYOUT_LEAVES = ("embed", "enc.0.attn.wq", "enc.0.mlp.wi_gate",
                 "dec.0.self.wk", "dec.0.cross.wq", "dec.0.cross.wk",
                 "dec.0.cross.wo", "dec.0.mlp.wo")


def _model(overrides: dict):
    cfg = dataclasses.replace(get_reduced_config(ARCH), **overrides)
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(SEED))
    return cfg, model


def _inputs(cfg) -> dict:
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, SEQ))
    frames = rng.normal(size=(BATCH, cfg.encoder_seq, cfg.d_model)) * 0.02
    return {"tokens": torch.from_numpy(tokens),
            "frames": torch.from_numpy(frames.astype(np.float32))}


def _run(model, cfg, batch, remat):
    """(logits, loss, each parameter's gradient of the train loss, the
    loss's forward and backward's bytes and calls a mesh axis)."""
    with torch.no_grad():
        logits, _ = model(batch["tokens"], batch["frames"])
    tp.reset_wire()
    total, (loss, _) = make_loss_fn(model, cfg, remat)(batch)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(total, list(params.values()))
    return (logits, float(loss.detach()), dict(zip(params, grads)),
            tp.wire_bytes())


def rank_whisper(cases: dict) -> dict:
    """Every case of one world in this rank: the logits and gradients
    gathered whole, the loss, the step's bytes and calls over ``model``,
    some leaves' local shapes."""
    torch.set_num_threads(1)
    out = {}
    for name, (m, overrides, remat) in cases.items():
        cfg, model = _model(overrides)
        mesh = make_local_mesh(1, m, device="cpu")
        layout = tp.parameter_layout(model, mesh)
        tp.shard_parameters(model, layout, mesh)
        with mesh_context(mesh):
            logits, loss, grads, wire = _run(model, cfg, _inputs(cfg), remat)
        cols = named_sharding(tuple(logits.shape), ("batch", None, "vocab"),
                              mesh)
        params = dict(model.named_parameters())
        out[name] = {
            "logits": tp.whole_of(logits, mesh, cols), "loss": loss,
            "grads": {n: tp.whole_of(g, mesh, layout[n])
                      for n, g in grads.items()},
            "wire": wire,
            "shapes": {k: tuple(params[k].shape) for k in LAYOUT_LEAVES}}
    return out


@pytest.fixture(scope="module")
def worlds():
    torch.set_num_threads(2)
    return {m: run_local_world(
        rank_whisper, m, {n: c for n, c in CASES.items() if c[0] == m},
        timeout=WORLD_TIMEOUT_S) for m in (2, 4)}


@pytest.fixture(scope="module")
def whole():
    torch.set_num_threads(2)
    out = {}
    for name, (_, overrides, remat) in CASES.items():
        cfg, model = _model(overrides)
        out[name] = _run(model, cfg, _inputs(cfg), remat)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_split_whisper_forward_matches_the_whole_model(name, worlds, whole):
    want_logits, want_loss = whole[name][:2]
    for rank in worlds[CASES[name][0]]:
        got = rank[name]
        assert got["logits"].shape == want_logits.shape
        err = (got["logits"] - want_logits).abs().max().item()
        print(f"{name}: logits {err:.3e}, loss "
              f"{abs(got['loss'] - want_loss):.3e}")
        assert err <= LOGITS_TOL, (name, err)
        assert abs(got["loss"] - want_loss) <= LOSS_TOL, name


@pytest.mark.parametrize("name", list(CASES))
def test_split_whisper_gradients_match_the_whole_model(name, worlds, whole):
    want = whole[name][2]
    for rank in worlds[CASES[name][0]]:
        got = rank[name]["grads"]
        assert set(got) == set(want)
        worst = 0.0
        for n, w in want.items():
            assert got[n].shape == w.shape, n
            scale = w.abs().max().item()
            err = (got[n] - w).abs().max().item()
            worst = max(worst, err / scale)
            assert err <= GRAD_RTOL * scale, (name, n, err, scale)
        print(f"{name}: gradients {worst:.3e} relative")


@pytest.mark.parametrize("name", list(CASES))
def test_split_whisper_layout_is_the_rules(name, worlds):
    """Heads, KV heads, ``d_ff`` and the vocabulary split where the model
    axis divides them, else whole."""
    m, overrides, _ = CASES[name]
    cfg = dataclasses.replace(get_reduced_config(ARCH), **overrides)
    d, h, kv, hd, f, v = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size)

    def cut(n):
        return n // m if n % m == 0 else n
    want = {"embed": (cut(v), d), "enc.0.attn.wq": (d, cut(h), hd),
            "enc.0.mlp.wi_gate": (d, cut(f)), "dec.0.self.wk": (d, cut(kv), hd),
            "dec.0.cross.wq": (d, cut(h), hd),
            "dec.0.cross.wk": (d, cut(kv), hd),
            "dec.0.cross.wo": (cut(h), hd, d), "dec.0.mlp.wo": (cut(f), d)}
    for rank in worlds[m]:
        assert rank[name]["shapes"] == want


@pytest.mark.parametrize("name", list(WIRE_STEP))
def test_split_whisper_step_wire_is_the_shapes(name, worlds):
    nbytes, calls = WIRE_STEP[name]
    for rank in worlds[CASES[name][0]]:
        assert rank[name]["wire"] == {"model": {"bytes": nbytes,
                                                "calls": calls}}


def test_a_cross_frame_slice_outside_its_mesh_raises():
    """The cross K/V cache holding 16 of the 32 frames and recording the
    whole 32, as a rank of a 2-way split holds them, decoded with no
    mesh: the layer cannot merge its partial softmax, so it refuses."""
    cfg, model = _model({})
    cache = model.init_cache(1, 4)
    cache["cross_k"] = cache["cross_k"].narrow(2, 0, cfg.encoder_seq // 2)
    cache["cross_v"] = cache["cross_v"].narrow(2, 0, cfg.encoder_seq // 2)
    cache["cross_frames"] = cfg.encoder_seq
    with torch.no_grad(), pytest.raises(ValueError, match="model axis"):
        model.decode(cache, torch.zeros((1, 1), dtype=torch.long))


def test_a_shorter_whole_cross_cache_decodes_as_the_forward():
    """The cross K/V of an encoder output of 24 frames (``encoder_seq``
    is 32), whole, with no mesh: every decoded token's logits are the
    forward's on those frames, as the reference attends a cross K/V of
    any frame count."""
    cfg, model = _model({})
    batch = _inputs(cfg)
    tokens, frames = batch["tokens"], batch["frames"][:, :24]
    with torch.inference_mode():
        want, _ = model(tokens, frames)
        enc = model.encode(frames)
        kv = [model._cross_kv(bp, enc) for bp in model.dec]
        cache = model.init_cache(BATCH, SEQ)
        cache["cross_k"] = torch.stack([k for k, _ in kv])
        cache["cross_v"] = torch.stack([v for _, v in kv])
        got = []
        for t in range(SEQ):
            logits, cache = model.decode(cache, tokens[:, t:t + 1])
            got.append(logits)
    err = (torch.cat(got, 1) - want).abs().max().item()
    assert err <= DECODE_TOL, err
