"""The VLM (qwen2-vl) split over the ``model`` axis, on the CPU, no jax:
gloo worlds from ``run_local_world``, each rank holding its slice of
reduced qwen2-vl-2b's weights (``tensor_parallel.shard_parameters`` under
the trainer's rules), running the forward pass and the train loss's
gradients on the same tokens, patches and M-RoPE positions; held to the
whole model's in this process.

The inputs: seeded tokens, seeded patch embeddings for the first 16
positions (``vision_tokens``), and M-RoPE positions (3, B, S) as Qwen2-VL
lays them out: the patches on a 4 x 4 grid (t 0, h and w the grid's row
and column), the text after them at 4 + its index on all three
components, each row offset by its index, so that the three components
differ and each section of the rotation reads its own.

The layouts, as the rules place them (reduced qwen2-vl: d 64, 4 heads of
16, 2 KV heads, d_ff 160, tied vocabulary 512, q/k/v biases, M-RoPE
sections (2, 3, 3), cut to 2 layers):
- ``heads_1x2`` (remat "none") and its ``_dots`` twin (remat "dots"):
  ``wq``/``wo`` and ``bq`` over the heads (2 a rank), ``wk``/``wv`` and
  ``bk``/``bv`` over the KV heads (1 a rank), the MLP over ``d_ff`` (80),
  the tied vocabulary over the ranks (256 rows);
- ``heads_1x4`` and ``heads_1x4_dots``: 1 head a rank; the 2 KV heads do
  not split 4 ways, so ``wk``/``wv``/``bk``/``bv`` are whole and enter
  the split region (their partial gradients summed), each rank's head
  reading its KV head (``tensor_parallel.kv_select``); ``d_ff`` 40 and
  128 rows a rank;
- ``prodlike_1x2``/``_dots``: 3 heads, 1 KV head and a vocabulary of 515
  (``num_heads=3, num_kv_heads=1, vocab_size=515``), none of which 2
  divides: the attention and the vocabulary whole on each rank and only
  the MLP split, as qwen2-vl-2b's 12 heads and 2 KV heads lie on the
  16-rank production meshes.

Tolerances, set before the runs: the loss within ``LOSS_TOL`` 1e-5 of the
whole model's; the logits (gathered over the vocabulary) within
``LOGITS_TOL`` 1e-5; each parameter's gradient (gathered whole) within
``GRAD_RTOL`` 1e-5 of the whole model's, relative to that leaf's largest
element: a gradient summed once too few or too many times over the ranks
is off by a factor of 2 or more.

Bytes and calls over ``model`` in one step (the loss's forward and
backward), worked out from the shapes before the first run; B = 2, S =
32, every payload float32, an all-reduce counted by its payload, X =
B·S·d·4 = 16,384 B:
- ``heads_1x2`` forward: the embedding's rows X; a layer's ``wo`` and
  MLP partial sums, X each (2 layers: 4 calls); the cross entropy's max,
  sum of exponentials and target logit, B·(S-1)·4 = 248 each: 82,664 B
  in 8 calls; backward: the logits' input's gradient X, a layer's
  attention and MLP inputs' gradients X each (4 calls); every bias split
  with its heads, so no replicated parameter in a split region: 81,920 B
  in 5 calls; in all 164,584 B in 13 calls;
- ``heads_1x2_dots``: the same, and each layer's recompute reruns its
  ``wo`` sum (the recompute stops at the last saved tensor, before the
  MLP's sum): 2 more calls, 197,352 B in 15;
- ``heads_1x4``: ``heads_1x2``'s calls, and a layer's whole ``wk``,
  ``wv`` (64·2·16·4 = 8,192 B each), ``bk`` and ``bv`` (2·16·4 = 128
  each) gradients summed: 2·16,640 more in 8 calls, 197,864 B in 21;
- ``prodlike_1x2``: only the MLP's partial sums forward and its inputs'
  gradients backward, X each a layer: 65,536 B in 4 calls; the cross
  entropy runs whole (515 columns on each rank).
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
SEED = 0
ARCH = "qwen2-vl-2b"
LAYERS = 2
BATCH, SEQ, GRID = 2, 32, 4
PRODLIKE = {"num_heads": 3, "num_kv_heads": 1, "vocab_size": 515}
# name -> (model ranks, config overrides, remat)
CASES = {
    "heads_1x2": (2, {}, "none"),
    "heads_1x2_dots": (2, {}, "dots"),
    "prodlike_1x2": (2, PRODLIKE, "none"),
    "prodlike_1x2_dots": (2, PRODLIKE, "dots"),
    "heads_1x4": (4, {}, "none"),
    "heads_1x4_dots": (4, {}, "dots"),
}
# name -> (bytes, calls) over model in one step, from the shapes
WIRE_STEP = {"heads_1x2": (164_584, 13), "heads_1x2_dots": (197_352, 15),
             "heads_1x4": (197_864, 21), "prodlike_1x2": (65_536, 4)}
LAYOUT_LEAVES = ("embed", "layers.0.attn.wq", "layers.0.attn.wk",
                 "layers.0.attn.wo", "layers.0.attn.bq", "layers.0.attn.bk",
                 "layers.1.mlp.wi_gate", "layers.1.mlp.wo")


def _model(overrides: dict):
    cfg = dataclasses.replace(get_reduced_config(ARCH), num_layers=LAYERS,
                              **overrides)
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(SEED))
    return cfg, model


def mrope_positions(batch: int, seq: int, grid: int) -> np.ndarray:
    """(3, B, S): the patches on a ``grid`` x ``grid`` image (t 0, h its
    row, w its column), then the text at ``grid`` + its index on every
    component; row b offset by b."""
    vis = grid * grid
    pos = np.zeros((3, batch, seq), np.int64)
    idx = np.arange(vis)
    pos[1, :, :vis], pos[2, :, :vis] = idx // grid, idx % grid
    pos[:, :, vis:] = grid + np.arange(seq - vis)
    return pos + np.arange(batch)[None, :, None]


def _inputs(cfg) -> dict:
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, SEQ))
    patches = rng.normal(size=(BATCH, cfg.vision_tokens, cfg.d_model)) * 0.02
    assert cfg.vision_tokens == GRID * GRID
    return {"tokens": torch.from_numpy(tokens),
            "patches": torch.from_numpy(patches.astype(np.float32)),
            "positions": torch.from_numpy(mrope_positions(BATCH, SEQ, GRID))}


def _run(model, cfg, batch, remat):
    """(logits, loss, each parameter's gradient of the train loss, the
    loss's forward and backward's bytes and calls a mesh axis)."""
    with torch.no_grad():
        logits, _ = model(batch["tokens"], positions=batch["positions"],
                          patches=batch["patches"])
    tp.reset_wire()
    total, (loss, _) = make_loss_fn(model, cfg, remat)(batch)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(total, list(params.values()))
    return (logits, float(loss.detach()), dict(zip(params, grads)),
            tp.wire_bytes())


def rank_vlm(cases: dict) -> dict:
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
        rank_vlm, m, {n: c for n, c in CASES.items() if c[0] == m},
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
def test_split_vlm_forward_matches_the_whole_model(name, worlds, whole):
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
def test_split_vlm_gradients_match_the_whole_model(name, worlds, whole):
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
def test_split_vlm_layout_is_the_rules(name, worlds):
    """Heads (with ``bq``), KV heads (with ``bk``/``bv``), ``d_ff`` and
    the vocabulary split where the model axis divides them, else whole."""
    m, overrides, _ = CASES[name]
    cfg = dataclasses.replace(get_reduced_config(ARCH), **overrides)
    d, h, kv, hd, f, v = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size)

    def cut(n):
        return n // m if n % m == 0 else n
    want = {"embed": (cut(v), d), "layers.0.attn.wq": (d, cut(h), hd),
            "layers.0.attn.wk": (d, cut(kv), hd),
            "layers.0.attn.wo": (cut(h), hd, d),
            "layers.0.attn.bq": (cut(h), hd),
            "layers.0.attn.bk": (cut(kv), hd),
            "layers.1.mlp.wi_gate": (d, cut(f)),
            "layers.1.mlp.wo": (cut(f), d)}
    for rank in worlds[m]:
        assert rank[name]["shapes"] == want


@pytest.mark.parametrize("name", list(WIRE_STEP))
def test_split_vlm_step_wire_is_the_shapes(name, worlds):
    nbytes, calls = WIRE_STEP[name]
    for rank in worlds[CASES[name][0]]:
        assert rank[name]["wire"] == {"model": {"bytes": nbytes,
                                                "calls": calls}}


def test_mrope_positions_differ_by_component():
    """The positions this file feeds rotate each section by its own
    component: the three differ on the patches, agree on the text."""
    pos = mrope_positions(BATCH, SEQ, GRID)
    vis = GRID * GRID
    assert pos.shape == (3, BATCH, SEQ)
    assert (pos[1, :, :vis] != pos[2, :, :vis]).any()
    assert (pos[0, :, :vis] != pos[1, :, :vis]).any()
    assert (pos[:, :, vis:] == pos[:1, :, vis:]).all()


def test_text_only_positions_are_the_token_index():
    """With no positions, an M-RoPE forward rotates every section by the
    token index: the same logits as positions (3, B, S) of the arange."""
    cfg, model = _model({})
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (BATCH, SEQ)))
    pos = torch.arange(SEQ).expand(3, BATCH, SEQ)
    with torch.no_grad():
        want, _ = model(tokens, positions=pos)
        got, _ = model(tokens)
    assert torch.equal(got, want)
