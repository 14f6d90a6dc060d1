"""Decode of a model split over the ``model`` axis, on the CPU, no jax: gloo
worlds from ``run_local_world``, each rank holding its slice of the
weights (``tensor_parallel.shard_parameters``) and of the cache
(``LM.init_cache`` under ``mesh_context``, placed by the reference's
``cache_shardings`` rule), decoding the same tokens from an empty cache
through ``make_decode_step``; held to the whole model's decode in this
process.

The layouts (reduced configs, float32 activations):
- tinyllama-1.1b (4 heads, 2 KV heads) at (1, 2): the cache split over
  KV heads, as ``wk`` is: layout (a); at (2, 2) the same with the batch
  split over ``data``;
- tinyllama at (1, 4): 2 KV heads do not split 4 ways, so the cache is
  split over its positions, ``wq`` over heads: layout (b); 20 tokens in
  48 slots leave ranks 2 and 3 without a visible slot;
- recurrentgemma-2b (2 heads, 1 KV head, window 32) at (1, 2) and (2, 2):
  its ring buffer split over positions, heads split: (b) on the ring;
- recurrentgemma-2b at (1, 4): 2 heads do not split 4 ways, ``wq`` whole:
  layout (c), the RG-LRU width (64) split 4 ways.
Every recurrentgemma case decodes 40 tokens, past the window, so the ring
wraps from the last rank's slots to the first's.
- granite-moe-1b-a400m (4 heads, 2 KV heads, 4 experts top-2) at (1, 2):
  layout (a), 2 experts a rank (EP); at (1, 4): layout (b), 1 expert a
  rank; with 5 experts at (1, 2) (``OVERRIDES``): layout (a), every expert
  whole with half its d_ff (FF).  A step's group is its batch's tokens,
  dropless, so each rank routes as the whole model does.
- rwkv6-7b (4 WKV heads of 16) at (1, 2), (2, 2) and (1, 4): layout (h),
  each rank's WKV state ``s`` its 2 or 1 heads (as ``u`` is split), the
  token-shift states whole, the channel mix split over ``d_ff`` and
  d_model, its 512-row untied vocabulary split.
- whisper-tiny (4 heads, MHA, 32 frames), its cross K/V cache primed from
  the whole model's ``_cross_kv`` on seeded frames and placed by
  ``tensor_parallel.shard_cache`` (the rules' cross rule, ``cache_seq``
  first), its self cache from ``init_cache`` as the others' (the layout
  names self/cross): at (1, 2) and (2, 2) the self cache over KV heads
  (a) and the cross K/V over the frames, 16 a rank, ``wq`` split (b);
  with 3 heads of 16 at (1, 4) (``num_heads=3, num_kv_heads=3,
  head_dim=16``) the self cache over positions and the cross K/V over
  the frames, 8 a rank, ``wq`` whole (c/c); with ``encoder_seq=30`` at
  (1, 4), which 4 does not divide, the cross K/V over the KV heads, 1 a
  rank (a/kv); with 3 heads, 31 frames and 515 rows at (1, 2) the cross
  K/V, the attention and the vocabulary whole, the self cache over
  positions (c/whole).
- qwen2-vl-2b (4 heads, 2 KV heads, q/k/v biases, M-RoPE), each step's
  positions (3, B, 1) from ``make_decode_step``: at (1, 2) and (2, 2)
  the cache over its KV heads, 1 a rank, as ``wk`` and ``bk`` are:
  layout (a); at (1, 4) the cache over its positions, 12 of 48 slots a
  rank, ``wq`` over the heads: layout (b).

Tolerances, set before the runs: every step's logits, gathered over the
vocabulary and the batch, within ``LOGITS_TOL`` 1e-5 of the whole model's
(float32; a split product sums its parts in another order and the
softmax is merged from the ranks' partials); every greedy token equal.
The rwkv cases' logits within 1e-5 or ``FLOOR_FACTOR`` (3) times reduced
rwkv6's float32 floor at the case's M, where that is larger: its whole
model's decode in this process with every product's contraction summed
in M parts (``torch_rwkv_cases.products_in_parts``, the ``floors``
fixture).  First held to 1e-5, rwkv_2x2 differed by 2.9e-5, and that
floor is of the same size (2.8e-5 and 3.2e-5 on the training forward,
``tests/test_torch_rwkv_parallel.py``), so 1e-5 cannot be met there in
float32.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.distributed import tensor_parallel as tp
from torch.distributed.tensor import Replicate, Shard

from repro_torch.distributed.sharding import (cache_placements, mesh_context,
                                              named_sharding)
from repro_torch.launch.mesh import make_local_mesh, run_local_world
from repro_torch.models.attention import KVCache, decode_step
from repro_torch.models.registry import build_model
from repro_torch.serving.serve_step import make_decode_step
from torch_rwkv_cases import bar, products_in_parts

WORLD_TIMEOUT_S = 300
LOGITS_TOL = 1e-5
SEED = 0
TL, RG, MOE = "tinyllama-1.1b", "recurrentgemma-2b", "granite-moe-1b-a400m"
RWKV, WH, VL = "rwkv6-7b", "whisper-tiny", "qwen2-vl-2b"
# name -> (arch, data, model, batch, tokens decoded, cache_len, layout;
# whisper's: self/cross)
CASES = {
    "tl_1x2": (TL, 1, 2, 2, 12, 48, "a"),
    "tl_2x2": (TL, 2, 2, 4, 12, 48, "a"),
    "tl_1x4": (TL, 1, 4, 2, 20, 48, "b"),
    "rg_1x2": (RG, 1, 2, 2, 40, 64, "b"),
    "rg_2x2": (RG, 2, 2, 4, 40, 64, "b"),
    "rg_1x4": (RG, 1, 4, 2, 40, 64, "c"),
    "moe_1x2": (MOE, 1, 2, 2, 12, 48, "a"),
    "moe_1x4": (MOE, 1, 4, 2, 20, 48, "b"),
    "moe_ff_1x2": (MOE, 1, 2, 2, 12, 48, "a"),
    "rwkv_1x2": (RWKV, 1, 2, 2, 12, 48, "h"),
    "rwkv_2x2": (RWKV, 2, 2, 4, 12, 48, "h"),
    "rwkv_1x4": (RWKV, 1, 4, 2, 20, 48, "h"),
    "wh_1x2": (WH, 1, 2, 2, 12, 48, "a/b"),
    "wh_2x2": (WH, 2, 2, 4, 12, 48, "a/b"),
    "wh_heads3_1x4": (WH, 1, 4, 2, 20, 48, "c/c"),
    "wh_seq30_1x4": (WH, 1, 4, 2, 12, 48, "a/kv"),
    "wh_whole_1x2": (WH, 1, 2, 2, 12, 48, "c/whole"),
    "vl_1x2": (VL, 1, 2, 2, 12, 48, "a"),
    "vl_2x2": (VL, 2, 2, 4, 12, 48, "a"),
    "vl_1x4": (VL, 1, 4, 2, 20, 48, "b"),
}
HEADS3 = {"num_heads": 3, "num_kv_heads": 3, "head_dim": 16}
# name -> config overrides
OVERRIDES = {"moe_ff_1x2": {"num_experts": 5},
             "wh_heads3_1x4": HEADS3,
             "wh_seq30_1x4": {"encoder_seq": 30},
             "wh_whole_1x2": {**HEADS3, "encoder_seq": 31,
                              "vocab_size": 515}}
# planted ties for the vocabulary-parallel argmax: 4 rows of 8 columns,
# split 4 ways (2 columns a rank)
TIES = [[1, 5, 5, 0, 5, 2, 5, 1],       # a tie inside rank 0 and across
        [0, 0, 0, 0, 0, 0, 0, 0],       # every column
        [0, 1, 2, 3, 4, 9, 9, 9],       # rank 2's second and rank 3's
        [7, 1, 1, 1, 1, 1, 1, 7]]       # the first and last columns


def _model(arch: str, overrides: dict | None = None):
    cfg = dataclasses.replace(get_reduced_config(arch), **(overrides or {}))
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(SEED))
    return cfg, model


def _tokens(cfg, batch: int, steps: int) -> torch.Tensor:
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, steps)))


def _primed_cache(model, cfg, batch: int, cache_len: int) -> dict:
    """whisper's whole cache: the self caches empty, the cross K/V the
    whole model's ``_cross_kv`` of seeded frames."""
    rng = np.random.default_rng(SEED + 2)
    frames = torch.from_numpy(rng.standard_normal(
        (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    with torch.inference_mode():
        cache = model.init_cache(batch, cache_len)
        enc = model.encode(frames)
        kv = [model._cross_kv(bp, enc) for bp in model.dec]
    cache["cross_k"] = torch.stack([k for k, _ in kv])
    cache["cross_v"] = torch.stack([v for _, v in kv])
    return cache


def _decode(model, cfg, tokens: torch.Tensor, batch: int, cache_len: int,
            cache=None):
    """Each step's logits and greedy token of ``tokens`` (this rank's rows
    of ``batch``) from ``cache`` (``init_cache``'s where None), with the
    cache's layout after the first step: per layer, (k's shape, start,
    capacity), the RG-LRU state's shapes or the RWKV state's; whisper's
    self caches', then the cross K's shape."""
    step = make_decode_step(model, cfg)
    if cache is None:
        cache = model.init_cache(batch, cache_len)
    logits, nxt, layout = [], [], None
    for t in range(tokens.shape[1]):
        n, lg, cache = step(cache, tokens[:, t:t + 1], t)
        logits.append(lg)
        nxt.append(n)
        if layout is None:
            states = cache["self"] if isinstance(cache, dict) else cache
            layout = [(tuple(c.k.shape), c.start, c.capacity)
                      if isinstance(c, KVCache)
                      else tuple(tuple(t.shape) for t in c)
                      for c in states]
            if isinstance(cache, dict):
                layout.append(tuple(cache["cross_k"].shape))
    return torch.cat(logits, 1), torch.cat(nxt, 1), layout


def rank_decode(cases: dict) -> dict:
    """Every case of one world in this rank: the gathered logits and
    tokens, the cache layout, the local query heads; in the 4-rank world
    also the planted ties' argmax and :func:`rank_slice`."""
    torch.set_num_threads(1)
    out = {}
    for name, (arch, d, m, batch, steps, cache_len, _) in cases.items():
        cfg, model = _model(arch, OVERRIDES.get(name))
        mesh = make_local_mesh(d, m, device="cpu")
        cache = (tp.shard_cache(_primed_cache(model, cfg, batch, cache_len),
                                mesh) if arch == WH else None)
        tp.shard_parameters(model, tp.parameter_layout(model, mesh), mesh)
        tokens = _tokens(cfg, batch, steps)
        rows = named_sharding(tuple(tokens.shape), ("batch", None), mesh)
        with mesh_context(mesh), torch.inference_mode():
            logits, nxt, layout = _decode(model, cfg,
                                          tp.shard_of(tokens, mesh, rows),
                                          batch, cache_len, cache)
        cols = named_sharding((batch, steps, cfg.vocab_size),
                              ("batch", None, "vocab"), mesh)
        out[name] = {"logits": tp.whole_of(logits, mesh, cols),
                     "tokens": tp.whole_of(nxt, mesh, rows),
                     "layout": layout,
                     "heads": _heads(model),
                     "experts": (tuple(model.layers[0].mlp["wi_gate"].shape)
                                 if cfg.num_experts else None)}
        if (d, m) == (1, 4):
            axis = tp.mesh_axis("model", mesh)
            ties = torch.tensor(TIES, dtype=torch.float32)
            out["argmax"] = tp.vocab_parallel_argmax(
                tp.local_slice(ties, axis), axis)
            out["slice"] = rank_slice()
    return out


def _heads(model) -> int:
    """The query heads (WKV heads for RWKV) of the first layer that has
    them, as this rank holds them."""
    if not hasattr(model, "layers"):                    # whisper
        return model.dec[0].self["wq"].shape[1]
    blk = [b for b in model.layers if b.kind in ("attn", "local", "rwkv")][0]
    return (blk.rwkv["u"].shape[0] if blk.kind == "rwkv"
            else blk.attn["wq"].shape[1])


def rank_slice() -> dict:
    """One local-attention layer of reduced recurrentgemma-2b (``wq``
    whole) decoded on this rank's slice of its ring at (1, 4): the
    outputs of 40 tokens."""
    cfg, model = _model(RG)
    mesh = make_local_mesh(1, 4, device="cpu")
    tp.shard_parameters(model, tp.parameter_layout(model, mesh), mesh)
    blk = [b for b in model.layers if b.kind == "local"][0]
    x = _layer_inputs(cfg)
    outs = []
    with mesh_context(mesh), torch.inference_mode():
        cache = tp.shard_cache([KVCache.init(1, 1, cfg.window,
                                             cfg.resolved_head_dim,
                                             torch.float32)], mesh)[0]
        for t in range(x.shape[1]):
            y, cache = decode_step(blk.attn, x[:, t:t + 1], cache, cfg,
                                   window=cfg.window)
            outs.append(y)
    return {"out": torch.cat(outs, 1), "k": tuple(cache.k.shape),
            "start": cache.start, "capacity": cache.capacity}


def _layer_inputs(cfg) -> torch.Tensor:
    rng = np.random.default_rng(SEED + 1)
    return torch.from_numpy(rng.standard_normal(
        (1, 40, cfg.d_model)).astype(np.float32))


@pytest.fixture(scope="module")
def worlds():
    torch.set_num_threads(2)
    two = {n: c for n, c in CASES.items() if c[1] * c[2] == 2}
    four = {n: c for n, c in CASES.items() if c[1] * c[2] == 4}
    return {2: run_local_world(rank_decode, 2, two,
                               timeout=WORLD_TIMEOUT_S),
            4: run_local_world(rank_decode, 4, four,
                               timeout=WORLD_TIMEOUT_S)}


@pytest.fixture(scope="module")
def whole():
    """The whole model's decode of every case's tokens, in this process."""
    out = {}
    for name, (arch, _, _, batch, steps, cache_len, _) in CASES.items():
        cfg, model = _model(arch, OVERRIDES.get(name))
        cache = (_primed_cache(model, cfg, batch, cache_len) if arch == WH
                 else None)
        with torch.inference_mode():
            out[name] = _decode(model, cfg, _tokens(cfg, batch, steps),
                                batch, cache_len, cache)
    return out


@pytest.fixture(scope="module")
def floors(whole):
    """Each rwkv case's float32 floor: how far the whole model's decoded
    logits move with every product summed in the case's M parts."""
    out = {}
    for name, (arch, _, m, batch, steps, cache_len, _) in CASES.items():
        if arch != RWKV:
            continue
        cfg, model = _model(arch, OVERRIDES.get(name))
        with products_in_parts(m), torch.inference_mode():
            logits = _decode(model, cfg, _tokens(cfg, batch, steps), batch,
                             cache_len)[0]
        out[name] = (logits - whole[name][0]).abs().max().item()
    return out


def _ranks(name, worlds):
    _, d, m = CASES[name][:3]
    return worlds[d * m]


@pytest.mark.parametrize("name", list(CASES))
def test_split_decode_matches_the_whole_model(name, worlds, whole, floors):
    want_logits, want_tokens, _ = whole[name]
    tol = bar(LOGITS_TOL, floors[name]) if name in floors else LOGITS_TOL
    for rank in _ranks(name, worlds):
        got = rank[name]
        assert got["logits"].shape == want_logits.shape
        err = (got["logits"] - want_logits).abs().max().item()
        print(f"{name}: logits {err:.3e} (bar {tol:.3e})")
        assert err <= tol, (name, err, tol)
        assert torch.equal(got["tokens"], want_tokens), name


@pytest.mark.parametrize("name", list(CASES))
def test_split_decode_layout_is_the_rules(name, worlds):
    """The cache each rank decodes on is the rules' slice: layout (a)
    splits the KV heads, (b) and (c) the positions (start and capacity
    recorded); (c) keeps every query head; the RG-LRU state holds the
    rank's channels; the MoE's experts are split where ``m`` divides them,
    else their d_ff; (h) holds the rank's WKV heads of ``s`` and the
    token-shift states whole."""
    arch, d, m, batch, _, cache_len, layout = CASES[name]
    cfg = dataclasses.replace(get_reduced_config(arch),
                              **OVERRIDES.get(name, {}))
    rows = batch // d
    e, f = cfg.num_experts, cfg.d_ff
    experts = (None if not e else (e // m, cfg.d_model, f) if e % m == 0
               else (e, cfg.d_model, f // m))
    heads_split = cfg.num_heads % m == 0
    if arch == WH:
        _whisper_layout_is_the_rules(name, cfg, worlds)
        return
    for r, rank in enumerate(_ranks(name, worlds)):
        got = rank[name]
        assert got["heads"] == (cfg.num_heads // m if heads_split
                                else cfg.num_heads)
        assert got["experts"] == experts
        assert (layout == "c") == (not heads_split)
        col = r % m
        for kind, state in zip([cfg.kind_of_layer(i)
                                for i in range(cfg.num_layers)],
                               got["layout"]):
            if kind == "rwkv":
                d, h, n = (cfg.d_model, cfg.num_heads,
                           cfg.resolved_head_dim)
                assert state == ((rows, d), (rows, d), (rows, h // m, n, n))
                continue
            if kind == "rglru":
                w = cfg.lru_width // m
                assert state == ((rows, w), (rows, cfg.conv_width - 1, w))
                continue
            slots = min(cache_len, cfg.window) if kind == "local" \
                else cache_len
            hd = cfg.resolved_head_dim
            if layout == "a":
                assert state == ((rows, cfg.num_kv_heads // m, slots, hd),
                                 0, 0)
            else:
                assert state == ((rows, cfg.num_kv_heads, slots // m, hd),
                                 col * slots // m, slots)


def _whisper_layout_is_the_rules(name, cfg, worlds):
    """whisper's self caches over KV heads (a) or positions (c), its
    cross K/V (L, B, T, KV, hd) over the frames (b, c), the KV heads (kv)
    or whole, each rank's query heads split where ``m`` divides them."""
    _, d, m, batch, _, cache_len, layout = CASES[name]
    own, cross = layout.split("/")
    rows, hd = batch // d, cfg.resolved_head_dim
    kv, t, heads = cfg.num_kv_heads, cfg.encoder_seq, cfg.num_heads
    assert (own == "a") == (kv % m == 0)
    assert {"b": heads % m == 0 and t % m == 0,
            "c": heads % m != 0 and t % m == 0,
            "kv": t % m != 0 and kv % m == 0,
            "whole": t % m != 0 and kv % m != 0}[cross]
    xk = {"b": (t // m, kv), "c": (t // m, kv), "kv": (t, kv // m),
          "whole": (t, kv)}[cross]
    for r, rank in enumerate(_ranks(name, worlds)):
        got = rank[name]
        assert got["heads"] == (heads // m if heads % m == 0 else heads)
        col = r % m
        want = [((rows, kv // m, cache_len, hd), 0, 0) if own == "a" else
                ((rows, kv, cache_len // m, hd), col * cache_len // m,
                 cache_len)] * cfg.num_layers
        assert got["layout"] == want + [(cfg.num_layers, rows, *xk, hd)]


def test_vocab_parallel_argmax_breaks_ties_low(worlds):
    want = torch.argmax(torch.tensor(TIES, dtype=torch.float32), dim=-1)
    assert want.tolist() == [1, 0, 5, 0]
    for rank in worlds[4]:
        assert torch.equal(rank["argmax"], want)


def test_local_attention_on_a_position_slice(worlds):
    """recurrentgemma's local attention (``wq`` whole: 2 heads over 4
    ranks) decoded on each rank's quarter of its 32-slot ring, 40 tokens
    (past the window), equals the whole layer's decode: each rank masks
    its slots by their global indices and the partials are merged.  Given
    the slice as if it were a whole ring of 8 slots, a decode would attend
    the wrong positions and return a wrong answer with no error."""
    cfg, model = _model(RG)
    blk = [b for b in model.layers if b.kind == "local"][0]
    x = _layer_inputs(cfg)
    cache = KVCache.init(1, 1, cfg.window, cfg.resolved_head_dim,
                         torch.float32)
    want = []
    with torch.inference_mode():
        for t in range(x.shape[1]):
            y, cache = decode_step(blk.attn, x[:, t:t + 1], cache, cfg,
                                   window=cfg.window)
            want.append(y)
    want = torch.cat(want, 1)
    for r, rank in enumerate(worlds[4]):
        got = rank["slice"]
        assert (got["k"], got["start"], got["capacity"]) == (
            (1, 1, 8, cfg.resolved_head_dim), 8 * r, cfg.window)
        err = (got["out"] - want).abs().max().item()
        assert err <= LOGITS_TOL, (r, err)


def test_a_slice_outside_its_mesh_raises():
    """A cache that records a place (a quarter of 32 slots) cannot decode
    outside a mesh of that split: the slice is never taken for a whole
    ring of 8."""
    cfg, model = _model(RG)
    blk = [b for b in model.layers if b.kind == "local"][0]
    whole = KVCache.init(1, 1, cfg.window, cfg.resolved_head_dim,
                         torch.float32)
    part = whole._replace(k=whole.k[:, :, 8:16], v=whole.v[:, :, 8:16],
                          start=8, capacity=cfg.window)
    x = _layer_inputs(cfg)[:, :1]
    with pytest.raises(ValueError, match="model axis"):
        decode_step(blk.attn, x, part, cfg, window=cfg.window)


@pytest.mark.parametrize("frames,kv,want", [
    (32, 4, (Shard(1), Shard(2))),        # the frames over model
    (31, 4, (Shard(1), Shard(3))),        # 31 frames do not split: KV heads
    (31, 3, (Shard(1), Replicate())),     # neither splits: whole
])
def test_cross_cache_placed_by_the_cross_rule(frames, kv, want):
    """whisper's cache dict on a (data=2, model=2) mesh: the cross K/V
    (L, B, T, KV, hd), written ``['cross_k']`` as a path, by the cross
    rule (the batch over data, then the frames or the KV heads over
    model); the self caches by the KV rule."""
    cache = {"self": [KVCache.init(4, kv, 8, 16, torch.float32, "meta")],
             "cross_k": torch.empty((2, 4, frames, kv, 16), device="meta"),
             "cross_v": torch.empty((2, 4, frames, kv, 16), device="meta")}
    place = cache_placements(SimpleNamespace(shape={"data": 2, "model": 2}),
                             cache)
    assert place["cross_k"] == place["cross_v"] == want
    assert place["self"][0].k == (Shard(0), Shard(1) if kv % 2 == 0
                                  else Shard(2))
