"""Attention: GQA/MQA, qk-norm, RoPE/M-RoPE, full-causal or sliding-window,
bidirectional (encoder) and cross (decoder) variants, with KV caches; port
of ``repro.models.attention``.

The local-attention prefill runs kernel K6 (``kernels/swa``).  Full
attention (``attend_full``) is the reference's plain f32 einsums and softmax
(``_sdpa``), as it is outside any Pallas kernel there.  Decode keeps a KV
cache: global layers write at ``pos``, local layers at ``pos % window`` (a
ring buffer of ``min(cache_len, window)`` slots, the §III-B line buffer in
time) and mask each slot by the absolute position it holds.

Under ``mesh_context`` with ``wq`` split over heads (the model axis), the
prefill runs this rank's query heads alone, column-parallel, and ``wo``
row-parallel (``distributed/tensor_parallel.py``).  Decode also takes a
cache split over its positions, the rules' placement where ``model`` does
not divide the KV heads (:func:`decode_step`), and cross-attention K/V
split over the encoder's frames (:func:`attend_full` with ``frames``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.swa.ops import sliding_window_attention
from repro_torch.models.common import (apply_rope, mrope_angles, rmsnorm,
                                       rmsnorm_spec, rope_angles)
from repro_torch.models.params import Spec

NEG_INF = -1e30


def attention_specs(cfg: ArchConfig, *,
                    kv_heads: int | None = None) -> dict[str, Spec]:
    d, h = cfg.d_model, cfg.num_heads
    kv = kv_heads if kv_heads is not None else cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    specs = {
        "wq": Spec((d, h, hd), ("fsdp", "heads", "head_dim")),
        "wk": Spec((d, kv, hd), ("fsdp", "kv_heads", "head_dim")),
        "wv": Spec((d, kv, hd), ("fsdp", "kv_heads", "head_dim")),
        "wo": Spec((h, hd, d), ("heads", "head_dim", "fsdp")),
    }
    if cfg.qkv_bias:
        specs |= {"bq": Spec((h, hd), ("heads", "head_dim"), init="zeros"),
                  "bk": Spec((kv, hd), ("kv_heads", "head_dim"), init="zeros"),
                  "bv": Spec((kv, hd), ("kv_heads", "head_dim"), init="zeros")}
    if cfg.qk_norm:
        specs |= {"q_norm": rmsnorm_spec(hd), "k_norm": rmsnorm_spec(hd)}
    return specs


class KVCache(NamedTuple):
    """k/v: (B, Hkv, C, hd); C = the full sequence for global layers, the
    window for local ones.  ``pos``: the next absolute write position (a
    Python int, shared by the batch).  A rank's slice of a cache split
    over its positions (``tensor_parallel.shard_cache``) records its
    place: ``start``, the first slot of the whole cache it holds, and
    ``capacity``, the whole cache's slots (0: this cache is whole)."""
    k: torch.Tensor
    v: torch.Tensor
    pos: int
    start: int = 0
    capacity: int = 0

    @staticmethod
    def init(batch: int, kv_heads: int, capacity: int, head_dim: int,
             dtype: torch.dtype, device=None) -> "KVCache":
        shape = (batch, kv_heads, capacity, head_dim)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device), 0)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _head_axis(p, cfg: ArchConfig) -> tp.Axis | None:
    """The model axis where ``wq`` is split over heads, else None."""
    return tp.split_axis(p["wq"].shape[1], cfg.num_heads)


def _project(p, x: torch.Tensor, cfg: ArchConfig, axis=None):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KV,hd): the bias, then the
    per-head RMSNorm.  With ``axis`` (heads split over it): this rank's
    query heads, and the KV heads they read, its own where ``wk`` is split
    too, else picked from all of them (``tensor_parallel.kv_select``)."""
    if axis is not None:
        x = tp.copy_in(x, axis)
        p = tp.enter(p, attention_specs(cfg), axis)
    q, k, v = _heads(x, p["wq"]), _heads(x, p["wk"]), _heads(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if axis is not None and k.shape[2] == cfg.num_kv_heads:
        idx, _ = tp.kv_select(q.shape[2], cfg.num_kv_heads, cfg.q_per_kv,
                              axis)
        if idx != list(range(cfg.num_kv_heads)):
            k, v = k[:, :, idx], v[:, :, idx]
    return q, k, v


def _rope_qk(q, k, cfg: ArchConfig, positions):
    if cfg.rope_theta <= 0 or positions is None:
        return q, k
    hd = q.shape[-1]
    if cfg.mrope_sections is not None:
        cos, sin = mrope_angles(positions, hd, cfg.rope_theta,
                                cfg.mrope_sections)
    else:
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def _out(p, o: torch.Tensor, axis=None) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul; row-parallel over ``axis``
    (this rank's heads of ``wo``) where heads are split."""
    h, k, d = p["wo"].shape
    if axis is not None:
        return tp.row_parallel(o.flatten(-2), p["wo"].reshape(h * k, d),
                               axis)
    return o.flatten(-2) @ p["wo"].to(o.dtype).reshape(h * k, d)


def _sdpa(q, k, v, mask: Optional[torch.Tensor], group: int) -> torch.Tensor:
    """q: (B,S,H,hd); k/v: (B,T,KV,hd); mask: (B|1, 1, S, T) bool or None
    (attend everywhere).  f32 logits and softmax, GQA by grouping the query
    heads of each KV head, as the JAX package computes it."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    scale = torch.sqrt(torch.tensor(hd, dtype=torch.float32, device=q.device))
    qg = (q.float() / scale).reshape(b, s, kv, group, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    if mask is not None:
        logits.masked_fill_(~mask[:, :, None], NEG_INF)
    pr = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", pr, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def attend_full(p, x: torch.Tensor, cfg: ArchConfig, *, positions,
                causal: bool = True,
                cross_kv: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
                frames: int = 0) -> torch.Tensor:
    """Prefill attention without a cache.  ``cross_kv`` supplies encoder K/V
    (B, T, KV, hd) for cross-attention: q is then ``wq`` alone, with no
    bias, no norm and no rope.  ``frames``: the encoder's whole frame
    count where ``cross_kv`` is a rank's slice of it (decode's cross
    cache split over the frames, which records the count,
    :func:`_cross_over_frames`); 0: ``cross_kv`` holds every frame, of
    any count.

    With ``wq`` split over heads, cross-attention runs the rank's query
    heads over the given K/V, the rank's KV heads (made by its heads of
    ``wk``/``wv``) or, where they are whole, those its queries read
    (``tensor_parallel.kv_select``), and ``wo`` row-parallel."""
    s = x.shape[1]
    axis = _head_axis(p, cfg)
    if cross_kv is None:
        q, k, v = _project(p, x, cfg, axis)
        q, k = _rope_qk(q, k, cfg, positions)
        mask = (torch.ones(s, s, dtype=torch.bool, device=x.device)
                .tril()[None, None] if causal else None)
    else:
        k, v = cross_kv
        slots = tp.split_axis(k.shape[1], frames) if frames else None
        if slots is not None:
            return _cross_over_frames(p, x, k, v, axis, slots)
        if axis is not None:
            x = tp.copy_in(x, axis)
        q = _heads(x, p["wq"])
        if axis is not None and k.shape[2] == cfg.num_kv_heads:
            idx, _ = tp.kv_select(q.shape[2], cfg.num_kv_heads,
                                  cfg.q_per_kv, axis)
            if idx != list(range(cfg.num_kv_heads)):
                k, v = k[:, :, idx], v[:, :, idx]
        mask = None
    return _out(p, _sdpa(q, k, v, mask, q.shape[2] // k.shape[2]), axis)


def _cross_over_frames(p, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       heads, slots: tp.Axis) -> torch.Tensor:
    """Cross-attention over K/V (B, T/M, KV, hd) split over the encoder's
    frames along ``slots``, as :func:`decode_step` attends a cache split
    over its positions: every head's query (gathered where ``wq`` is split
    over ``heads``, layout (b); the rank's own where it is whole, (c)),
    each rank's frames attended unmasked and the partials merged
    (``tensor_parallel.merge_softmax``), then the rank's heads through
    ``wo``, row-parallel where it is split."""
    q = _heads(x, p["wq"])
    h = q.shape[2]
    if heads is not None:
        q = tp.gather_cat(q, heads, dim=2)
    out = _attend_partial(q, k.transpose(1, 2), v.transpose(1, 2), 0.0,
                          slots).to(x.dtype)
    if heads is not None:
        out = out.narrow(2, heads.rank * h, h)
    return _out(p, out, heads)


def attend_local(p, x: torch.Tensor, cfg: ArchConfig, *,
                 positions) -> torch.Tensor:
    """Sliding-window attention, prefill path (kernel K6). x: (B, S, D)."""
    axis = _head_axis(p, cfg)
    q, k, v = _project(p, x, cfg, axis)
    q, k = _rope_qk(q, k, cfg, positions)
    # (B, S, H, hd) viewed as (B, H, S, hd): K6 reads the views through their
    # strides and writes its output in q's layout, so nothing is copied
    out = sliding_window_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), window=cfg.window)
    return _out(p, out.transpose(1, 2), axis)


def _attend_partial(q, k, v, bias, axis=None) -> torch.Tensor:
    """q (B,S,H,hd) over k/v (B,KV,C,hd) with the additive ``bias`` (C,)
    or a scalar: f32 logits and softmax, GQA by grouping the query heads
    of each KV head.  With ``axis`` (k/v split over C along it), this
    rank's partial, merged over the axis
    (``tensor_parallel.merge_softmax``).  Returns (B,S,H,hd) in f32."""
    b, s, h, hd = q.shape
    kv = k.shape[1]
    scale = torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    qg = (q.float() / scale.to(q.device)).reshape(b, s, kv, h // kv, hd)
    logits = torch.einsum("bskgd,bktd->bkgst", qg, k.float()) + bias
    if axis is None:
        pr = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkgst,bktd->bskgd", pr, v.float())
        return out.reshape(b, s, h, hd)
    m = logits.amax(-1)                                     # (B,KV,G,S)
    e = torch.exp(logits - m[..., None])
    o = torch.einsum("bkgst,bktd->bkgsd", e, v.float())
    out = tp.merge_softmax(m, e.sum(-1), o, axis)           # (B,KV,G,S,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)


def decode_step(p, x: torch.Tensor, cache: KVCache, cfg: ArchConfig, *,
                window: int = 0, positions=None
                ) -> tuple[torch.Tensor, KVCache]:
    """x: (B, 1, D); returns (out (B,1,D), the cache advanced by one token).

    A global layer (``window=0``) writes at ``pos``; a local layer at ``pos
    % window`` (a ring buffer) and masks each slot by the absolute position
    it holds.  ``positions`` (vlm: (3, B, 1)) rotate q and k in place of
    ``pos``.  The slot is clamped to the capacity, as
    ``jax.lax.dynamic_update_slice`` clamps it.  The cache's k/v are updated
    in place (the returned cache holds the same tensors) to spare a copy of
    the cache per token.

    Under ``mesh_context``, the layout follows the cache's recorded place
    and the split of ``wq``/``wk`` (``tensor_parallel.shard_cache`` places
    the cache by the rules):
    (a) the cache split over KV heads, as ``wk`` is: this rank's query
        heads over its KV heads' whole cache, ``wo`` row-parallel;
    (b) the cache split over its positions, ``wq`` split over heads: every
        head's query gathered, k/v of every KV head written by the slot's
        owner alone, each rank's slots attended by every head and the
        partials merged, then this rank's heads through ``wo``
        row-parallel;
    (c) the cache split over its positions, ``wq`` whole: as (b) with no
        gather and ``wo`` whole.
    A whole cache with ``wq`` split reads the KV heads this rank's queries
    read (``tensor_parallel.kv_select``)."""
    b, s1, _ = x.shape
    if s1 != 1:
        raise ValueError(f"decode_step takes one token, got {s1}")
    heads = _head_axis(p, cfg)
    q, k_new, v_new = _project(p, x, cfg)
    pos = cache.pos
    pos_arr = (torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
               if positions is None else positions)
    q, k_new = _rope_qk(q, k_new, cfg, pos_arr)

    k, v = cache.k, cache.v
    kv, cap = k.shape[1], k.shape[2]
    whole = cache.capacity or cap
    slots = tp.split_axis(cap, whole)      # the cache split over positions
    if k_new.shape[2] != kv or (slots is not None
                                and kv != cfg.num_kv_heads):
        raise ValueError(
            f"a cache of {kv} KV heads and {cap} of {whole} slots does not "
            f"fit wk's {k_new.shape[2]} KV heads of {cfg.num_kv_heads}: "
            "place it with tensor_parallel.shard_cache (LM.init_cache "
            "under mesh_context)")
    # the slot in the whole cache; only the rank that holds it writes
    slot = min(pos % window if window else pos, whole - 1) - cache.start
    if 0 <= slot < cap:
        k[:, :, slot] = k_new[:, 0]
        v[:, :, slot] = v_new[:, 0]

    idx = cache.start + torch.arange(cap, device=x.device)
    if window:
        # absolute position held by ring slot i = the latest write time t
        # with t <= pos and t % window == i; negative -> never written.
        visible = pos - ((pos % window) - idx) % window >= 0
    else:
        visible = idx <= pos
    bias = torch.where(visible, 0.0, NEG_INF)                  # (C,)

    new = cache._replace(k=k, v=v, pos=pos + 1)
    if slots is None:
        if heads is not None and kv == cfg.num_kv_heads:
            sel, _ = tp.kv_select(q.shape[2], kv, cfg.q_per_kv, heads)
            if sel != list(range(kv)):
                k, v = k[:, sel], v[:, sel]
        out = _attend_partial(q, k, v, bias)
        return _out(p, out.to(x.dtype), heads), new
    h = q.shape[2]
    if heads is not None:
        q = tp.gather_cat(q, heads, dim=2)
    out = _attend_partial(q, k, v, bias, slots).to(x.dtype)
    if heads is not None:
        out = out.narrow(2, heads.rank * h, h)
    return _out(p, out, heads), new
