"""Attention: GQA/MQA, qk-norm, RoPE/M-RoPE, full-causal or sliding-window,
bidirectional (encoder) and cross (decoder) variants, with KV caches; port
of ``repro.models.attention``.

The local-attention prefill runs kernel K6 (``kernels/swa``).  Full
attention (``attend_full``) is the reference's plain f32 einsums and softmax
(``_sdpa``), as it is outside any Pallas kernel there.  Decode keeps a KV
cache: global layers write at ``pos``, local layers at ``pos % window`` (a
ring buffer of ``min(cache_len, window)`` slots, the §III-B line buffer in
time) and mask each slot by the absolute position it holds.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs import ArchConfig
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
    Python int, shared by the batch)."""
    k: torch.Tensor
    v: torch.Tensor
    pos: int

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


def _project(p, x: torch.Tensor, cfg: ArchConfig):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KV,hd): the bias, then the
    per-head RMSNorm."""
    q, k, v = _heads(x, p["wq"]), _heads(x, p["wk"]), _heads(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
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


def _out(p, o: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, k, d = p["wo"].shape
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
                cross_kv: Optional[tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
    """Prefill attention without a cache.  ``cross_kv`` supplies encoder K/V
    (B, T, KV, hd) for cross-attention: q is then ``wq`` alone, with no
    bias, no norm and no rope."""
    s = x.shape[1]
    if cross_kv is None:
        q, k, v = _project(p, x, cfg)
        q, k = _rope_qk(q, k, cfg, positions)
        mask = (torch.ones(s, s, dtype=torch.bool, device=x.device)
                .tril()[None, None] if causal else None)
        group = cfg.q_per_kv
    else:
        q = _heads(x, p["wq"])
        k, v = cross_kv
        mask = None
        group = q.shape[2] // k.shape[2]
    return _out(p, _sdpa(q, k, v, mask, group))


def attend_local(p, x: torch.Tensor, cfg: ArchConfig, *,
                 positions) -> torch.Tensor:
    """Sliding-window attention, prefill path (kernel K6). x: (B, S, D)."""
    q, k, v = _project(p, x, cfg)
    q, k = _rope_qk(q, k, cfg, positions)
    # (B, S, H, hd) viewed as (B, H, S, hd): K6 reads the views through their
    # strides and writes its output in q's layout, so nothing is copied
    out = sliding_window_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), window=cfg.window)
    return _out(p, out.transpose(1, 2))


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
    the cache per token."""
    b, s1, _ = x.shape
    if s1 != 1:
        raise ValueError(f"decode_step takes one token, got {s1}")
    q, k_new, v_new = _project(p, x, cfg)
    pos = cache.pos
    pos_arr = (torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
               if positions is None else positions)
    q, k_new = _rope_qk(q, k_new, cfg, pos_arr)

    cap = cache.k.shape[2]
    slot = min(pos % window if window else pos, cap - 1)
    k, v = cache.k, cache.v
    k[:, :, slot] = k_new[:, 0]
    v[:, :, slot] = v_new[:, 0]

    idx = torch.arange(cap, device=x.device)
    if window:
        # absolute position held by ring slot i = the latest write time t
        # with t <= pos and t % window == i; negative -> never written.
        visible = pos - ((pos % window) - idx) % window >= 0
    else:
        visible = idx <= pos
    bias = torch.where(visible, 0.0, NEG_INF)                  # (C,)

    kv = k.shape[1]
    group = q.shape[2] // kv
    scale = torch.sqrt(torch.tensor(q.shape[-1], dtype=torch.float32))
    qg = (q.float() / scale.to(x.device)).reshape(b, 1, kv, group, -1)
    logits = torch.einsum("bskgd,bktd->bkgst", qg, k.float()) + bias
    pr = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,bktd->bskgd", pr, v.float())
    out = out.reshape(b, 1, q.shape[2], q.shape[3]).to(x.dtype)
    return _out(p, out), KVCache(k, v, pos + 1)
