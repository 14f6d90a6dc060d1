"""Local (sliding-window) attention with GQA/MQA and RoPE, and its
ring-buffer decode; port of the parts of ``repro.models.attention`` that the
hybrid family runs.

The prefill path runs kernel K6 (``kernels/swa``).  Decode keeps a KV cache
of ``min(cache_len, window)`` slots written at ``pos % window`` and masks by
each slot's absolute position (the §III-B line buffer in time).  Full
attention, ``_sdpa`` and cross-attention are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs import ArchConfig
from repro_torch.kernels.swa.ops import sliding_window_attention
from repro_torch.models.common import apply_rope, rope_angles
from repro_torch.models.params import Spec

NEG_INF = -1e30


def attention_specs(cfg: ArchConfig) -> dict[str, Spec]:
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    return {
        "wq": Spec((d, h, hd), ("fsdp", "heads", "head_dim")),
        "wk": Spec((d, kv, hd), ("fsdp", "kv_heads", "head_dim")),
        "wv": Spec((d, kv, hd), ("fsdp", "kv_heads", "head_dim")),
        "wo": Spec((h, hd, d), ("heads", "head_dim", "fsdp")),
    }


class KVCache(NamedTuple):
    """k/v: (B, Hkv, C, hd); C = window for local layers.  ``pos``: the next
    absolute write position (a Python int, shared by the batch)."""
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


def _project(p, x: torch.Tensor):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KV,hd)."""
    return _heads(x, p["wq"]), _heads(x, p["wk"]), _heads(x, p["wv"])


def _rope_qk(q, k, cfg: ArchConfig, positions):
    if cfg.rope_theta <= 0 or positions is None:
        return q, k
    cos, sin = rope_angles(positions, q.shape[-1], cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def _out(p, o: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, k, d = p["wo"].shape
    return o.flatten(-2) @ p["wo"].to(o.dtype).reshape(h * k, d)


def attend_local(p, x: torch.Tensor, cfg: ArchConfig, *,
                 positions) -> torch.Tensor:
    """Sliding-window attention, prefill path (kernel K6). x: (B, S, D)."""
    q, k, v = _project(p, x)
    q, k = _rope_qk(q, k, cfg, positions)
    # (B, S, H, hd) viewed as (B, H, S, hd): K6 reads the views through their
    # strides and writes its output in q's layout, so nothing is copied
    out = sliding_window_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), window=cfg.window)
    return _out(p, out.transpose(1, 2))


def decode_step(p, x: torch.Tensor, cache: KVCache, cfg: ArchConfig, *,
                window: int, positions=None
                ) -> tuple[torch.Tensor, KVCache]:
    """x: (B, 1, D); returns (out (B,1,D), the cache advanced by one token).

    A local layer writes at ``pos % window`` (a ring buffer) and masks each
    slot by the absolute position it holds.  The slot is clamped to the
    capacity, as ``jax.lax.dynamic_update_slice`` clamps it.  The cache's k/v
    are updated in place (the returned cache holds the same tensors) to spare
    a copy of the cache per token."""
    b, s1, _ = x.shape
    if s1 != 1:
        raise ValueError(f"decode_step takes one token, got {s1}")
    q, k_new, v_new = _project(p, x)
    pos = cache.pos
    pos_arr = (torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
               if positions is None else positions)
    q, k_new = _rope_qk(q, k_new, cfg, pos_arr)

    cap = cache.k.shape[2]
    slot = min(pos % window, cap - 1)
    k, v = cache.k, cache.v
    k[:, :, slot] = k_new[:, 0]
    v[:, :, slot] = v_new[:, 0]

    # absolute position held by ring slot i = the latest write time t with
    # t <= pos and t % window == i; negative -> never written.
    idx = torch.arange(cap, device=x.device)
    visible = pos - ((pos % window) - idx) % window >= 0
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
