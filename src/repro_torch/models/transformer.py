"""Decoder-only LM stack (port of ``repro.models.transformer``) for the
block kinds the port has: ``"rglru"`` and ``"local"`` (the hybrid family,
RecurrentGemma).

The block pattern is cycled over ``num_layers``.  The JAX package stacks
full pattern periods for ``lax.scan`` and applies the ``num_layers %
period`` remainder unrolled; here every layer is its own :class:`Block`,
applied in order.  Layer ``i`` is scan period ``i // period``, slot
``i % period`` for ``i < n_full·period``, then the tail
(:mod:`repro_torch.models.convert` maps the JAX pytree onto that order).
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from repro_torch.configs import ArchConfig
from repro_torch.models import params as pr
from repro_torch.models.attention import (KVCache, attend_local,
                                          attention_specs,
                                          decode_step as attn_decode)
from repro_torch.models.common import (embed, embed_spec, rmsnorm,
                                       rmsnorm_spec, unembed)
from repro_torch.models.mlp import mlp, mlp_specs
from repro_torch.models.rglru import (rglru_block, rglru_decode,
                                      rglru_init_state, rglru_specs)

def block_specs(cfg: ArchConfig, kind: str) -> dict[str, Any]:
    out: dict[str, Any] = {"ln1": rmsnorm_spec(cfg.d_model),
                           "ln2": rmsnorm_spec(cfg.d_model)}
    if kind == "local":
        out["attn"] = attention_specs(cfg)
    elif kind == "rglru":
        out["rec"] = rglru_specs(cfg)
    else:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP.md Queue 1, "
            "slice 4: the other LM families)")
    out["mlp"] = mlp_specs(cfg)
    return out


def _empty(spec: pr.Spec, default_dtype: str, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(spec.shape,
                                    dtype=pr.spec_dtype(spec, default_dtype),
                                    device=device))


class Block(nn.Module):
    """One layer: pre-norm mixer (RG-LRU or local attention) and pre-norm
    MLP, each with a residual.  Parameters are named as in the JAX tree."""

    def __init__(self, cfg: ArchConfig, kind: str, device=None):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        for name, spec in block_specs(cfg, kind).items():
            if isinstance(spec, pr.Spec):
                setattr(self, name, _empty(spec, cfg.param_dtype, device))
            else:
                setattr(self, name, nn.ParameterDict(
                    {k: _empty(s, cfg.param_dtype, device)
                     for k, s in spec.items()}))

    def forward(self, h: torch.Tensor, positions) -> torch.Tensor:
        cfg = self.cfg
        hn = rmsnorm(self.ln1, h, cfg.norm_eps)
        if self.kind == "local":
            h = h + attend_local(self.attn, hn, cfg, positions=positions)
        else:
            h = h + rglru_block(self.rec, hn, cfg)
        hn = rmsnorm(self.ln2, h, cfg.norm_eps)
        return h + mlp(self.mlp, hn, cfg)

    def decode(self, h: torch.Tensor, cache, positions):
        cfg = self.cfg
        hn = rmsnorm(self.ln1, h, cfg.norm_eps)
        if self.kind == "local":
            y, cache = attn_decode(self.attn, hn, cache, cfg,
                                   window=cfg.window, positions=positions)
        else:
            y, cache = rglru_decode(self.rec, hn, cache, cfg)
        h = h + y
        hn = rmsnorm(self.ln2, h, cfg.norm_eps)
        return h + mlp(self.mlp, hn, cfg), cache


class LM(nn.Module):
    """Decoder-only language model built from an ArchConfig.  Holds its
    parameters (uninitialised until :meth:`init` or ``load_state_dict``) on
    ``device``."""

    def __init__(self, cfg: ArchConfig, *, device="cuda"):
        super().__init__()
        if cfg.num_experts:
            raise NotImplementedError("MoE is not ported yet (ROADMAP.md "
                                      "Queue 1, slice 4)")
        if cfg.qkv_bias or cfg.qk_norm or cfg.mrope_sections is not None:
            raise NotImplementedError("qkv bias, qk norm and M-RoPE are not "
                                      "ported yet (ROADMAP.md Queue 1, slice 4)")
        for kind in cfg.block_pattern:
            block_specs(cfg, kind)          # raises on a kind not ported
        self.cfg = cfg
        self.period = len(cfg.block_pattern)
        self.n_full = cfg.num_layers // self.period
        self.n_tail = cfg.num_layers % self.period
        top = self._top_specs()
        self.embed = _empty(top["embed"], cfg.param_dtype, device)
        self.final_norm = _empty(top["final_norm"], cfg.param_dtype, device)
        if not cfg.tie_embeddings:
            self.unembed = _empty(top["unembed"], cfg.param_dtype, device)
        self.layers = nn.ModuleList(
            Block(cfg, cfg.kind_of_layer(i), device)
            for i in range(cfg.num_layers))

    # ----- parameters -------------------------------------------------------
    def _top_specs(self) -> dict[str, pr.Spec]:
        cfg = self.cfg
        d, v = cfg.d_model, cfg.vocab_size
        out = {"embed": embed_spec(v, d), "final_norm": rmsnorm_spec(d)}
        if not cfg.tie_embeddings:
            out["unembed"] = pr.Spec((d, v), ("fsdp", "vocab"))
        return out

    def specs(self) -> dict[str, pr.Spec]:
        """Spec of every parameter, under its ``state_dict`` name."""
        out = dict(self._top_specs())
        for i, layer in enumerate(self.layers):
            for name, spec in block_specs(self.cfg, layer.kind).items():
                if isinstance(spec, pr.Spec):
                    out[f"layers.{i}.{name}"] = spec
                else:
                    out |= {f"layers.{i}.{name}.{k}": s
                            for k, s in spec.items()}
        return out

    def init(self, generator: torch.Generator) -> "LM":
        """Fill every parameter from ``generator`` (on the parameters'
        device), one pass in ``specs()`` order."""
        params = dict(self.named_parameters())
        for name, spec in self.specs().items():
            pr.init_leaf_(params[name], spec, generator)
        return self

    # ----- forward (prefill logits) -------------------------------------------
    def embed_inputs(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = embed(self.embed, tokens, getattr(torch, cfg.dtype))
        if cfg.family == "hybrid":                      # gemma lineage scales
            # by sqrt(d_model) rounded to the activation type first
            h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype)
        return h

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = rmsnorm(self.final_norm, h, cfg.norm_eps)
        w = self.embed if cfg.tie_embeddings else self.unembed
        return unembed(w, h, tied=cfg.tie_embeddings)

    def forward(self, tokens: torch.Tensor, *, positions=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B, S) -> (logits (B,S,V) fp32, aux loss scalar)."""
        h = self.embed_inputs(tokens)
        if positions is None:
            positions = torch.arange(tokens.shape[1],
                                     device=tokens.device)[None, :]
        for layer in self.layers:
            h = layer(h, positions)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        return self._logits(h), aux

    # ----- serving ----------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int) -> list:
        """One state per layer: a ring-buffer KVCache of
        ``min(cache_len, window)`` slots for local layers, an RGLRUState for
        recurrent ones."""
        cfg = self.cfg
        dtype, dev = getattr(torch, cfg.dtype), self.embed.device
        return [KVCache.init(batch, cfg.num_kv_heads,
                             min(cache_len, cfg.window),
                             cfg.resolved_head_dim, dtype, dev)
                if layer.kind == "local"
                else rglru_init_state(batch, cfg, dtype, dev)
                for layer in self.layers]

    def decode(self, cache: list, tokens: torch.Tensor, *, positions=None
               ) -> tuple[torch.Tensor, list]:
        """One-token decode. tokens: (B, 1). Returns (logits (B,1,V), cache)."""
        h = self.embed_inputs(tokens)
        new_cache = []
        for layer, state in zip(self.layers, cache):
            h, state = layer.decode(h, state, positions)
            new_cache.append(state)
        return self._logits(h), new_cache
