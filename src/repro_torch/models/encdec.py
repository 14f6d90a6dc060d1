"""Whisper-style encoder-decoder backbone (audio family); port of
``repro.models.encdec``.

The conv/mel frontend is a stub, as in the JAX package: the encoder consumes
precomputed frame embeddings (B, encoder_seq, d_model) from
``registry.input_arrays``.  Encoder: bidirectional attention blocks with
sinusoidal positions.  Decoder: causal self-attention, cross-attention and
MLP, sinusoidal positions.  Each stack is a list of blocks, named
``enc.{i}`` and ``dec.{i}`` (``convert.from_jax_params`` unstacks the JAX
package's ``enc``/``dec`` trees onto them).
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch import nn

from repro_torch.configs import ArchConfig
from repro_torch.models import params as pr
from repro_torch.models.attention import (KVCache, attend_full,
                                          attention_specs,
                                          decode_step as attn_decode)
from repro_torch.models.common import (embed, embed_spec, rmsnorm,
                                       rmsnorm_spec, sinusoidal_positions,
                                       unembed)
from repro_torch.models.mlp import mlp, mlp_specs
from repro_torch.models.transformer import add_params, flat_specs, remat_call


def _enc_block_specs(cfg: ArchConfig) -> dict[str, Any]:
    return {"ln1": rmsnorm_spec(cfg.d_model), "attn": attention_specs(cfg),
            "ln2": rmsnorm_spec(cfg.d_model), "mlp": mlp_specs(cfg)}


def _dec_block_specs(cfg: ArchConfig) -> dict[str, Any]:
    return {"ln1": rmsnorm_spec(cfg.d_model), "self": attention_specs(cfg),
            "lnx": rmsnorm_spec(cfg.d_model), "cross": attention_specs(cfg),
            "ln2": rmsnorm_spec(cfg.d_model), "mlp": mlp_specs(cfg)}


class _Params(nn.Module):
    """A block's parameters, named as in the JAX tree."""

    def __init__(self, cfg: ArchConfig, specs: dict[str, Any], device):
        super().__init__()
        add_params(self, specs, cfg.param_dtype, device)


class EncDecLM(nn.Module):
    """Whisper-tiny-style backbone.  Holds its parameters (uninitialised
    until :meth:`init` or ``load_state_dict``) on ``device``.
    ``force_unroll`` is accepted and ignored, as by ``transformer.LM``."""

    def __init__(self, cfg: ArchConfig, force_unroll: bool = False, *,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        add_params(self, self._top_specs(), cfg.param_dtype, device)
        self.enc = nn.ModuleList(_Params(cfg, _enc_block_specs(cfg), device)
                                 for _ in range(cfg.encoder_layers))
        self.dec = nn.ModuleList(_Params(cfg, _dec_block_specs(cfg), device)
                                 for _ in range(cfg.num_layers))

    # ----- parameters -------------------------------------------------------
    def _top_specs(self) -> dict[str, pr.Spec]:
        d = self.cfg.d_model
        return {"embed": embed_spec(self.cfg.vocab_size, d),
                "enc_norm": rmsnorm_spec(d), "final_norm": rmsnorm_spec(d)}

    def specs(self) -> dict[str, pr.Spec]:
        """Spec of every parameter, under its ``state_dict`` name."""
        cfg = self.cfg
        out = dict(self._top_specs())
        for i in range(cfg.encoder_layers):
            out |= flat_specs(f"enc.{i}.", _enc_block_specs(cfg))
        for i in range(cfg.num_layers):
            out |= flat_specs(f"dec.{i}.", _dec_block_specs(cfg))
        return out

    def init(self, generator: torch.Generator) -> "EncDecLM":
        """Fill every parameter from ``generator`` (on the parameters'
        device), one pass in ``specs()`` order."""
        params = dict(self.named_parameters())
        for name, spec in self.specs().items():
            pr.init_leaf_(params[name], spec, generator)
        return self

    # ----- encoder ----------------------------------------------------------
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, T, D) stub embeddings -> encoder output (B, T, D)."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        pos = sinusoidal_positions(frames.shape[1], cfg.d_model,
                                   device=frames.device)
        h = frames.to(dtype) + pos.to(dtype)[None]
        for bp in self.enc:
            hn = rmsnorm(bp.ln1, h, cfg.norm_eps)
            h = h + attend_full(bp.attn, hn, cfg, positions=None,
                                causal=False)
            hn = rmsnorm(bp.ln2, h, cfg.norm_eps)
            h = h + mlp(bp.mlp, hn, cfg)
        return rmsnorm(self.enc_norm, h, cfg.norm_eps)

    def _cross_kv(self, bp: nn.Module, enc_out: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """A decoder block's cross-attention K/V (B, T, KV, hd) of the
        encoder output."""
        d, kv, hd = bp.cross["wk"].shape
        k = (enc_out @ bp.cross["wk"].to(enc_out.dtype).reshape(d, kv * hd))
        v = (enc_out @ bp.cross["wv"].to(enc_out.dtype).reshape(d, kv * hd))
        return k.unflatten(-1, (kv, hd)), v.unflatten(-1, (kv, hd))

    # ----- decoder (teacher-forced / prefill logits) -------------------------
    def _dec_block(self, bp: nn.Module, h: torch.Tensor,
                   enc_out: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        hn = rmsnorm(bp.ln1, h, cfg.norm_eps)
        h = h + attend_full(bp.self, hn, cfg, positions=None, causal=True)
        hn = rmsnorm(bp.lnx, h, cfg.norm_eps)
        h = h + attend_full(bp.cross, hn, cfg, positions=None,
                            cross_kv=self._cross_kv(bp, enc_out))
        hn = rmsnorm(bp.ln2, h, cfg.norm_eps)
        return h + mlp(bp.mlp, hn, cfg)

    def reference_leaf(self, name: str) -> str:
        """The JAX package's leaf that holds parameter ``name``: the
        encoder's and decoder's blocks are stacked over layers (``enc.{i}.x``
        is leaf ``enc.x``); any other parameter is its own leaf."""
        if name.startswith(("enc.", "dec.")):
            stack, _, rest = name.split(".", 2)
            return f"{stack}.{rest}"
        return name

    def forward(self, tokens: torch.Tensor, frames: torch.Tensor,
                remat: str = "none") -> tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B, S), frames: (B, T, D) -> (logits (B,S,V) fp32, 0).
        ``remat`` recomputes each decoder block in the backward pass, as
        the JAX package checkpoints its decoder scan
        (``transformer.remat_call``)."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        enc_out = self.encode(frames)
        pos = sinusoidal_positions(tokens.shape[1], cfg.d_model,
                                   device=tokens.device)
        h = embed(self.embed, tokens, dtype) + pos.to(dtype)[None]
        for bp in self.dec:
            h = remat_call(functools.partial(self._dec_block, bp), remat, h,
                           enc_out)
        h = rmsnorm(self.final_norm, h, cfg.norm_eps)
        logits = unembed(self.embed, h, tied=True)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=tokens.device)

    # ----- decode -----------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int) -> dict[str, Any]:
        """``self``: one KVCache per decoder layer; ``cross_k``/``cross_v``:
        (layers, B, encoder_seq, KV, hd) zeros, to be filled once a request
        from its encoder output (``_cross_kv``)."""
        cfg = self.cfg
        dtype, dev = getattr(torch, cfg.dtype), self.embed.device
        hd = cfg.resolved_head_dim
        xk = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads, hd)
        return {"self": [KVCache.init(batch, cfg.num_kv_heads, cache_len, hd,
                                      dtype, dev)
                         for _ in range(cfg.num_layers)],
                "cross_k": torch.zeros(xk, dtype=dtype, device=dev),
                "cross_v": torch.zeros(xk, dtype=dtype, device=dev)}

    def decode(self, cache: dict[str, Any], tokens: torch.Tensor, *,
               positions=None) -> tuple[torch.Tensor, dict[str, Any]]:
        """One-token decode. tokens: (B, 1).  The position is layer 0's
        cache position."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        pos = cache["self"][0].pos
        h = embed(self.embed, tokens, dtype)
        ptab = sinusoidal_positions(1, cfg.d_model, offset=pos,
                                    device=tokens.device)
        h = h + ptab.to(dtype)[None]
        new_self = []
        for i, (bp, kv_cache) in enumerate(zip(self.dec, cache["self"])):
            hn = rmsnorm(bp.ln1, h, cfg.norm_eps)
            y, kv_cache = attn_decode(bp.self, hn, kv_cache, cfg,
                                      positions=None)
            h = h + y
            hn = rmsnorm(bp.lnx, h, cfg.norm_eps)
            h = h + attend_full(bp.cross, hn, cfg, positions=None,
                                cross_kv=(cache["cross_k"][i],
                                          cache["cross_v"][i]))
            hn = rmsnorm(bp.ln2, h, cfg.norm_eps)
            h = h + mlp(bp.mlp, hn, cfg)
            new_self.append(kv_cache)
        h = rmsnorm(self.final_norm, h, cfg.norm_eps)
        logits = unembed(self.embed, h, tied=True)
        return logits, {"self": new_self, "cross_k": cache["cross_k"],
                        "cross_v": cache["cross_v"]}
