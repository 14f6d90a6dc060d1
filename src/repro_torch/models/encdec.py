"""Whisper-style encoder-decoder backbone (audio family); port of
``repro.models.encdec``.

The conv/mel frontend is a stub, as in the JAX package: the encoder consumes
precomputed frame embeddings (B, encoder_seq, d_model) from
``registry.input_arrays``.  Encoder: bidirectional attention blocks with
sinusoidal positions.  Decoder: causal self-attention, cross-attention and
MLP, sinusoidal positions.  Each stack is a list of blocks, named
``enc.{i}`` and ``dec.{i}`` (``convert.from_jax_params`` unstacks the JAX
package's ``enc``/``dec`` trees onto them).

Under ``mesh_context`` with parameters split over the model axis
(``distributed/tensor_parallel.py``), each attention runs its rank's
heads and each MLP its ``d_ff`` columns, as the decoder-only stack does;
the encoder output enters the decoder's split cross-attention through one
``copy_in`` before the decoder stack; a table split over the vocabulary
is looked up vocabulary-parallel and the tied logits stay split over it.
``init_cache`` under ``mesh_context`` gives this rank's slice of the
cache, the cross K/V placed by the rules' cross rule, which decode
attends as it finds them (``attention.attend_full`` with ``frames``, the
whole frame count that a cache split over the frames records).  Where
the rules also split parameters over ``data`` (FSDP), each block gathers
its own whole as it runs, the decoder's inside its remat region, and the
embedding and the logits the table where they use it
(``tensor_parallel.unshard``, ``gather_fsdp``).
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch import nn
from torch.utils._pytree import tree_map

from repro_torch.configs import ArchConfig
from repro_torch.distributed import tensor_parallel as tp
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
        for block in self.enc:
            bp = tp.unshard(block)
            hn = rmsnorm(bp["ln1"], h, cfg.norm_eps)
            h = h + attend_full(bp["attn"], hn, cfg, positions=None,
                                causal=False)
            hn = rmsnorm(bp["ln2"], h, cfg.norm_eps)
            h = h + mlp(bp["mlp"], hn, cfg)
        return rmsnorm(self.enc_norm, h, cfg.norm_eps)

    def _cross_kv(self, bp, enc_out: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """A decoder block's cross-attention K/V (B, T, KV, hd) of the
        encoder output: the rank's KV heads where ``wk``/``wv`` are split
        over them.  ``bp``: the block, or its parameters as
        ``tensor_parallel.unshard`` gives them.  Where the cross-attention
        is split over heads and ``wk``/``wv`` are whole, they enter its
        split region (``tensor_parallel.enter``); the encoder output has
        entered it before the stack (:meth:`_enter_cross`)."""
        cross = (tp.unshard(bp) if isinstance(bp, nn.Module) else bp)["cross"]
        p = {"wk": cross["wk"], "wv": cross["wv"]}
        axis = tp.split_axis(cross["wq"].shape[1], self.cfg.num_heads)
        if axis is not None:
            p = tp.enter(p, attention_specs(self.cfg), axis)
        d, kv, hd = p["wk"].shape
        k = (enc_out @ p["wk"].to(enc_out.dtype).reshape(d, kv * hd))
        v = (enc_out @ p["wv"].to(enc_out.dtype).reshape(d, kv * hd))
        return k.unflatten(-1, (kv, hd)), v.unflatten(-1, (kv, hd))

    def _enter_cross(self, enc_out: torch.Tensor) -> torch.Tensor:
        """The encoder output as the decoder's cross K/V read it: through
        one ``copy_in`` where the cross-attention is split over heads, so
        the layers' partial gradients add up on the rank before a single
        all-reduce."""
        axis = tp.split_axis(self.dec[0].cross["wq"].shape[1],
                             self.cfg.num_heads)
        return enc_out if axis is None else tp.copy_in(enc_out, axis)

    def _embed(self, tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Token embeddings plus the sinusoidal positions ``pos``;
        vocabulary-parallel where the table is split over the vocabulary."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        table = tp.gather_fsdp(self.embed, self.param_specs["embed"])
        axis = tp.split_axis(table.shape[0], cfg.vocab_size)
        h = (embed(table, tokens, dtype) if axis is None
             else tp.vocab_parallel_embed(table, tokens, dtype, axis))
        return h + pos.to(dtype)[None]

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """f32 tied logits; this rank's columns of the vocabulary where the
        table is split over it (the input through ``copy_in``)."""
        cfg = self.cfg
        h = rmsnorm(self.final_norm, h, cfg.norm_eps)
        table = tp.gather_fsdp(self.embed, self.param_specs["embed"])
        axis = tp.split_axis(table.shape[0], cfg.vocab_size)
        if axis is not None:
            h = tp.copy_in(h, axis)
        return unembed(table, h, tied=True)

    # ----- decoder (teacher-forced / prefill logits) -------------------------
    def _dec_block(self, block: nn.Module, h: torch.Tensor,
                   enc_out: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        bp = tp.unshard(block)
        hn = rmsnorm(bp["ln1"], h, cfg.norm_eps)
        h = h + attend_full(bp["self"], hn, cfg, positions=None, causal=True)
        hn = rmsnorm(bp["lnx"], h, cfg.norm_eps)
        h = h + attend_full(bp["cross"], hn, cfg, positions=None,
                            cross_kv=self._cross_kv(bp, enc_out))
        hn = rmsnorm(bp["ln2"], h, cfg.norm_eps)
        return h + mlp(bp["mlp"], hn, cfg)

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
        enc_out = self._enter_cross(self.encode(frames))
        h = self._embed(tokens, sinusoidal_positions(
            tokens.shape[1], self.cfg.d_model, device=tokens.device))
        for bp in self.dec:
            h = remat_call(functools.partial(self._dec_block, bp), remat, h,
                           enc_out)
        return self._logits(h), torch.zeros((), dtype=torch.float32,
                                            device=tokens.device)

    # ----- decode -----------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int) -> dict[str, Any]:
        """``self``: one KVCache per decoder layer; ``cross_k``/``cross_v``:
        (layers, B, encoder_seq, KV, hd) zeros, to be filled once a request
        from its encoder output (``_cross_kv``).  Under ``mesh_context``:
        this rank's slice of the cache of ``batch`` rows
        (``tensor_parallel.shard_cache``), made without the whole."""
        cfg = self.cfg
        dtype, dev = getattr(torch, cfg.dtype), self.embed.device
        mesh = tp.ambient_mesh()
        make = dev if mesh is None else "meta"
        hd = cfg.resolved_head_dim
        xk = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads, hd)
        cache = {"self": [KVCache.init(batch, cfg.num_kv_heads, cache_len, hd,
                                       dtype, make)
                          for _ in range(cfg.num_layers)],
                 "cross_k": torch.zeros(xk, dtype=dtype, device=make),
                 "cross_v": torch.zeros(xk, dtype=dtype, device=make)}
        if mesh is None:
            return cache
        return tree_map(lambda t: torch.zeros_like(t, device=dev)
                        if isinstance(t, torch.Tensor) else t,
                        tp.shard_cache(cache, mesh))

    def decode(self, cache: dict[str, Any], tokens: torch.Tensor, *,
               positions=None) -> tuple[torch.Tensor, dict[str, Any]]:
        """One-token decode. tokens: (B, 1).  The position is layer 0's
        cache position.  The cross K/V are attended as the cache holds
        them: whole, of any frame count, a rank's KV heads, or a rank's
        slice of the frames, whose whole count the cache records as
        ``cross_frames`` (``tensor_parallel.shard_cache``)."""
        cfg = self.cfg
        pos = cache["self"][0].pos
        h = self._embed(tokens, sinusoidal_positions(
            1, cfg.d_model, offset=pos, device=tokens.device))
        new_self = []
        for i, (block, kv_cache) in enumerate(zip(self.dec, cache["self"])):
            bp = tp.unshard(block)
            hn = rmsnorm(bp["ln1"], h, cfg.norm_eps)
            y, kv_cache = attn_decode(bp["self"], hn, kv_cache, cfg,
                                      positions=None)
            h = h + y
            hn = rmsnorm(bp["lnx"], h, cfg.norm_eps)
            h = h + attend_full(bp["cross"], hn, cfg, positions=None,
                                cross_kv=(cache["cross_k"][i],
                                          cache["cross_v"][i]),
                                frames=cache.get("cross_frames", 0))
            hn = rmsnorm(bp["ln2"], h, cfg.norm_eps)
            h = h + mlp(bp["mlp"], hn, cfg)
            new_self.append(kv_cache)
        return self._logits(h), {**cache, "self": new_self}
