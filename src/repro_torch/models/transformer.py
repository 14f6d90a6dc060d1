"""Decoder-only LM stack (port of ``repro.models.transformer``) for every
block kind: ``"attn"`` (full attention, with a dense or MoE MLP), ``"local"``
and ``"rglru"`` (the hybrid family) and ``"rwkv"``.

The block pattern is cycled over ``num_layers``.  The JAX package stacks
full pattern periods for ``lax.scan`` and applies the ``num_layers %
period`` remainder unrolled; here every layer is its own :class:`Block`,
applied in order.  Layer ``i`` is scan period ``i // period``, slot
``i % period`` for ``i < n_full·period``, then the tail
(:mod:`repro_torch.models.convert` maps the JAX pytree onto that order).
The cache is a list with one state per layer: a KVCache (full or ring
buffer), an RGLRUState or an RWKVState.

``forward(remat=)`` recomputes activations in the backward pass as the JAX
package's ``jax.checkpoint`` of its scan body does, one layer at a time
(:func:`remat_call`): ``"full"`` keeps only each layer's input,
``"dots"`` also keeps the outputs of the matrix products without batch
dimensions (``dots_with_no_batch_dims_saveable``).  Gradients do not depend
on it.

Under ``mesh_context`` with the table split over ``vocab`` (the model
axis), the embedding is vocabulary-parallel (a masked lookup, then a sum
over the ranks) and the logits stay split over the vocabulary: the train
step's cross entropy takes them so (``tensor_parallel.vocab_parallel_xent``),
and so does decode's greedy token (``tensor_parallel.vocab_parallel_argmax``).
``init_cache`` under ``mesh_context`` gives this rank's slice of the cache
as the rules place it (``tensor_parallel.shard_cache``).  Where the rules
also split parameters over ``data`` (FSDP, ``DEFAULT_RULES``), each layer
gathers its own whole as it runs, inside its remat region, and the
embedding and the logits gather their table where they use it
(``tensor_parallel.unshard``, ``gather_fsdp``).
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch
from torch import nn
from torch.utils._pytree import tree_map
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs import ArchConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import params as pr
from repro_torch.models.attention import (KVCache, attend_full, attend_local,
                                          attention_specs,
                                          decode_step as attn_decode)
from repro_torch.models.common import (embed, embed_spec, rmsnorm,
                                       rmsnorm_spec, unembed)
from repro_torch.models.mlp import mlp, mlp_specs, moe, moe_specs
from repro_torch.models.rglru import (rglru_block, rglru_decode,
                                      rglru_init_state, rglru_specs)
from repro_torch.models.rwkv6 import (RWKVState, rwkv_channel_mix,
                                      rwkv_init_state, rwkv_specs,
                                      rwkv_time_mix)


REMAT = ("none", "full", "dots")
# the products ``dots`` keeps: a matrix product without batch dimensions
# reaches the dispatcher as one of these (a 3-d activation times a 2-d
# weight is folded into one mm); batched products (bmm, the attention
# einsums) are recomputed, as under dots_with_no_batch_dims_saveable
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_call(fn, remat: str, *args):
    """``fn(*args)``, recomputed in the backward pass under ``remat`` "full"
    or "dots" (``torch.utils.checkpoint``, non-reentrant)."""
    if remat == "none":
        return fn(*args)
    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _dots_policy))
    raise ValueError(f"unknown remat {remat!r} (one of {REMAT})")


def xent_loss(logits: torch.Tensor, labels: torch.Tensor,
              z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token cross-entropy (f32 logits) + z-loss regularizer."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    loss = torch.mean(lse - ll)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss


def block_specs(cfg: ArchConfig, kind: str) -> dict[str, Any]:
    d = cfg.d_model
    out: dict[str, Any] = {"ln1": rmsnorm_spec(d), "ln2": rmsnorm_spec(d)}
    if kind in ("attn", "local"):
        out["attn"] = attention_specs(cfg)
        out["mlp"] = moe_specs(cfg) if cfg.num_experts else mlp_specs(cfg)
    elif kind == "rglru":
        out["rec"] = rglru_specs(cfg)
        out["mlp"] = moe_specs(cfg) if cfg.num_experts else mlp_specs(cfg)
    elif kind == "rwkv":
        out["rwkv"] = rwkv_specs(cfg)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    return out


def _empty(spec: pr.Spec, default_dtype: str, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(spec.shape,
                                    dtype=pr.spec_dtype(spec, default_dtype),
                                    device=device))


def add_params(module: nn.Module, specs: dict[str, Any], default_dtype: str,
               device) -> None:
    """Give ``module`` an uninitialised parameter per Spec of ``specs`` (a
    ``ParameterDict`` per nested dict), named as in the JAX tree; its
    ``param_specs`` keep them (``tensor_parallel.unshard`` reads them)."""
    module.param_specs = {**getattr(module, "param_specs", {}), **specs}
    for name, spec in specs.items():
        if pr.is_spec(spec):
            setattr(module, name, _empty(spec, default_dtype, device))
        else:
            setattr(module, name, nn.ParameterDict(
                {k: _empty(s, default_dtype, device)
                 for k, s in spec.items()}))


def flat_specs(prefix: str, specs: dict[str, Any]) -> dict[str, pr.Spec]:
    """A block's nested specs under their ``state_dict`` names."""
    out = {}
    for name, spec in specs.items():
        if pr.is_spec(spec):
            out[f"{prefix}{name}"] = spec
        else:
            out |= flat_specs(f"{prefix}{name}.", spec)
    return out


class Block(nn.Module):
    """One layer: a pre-norm mixer (attention, RG-LRU or RWKV time-mix) and
    a pre-norm MLP (dense, MoE or RWKV channel-mix), each with a residual.
    Parameters are named as in the JAX tree.  Each call runs on the
    layer's parameters gathered whole over ``data`` where FSDP splits them
    (``tensor_parallel.unshard``)."""

    def __init__(self, cfg: ArchConfig, kind: str, device=None):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        add_params(self, block_specs(cfg, kind), cfg.param_dtype, device)

    def _ffn(self, p: dict, h: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The MLP half: (h + mlp(ln2(h)), the MoE's aux loss or None)."""
        cfg = self.cfg
        hn = rmsnorm(p["ln2"], h, cfg.norm_eps)
        if cfg.num_experts:
            y, aux = moe(p["mlp"], hn, cfg)
            return h + y, aux
        return h + mlp(p["mlp"], hn, cfg), None

    def forward(self, h: torch.Tensor, positions
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Returns (h, the MoE's aux loss or None)."""
        cfg = self.cfg
        p = tp.unshard(self)
        hn = rmsnorm(p["ln1"], h, cfg.norm_eps)
        if self.kind == "rwkv":
            y, _ = rwkv_time_mix(p["rwkv"], hn, cfg)
            h = h + y
            hn = rmsnorm(p["ln2"], h, cfg.norm_eps)
            y, _ = rwkv_channel_mix(p["rwkv"], hn, cfg)
            return h + y, None
        if self.kind == "attn":
            h = h + attend_full(p["attn"], hn, cfg, positions=positions)
        elif self.kind == "local":
            h = h + attend_local(p["attn"], hn, cfg, positions=positions)
        else:
            h = h + rglru_block(p["rec"], hn, cfg)
        return self._ffn(p, h)

    def decode(self, h: torch.Tensor, cache, positions):
        cfg = self.cfg
        p = tp.unshard(self)
        hn = rmsnorm(p["ln1"], h, cfg.norm_eps)
        if self.kind == "rwkv":
            y, (tm_shift, s_fin) = rwkv_time_mix(
                p["rwkv"], hn, cfg, shift=cache.shift_tm, s0=cache.s)
            h = h + y
            hn = rmsnorm(p["ln2"], h, cfg.norm_eps)
            y, cm_shift = rwkv_channel_mix(p["rwkv"], hn, cfg,
                                           shift=cache.shift_cm)
            return h + y, RWKVState(shift_tm=tm_shift, shift_cm=cm_shift,
                                    s=s_fin)
        if self.kind in ("attn", "local"):
            y, cache = attn_decode(
                p["attn"], hn, cache, cfg,
                window=cfg.window if self.kind == "local" else 0,
                positions=positions)
        else:
            y, cache = rglru_decode(p["rec"], hn, cache, cfg)
        h, _ = self._ffn(p, h + y)
        return h, cache


class LM(nn.Module):
    """Decoder-only language model built from an ArchConfig.  Holds its
    parameters (uninitialised until :meth:`init` or ``load_state_dict``) on
    ``device``.  ``force_unroll`` is accepted and ignored: in the reference
    it unrolls the layer scan for the dry run's cost estimate, and the port
    has no scan (one block per layer)."""

    def __init__(self, cfg: ArchConfig, force_unroll: bool = False, *,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.period = len(cfg.block_pattern)
        self.n_full = cfg.num_layers // self.period
        self.n_tail = cfg.num_layers % self.period
        add_params(self, self._top_specs(), cfg.param_dtype, device)
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
            out |= flat_specs(f"layers.{i}.", block_specs(self.cfg, layer.kind))
        return out

    def init(self, generator: torch.Generator) -> "LM":
        """Fill every parameter from ``generator`` (on the parameters'
        device), one pass in ``specs()`` order."""
        params = dict(self.named_parameters())
        for name, spec in self.specs().items():
            pr.init_leaf_(params[name], spec, generator)
        return self

    # ----- forward (prefill logits) -------------------------------------------
    def embed_inputs(self, tokens: torch.Tensor,
                     patches: torch.Tensor | None = None) -> torch.Tensor:
        """Token embeddings; ``patches`` (vlm: (B, Tv, D)) replace the first
        Tv positions."""
        cfg = self.cfg
        table = tp.gather_fsdp(self.embed, self.param_specs["embed"])
        axis = tp.split_axis(table.shape[0], cfg.vocab_size)
        if axis is not None:
            h = tp.vocab_parallel_embed(table, tokens,
                                        getattr(torch, cfg.dtype), axis)
        else:
            h = embed(table, tokens, getattr(torch, cfg.dtype))
        if cfg.family == "hybrid":                      # gemma lineage scales
            # by sqrt(d_model) rounded to the activation type first
            h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype)
        if patches is not None:
            tv = patches.shape[1]
            h = torch.cat([patches.to(h.dtype), h[:, tv:, :]], dim=1)
        return h

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """f32 logits; this rank's columns of the vocabulary where the
        table is split over it."""
        cfg = self.cfg
        h = rmsnorm(self.final_norm, h, cfg.norm_eps)
        name = "embed" if cfg.tie_embeddings else "unembed"
        w = tp.gather_fsdp(getattr(self, name), self.param_specs[name])
        axis = tp.split_axis(w.shape[0 if cfg.tie_embeddings else 1],
                             cfg.vocab_size)
        if axis is not None:
            h = tp.copy_in(h, axis)
        return unembed(w, h, tied=cfg.tie_embeddings)

    def reference_leaf(self, name: str) -> str:
        """The JAX package's leaf that holds parameter ``name``: layers
        before the tail are stacked over periods (``scan/p{p}``, one leaf
        with a leading layer axis per slot and parameter), so layer ``i``'s
        ``x`` is leaf ``scan.p{i % period}.x``; any other parameter is its
        own leaf.  The optimizer decays and compresses by the reference's
        leaves."""
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            if int(i) < self.n_full * self.period:
                return f"scan.p{int(i) % self.period}.{rest}"
        return name

    def forward(self, tokens: torch.Tensor, *, positions=None, patches=None,
                remat: str = "none") -> tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B, S) -> (logits (B,S,V) fp32, aux loss scalar: the sum
        of the MoE layers').  ``remat``: see :func:`remat_call`.  With no
        ``positions``, the token index; under M-RoPE, the text-only
        positions (3, B, S), every component the token index (the
        reference's (1, S) default raises under M-RoPE)."""
        h = self.embed_inputs(tokens, patches)
        if positions is None:
            positions = torch.arange(tokens.shape[1],
                                     device=tokens.device)[None, :]
            if self.cfg.mrope_sections is not None:
                positions = positions.expand(3, tokens.shape[0], -1)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for layer in self.layers:
            h, a = remat_call(layer, remat, h, positions)
            if a is not None:
                aux = aux + a
        return self._logits(h), aux

    # ----- serving ----------------------------------------------------------
    def _cache_for(self, kind: str, batch: int, cache_len: int,
                   dtype: torch.dtype, dev):
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        if kind == "attn":
            return KVCache.init(batch, cfg.num_kv_heads, cache_len, hd, dtype,
                                dev)
        if kind == "local":
            return KVCache.init(batch, cfg.num_kv_heads,
                                min(cache_len, cfg.window), hd, dtype, dev)
        if kind == "rglru":
            return rglru_init_state(batch, cfg, dtype, dev)
        if kind == "rwkv":
            return rwkv_init_state(batch, cfg, dtype, dev)
        raise ValueError(f"unknown block kind {kind!r}")

    def init_cache(self, batch: int, cache_len: int) -> list:
        """One state per layer: a KVCache of ``cache_len`` slots for global
        attention, a ring buffer of ``min(cache_len, window)`` for local
        attention, an RGLRUState or an RWKVState for recurrent layers.
        Under ``mesh_context``: this rank's slice of the cache of ``batch``
        rows (``tensor_parallel.shard_cache``), made without the whole."""
        dtype = getattr(torch, self.cfg.dtype)
        mesh = tp.ambient_mesh()
        dev = self.embed.device if mesh is None else "meta"
        cache = [self._cache_for(layer.kind, batch, cache_len, dtype, dev)
                 for layer in self.layers]
        if mesh is None:
            return cache
        dev = self.embed.device
        return tree_map(lambda t: torch.zeros_like(t, device=dev)
                        if isinstance(t, torch.Tensor) else t,
                        tp.shard_cache(cache, mesh))

    def decode(self, cache: list, tokens: torch.Tensor, *, positions=None
               ) -> tuple[torch.Tensor, list]:
        """One-token decode. tokens: (B, 1). Returns (logits (B,1,V), cache)."""
        h = self.embed_inputs(tokens)
        new_cache = []
        for layer, state in zip(self.layers, cache):
            h, state = layer.decode(h, state, positions)
            new_cache.append(state)
        return self._logits(h), new_cache
