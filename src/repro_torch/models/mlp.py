"""Feed-forward blocks: gated (SwiGLU/GeGLU) dense MLP and GShard-style top-k
MoE with capacity-factor dispatch; port of ``repro.models.mlp``.

The MoE is the reference's einsums in plain PyTorch (no Pallas kernel there).
Its dispatch and combine run inside the profiler range ``MOE_DISPATCH``, so a
trace can split them from the experts' products.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.models.common import activation
from repro_torch.models.params import Spec

MOE_DISPATCH = "moe.dispatch_combine"


def mlp_specs(cfg: ArchConfig) -> dict[str, Spec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi_gate": Spec((d, f), ("fsdp", "mlp")),
        "wi_up": Spec((d, f), ("fsdp", "mlp")),
        "wo": Spec((f, d), ("mlp", "fsdp")),
    }


def mlp(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    act = activation(cfg.act)
    g = x @ p["wi_gate"].to(x.dtype)
    u = x @ p["wi_up"].to(x.dtype)
    return (act(g) * u) @ p["wo"].to(x.dtype)


def moe_specs(cfg: ArchConfig) -> dict[str, Spec]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": Spec((d, e), ("fsdp", "experts"), scale=0.1),
        "wi_gate": Spec((e, d, f), ("experts", "fsdp", "mlp")),
        "wi_up": Spec((e, d, f), ("experts", "fsdp", "mlp")),
        "wo": Spec((e, f, d), ("experts", "mlp", "fsdp")),
    }


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index.  ``torch.topk`` promises no order among ties; a stable
    descending sort keeps equal values in index order.  The zero rows that
    pad a group all tie (uniform router probabilities) and count in the aux
    loss."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(g: int, cfg: ArchConfig) -> int:
    """Slots per expert and group: dropless for small groups (decode steps,
    smoke tests), ``int(g·k/E·cf)`` in Python floats above 64 tokens."""
    e, k = cfg.num_experts, cfg.experts_per_token
    if g <= 64:
        return g
    return max(1, min(g, int(g * k / e * cfg.moe_capacity_factor)))


def moe(p, x: torch.Tensor, cfg: ArchConfig,
        group_size: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out, aux_loss).  x: (B, S, D).

    Grouped GShard dispatch: the tokens are split into groups of
    ``group_size`` (the last one zero-padded) and each group routes on its
    own with per-expert capacity ``capacity(g)``; queue positions come from
    a cumsum over the flattened (token, slot) axis and tokens over capacity
    are dropped.  The (G, g, E, C) dispatch and combine tensors carry exact
    0/1 values (and the gate rounded once) in the activation type."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    xt = x.reshape(t, d)
    act = activation(cfg.act)

    g = min(group_size or cfg.moe_group_size, t)
    pad = (-t) % g
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    ng = xt.shape[0] // g
    xg = xt.reshape(ng, g, d)

    logits = xg.float() @ p["router"].float()                   # (G, g, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, choices = top_k(probs, k)                         # (G, g, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    cap = capacity(g, cfg)
    dd = x.dtype
    with torch.profiler.record_function(MOE_DISPATCH):
        onehot = F.one_hot(choices, e).float()                   # (G, g, k, E)
        flat = onehot.reshape(ng, g * k, e)
        pos_flat = flat.cumsum(dim=1) - flat                     # queue position
        pos = (pos_flat.reshape(ng, g, k, e) * onehot).sum(-1)   # (G, g, k)
        keep = (pos < cap).float()
        gate_vals = gate_vals * keep
        # a position past the capacity has no one-hot row (keep is 0 there)
        pos_oh = (F.one_hot(pos.long().clamp(max=cap - 1), cap).float()
                  * keep[..., None])                             # (G, g, k, C)
        oh = onehot.to(dd)
        # sum over k of exact 0/1 products with at most one non-zero term
        dispatch = torch.einsum("Ggke,Ggkc->Ggec", oh, pos_oh.to(dd))
        # the reference's three-operand einsum in two steps: each (e, c) of a
        # token holds one choice, so its gate is picked exactly, then scaled
        # by the exact 0/1 dispatch value
        gate_e = (gate_vals.to(dd)[..., None] * oh).sum(2)       # (G, g, E)
        combine = dispatch * gate_e[..., None]                   # (G, g, E, C)
        xe = torch.einsum("Ggec,Ggd->Gecd", dispatch, xg)

    gg = torch.einsum("Gecd,edf->Gecf", xe, p["wi_gate"].to(dd))
    uu = torch.einsum("Gecd,edf->Gecf", xe, p["wi_up"].to(dd))
    ye = torch.einsum("Gecf,efd->Gecd", act(gg) * uu, p["wo"].to(dd))
    with torch.profiler.record_function(MOE_DISPATCH):
        out = torch.einsum("Ggec,Gecd->Ggd", combine, ye)
    out = out.reshape(-1, d)[:t].reshape(b, s, d)

    # load-balance aux loss (Switch): E * sum_e f_e * P_e / k
    f_e = onehot.sum(2).mean(dim=(0, 1))                        # fraction routed
    p_e = probs.mean(dim=(0, 1))
    aux = e * (f_e * p_e).sum() / k
    return out, aux.float()
