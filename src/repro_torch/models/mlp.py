"""Feed-forward blocks: gated (SwiGLU/GeGLU) dense MLP and GShard-style top-k
MoE with capacity-factor dispatch; port of ``repro.models.mlp``.

The MoE is the reference's einsums in plain PyTorch (no Pallas kernel there).
Its dispatch and combine run inside the profiler range ``MOE_DISPATCH``, so a
trace can split them from the experts' products.

Under ``mesh_context``: the dense MLP with ``wi_gate`` split over ``mlp``
(the model axis) runs column-parallel, ``wo`` row-parallel; the MoE's
routed fractions are averaged over the data axis, as the global batch's
(``distributed/tensor_parallel.py``).  The MoE reads its layout from its
weights' shapes (:func:`moe_split`): its experts split over the model axis
(EP), or every expert whole with its ``d_ff`` split (FF, where the experts
do not divide the axis).  The routing runs replicated on every rank, each
rank runs its experts or its ``d_ff`` columns on the tokens dispatched to
them, and the ranks' partial outputs are summed once, after the combine.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.distributed import tensor_parallel as tp
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
    axis = tp.split_axis(p["wi_gate"].shape[1], cfg.d_ff)
    if axis is not None:
        x = tp.copy_in(x, axis)
    g = x @ p["wi_gate"].to(x.dtype)
    u = x @ p["wi_up"].to(x.dtype)
    if axis is not None:
        return tp.row_parallel(act(g) * u, p["wo"], axis)
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


class MoESplit(NamedTuple):
    """An MoE layer's place on the model axis: the axis its experts or
    their ``d_ff`` are split over (None where they are whole), the first
    of this rank's experts and their count (all ``E`` under FF), and the
    axis the router's experts are split over (or None)."""
    axis: tp.Axis | None
    first: int
    count: int
    router: tp.Axis | None


def moe_split(p, cfg: ArchConfig) -> MoESplit:
    """The layout of an MoE layer's weights, from their shapes
    (``tensor_parallel.split_axis``): ``wi_gate`` (E, d, f) holding fewer
    than ``E`` experts is EP, fewer than ``d_ff`` columns FF; a router
    (d, E) holding fewer than ``E`` columns is split over the experts.  A
    split outside a mesh of that split raises, as does a layout the three
    expert weights do not share or one that splits both experts and
    columns (the rules use a mesh axis once a tensor)."""
    e, f, d = cfg.num_experts, cfg.d_ff, cfg.d_model
    n, _, nf = p["wi_gate"].shape
    ep, ff = tp.split_axis(n, e), tp.split_axis(nf, f)
    router = tp.split_axis(p["router"].shape[1], e)
    if (ep is not None and ff is not None) or tuple(p["wi_up"].shape) != (
            n, d, nf) or tuple(p["wo"].shape) != (n, nf, d):
        raise ValueError(
            f"MoE weights wi_gate {tuple(p['wi_gate'].shape)}, wi_up "
            f"{tuple(p['wi_up'].shape)}, wo {tuple(p['wo'].shape)}: the "
            "three must share one split, over the experts or over d_ff")
    return MoESplit(ep or ff, ep.rank * n if ep is not None else 0, n,
                    router)


def moe(p, x: torch.Tensor, cfg: ArchConfig,
        group_size: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out, aux_loss).  x: (B, S, D).

    Grouped GShard dispatch: the tokens are split into groups of
    ``group_size`` (the last one zero-padded) and each group routes on its
    own with per-expert capacity ``capacity(g)``; queue positions come from
    a cumsum over the flattened (token, slot) axis and tokens over capacity
    are dropped.  The (G, g, E, C) dispatch and combine tensors carry exact
    0/1 values (and the gate rounded once) in the activation type.

    Split over the model axis (:func:`moe_split`, the Megatron pattern of
    ``distributed/tensor_parallel.py``): a router split over the experts is
    gathered whole (``gather_weight``), so every rank routes as one device
    does, on the whole one-hot (queue positions, ``keep``, the aux loss);
    the dispatch and combine are then narrowed to the rank's experts (EP;
    the positions are per expert, so narrowing after the cumsum is exact)
    or kept whole (FF).  ``xg`` and the gates enter the experts' region
    through ``copy_in``; the rank's partial output (G, g, D), after the
    combine, leaves it through ``reduce_out`` (f32, cast once).  The aux
    loss stays replicated: its gradient is not summed."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    xt = x.reshape(t, d)
    act = activation(cfg.act)
    split = moe_split(p, cfg)
    axis = split.axis

    g = min(group_size or cfg.moe_group_size, t)
    pad = (-t) % g
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    ng = xt.shape[0] // g
    xg = xt.reshape(ng, g, d)

    router = p["router"]
    if split.router is not None:
        router = tp.gather_weight(router, split.router, 1)
    logits = xg.float() @ router.float()                         # (G, g, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, choices = top_k(probs, k)                         # (G, g, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    cap = capacity(g, cfg)
    dd = x.dtype
    lo, n = split.first, split.count
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
        oh = onehot[..., lo:lo + n].to(dd)                       # this rank's
        xe_in, gates = xg, gate_vals
        if axis is not None:
            xe_in, gates = tp.copy_in(xg, axis), tp.copy_in(gate_vals, axis)
        # sum over k of exact 0/1 products with at most one non-zero term
        dispatch = torch.einsum("Ggke,Ggkc->Ggec", oh, pos_oh.to(dd))
        # the reference's three-operand einsum in two steps: each (e, c) of a
        # token holds one choice, so its gate is picked exactly, then scaled
        # by the exact 0/1 dispatch value
        gate_e = (gates.to(dd)[..., None] * oh).sum(2)           # (G, g, E)
        combine = dispatch * gate_e[..., None]                   # (G, g, E, C)
        xe = torch.einsum("Ggec,Ggd->Gecd", dispatch, xe_in)

    gg = torch.einsum("Gecd,edf->Gecf", xe, p["wi_gate"].to(dd))
    uu = torch.einsum("Gecd,edf->Gecf", xe, p["wi_up"].to(dd))
    ye = torch.einsum("Gecf,efd->Gecd", act(gg) * uu, p["wo"].to(dd))
    with torch.profiler.record_function(MOE_DISPATCH):
        if axis is None:
            out = torch.einsum("Ggec,Gecd->Ggd", combine, ye)
        else:       # the rank's experts' or d_ff columns' share, summed
            out = tp.reduce_out(torch.einsum(
                "Ggec,Gecd->Ggd", combine.float(), ye.float()), axis).to(dd)
    out = out.reshape(-1, d)[:t].reshape(b, s, d)

    # load-balance aux loss (Switch): E * sum_e f_e * P_e / k
    f_e = onehot.sum(2).mean(dim=(0, 1))                        # fraction routed
    data = tp.data_axis()
    if data is not None:      # the global batch's fractions (no gradient)
        f_e = tp.mean_over_data(f_e, data)
    p_e = probs.mean(dim=(0, 1))
    aux = e * (f_e * p_e).sum() / k
    return out, aux.float()
