"""RWKV-6 "Finch" block [arXiv:2404.05892]: attention-free, data-dependent
decay; port of ``repro.models.rwkv6``.

Time-mix (per head h, head_dim n):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (S: (n, n) per head)
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with data-dependent per-channel decay  w_t = exp(-exp(w0 + lora_w(x_mix))) and
the token-shift data-dependent interpolation (ddlerp) of RWKV-6.  GroupNorm
per head on the output, silu(gate) multiplicative gate.

Channel-mix: out = sigmoid(x_r W_r) ⊙ (relu(x_k W_k)^2 W_v).

The token shift is a radius-1 one-sided sequence stencil; the WKV recurrence
is a plain loop over the sequence on a (B, H, n, n) f32 state, as the
reference's ``lax.scan`` is (no Pallas kernel there).  On meta tensors (the
dry run) the loop runs its first step alone, as a cost analysis counts a
scan's body once (:func:`_wkv_scan`).  Decode carries (shift_tm, shift_cm,
S).

Under ``mesh_context``, with ``wr``'s columns split over the model axis
(the rules' "mlp"; ``u`` split over "heads"), the time mix runs h/M whole
heads a rank: the token shift, the ddlerp and the decay's LoRA run
replicated, the decay only for the rank's heads' columns, ``r``/``k``/``v``
/``g`` column-parallel, the recurrence and the per-head group norm on the
rank's heads (its slice of the state ``S``), ``wo`` row-parallel.  A split
of ``wr``'s columns that cuts heads (M divides d_model but not the heads)
raises.  The channel mix's halves split on their own, each read from its
weights' shapes: the value half over ``d_ff`` (``cm_wk`` columns, ``cm_wv``
rows, its output summed over the ranks), the receptance over d_model
(``cm_wr`` columns, gathered whole for the product with the value).  Only
the mixed inputs of a split half enter its split region
(``distributed/tensor_parallel.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.params import Spec

_LORA_TM = 32      # ddlerp lora rank (5 projections)
_LORA_W = 64       # decay lora rank


def rwkv_specs(cfg: ArchConfig) -> dict[str, Spec]:
    d = cfg.d_model
    f = cfg.d_ff
    h = cfg.num_heads
    n = cfg.resolved_head_dim
    if h * n != d:
        raise ValueError(f"rwkv heads*head_dim ({h}*{n}) must equal d_model "
                         f"({d})")
    return {
        # time-mix ddlerp
        "mu_x": Spec((d,), (None,), init="zeros"),
        "mu": Spec((5, d), (None, None), init="zeros"),        # w,k,v,r,g
        "tm_w1": Spec((d, 5 * _LORA_TM), ("fsdp", None), scale=0.1),
        "tm_w2": Spec((5, _LORA_TM, d), (None, None, "fsdp"), scale=0.1),
        # decay
        "w0": Spec((d,), (None,), init="normal", scale=1.0),
        "w_lora1": Spec((d, _LORA_W), ("fsdp", None), scale=0.1),
        "w_lora2": Spec((_LORA_W, d), (None, "fsdp"), scale=0.1),
        "u": Spec((h, n), ("heads", "head_dim"), init="normal", scale=0.5),
        # projections
        "wr": Spec((d, d), ("fsdp", "mlp")),
        "wk": Spec((d, d), ("fsdp", "mlp")),
        "wv": Spec((d, d), ("fsdp", "mlp")),
        "wg": Spec((d, d), ("fsdp", "mlp")),
        "wo": Spec((d, d), ("mlp", "fsdp")),
        "ln_x_scale": Spec((d,), (None,), init="ones", dtype="float32"),
        # channel-mix
        "cm_mu_k": Spec((d,), (None,), init="zeros"),
        "cm_mu_r": Spec((d,), (None,), init="zeros"),
        "cm_wk": Spec((d, f), ("fsdp", "mlp")),
        "cm_wv": Spec((f, d), ("mlp", "fsdp")),
        "cm_wr": Spec((d, d), ("fsdp", "mlp")),
    }


class RWKVState(NamedTuple):
    shift_tm: torch.Tensor    # (B, D) previous token (time-mix)
    shift_cm: torch.Tensor    # (B, D) previous token (channel-mix)
    s: torch.Tensor           # (B, H, n, n) WKV state (fp32)


def _f32_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum(a.astype(w.dtype), w, preferred_element_type=f32)``: ``a``
    rounded to the weight's type, the product summed and returned in f32
    (a bf16 product is exact in f32)."""
    return a.to(w.dtype).float() @ w.float()


def _ddlerp(p, x: torch.Tensor, xx: torch.Tensor) -> list[torch.Tensor]:
    """RWKV6 data-dependent token-shift interpolation.
    x, xx: (B, S, D); returns 5 mixed streams (w, k, v, r, g), f32."""
    xf = x.float()
    dxf = xx.float() - xf
    base = xf + dxf * p["mu_x"]
    lora = torch.tanh(base @ p["tm_w1"].float())
    lora = lora.unflatten(-1, (5, _LORA_TM))                    # (B, S, 5, r)
    adj = torch.einsum("bsir,ird->bsid", lora, p["tm_w2"].float())
    mixed = xf[:, :, None, :] + dxf[:, :, None, :] * (p["mu"] + adj)
    return [mixed[:, :, i, :] for i in range(5)]                # each (B,S,D)


def _decay(p, xw: torch.Tensor, axis: tp.Axis | None = None) -> torch.Tensor:
    """w_t in (0, 1): exp(-exp(w0 + lora)); xw: (B, S, D) f32.  With
    ``axis``: only this rank's heads' columns of ``w0`` and ``w_lora2``."""
    lora = torch.tanh(xw) @ p["w_lora1"].float()
    w0, w2 = p["w0"], p["w_lora2"]
    if axis is not None:
        w0, w2 = tp.local_slice(w0, axis), tp.local_slice(w2, axis)
    ww = w0 + lora @ w2.float()
    return torch.exp(-torch.exp(ww.clamp(-30.0, 20.0)))


def _wkv_scan(r, k, v, w, u, s0) -> tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: (B, S, H, n) f32; u: (H, n); s0: (B, H, n, n).
    Returns o: (B, S, H, n) and the final state: one step per token.

    On meta tensors one step runs alone, its output read from the state
    it updated, so that every input, the decay too, stays in the autograd
    graph and the products upstream keep their backward (a later step's
    output reads the decay through the state): ``o`` is that output
    expanded over the sequence and the state is that step's.  A cost count
    on meta sees the step once, as XLA counts a ``lax.scan`` body, and the
    dry run adds the other S - 1 steps analytically
    (``launch.dryrun._wkv_analytic_flops``)."""
    uu = u[None, :, :, None]
    if r.is_meta:
        kv = k[:, 0, ..., :, None] * v[:, 0, ..., None, :]
        s = w[:, 0, ..., None] * s0 + kv
        o = torch.einsum("bhi,bhij->bhj", r[:, 0], s + uu * kv)
        return o[:, None].expand(-1, r.shape[1], -1, -1), s
    s = s0
    outs = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]  # (B, H, n)
        kv = k_t[..., :, None] * v_t[..., None, :]               # (B,H,n,n)
        outs.append(torch.einsum("bhi,bhij->bhj", r_t, s + uu * kv))
        s = w_t[..., None] * s + kv
    return torch.stack(outs, dim=1), s


def _head_axis(p, cfg: ArchConfig) -> tp.Axis | None:
    """The model axis where the time mix's heads are split (``wr``'s
    columns, with ``u``'s heads), else None.  ``wr``'s columns split
    without ``u``'s heads cut heads in two: the recurrence and the group
    norm need whole heads, so that raises."""
    axis = tp.split_axis(p["wr"].shape[1], cfg.d_model)
    if axis is not None and tp.split_axis(p["u"].shape[0],
                                          cfg.num_heads) is None:
        raise ValueError(
            f"rwkv: a model axis of {axis.size} ranks splits d_model "
            f"{cfg.d_model} but not its {cfg.num_heads} heads of "
            f"{cfg.resolved_head_dim}: a rank would hold part of a head; "
            "pick a model axis that divides the heads")
    return axis


def rwkv_time_mix(p, x: torch.Tensor, cfg: ArchConfig, *,
                  shift: torch.Tensor | None = None,
                  s0: torch.Tensor | None = None):
    """x: (B, S, D) -> (out, (the last token, the final WKV state)).  With
    the heads split over the model axis (see the module's docstring),
    ``s0`` and the returned state hold this rank's heads."""
    b, s, d = x.shape
    h, n = cfg.num_heads, cfg.resolved_head_dim
    last = x[:, -1, :]
    axis = _head_axis(p, cfg)
    if axis is not None:
        x = tp.copy_in(x, axis)
        p = tp.enter(p, rwkv_specs(cfg), axis)
        h //= axis.size
    prev = (torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
            if shift is None else shift[:, None, :])
    xx = torch.cat([prev, x[:, :-1, :]], dim=1)                 # token shift
    xw, xk, xv, xr, xg = _ddlerp(p, x, xx)

    w = _decay(p, xw, axis)                                     # (B, S, hn)
    r = _f32_product(xr, p["wr"])
    k = _f32_product(xk, p["wk"])
    v = _f32_product(xv, p["wv"])
    g = _f32_product(xg, p["wg"])

    s_init = (torch.zeros((b, h, n, n), dtype=torch.float32, device=x.device)
              if s0 is None else s0)
    o, s_fin = _wkv_scan(*(a.reshape(b, s, h, n) for a in (r, k, v, w)),
                         p["u"].float(), s_init)

    # per-head groupnorm
    scale = p["ln_x_scale"] if axis is None else tp.local_slice(
        p["ln_x_scale"], axis)
    mu = o.mean(dim=-1, keepdim=True)
    var = o.var(dim=-1, keepdim=True, unbiased=False)
    o = ((o - mu) * torch.rsqrt(var + 64e-5)).reshape(b, s, h * n) * scale
    out = (o * F.silu(g)).to(x.dtype)
    if axis is not None:
        return tp.row_parallel(out, p["wo"], axis), (last, s_fin)
    return out @ p["wo"].to(x.dtype), (last, s_fin)


def rwkv_channel_mix(p, x: torch.Tensor, cfg: ArchConfig, *,
                     shift: torch.Tensor | None = None):
    """x: (B, S, D) -> (out, the last token).  ``cfg`` gives the whole
    ``d_ff``, against which a split of the value half is read."""
    b, s, d = x.shape
    ff = tp.split_axis(p["cm_wk"].shape[1], cfg.d_ff)
    dr = tp.split_axis(p["cm_wr"].shape[1], d)
    prev = (torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
            if shift is None else shift[:, None, :])
    xx = torch.cat([prev, x[:, :-1, :]], dim=1)
    # the difference in the activation type, then f32, as the reference
    xf, dxf = x.float(), (xx - x).float()
    xk = xf + dxf * p["cm_mu_k"]
    xr = xf + dxf * p["cm_mu_r"]
    if ff is not None:
        xk = tp.copy_in(xk, ff)
    if dr is not None:
        xr = tp.copy_in(xr, dr)
    kk = torch.square(F.relu(_f32_product(xk, p["cm_wk"])))
    vv = _f32_product(kk, p["cm_wv"])
    if ff is not None:
        vv = tp.reduce_out(vv, ff)
    rr = torch.sigmoid(_f32_product(xr, p["cm_wr"]))
    if dr is not None:
        rr = tp.gather_weight(rr, dr, -1)
    return (rr * vv).to(x.dtype), x[:, -1, :]


def rwkv_init_state(batch: int, cfg: ArchConfig, dtype: torch.dtype,
                    device=None) -> RWKVState:
    d, h, n = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    return RWKVState(
        shift_tm=torch.zeros((batch, d), dtype=dtype, device=device),
        shift_cm=torch.zeros((batch, d), dtype=dtype, device=device),
        s=torch.zeros((batch, h, n, n), dtype=torch.float32, device=device))
