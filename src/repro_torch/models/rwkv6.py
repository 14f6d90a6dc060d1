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
reference's ``lax.scan`` is (no Pallas kernel there).  Decode carries
(shift_tm, shift_cm, S).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
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


def _decay(p, xw: torch.Tensor) -> torch.Tensor:
    """w_t in (0, 1): exp(-exp(w0 + lora)); xw: (B, S, D) f32."""
    lora = torch.tanh(xw) @ p["w_lora1"].float()
    ww = p["w0"] + lora @ p["w_lora2"].float()
    return torch.exp(-torch.exp(ww.clamp(-30.0, 20.0)))


def _wkv_scan(r, k, v, w, u, s0) -> tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: (B, S, H, n) f32; u: (H, n); s0: (B, H, n, n).
    Returns o: (B, S, H, n) and the final state: one step per token."""
    s = s0
    outs = []
    uu = u[None, :, :, None]
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]  # (B, H, n)
        kv = k_t[..., :, None] * v_t[..., None, :]               # (B,H,n,n)
        outs.append(torch.einsum("bhi,bhij->bhj", r_t, s + uu * kv))
        s = w_t[..., None] * s + kv
    return torch.stack(outs, dim=1), s


def rwkv_time_mix(p, x: torch.Tensor, cfg: ArchConfig, *,
                  shift: torch.Tensor | None = None,
                  s0: torch.Tensor | None = None):
    """x: (B, S, D) -> (out, (the last token, the final WKV state))."""
    b, s, d = x.shape
    h, n = cfg.num_heads, cfg.resolved_head_dim
    prev = (torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
            if shift is None else shift[:, None, :])
    xx = torch.cat([prev, x[:, :-1, :]], dim=1)                 # token shift
    xw, xk, xv, xr, xg = _ddlerp(p, x, xx)

    w = _decay(p, xw)                                           # (B, S, D)
    r = _f32_product(xr, p["wr"])
    k = _f32_product(xk, p["wk"])
    v = _f32_product(xv, p["wv"])
    g = _f32_product(xg, p["wg"])

    s_init = (torch.zeros((b, h, n, n), dtype=torch.float32, device=x.device)
              if s0 is None else s0)
    o, s_fin = _wkv_scan(*(a.reshape(b, s, h, n) for a in (r, k, v, w)),
                         p["u"].float(), s_init)

    # per-head groupnorm
    mu = o.mean(dim=-1, keepdim=True)
    var = o.var(dim=-1, keepdim=True, unbiased=False)
    o = ((o - mu) * torch.rsqrt(var + 64e-5)).reshape(b, s, d) \
        * p["ln_x_scale"]
    out = (o * F.silu(g)).to(x.dtype)
    out = out @ p["wo"].to(x.dtype)
    return out, (x[:, -1, :], s_fin)


def rwkv_channel_mix(p, x: torch.Tensor, *,
                     shift: torch.Tensor | None = None):
    b, s, d = x.shape
    prev = (torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
            if shift is None else shift[:, None, :])
    xx = torch.cat([prev, x[:, :-1, :]], dim=1)
    # the difference in the activation type, then f32, as the reference
    xf, dxf = x.float(), (xx - x).float()
    xk = xf + dxf * p["cm_mu_k"]
    xr = xf + dxf * p["cm_mu_r"]
    kk = torch.square(F.relu(_f32_product(xk, p["cm_wk"])))
    vv = _f32_product(kk, p["cm_wv"])
    rr = torch.sigmoid(_f32_product(xr, p["cm_wr"]))
    return (rr * vv).to(x.dtype), x[:, -1, :]


def rwkv_init_state(batch: int, cfg: ArchConfig, dtype: torch.dtype,
                    device=None) -> RWKVState:
    d, h, n = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    return RWKVState(
        shift_tm=torch.zeros((batch, d), dtype=dtype, device=device),
        shift_cm=torch.zeros((batch, d), dtype=dtype, device=device),
        s=torch.zeros((batch, h, n, n), dtype=torch.float32, device=device))
