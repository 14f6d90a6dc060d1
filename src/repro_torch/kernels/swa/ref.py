"""Torch oracles for causal sliding-window (local) attention with GQA (port
of ``repro.kernels.swa.ref``); :func:`swa_ref` is also the plain version the
K6 wrapper runs on CPU tensors, :func:`swa_bwd_ref`, its
vector-Jacobian product, the plain version of K6's backward, and
:func:`swa_bwd_fold_ref` the plain version of the backward's fold of
partial sums.

``out[b,h,i] = softmax_j(q_i . k_j / sqrt(D)) @ v`` over keys
``j in (i - window, i]`` (causal, the window includes the current token).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _scale(d: int) -> torch.Tensor:
    return 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))


def swa_ref_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int) -> torch.Tensor:
    """Linear-memory formulation: queries in window-sized chunks, each
    attending to its (chunk + trailing-window) KV band.  The same semantics
    as :func:`swa_ref`; probabilities and P·V run in the input type."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    w = c = window                               # chunk size = window
    pad = (-s) % c
    sp = s + pad
    qp = F.pad(q, (0, 0, 0, pad))
    kp = F.pad(k.repeat_interleave(group, dim=1), (0, 0, w, pad))
    vp = F.pad(v.repeat_interleave(group, dim=1), (0, 0, w, pad))
    scale = _scale(d).to(q.device)
    qpos = torch.arange(c, device=q.device)[:, None]
    kpos = torch.arange(c + w, device=q.device)[None, :]
    outs = []
    for i in range(sp // c):
        qi = qp[:, :, i * c:(i + 1) * c].float() * scale
        kwin = kp[:, :, i * c:i * c + c + w].float()
        vwin = vp[:, :, i * c:i * c + c + w]
        logits = torch.einsum("bhid,bhjd->bhij", qi, kwin)
        qa, ka = i * c + qpos, i * c - w + kpos
        mask = (ka <= qa) & (ka > qa - w) & (ka >= 0) & (ka < s)
        logits = logits.masked_fill(~mask, -math.inf)
        p = torch.softmax(logits, dim=-1)
        p = torch.where(mask.any(-1, keepdim=True), p, 0.0)
        outs.append(torch.einsum("bhij,bhjd->bhid", p.to(q.dtype),
                                 vwin.to(q.dtype)))
    return torch.cat(outs, dim=2)[:, :, :s].to(q.dtype)


def swa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            window: int) -> torch.Tensor:
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D); Hq % Hkv == 0."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhid,bhjd->bhij", q.float(), k.float())
    logits = logits * _scale(d).to(q.device)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = (j <= i) & (j > i - window)
    p = torch.softmax(logits.masked_fill(~mask, -math.inf), dim=-1)
    return torch.einsum("bhij,bhjd->bhid", p, v.float()).to(q.dtype)


def swa_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                dout: torch.Tensor, *, window: int, forward=swa_ref
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): the vector-Jacobian product of ``forward`` (by default
    :func:`swa_ref`) at (q, k, v) with ``dout``, taken by
    ``torch.autograd``, each in its input's type and shape."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = forward(*leaves, window=window)
        return torch.autograd.grad(out, leaves, dout)


def swa_bwd_fold_ref(partial: torch.Tensor, dtype: torch.dtype
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) from f32 partial sums (2, parts, B, Hkv, S, D): the parts
    added in order, one f32 addition at a time, then cast to ``dtype``."""
    acc = partial[:, 0].clone()
    for p in range(1, partial.shape[1]):
        acc += partial[:, p]
    return acc[0].to(dtype), acc[1].to(dtype)
