"""Griffin RG-LRU recurrent block (recurrentgemma) [arXiv:2402.19427]; port
of ``repro.models.rglru``.

Block structure (the "recurrent block" of Griffin):
    x ->  linear (D -> lru) -> causal conv1d (width 4) -> RG-LRU  \\
    x ->  linear (D -> lru) -> GeLU                                ⊙ -> out proj

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)                 (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)                 (input gate)
    log a_t = -c * softplus(Λ) * r_t             (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t ⊙ x_t)

The prefill path runs the conv through kernel K5 (``kernels/conv1d``) and the
linear recurrence as a log2(S)-step doubling scan; the decode path carries
(conv_state (K-1 tokens), h) per layer.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs import ArchConfig
from repro_torch.kernels.conv1d.ops import causal_conv1d
from repro_torch.models.common import activation, softplus
from repro_torch.models.params import Spec

_C = 8.0


def rglru_specs(cfg: ArchConfig) -> dict[str, Spec]:
    d = cfg.d_model
    w = cfg.lru_width or d
    k = cfg.conv_width
    return {
        "w_in": Spec((d, w), ("fsdp", "mlp")),
        "w_gate_branch": Spec((d, w), ("fsdp", "mlp")),
        "conv_w": Spec((k, w), ("conv_k", "mlp"), scale=1.0),
        "conv_b": Spec((w,), ("mlp",), init="zeros"),
        "wa": Spec((w, w), ("mlp", None), scale=0.5),
        "ba": Spec((w,), (None,), init="zeros"),
        "wx": Spec((w, w), ("mlp", None), scale=0.5),
        "bx": Spec((w,), (None,), init="zeros"),
        "lam": Spec((w,), (None,), init="normal", scale=1.0),
        "w_out": Spec((w, d), ("mlp", "fsdp")),
    }


class RGLRUState(NamedTuple):
    h: torch.Tensor        # (B, W) recurrent state, float32
    conv: torch.Tensor     # (B, K-1, W) trailing inputs for the conv stencil


def _gates(p, xc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """xc: (..., W) post-conv branch -> (log_a, b), both float32 (..., W)."""
    xf = xc.float()
    r = torch.sigmoid(xf @ p["wa"].float() + p["ba"])
    i = torch.sigmoid(xf @ p["wx"].float() + p["bx"])
    log_a = -_C * softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return log_a, b


def rglru_scan(p, xc: torch.Tensor) -> torch.Tensor:
    """xc: (B, S, W) -> h: (B, S, W), h_t = a_t h_{t-1} + b_t from h_{-1} = 0.

    A doubling (Hillis-Steele) scan: step 2^j combines every position with
    the one 2^j before it, ``(la_l, b_l)∘(la_r, b_r) = (la_l + la_r,
    exp(la_r)·b_l + b_r)``, so log2(S) rounds of whole-tensor ops and no loop
    over S.  The log-decay carry stays float32; the additive carry ``b`` rides
    in ``xc.dtype``, as in the JAX package."""
    log_a, b = _gates(p, xc)
    b = b.to(xc.dtype)
    s = xc.shape[1]
    step = 1
    while step < s:
        la_r, b_r = log_a[:, step:], b[:, step:]
        b = torch.cat([b[:, :step],
                       torch.exp(la_r).to(b.dtype) * b[:, :-step] + b_r], 1)
        log_a = torch.cat([log_a[:, :step], log_a[:, :-step] + la_r], 1)
        step *= 2
    return b.to(xc.dtype)


def rglru_block(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Full recurrent block, prefill path. x: (B, S, D)."""
    gelu = activation("gelu")
    branch = x @ p["w_in"].to(x.dtype)
    gate = x @ p["w_gate_branch"].to(x.dtype)
    xc = causal_conv1d(branch, p["conv_w"].to(x.dtype),
                       p["conv_b"].to(x.dtype))
    h = rglru_scan(p, xc)
    y = h * gelu(gate.float()).to(x.dtype)
    return y @ p["w_out"].to(x.dtype)


def rglru_decode(p, x: torch.Tensor, state: RGLRUState,
                 cfg: ArchConfig) -> tuple[torch.Tensor, RGLRUState]:
    """Single-token decode. x: (B, 1, D)."""
    gelu = activation("gelu")
    branch = (x @ p["w_in"].to(x.dtype))[:, 0]
    gate = (x @ p["w_gate_branch"].to(x.dtype))[:, 0]
    win = torch.cat([state.conv, branch[:, None, :]], dim=1)      # (B, K, W)
    xc = torch.einsum("bkw,kw->bw", win, p["conv_w"].to(x.dtype)) \
        + p["conv_b"].to(x.dtype)
    log_a, b = _gates(p, xc)
    h = torch.exp(log_a) * state.h.float() + b
    y = h.to(x.dtype) * gelu(gate.float()).to(x.dtype)
    out = (y @ p["w_out"].to(x.dtype))[:, None, :]
    return out, RGLRUState(h=h.to(state.h.dtype), conv=win[:, 1:, :])


def rglru_init_state(batch: int, cfg: ArchConfig, dtype: torch.dtype,
                     device=None) -> RGLRUState:
    w = cfg.lru_width or cfg.d_model
    return RGLRUState(
        h=torch.zeros((batch, w), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                         device=device))
