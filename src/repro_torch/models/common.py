"""Shared model components (port of ``repro.models.common``): RMSNorm,
activations, rotary embeddings and the token embedding.  Plain functions on
tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import Spec


def rmsnorm_spec(dim: int) -> Spec:
    return Spec((dim,), (None,), init="ones", dtype="float32")


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu,
            "relu2": lambda x: torch.square(F.relu(x))}[name]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)`` everywhere
    (``F.softplus`` turns linear above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., S) int -> cos/sin of shape (..., S, head_dim//2)."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D//2), broadcast over heads.
    Rotates the two halves (llama convention)."""
    half = x.shape[-1] // 2
    c, s = cos[:, :, None, :].float(), sin[:, :, None, :].float()
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def embed_spec(vocab: int, dim: int) -> Spec:
    return Spec((vocab, dim), ("vocab", "fsdp"), init="embed", scale=0.02)


def embed(table: torch.Tensor, tokens: torch.Tensor,
          compute_dtype: torch.dtype) -> torch.Tensor:
    # gather, then cast: the same values as casting the table first
    return table[tokens].to(compute_dtype)


def unembed(table_or_w: torch.Tensor, x: torch.Tensor, *,
            tied: bool) -> torch.Tensor:
    """Logits in fp32.  f32 weights take the f32 product.  bf16 weights are
    multiplied with bf16 activations and summed in f32: each bf16 product is
    exact in f32, so that is the f32 product of the bf16 values."""
    w = table_or_w
    xq = x.to(torch.bfloat16) if w.dtype == torch.bfloat16 else x
    xf, wf = xq.float(), w.float()
    return xf @ (wf.T if tied else wf)
