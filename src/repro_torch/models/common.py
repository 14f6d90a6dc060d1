"""Shared model components (port of ``repro.models.common``): RMSNorm and
LayerNorm, activations, rotary embeddings (RoPE and M-RoPE), sinusoidal
positions and the token embedding.  Plain functions on tensors.
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


def layernorm_specs(dim: int) -> dict[str, Spec]:
    return {"scale": Spec((dim,), (None,), init="ones", dtype="float32"),
            "bias": Spec((dim,), (None,), init="zeros", dtype="float32")}


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(x.dtype)


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


def _freqs(half: int, theta: float, device) -> torch.Tensor:
    """theta ** (-arange(half) / half) in f32, as the JAX package builds it."""
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device),
                     exps)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., S) int -> cos/sin of shape (..., S, head_dim//2)."""
    freqs = _freqs(head_dim // 2, theta, positions.device)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: tuple[int, int, int]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL multimodal RoPE.  positions: (3, B, S) (the t/h/w
    components) -> cos/sin (B, S, head_dim//2), where frequency slot f takes
    its position component from the section it falls in."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} must sum to head_dim "
                         f"// 2 = {half}")
    freqs = _freqs(half, theta, positions.device)
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=positions.device)
    chosen = positions.float()[sec_id]                            # (half, B, S)
    ang = chosen.permute(1, 2, 0) * freqs                         # (B, S, half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D//2), broadcast over heads.
    Rotates the two halves (llama convention)."""
    half = x.shape[-1] // 2
    c, s = cos[:, :, None, :].float(), sin[:, :, None, :].float()
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def sinusoidal_positions(seq: int, dim: int, offset=0,
                         device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal table: (seq, dim), float32."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None] \
        + offset
    half = dim // 2
    exps = -torch.arange(half, dtype=torch.float32, device=device) \
        / max(half - 1, 1)
    inv = torch.pow(torch.tensor(10_000.0, dtype=torch.float32, device=device),
                    exps)
    ang = pos * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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
