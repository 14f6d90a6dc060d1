"""Torch oracle for depthwise *causal* 1D convolution (port of
``repro.kernels.conv1d.ref``), and the plain version the K5 wrapper runs on
CPU tensors.

``y[b, s, c] = sum_k w[k, c] * x[b, s - K + 1 + k, c]`` (left zero padding),
optionally + bias, summed in float32 in tap order and cast to ``x.dtype``
once, after the bias.  This is a radius-(K-1) one-sided sequence stencil with
learned per-channel taps: the temporal conv of Griffin's recurrent block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def conv1d_ref(x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor | None = None) -> torch.Tensor:
    """x: (B, S, C); w: (K, C); b: (C,) or None."""
    kk, s = w.shape[0], x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(kk):
        shift = kk - 1 - k          # tap k reads x[s - shift]
        xs = F.pad(x, (0, 0, shift, 0))[:, :s, :]
        out = out + xs.float() * w[k][None, None, :].float()
    if b is not None:
        out = out + b[None, None, :].float()
    return out.to(x.dtype)


def conv1d_bwd_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                   dy: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """(dx, dw, db): the vector-Jacobian product of :func:`conv1d_ref` at
    (x, w, b) with ``dy``, taken by ``torch.autograd``, each in its input's
    type (db None without a bias)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, w)]
        if b is not None:
            leaves.append(b.detach().requires_grad_())
        y = conv1d_ref(*leaves)
        grads = torch.autograd.grad(y, leaves, dy)
    return grads[0], grads[1], grads[2] if b is not None else None
