"""Public entry point for sliding-window attention: backend dispatch,
differentiable.

``backend="auto"`` follows the tensor: on a CUDA tensor it launches K6,
which masks by the true length, so nothing is padded; on a CPU tensor it runs
the plain versions with the JAX package's switch between the dense and the
chunked formulation.  ``backend="cuda"`` raises on a CPU tensor.

The op is one ``torch.autograd.Function``: on CUDA tensors its backward
launches K6's backward kernels (:func:`swa_bwd_kernel`, which recompute the
rows' log-sum-exp from q and k, so the tuned forward keeps no extra
output); on CPU tensors it is the vector-Jacobian product of the plain
version the forward ran (:func:`swa_bwd_ref` of :func:`swa_plain`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.swa.kernel import swa_bwd_kernel, swa_kernel
from repro_torch.kernels.swa.ref import swa_bwd_ref, swa_ref, swa_ref_chunked

# beyond this many positions the dense (S x S) mask path is replaced by the
# strip-mined chunked path (linear memory in S).
CHUNKED_THRESHOLD = 4096


def swa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: int) -> torch.Tensor:
    """The plain versions as the JAX package's XLA path picks them."""
    s = q.shape[2]
    if s > CHUNKED_THRESHOLD or (s > 2 * window and s > 1024):
        return swa_ref_chunked(q, k, v, window=window)
    return swa_ref(q, k, v, window=window)


class SlidingWindowAttention(torch.autograd.Function):
    """out = swa(q, k, v); kernels forward and backward on CUDA tensors, the
    plain versions on CPU ones."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        if q.device.type == "cpu":
            out = swa_plain(q, k, v, window=window)
        else:
            out = swa_kernel(q, k, v, window=window)
        ctx.window = window
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = swa_bwd_ref(q, k, v, dout, window=ctx.window,
                                forward=swa_plain)
        else:
            grads = swa_bwd_kernel(q, k, v, out, dout, window=ctx.window)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)


def sliding_window_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, window: int,
                             backend: str = "auto") -> torch.Tensor:
    """Causal local attention. q: (B, Hq, S, D); k/v: (B, Hkv, S, D), in
    any memory layout (the kernel reads them through their strides)."""
    _build.check_backend(backend, q)
    if q.device.type == "cpu":
        _build.check_grid(q, 4, "swa")
    return SlidingWindowAttention.apply(q, k, v, window)
