"""Public entry point for depthwise causal conv1d, differentiable.

``backend="auto"`` follows the tensor: on a CUDA tensor it launches K5 once,
with the bias fused: added in float32 after the kernel's cast to
``x.dtype`` and rounded again (as the JAX package's Pallas path adds it); on
a CPU tensor it runs the plain version, which adds the bias before its
single cast (as the JAX package's XLA path does).  ``backend="cuda"`` raises
on a CPU tensor.

The op is one ``torch.autograd.Function``.  On CUDA tensors its backward
is one launch of K5's backward (:func:`conv1d_bwd`), which gives dx, dw and
db in one pass over x and dy, each only where autograd needs it; dx has the
bits of K5 on the time-reversed gradient (the causal conv's transpose).
On CPU tensors forward and backward run the plain versions
(:func:`conv1d_ref` and its vector-Jacobian product
:func:`conv1d_bwd_ref`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv1d.kernel import conv1d_bwd, conv1d_kernel
from repro_torch.kernels.conv1d.ref import conv1d_bwd_ref, conv1d_ref


class CausalConv1d(torch.autograd.Function):
    """y = causal_conv1d(x, w, b); kernels forward and backward on CUDA
    tensors, the plain versions on CPU ones."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        if x.device.type == "cpu":
            return conv1d_ref(x, w, b)
        return conv1d_kernel(x.contiguous(), w, b)

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        if x.device.type == "cpu":
            dx, dw, db = conv1d_bwd_ref(x, w, b, dy)
        else:
            dx, dw, db = conv1d_bwd(x, dy, w, b, need_x=need_x,
                                    need_wb=need_w or need_b)
        return (dx if need_x else None, dw if need_w else None,
                db if need_b else None)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor | None = None, *,
                  backend: str = "auto") -> torch.Tensor:
    """x: (B, S, C); w: (K, C); optional bias (C,)."""
    _build.check_backend(backend, x)
    if x.device.type == "cpu":
        _build.check_grid(x, 3, "conv1d")
    return CausalConv1d.apply(x, w, b)
