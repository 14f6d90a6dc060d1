"""Public entry point for depthwise causal conv1d.

``backend="auto"`` follows the tensor: on a CUDA tensor it launches K5 once,
with the bias fused: added in float32 after the kernel's cast to
``x.dtype`` and rounded again (as the JAX package's Pallas path adds it); on
a CPU tensor it runs the plain version, which adds the bias before its
single cast (as the JAX package's XLA path does).  ``backend="cuda"`` raises
on a CPU tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv1d.kernel import conv1d_kernel
from repro_torch.kernels.conv1d.ref import conv1d_ref


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor | None = None, *,
                  backend: str = "auto") -> torch.Tensor:
    """x: (B, S, C); w: (K, C); optional bias (C,)."""
    _build.check_backend(backend, x)
    if x.device.type == "cpu":
        _build.check_grid(x, 3, "conv1d")
        return conv1d_ref(x, w, b)
    return conv1d_kernel(x.contiguous(), w, b)
