"""Hand-written CUDA kernels (sm_90a) for the paper's compute hot-spots and
the LM side path (causal conv1d, sliding-window attention).

Each subpackage: ``kernel.py`` (the wrapper that builds, checks and launches
the kernel in ``csrc/``), ``ops.py`` (public entry point with planning and
backend dispatch), ``ref.py`` (the torch oracle, which is also the kernel's
plain version on CPU tensors).  ``_build.py`` compiles ``csrc/*.cu`` with
``nvcc`` at first use and counts launches.
"""
from repro_torch.kernels.conv1d.ops import causal_conv1d
from repro_torch.kernels.stencil1d.ops import stencil1d, stencil1d_from_spec
from repro_torch.kernels.stencil2d.ops import stencil2d, stencil2d_from_spec
from repro_torch.kernels.stencil3d.ops import stencil3d
from repro_torch.kernels.swa.ops import sliding_window_attention

__all__ = ["causal_conv1d", "sliding_window_attention", "stencil1d",
           "stencil1d_from_spec", "stencil2d", "stencil2d_from_spec",
           "stencil3d"]
