"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

Mirrors the JAX package's layout module by module; imports neither jax nor
``repro``.  Ported so far: the stencil main path — ``core.spec``, the torch
oracles in ``core.reference``, ``core.mapping.plan_blocks`` and the
``stencil1d``/``stencil2d``/``stencil3d`` kernels.
"""
