"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

Mirrors the JAX package's layout module by module; imports neither jax nor
``repro``.  Ported so far: the stencil main path (``core.spec``, the torch
oracles in ``core.reference``, the ``stencil1d``/``stencil2d``/``stencil3d``
kernels), the RecurrentGemma-2B serving path (``kernels.conv1d``,
``kernels.swa``, ``configs``, ``models``, ``serving``, ``launch.serve``),
and the CGRA model as host numpy (``core.roofline``, ``core.temporal``,
``core.dfg``, ``core.mapping``, ``core.engine``, ``core.simulator``,
``fabric``, ``analysis.static_verify``, ``telemetry.probe`` and
``telemetry.attribution``).
"""
