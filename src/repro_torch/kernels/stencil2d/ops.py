"""Public entry point for the 2D stencil: planning and backend dispatch
(the same contract as ``stencil1d/ops.py``, over the last two axes).  A
call is the span ``stencil2d``, its planning ``stencil2d.plan``
(``repro_torch.telemetry.host``)."""
from __future__ import annotations

import torch

from repro_torch.core.spec import StencilSpec
from repro_torch.kernels import _build
from repro_torch.kernels.stencil2d.kernel import smem_bytes, stencil2d_kernel
from repro_torch.telemetry import host

MAX_BLOCK_Y = 128     # the tile grows to 128 x 128 outputs at most
MAX_BLOCK_X = 128


def plan_2d_blocks(ny: int, nx: int, ry: int, rx: int, timesteps: int,
                   smem_budget: int = _build.H100_SMEM_PER_BLOCK
                   ) -> tuple[int, int]:
    """(block_y, block_x) under a shared-memory budget per thread block
    (on the card: its opt-in limit, ``_build.smem_per_block``).

    Starts from an 8 x 32 tile and doubles x (to 128), then y (to 128),
    while the haloed workspace fits and the grid still needs the room: the
    larger the tile, the smaller the share of halo it reads (at r = 12 and
    T = 1, 1.48x the outputs at 128 x 128 against 2.08x at 32 x 128).
    At T = 1 and r = 12 the 128 x 128 tile takes 97,280 B, so two blocks
    share an SM.  Raises ValueError when not even the 8 x 32 tile fits: the
    halo ``(ry·T, rx·T)`` is then too wide for one block."""
    by, bx = 8, 32

    def fits(by_: int, bx_: int) -> bool:
        return smem_bytes(ry, rx, timesteps, by_, bx_) <= smem_budget

    if not fits(by, bx):
        raise ValueError(
            f"an 8 x 32 tile of the 2D stencil at r=({ry}, {rx}), "
            f"T={timesteps} needs {smem_bytes(ry, rx, timesteps, by, bx)} B of "
            f"shared memory; the budget is {smem_budget} B")
    while bx < min(nx, MAX_BLOCK_X) and fits(by, bx * 2):
        bx *= 2
    while by < min(ny, MAX_BLOCK_Y) and fits(by * 2, bx):
        by *= 2
    return by, bx


def stencil2d(x: torch.Tensor, cy: tuple[float, ...], cx: tuple[float, ...], *,
              timesteps: int = 1, backend: str = "auto",
              block: tuple[int, int] | None = None) -> torch.Tensor:
    """Batched 2D star stencil over the last two axes (y=-2, x=-1).  On the
    card the radius of each axis is at most 63 (the kernel's tap struct)."""
    with host.span("stencil2d"):
        with host.span("stencil2d.plan"):
            cy = tuple(float(c) for c in cy)
            cx = tuple(float(c) for c in cx)
            _build.check_backend(backend, x)
            ry, rx = (len(cy) - 1) // 2, (len(cx) - 1) // 2
            ny, nx = x.shape[-2:]
            xb = x.reshape(-1, ny, nx).contiguous()
            if block is None and xb.is_cuda:
                block = plan_2d_blocks(ny, nx, ry, rx, timesteps,
                                       _build.smem_per_block(xb.device))
        y = stencil2d_kernel(xb, cy, cx, timesteps=timesteps, block=block)
        return y.reshape(x.shape)


def stencil2d_from_spec(x: torch.Tensor, spec: StencilSpec, **kw) -> torch.Tensor:
    if spec.ndim != 2:
        raise ValueError(f"stencil2d_from_spec needs a 2D spec, got {spec.ndim}D")
    return stencil2d(x, spec.coeffs[0], spec.coeffs[1],
                     timesteps=spec.timesteps, **kw)
