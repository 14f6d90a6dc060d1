"""Canonical stencil programs (shared by tests, benchmarks, and examples)."""
from __future__ import annotations

from repro_torch.core.spec import StencilSpec, heat_2d
from repro_torch.program.ir import CombineOp, StencilOp, StencilProgram


def two_stage_heat(ny: int, nx: int, alpha: float = 0.1,
                   dtype: str = "float64") -> StencilProgram:
    """``heat_2d ∘ heat_2d``: two dependent 5-pt Jacobi sweeps, fused into
    one spatial pipeline (no store/reload of the intermediate field)."""
    spec = heat_2d(ny, nx, alpha=alpha, dtype=dtype)
    return StencilProgram("two_stage_heat", [
        StencilOp("heat1", spec, input="u", output="u1"),
        StencilOp("heat2", spec, input="u1", output="u2"),
    ])


def laplacian_2d(ny: int, nx: int, dtype: str = "float64") -> StencilSpec:
    """Plain 5-pt laplacian (the hdiff first stage)."""
    return StencilSpec((ny, nx), (1, 1),
                       ((1.0, -4.0, 1.0), (1.0, 0.0, 1.0)), dtype=dtype)


def hdiff_program(ny: int, nx: int, coeff: float = 0.025,
                  dtype: str = "float64") -> StencilProgram:
    """StencilFlow-style horizontal diffusion: laplacian → flux → output.

    ``lap = ∇²(inp)``; ``flx`` is a symmetric flux smoother of ``lap``; the
    output combines the *original* field with the flux — the branch that
    makes ``inp`` fan out into both the deep (2-op) pipeline and the final
    combine, exercising the computed inter-operator skew buffers.
    """
    flux = StencilSpec((ny, nx), (1, 1),
                       ((0.25, 0.0, 0.25), (0.25, 0.0, 0.25)), dtype=dtype)
    return StencilProgram("hdiff", [
        StencilOp("lap", laplacian_2d(ny, nx, dtype), input="inp",
                  output="lap"),
        StencilOp("flx", flux, input="lap", output="flx"),
        CombineOp("out", inputs=("inp", "flx"), coeffs=(1.0, -coeff),
                  output="out"),
    ])
