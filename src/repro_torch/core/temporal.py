"""Temporal-locality planner (paper §IV, implemented beyond the paper),
carried over from ``repro.core.temporal``.

Fusing T time-steps multiplies arithmetic intensity ~T× (one grid read + one
write amortized over T sweeps) at the cost of:
  * T x the arithmetic PEs (CGRA) / T x the per-block compute (GPU),
  * halo growth: a block of interior size B needs B + 2*T*r input points,
  * redundant flops at block seams ~ proportional to T^2 * r / B
    (the classic overlapped-trapezoid overhead).

``fusion_report`` finds the smallest T at which the stencil crosses from
memory- to compute-bound on a machine, and the PE/on-chip memory budget it costs.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.roofline import Machine, analyze
from repro_torch.core.spec import StencilSpec


@dataclasses.dataclass(frozen=True)
class FusionPoint:
    timesteps: int
    arithmetic_intensity: float
    achievable_gflops: float
    bound: str
    mac_pes_needed: int          # CGRA: T * w * macs_per_worker
    fits_fabric: bool
    halo: int                    # per-face input halo, elements
    seam_overhead: float         # redundant flops fraction for a given block


def fusion_report(spec: StencilSpec, machine: Machine, workers: int,
                  block: int = 1024, max_t: int = 16) -> list[FusionPoint]:
    out = []
    for t in range(1, max_t + 1):
        s = dataclasses.replace(spec, timesteps=t)
        rep = analyze(s, machine, workers=workers)
        mac_needed = t * workers * spec.macs_per_worker
        fits = machine.num_macs == 0 or mac_needed <= machine.num_macs
        halo = t * max(spec.radii)
        # redundant work at seams: each block recomputes a trapezoid skirt of
        # width r*(t-k) at step k -> sum_k 2*r*(t-k) = r*t*(t-1) extra points
        # per block per axis pair, vs block*t useful points.
        seam = (max(spec.radii) * t * (t - 1)) / max(1, block * t)
        out.append(FusionPoint(
            timesteps=t, arithmetic_intensity=rep.arithmetic_intensity,
            achievable_gflops=rep.achievable_gflops, bound=rep.bound,
            mac_pes_needed=mac_needed, fits_fabric=fits, halo=halo,
            seam_overhead=seam))
    return out


def crossover_timesteps(spec: StencilSpec, machine: Machine, workers: int,
                        max_t: int = 64) -> int | None:
    """Smallest T at which the fused stencil becomes compute-bound."""
    for t in range(1, max_t + 1):
        s = dataclasses.replace(spec, timesteps=t)
        if analyze(s, machine, workers=workers).bound == "compute":
            return t
    return None


def vmem_working_set(spec: StencilSpec, block_shape: tuple[int, ...],
                     timesteps: int | None = None) -> int:
    """Bytes resident on chip (the reference's VMEM; shared memory on the
    GPU) for a fused block: input block + halos, the rolling intermediate,
    and the output block."""
    t = timesteps or spec.timesteps
    b = spec.bytes_per_elem
    ext = math.prod(bb + 2 * r * t for bb, r in zip(block_shape, spec.radii))
    return (2 * ext + math.prod(block_shape)) * b
