"""Roofline model — paper §VI arithmetic, plus the two H100 parts.

Carried over from ``repro.core.roofline`` as host arithmetic; the H100
machines take the place of the reference's TPU constants, and the H100
SXM's peaks are :class:`TpuRooflineTerms`' defaults.

The paper's method: given a stencil's arithmetic intensity AI (flops/byte) and
a machine (peak bandwidth BW, #MAC PEs, clock f), choose the worker count

    w* = smallest w such that  w * flops_per_worker_per_cycle * f >= BW * AI

i.e. just enough compute workers to saturate the bandwidth-limited flop rate,
and the achievable peak is  min(BW * AI,  2 * #MAC * f).

Everything here is exact integer/float arithmetic reproduced from §VI so that
the paper-validation tests can assert the paper's own numbers:
  1D 17-pt N=194400:  AI = 2.06,  BW-peak = 206 GFLOPS, w*=6 demands 237.6
  2D 49-pt 960x449:   AI = 5.59,  BW-peak = 559 GFLOPS, 5 workers = 582
  CGRA compute peak:  2*256*1.2 = 614.4 GFLOPS
"""
from __future__ import annotations

import dataclasses
import math
import warnings

from repro_torch.core.spec import StencilSpec


@dataclasses.dataclass(frozen=True)
class Machine:
    """A roofline machine model."""
    name: str
    clock_ghz: float          # PE clock (CGRA) or boost clock (GPU: folded into peaks)
    num_macs: int             # MAC PEs (CGRA); 0 for a GPU (no PE model)
    bw_gbps: float            # HBM / memory bandwidth, GB/s
    peak_gflops: float        # 2 * num_macs * clock for the CGRA
    link_gbps: float = 0.0    # inter-chip link bandwidth (NVLink), GB/s
    tiles: int = 1            # CGRA tiles ganged together (paper uses 16)

    def scaled(self, tiles: int) -> "Machine":
        return dataclasses.replace(
            self, name=f"{self.name}x{tiles}", tiles=tiles,
            bw_gbps=self.bw_gbps * tiles, peak_gflops=self.peak_gflops * tiles,
            num_macs=self.num_macs * tiles)


# The paper's target CGRA (§VI): 1.2 GHz, 256 MACs, 100 GB/s.
CGRA = Machine("cgra", clock_ghz=1.2, num_macs=256, bw_gbps=100.0,
               peak_gflops=2 * 256 * 1.2)
# V100 as the paper models it (§VIII): 850 GB/s copy BW; DP peak 7.8 TFLOPS.
V100 = Machine("v100", clock_ghz=1.53, num_macs=2560, bw_gbps=850.0,
               peak_gflops=7800.0)
# The port's target, the two H100 parts: the datasheet's HBM rate, FP32
# (non-tensor) peak -- the stencil kernels' accumulation type -- and boost
# clock for each part, not measured.  No PE model (num_macs 0); the
# inter-card link rate stays 0 until it is measured.
H100_SXM = Machine("h100_sxm", clock_ghz=1.98, num_macs=0, bw_gbps=3350.0,
                   peak_gflops=67_000.0, link_gbps=0.0)
H100_PCIE = Machine("h100_pcie", clock_ghz=1.755, num_macs=0, bw_gbps=2000.0,
                    peak_gflops=51_000.0, link_gbps=0.0)


@dataclasses.dataclass(frozen=True)
class RooflineReport:
    machine: str
    arithmetic_intensity: float
    bw_bound_gflops: float        # BW * AI
    compute_bound_gflops: float   # machine peak
    achievable_gflops: float      # min of the two
    bound: str                    # "memory" | "compute"
    workers: int                  # w* chosen
    worker_demand_gflops: float   # flops the chosen workers can execute
    macs_per_worker: int
    capped: bool = False          # w* silently hit the physical-fit ceiling
    workers_demanded: int = 0     # BW-limited demand before the fit cap

    @property
    def ridge_ai(self) -> float:
        return self.compute_bound_gflops / (self.bw_bound_gflops / self.arithmetic_intensity)


def worker_fit(spec: StencilSpec, machine: Machine) -> int:
    """How many workers physically fit: ``#MACs / MACs_per_worker``."""
    mpw = spec.macs_per_worker
    return max(1, machine.num_macs // mpw) if machine.num_macs else 1


def workers_demanded(spec: StencilSpec, machine: Machine) -> int:
    """The BW-limited worker demand *before* any physical-fit cap: the
    fewest workers whose flop rate covers ``BW * AI``."""
    mpw = spec.macs_per_worker
    ai = spec.arithmetic_intensity()
    bw_gflops = machine.bw_gbps * ai
    per_worker = (2 * (mpw - 1) + 1) * machine.clock_ghz  # 2r MACs + 1 MUL per cycle
    return max(1, math.ceil(bw_gflops / per_worker))


def select_workers(spec: StencilSpec, machine: Machine) -> int:
    """Paper §VI: fit Y/#MACs_per_worker workers; use the fewest that satisfy
    the BW-limited flop demand, capped by what physically fits.

    When the cap binds (the machine cannot host the demanded workers) a
    ``RuntimeWarning`` is emitted — callers wanting the cap programmatically
    should use :func:`analyze` and read ``RooflineReport.capped`` /
    ``RooflineReport.workers_demanded``.
    """
    need = workers_demanded(spec, machine)
    if not machine.num_macs:
        return need
    fit = worker_fit(spec, machine)
    if need > fit:
        warnings.warn(
            f"select_workers: bandwidth-limited demand of {need} workers "
            f"exceeds the {fit} that physically fit on {machine.name} "
            f"({machine.num_macs} MACs / {spec.macs_per_worker} per worker);"
            f" capping at {fit} leaves the memory system unsaturated",
            RuntimeWarning, stacklevel=2)
    return min(fit, need)


def worker_demand_gflops(spec: StencilSpec, machine: Machine, w: int) -> float:
    """GFLOPS demanded/suppliable by ``w`` workers (paper's 6*16*2*1.2 + 6*1.2 form)."""
    macs = spec.macs_per_worker - 1  # chain MACs
    return w * macs * 2 * machine.clock_ghz + w * machine.clock_ghz


def analyze(spec: StencilSpec, machine: Machine, workers: int | None = None) -> RooflineReport:
    ai = (spec.arithmetic_intensity_fused() if spec.timesteps > 1
          else spec.arithmetic_intensity())
    bw_bound = machine.bw_gbps * ai
    achievable = min(bw_bound, machine.peak_gflops)
    need = workers_demanded(spec, machine)
    fit = worker_fit(spec, machine)
    # same arithmetic as select_workers, without re-warning: the report
    # *records* the cap instead (capped only describes the selection path —
    # an explicitly-passed worker count was chosen, not capped)
    w = workers if workers is not None else (
        min(fit, need) if machine.num_macs else need)
    return RooflineReport(
        machine=machine.name,
        arithmetic_intensity=ai,
        bw_bound_gflops=bw_bound,
        compute_bound_gflops=machine.peak_gflops,
        achievable_gflops=achievable,
        bound="memory" if bw_bound < machine.peak_gflops else "compute",
        workers=w,
        worker_demand_gflops=worker_demand_gflops(spec, machine, w),
        macs_per_worker=spec.macs_per_worker,
        capped=workers is None and bool(machine.num_macs) and need > fit,
        workers_demanded=need,
    )



# ---------------------------------------------------------------------------
# Three-term roofline of one step on a mesh (the dry run's, launch/dryrun.py).
# ---------------------------------------------------------------------------
# The H100 SXM's datasheet peaks, not measured: dense BF16 tensor-core
# flop/s, HBM bytes/s (H100_SXM.bw_gbps), and NVLink 4's 900 GB/s counted
# one direction, a stated constant (this machine has one card, so no link
# is measured).
H100_BF16_FLOPS = 989e12
H100_NVLINK_BYTES = 450e9


@dataclasses.dataclass(frozen=True)
class TpuRooflineTerms:
    """Seconds spent in each roofline term for one step on a mesh.  The
    reference's name and fields; its defaults are the H100 SXM's peaks, in
    place of the TPU's."""
    flops: float                # total flops (all chips)
    hbm_bytes: float            # total bytes accessed (all chips)
    collective_bytes: float     # summed collective payload bytes (all chips)
    chips: int
    peak_flops_per_chip: float = H100_BF16_FLOPS
    hbm_bw_per_chip: float = H100_SXM.bw_gbps * 1e9
    link_bw_per_chip: float = H100_NVLINK_BYTES

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * self.peak_flops_per_chip)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * self.hbm_bw_per_chip)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (self.chips * self.link_bw_per_chip)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Optimistic (perfect-overlap) step time: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes, "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "step_time_s": self.step_time_s,
        }
