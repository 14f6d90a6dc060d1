#!/usr/bin/env python3
"""Drive the PyTorch port's stencil main path on one NVIDIA GPU (H100).

    PYTHONPATH=src python3 chip_smoke.py [--device cuda:0] [--seed 0]

1. Builds the four hand-written CUDA kernels from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, in parallel).
2. Drives the main path through the public ops (``stencil1d_from_spec``,
   ``stencil2d_from_spec``, ``stencil3d``) with every launch count zeroed just
   before and read just after: the paper's §VI shapes in f32 (1D 17-pt
   N=194400 through both variants, 2D 49-pt 449x960 at T=1 and T=4, 3D
   ``star_3d(64, 64, 256, r=2)``), then deployment sizes (1D 1024 x 194400,
   2D 256 x 449 x 960, 3D 512^3) in f32 and bf16.
3. Holds every output against the kernel's plain PyTorch version on the card
   (tolerance: f32 2e-5, bf16 3e-2, the TOL table of tests/test_kernels.py),
   and the paper shapes also against the numpy oracle on the host.
4. Times each kernel at its deployment shape (median of CUDA-event times
   after warm-up) beside its plain version, a cuDNN convolution yardstick
   (``library_ms``; TF32 off) and its bound, prints one JSON line per case,
   the ``kernels`` JSON line, the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

Any build error, launch error, mismatch or kernel that the main path did not
launch exits non-zero without the last line.  Needs a CUDA device: without
one it exits non-zero before doing anything.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import (paper_stencil_1d, paper_stencil_2d,  # noqa: E402
                              star_3d, stencil_reference_np)
from repro_torch.kernels import (stencil1d_from_spec, stencil2d_from_spec,  # noqa: E402
                                 stencil3d)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.stencil1d.ref import stencil1d_ref  # noqa: E402
from repro_torch.kernels.stencil2d.ref import stencil2d_ref  # noqa: E402
from repro_torch.kernels.stencil3d.ref import stencil3d_ref  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# Datasheet peaks (dense, no sparsity): HBM bytes/s and FP32 (non-tensor)
# flop/s of the two H100 parts.
PEAKS = {"sxm": (3.35e12, 67e12), "pcie": (2.0e12, 51e12)}
KERNELS = {   # kernel -> (route, source, the TPU kernel it replaces)
    "stencil1d_vpu": ("cuda", "src/repro_torch/csrc/stencil1d.cu",
                      "src/repro/kernels/stencil1d/kernel.py:147"),
    "stencil1d_mxu": ("cuda", "src/repro_torch/csrc/stencil1d.cu",
                      "src/repro/kernels/stencil1d/kernel.py:158"),
    "stencil2d": ("cuda", "src/repro_torch/csrc/stencil2d.cu",
                  "src/repro/kernels/stencil2d/kernel.py:103"),
    "stencil3d": ("cuda", "src/repro_torch/csrc/stencil3d.cu",
                  "src/repro/kernels/stencil3d/kernel.py:97"),
}


@dataclasses.dataclass
class Case:
    name: str
    kernel: str
    spec: object          # the StencilSpec (grid_shape is one grid of the batch)
    x: torch.Tensor
    variant: str = "vpu"
    timed: bool = False   # the kernel's row in the `kernels` line
    y: torch.Tensor | None = None

    def run(self) -> torch.Tensor:
        """The public op a user calls."""
        if self.spec.ndim == 1:
            return stencil1d_from_spec(self.x, self.spec, variant=self.variant,
                                       backend="cuda")
        if self.spec.ndim == 2:
            return stencil2d_from_spec(self.x, self.spec, backend="cuda")
        return stencil3d(self.x, *self.spec.coeffs,
                         timesteps=self.spec.timesteps, backend="cuda")

    def plain(self) -> torch.Tensor:
        """The kernel's plain PyTorch version on the same inputs."""
        c, t = self.spec.coeffs, self.spec.timesteps
        if self.spec.ndim == 1:
            return stencil1d_ref(self.x, c[0], t)
        if self.spec.ndim == 2:
            return stencil2d_ref(self.x, c[0], c[1], t)
        return stencil3d_ref(self.x, *c, t)

    def library(self) -> torch.Tensor:
        """Yardstick: T cuDNN convolutions with the taps as a dense
        cross-shaped kernel and zero padding r (no rim mask).  In 2D and 3D
        the dense kernel does (2r+1)^2 / (2r+1)^3 taps, so it is loose."""
        spec = self.spec
        size = tuple(2 * r + 1 for r in spec.radii)
        w = torch.zeros(size, dtype=torch.float32)
        for ax, (r, coeffs) in enumerate(zip(spec.radii, spec.coeffs)):
            for k, c in enumerate(coeffs):
                idx = list(spec.radii)
                idx[ax] = k
                w[tuple(idx)] += c
        w = w.to(self.x.device, self.x.dtype)[None, None]
        conv = (F.conv1d, F.conv2d, F.conv3d)[spec.ndim - 1]
        out = self.x.reshape(-1, 1, *self.x.shape[-spec.ndim:])
        for _ in range(spec.timesteps):
            out = conv(out, w, padding=tuple(spec.radii))
        return out

    def bound(self, part: str) -> tuple[float, str]:
        """Least time (ms) the card could take for the function, whatever
        the kernel: one read and one write of the grids at HBM rate, or one
        FMA per non-zero tap per point and sweep at the FP32 datasheet rate."""
        bw, fp32 = PEAKS[part]
        n = self.x.numel()
        nbytes = 2 * n * self.x.element_size()
        taps = sum(1 for cs in self.spec.coeffs for c in cs if c != 0.0)
        flops = 2 * taps * n * self.spec.timesteps
        t_bytes, t_ops = nbytes / bw * 1e3, flops / fp32 * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def make_cases(dev: torch.device, seed: int) -> list[Case]:
    gen = torch.Generator(device=dev).manual_seed(seed)

    def grid(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    s1 = paper_stencil_1d(dtype="float32")                 # N=194400, r=8
    s2 = paper_stencil_2d(dtype="float32")                 # 449 x 960, r=12
    s2t4 = dataclasses.replace(s2, timesteps=4)
    s3 = star_3d(64, 64, 256, r=2, dtype="float32")
    s3d = star_3d(512, 512, 512, r=2, dtype="float32")
    bf16 = torch.bfloat16
    cases = [
        Case("paper_1d_vpu", "stencil1d_vpu", s1, grid(s1.grid_shape)),
        Case("paper_1d_mxu", "stencil1d_mxu", s1, grid(s1.grid_shape), "mxu"),
        Case("paper_2d_t1", "stencil2d", s2, grid(s2.grid_shape)),
        Case("paper_2d_t4", "stencil2d", s2t4, grid(s2.grid_shape)),
        Case("paper_3d", "stencil3d", s3, grid(s3.grid_shape)),
        Case("deploy_1d_vpu", "stencil1d_vpu", s1, grid((1024, 194400)),
             timed=True),
        Case("deploy_1d_mxu", "stencil1d_mxu", s1, grid((1024, 194400)), "mxu",
             timed=True),
        Case("deploy_2d", "stencil2d", s2, grid((256, 449, 960)), timed=True),
        Case("deploy_3d", "stencil3d", s3d, grid(s3d.grid_shape), timed=True),
        Case("deploy_1d_vpu_bf16", "stencil1d_vpu", s1,
             grid((1024, 194400), bf16)),
        Case("deploy_1d_mxu_bf16", "stencil1d_mxu", s1,
             grid((1024, 194400), bf16), "mxu"),
        Case("deploy_2d_bf16", "stencil2d", s2, grid((256, 449, 960), bf16)),
        Case("deploy_3d_bf16", "stencil3d", s3d, grid(s3d.grid_shape, bf16)),
    ]
    return cases


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit(f"chip_smoke.py needs a CUDA device (asked for "
                         f"{args.device}; torch.cuda.is_available() is "
                         f"{torch.cuda.is_available()})")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(dev)
    part = "pcie" if "pcie" in name.lower() else "sxm"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()

    t0 = time.perf_counter()
    sources = sorted({Path(src).stem for _, src, _ in KERNELS.values()})
    _build.build(*sources)
    print(f"built {sources} in {time.perf_counter() - t0:.1f} s")
    cases = make_cases(dev, args.seed)
    torch.cuda.synchronize()

    # -- the main path, counted -------------------------------------------
    _build.reset_launches()
    t0 = time.perf_counter()
    for case in cases:
        case.y = case.run()
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {k: _build.LAUNCHES.get(k, 0) for k in KERNELS}
    print(f"main path: {len(cases)} calls in {main_s:.3f} s, launches {launches}")

    # -- correctness --------------------------------------------------------
    failures = [f"{k}: not launched on the main path"
                for k, n in launches.items() if n == 0]
    errs: dict[tuple[str, torch.dtype], float] = {}
    for case in cases:
        y, tol = case.y, TOL[case.x.dtype]
        ok_shape = y.shape == case.x.shape and y.dtype == case.x.dtype
        finite = bool(torch.isfinite(y).all())
        err = (y.float() - case.plain().float()).abs().max().item()
        key = (case.kernel, case.x.dtype)
        errs[key] = max(errs.get(key, 0.0), err)
        host_err = None
        if case.name.startswith("paper"):
            want = stencil_reference_np(case.x.cpu().numpy(), case.spec)
            host_err = float(np.abs(y.float().cpu().numpy() - want).max())
        good = ok_shape and finite and err <= tol and (host_err is None
                                                      or host_err <= tol)
        if not good:
            failures.append(f"{case.name}: shape/dtype ok {ok_shape}, finite "
                            f"{finite}, err vs plain {err}, err vs host "
                            f"oracle {host_err}, tol {tol}")
        print(json.dumps({"case": case.name, "kernel": case.kernel,
                          "shape": list(case.x.shape),
                          "dtype": str(case.x.dtype).removeprefix("torch."),
                          "timesteps": case.spec.timesteps,
                          "max_abs_err": err, "host_err": host_err,
                          "tol": tol, "ok": good}))
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1

    # -- timing (launches here are not counted above) -----------------------
    rows = []
    for case in cases:
        if not case.name.startswith("deploy"):
            print(json.dumps({"case": case.name,
                              "ms": median_ms(case.run, reps=20)}))
            continue
        ms = median_ms(case.run, reps=20)
        plain_ms = median_ms(case.plain, reps=10)
        library_ms = median_ms(case.library, reps=10)
        bound_ms, bound_by = case.bound(part)
        print(json.dumps({"case": case.name, "ms": ms, "plain_ms": plain_ms,
                          "library_ms": library_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by}))
        if case.timed:
            route, source, replaces = KERNELS[case.kernel]
            rows.append({
                "name": case.kernel, "route": route, "source": source,
                "replaces": replaces, "launches": launches[case.kernel],
                "max_abs_err": errs[(case.kernel, torch.float32)],
                "tol": TOL[torch.float32],
                "max_abs_err_bf16": errs[(case.kernel, torch.bfloat16)],
                "tol_bf16": TOL[torch.bfloat16],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms,
                "shape": list(case.x.shape), "part": part})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}))   # the card it drove
    return 0


if __name__ == "__main__":
    sys.exit(main())
