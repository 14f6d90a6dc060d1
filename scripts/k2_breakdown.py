#!/usr/bin/env python3
"""Where K2's time goes (``csrc/stencil1d.cu``, ``variant="mxu"``), or K1's
with ``--variant vpu``: time it as the tree has it and in copies patched to
drop one part of its work, on one CUDA card at the deployment shape
(1024, 194400), the paper's 17-pt taps, T = 1, the planned tile, f32 and
bf16.

    python3 scripts/k2_breakdown.py [--variant mxu|vpu]

Variants (each a copy of ``stencil1d.cu`` and ``common.cuh`` under the
git-ignored ``build/k2_breakdown/`` with its own build):
- ``tree``: as committed; its error against the plain version is printed;
- ``nomma`` (mxu only): each ``mma.sync`` replaced by four f32 adds (the
  tensor cores' share);
- ``noload``: no ``cp.async`` is issued (the loads' share; the tile holds
  whatever shared memory held);
- ``nostore``: the output tile is read from shared memory but not written
  to the grid (the stores' share);
- ``nocompute``: no sweep runs; the tile is loaded and the output tile
  stored (the floor set by the loads and stores of this structure, which
  K1 and K2 share).
Beside them ``copy``: ``Tensor.copy_`` of the same grid, a read and a write
of every byte, the practical floor of the card's memory.  One JSON line per
case: median of 20 CUDA-event times after 3 warm-up calls.  The ``ptxas``
registers and spills of each variant are printed, and the card's name and
power limit first.
"""
import argparse
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import paper_stencil_1d  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.stencil1d.kernel import stencil1d_kernel  # noqa: E402
from repro_torch.kernels.stencil1d.ops import plan_1d_blocks  # noqa: E402
from repro_torch.kernels.stencil1d.ref import stencil1d_ref  # noqa: E402

EXP = ROOT / "build" / "k2_breakdown"
CSRC = ROOT / "src" / "repro_torch" / "csrc"
SHAPE = (1024, 194400)
NOLOAD = [("      cp_async16(smem_addr(dst), in ? src : x, in ? 16 : 0);",
           "      if (gc == -12345) cp_async16(smem_addr(dst), in ? src : x, "
           "in ? 16 : 0);")]
NOSTORE = [("      *reinterpret_cast<uint4*>(dst + E * c) = "
            "*reinterpret_cast<const uint4*>(src + E * c);",
            "      { const uint4 v = *reinterpret_cast<const uint4*>(src + E * c);"
            " if (v.x == 0x12345u) *reinterpret_cast<uint4*>(dst + E * c) = v; }")]
PATCHES = {
    "mxu": {
        "tree": [],
        "nomma": [('''  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));''',
                   '''  d[0] += __uint_as_float(a[0] ^ b0);
  d[1] += __uint_as_float(a[1] ^ b1);
  d[2] += __uint_as_float(a[2]);
  d[3] += __uint_as_float(a[3]);''')],
        "noload": NOLOAD,
        "nostore": NOSTORE,
        "nocompute": [("    if (a.steps == 1) {\n      sweep<NK",
                       "    if (a.steps == 1) {\n      if (a.r == 12345) sweep<NK")],
    },
    "vpu": {
        "tree": [],
        "noload": NOLOAD,
        "nostore": NOSTORE,
        "nocompute": [("    if (a.steps == 1) {\n      vpu_sweep<R>",
                       "    if (a.steps == 1) {\n      if (a.r == 12345) vpu_sweep<R>")],
    },
}


def median_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    st = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    en = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(st, en):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(st, en))


def use_variant(kernel: str, name: str) -> None:
    """Point the build at a patched copy of the sources."""
    src = (CSRC / "stencil1d.cu").read_text()
    for old, new in PATCHES[kernel][name]:
        if old not in src:
            raise SystemExit(f"variant {name}: its patch no longer applies")
        src = src.replace(old, new)
    d = EXP / kernel / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "stencil1d.cu").write_text(src)
    shutil.copy(CSRC / "common.cuh", d / "common.cuh")
    _build.CSRC, _build.BUILD_DIR = d, d / "lib"
    _build._libs.clear()
    _build.build("stencil1d")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", choices=sorted(PATCHES), default="mxu")
    variant = ap.parse_args().variant
    if not torch.cuda.is_available():
        raise SystemExit("k2_breakdown.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    taps = paper_stencil_1d(dtype="float32").coeffs[0]
    grids = {dt: torch.randn(SHAPE, generator=gen, device=dev).to(dt)
             for dt in (torch.float32, torch.bfloat16)}
    for dt, x in grids.items():
        y = torch.empty_like(x)
        print(json.dumps({"variant": "copy", "dtype": str(dt),
                          "ms": median_ms(lambda: y.copy_(x))}))
    for name in PATCHES[variant]:
        use_variant(variant, name)
        regs = [line.split(":", 1)[-1].strip()
                for line in _build.build_log("stencil1d").splitlines()
                if "registers" in line or "spill" in line]
        print(json.dumps({"variant": name, "ptxas": regs}))
        for dt, x in grids.items():
            block = plan_1d_blocks(SHAPE[1], SHAPE[0], 8, 1, variant,
                                   itemsize=x.element_size())

            def run():
                return stencil1d_kernel(x, taps, block=block, variant=variant)
            row = {"kernel": f"stencil1d_{variant}", "variant": name,
                   "dtype": str(dt), "block": block,
                   "ms": median_ms(run)}
            if name == "tree":
                row["max_abs_err"] = (run().float() - stencil1d_ref(
                    x, taps, 1).float()).abs().max().item()
            print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
