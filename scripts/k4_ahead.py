#!/usr/bin/env python3
"""Time K4 (``csrc/stencil3d.cu``) with two planes in flight for both types,
as the tree has it, against a copy patched to keep four bf16 planes in
flight, on one CUDA card at 512^3.

    python3 scripts/k4_ahead.py

Cases, f32 and bf16 at T = 1: ``star_3d``'s pattern of taps at r = 1 and
r = 2 (the compile-time instances), taps off that pattern at r = 2 and the
star pattern at r = 3 (the generic instance), the last at the default
block fitted to the halo and at the planner's tile (``block="plan"``).
Each variant is a copy of ``src/repro_torch`` under the git-ignored
``build/k4_ahead/`` with its own build; they run in the order tree, patched,
patched, tree, each in its own process, one JSON line per case (median of
20 CUDA-event times after 3 warm-up calls, and the max error against the
plain version).  The ``ptxas`` registers and spills of each variant's first
run are printed too.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EXP = ROOT / "build" / "k4_ahead"

CHILD = r'''
import json, statistics, sys, torch
from repro_torch.kernels import _build
from repro_torch.kernels.stencil3d.kernel import instance
from repro_torch.kernels.stencil3d.ops import (DEFAULT_BLOCK, _auto_block,
                                               fit_block, stencil3d)
from repro_torch.kernels.stencil3d.ref import stencil3d_ref

run = sys.argv[1]
_build.build("stencil3d")
if run.endswith(("-0", "-1")):
    for line in _build.build_log("stencil3d").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(run, line.strip()[-110:])
dev = torch.device("cuda")


def ms(fn, reps=20):
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


g = torch.Generator(device=dev).manual_seed(0)


def taps(r, star):
    c = [(torch.randn(2 * r + 1, generator=g, device=dev) / (6 * r + 1)).tolist()
         for _ in range(3)]
    if star:
        c[1][r] = c[2][r] = 0.0
    return tuple(tuple(v) for v in c)


budget = _build.smem_per_block(dev)
for dtype in (torch.float32, torch.bfloat16):
    x = torch.randn((1, 512, 512, 512), generator=g, device=dev).to(dtype)
    name = str(dtype).removeprefix("torch.")
    for r, star, blk in ((2, True, None), (1, True, None), (2, False, None),
                         (3, True, None), (3, True, "plan")):
        cz, cy, cx = taps(r, star)
        inst = instance(cz, cy, cx)
        used = (fit_block(DEFAULT_BLOCK, (r,) * 3, x.element_size(), budget,
                          inst > 0) if blk is None
                else _auto_block((512,) * 3, cz, cy, cx, name, budget))
        fn = lambda: stencil3d(x, cz, cy, cx, backend="cuda", block=blk)
        err = (fn().float() - stencil3d_ref(x, cz, cy, cx, 1).float()).abs().max()
        print(json.dumps({"v": run, "dtype": name, "r": r, "star": star,
                          "inst": inst, "block": blk or "default",
                          "used": list(used), "ms": round(ms(fn), 4),
                          "err": err.item()}), flush=True)
    del x
    torch.cuda.empty_cache()
'''


def make_variant(name: str) -> Path:
    """A copy of src/repro_torch; "ahead4" keeps four bf16 planes in
    flight (kAhead and smem_bytes patched together)."""
    src = EXP / name / "src"
    shutil.rmtree(EXP / name, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if name == "ahead4":
        for path, old, new in (
                (src / "repro_torch" / "csrc" / "stencil3d.cu",
                 "constexpr int kAhead = 2;",
                 "template <typename T> constexpr int kAheadOf = "
                 "sizeof(T) == 4 ? 2 : 4;\n#define kAhead kAheadOf<T>"),
                (src / "repro_torch" / "kernels" / "stencil3d" / "kernel.py",
                 "return (ring_slots(rz, queued) *",
                 "return ((ring_slots(rz, queued) + 2 * (itemsize == 2)) *")):
            text = path.read_text()
            assert text.count(old) == 1, (path, old)
            path.write_text(text.replace(old, new))
    return src


def main() -> int:
    srcs = {n: make_variant(n) for n in ("tree", "ahead4")}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rc = 0
    for i, name in enumerate(("tree", "ahead4", "ahead4", "tree")):
        env = dict(os.environ, PYTHONPATH=str(srcs[name]))
        rc |= subprocess.run([sys.executable, "-c", CHILD, f"{name}-{i}"],
                             env=env).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
