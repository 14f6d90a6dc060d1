#!/usr/bin/env python3
"""Time K5 (``csrc/conv1d.cu``, causal conv1d) with a cold L2 at
RecurrentGemma-2B's shape, x (2, 4096, 2560) with 4 taps, in f32 and bf16,
on one CUDA card: the measurement behind ``kernels/conv1d/kernel.py:plan``.

    python3 scripts/k5_tiles.py                 # this checkout's K5
    python3 scripts/k5_tiles.py --src DIR       # the K5 of DIR's repro_torch

First, for each type, the kernel as it launches by default, cold and warm
(min / median / max over 20 calls), the op with its bias, cold, and a cold
``copy_`` of the input (``default`` lines); with ``--src`` (another
checkout's ``src/``, such as its parent's, built into that checkout's
``build/``) only these, so two checkouts compare line for line.  Then, for
this checkout, every vector launch over runs, threads per block and rows in
flight (``ahead`` 1: no look-ahead), and the generic instance forced
(``sweep`` lines), each cold, each output checked bit for bit against the
default launch's.  Cold: a read of 4 times the L2 before each call, outside
the CUDA events (as ``chip_smoke.py`` times K5).  The card's name and power
limit come first.
"""
import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPE, TAPS = (2, 4096, 2560), 4
RUNS = (4, 8, 16, 32, 64, 128)
THREADS = (32, 64, 128, 256)
FLUSH_L2 = 4


def times_ms(fn, flush=None, reps: int = 20) -> list[float]:
    for _ in range(3):
        fn()
    st = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    en = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(st, en):
        if flush is not None:
            flush.sum()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in zip(st, en)]


def spread(t: list[float]) -> dict:
    return {"min": min(t), "median": statistics.median(t), "max": max(t)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src/ directory whose repro_torch to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k5_tiles.py needs a CUDA device")
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels import causal_conv1d
    from repro_torch.kernels.conv1d import kernel as k5

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    flush = torch.ones(FLUSH_L2 * l2 // 4, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    sweep = args.src.resolve() == (ROOT / "src").resolve()
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).removeprefix("torch.")
        x = torch.randn(SHAPE, generator=gen, device=dev).to(dt)
        w = torch.randn((TAPS, SHAPE[2]), generator=gen, device=dev).to(dt)
        b = torch.randn(SHAPE[2], generator=gen, device=dev).to(dt)
        y = torch.empty_like(x)
        with torch.inference_mode():
            want = k5.conv1d_kernel(x, w)
            print(json.dumps({
                "line": "default", "src": str(args.src), "dtype": name,
                "shape": list(SHAPE), "taps": TAPS,
                "cold": spread(times_ms(lambda: k5.conv1d_kernel(x, w),
                                        flush)),
                "warm": spread(times_ms(lambda: k5.conv1d_kernel(x, w))),
                "op_cold": spread(times_ms(lambda: causal_conv1d(x, w, b),
                                           flush)),
                "copy_cold": spread(times_ms(lambda: y.copy_(x), flush))}),
                flush=True)
            if not sweep:
                continue
            planned = k5.launch_plan(x, w)
            plans = [k5.Plan(TAPS, r, t, a) for r in RUNS for t in THREADS
                     for a in k5.AHEADS if a <= r]
            plans += [k5.Plan(0, k5.GENERIC_RUN, k5.GENERIC_THREADS, 1),
                      k5.Plan(0, 128, 256, 1)]
            for p in plans + ([planned] if planned not in plans else []):
                def run(p=p):
                    return k5.conv1d_kernel(x, w, launch=p)
                print(json.dumps({
                    "line": "sweep", "dtype": name, **dataclasses.asdict(p),
                    "planned": p == planned,
                    "bit_equal": torch.equal(run(), want),
                    "cold": spread(times_ms(run, flush))}), flush=True)
        del x, y, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
