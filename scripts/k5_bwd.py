#!/usr/bin/env python3
"""Time K5's whole backward (``csrc/conv1d.cu``: dx, dw and db) with a cold
L2 at RecurrentGemma-2B's training shape, x and dy (1, 4096, 2560) with 4
taps and a bias, in bf16 (the training step's type) or f32, on one CUDA
card.

    python3 scripts/k5_bwd.py                    # this checkout's backward
    python3 scripts/k5_bwd.py --src DIR          # that of DIR's repro_torch
    python3 scripts/k5_bwd.py --dtype float32
    python3 scripts/k5_bwd.py --sweep --turns 4  # the planner's choices

One ``bwd`` line: min / median / max ms over ``--reps`` calls of the whole
backward as the op's autograd runs it (every launch: ``conv1d_bwd`` where
the checkout has it, else K5 on the flipped gradient and
``conv1d_bwd_wb``), of the plain version and of the library's whole
backward (one ``torch.autograd.grad`` of ``F.conv1d`` with ``groups=C`` for
x, w and b); the launches one backward makes; and whether two calls gave
equal bits.  Where the checkout has ``conv1d_bwd``, a ``parts`` line: its
time with dx alone and with dw and db alone, and each kernel's device
time in a whole backward by the profiler.  Cold: a read of 4 times the L2, then a short sleeping kernel
that holds the card while the call is issued, before each call and outside
the CUDA events, so the events hold device time only.  With ``--src``
(another checkout's ``src/``, such as its parent's from ``git archive``
into ``build/``, built into that checkout's ``build/``) the same line, so
two checkouts compare line for line: run them in one call, on one card, in
turns.  With ``--sweep`` (this checkout only) one ``sweep`` line a launch
over runs, threads a block and rows in flight, and the generic instance
forced, each timed in ``--turns`` turns whose order alternates, dx checked
bit for bit against the planned launch's.  The card's name and power limit
come first.
"""
import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
SHAPE, TAPS = (1, 4096, 2560), 4
FLUSH_L2 = 4
SLEEP_CYCLES = 1_000_000        # ~0.5 ms: longer than a call's host time
RUNS = (8, 16, 32, 64)
THREADS = (64, 128, 256)
AHEADS = (1, 2, 4, 8)


def times_ms(fn, flush, reps: int) -> list[float]:
    for _ in range(2):
        fn()
    st = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    en = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(st, en):
        flush.sum()
        torch.cuda._sleep(SLEEP_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in zip(st, en)]


def kernel_ms(fn, flush, reps: int) -> dict:
    """Device ms a call of each kernel ``fn`` launches, by the profiler,
    each call after a read of the flush buffer."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.sum()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = re.search(r"conv1d\w*", e.key)
        if name:
            total = getattr(e, "device_time_total", None)
            if total is None:
                total = e.cuda_time_total
            out[name.group(0)] = total / reps / 1e3
    return out


def spread(t: list[float]) -> dict:
    return {"min": min(t), "median": statistics.median(t), "max": max(t)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src/ directory whose repro_torch to time")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    dtype = getattr(torch, args.dtype)
    if not torch.cuda.is_available():
        raise SystemExit("k5_bwd.py needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels import _build
    from repro_torch.kernels.conv1d import kernel as k5
    from repro_torch.kernels.conv1d.ref import conv1d_bwd_ref

    dev = torch.device("cuda")
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    flush = torch.ones(FLUSH_L2 * l2 // 4, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x, dy = (torch.randn(SHAPE, generator=gen, device=dev).to(dtype)
             for _ in range(2))
    w = torch.randn((TAPS, SHAPE[2]), generator=gen, device=dev).to(dtype)
    b = torch.randn(SHAPE[2], generator=gen, device=dev).to(dtype)
    if hasattr(k5, "conv1d_bwd"):
        def whole():
            return k5.conv1d_bwd(x, dy, w, b)
    else:                   # the earlier design: K5 on the flipped gradient
        def whole():
            dx = k5.conv1d_kernel(dy.flip(1), w).flip(1)
            return (dx, *k5.conv1d_bwd_wb(x, dy, w, b))
    leaves = [x.transpose(1, 2).detach().requires_grad_(),
              w.T[:, None, :].detach().requires_grad_(),
              b.detach().requires_grad_()]
    lib = F.conv1d(*leaves, groups=SHAPE[2], padding=TAPS - 1)[..., :SHAPE[1]]
    dyt = dy.transpose(1, 2)
    _build.reset_launches()
    first = whole()
    torch.cuda.synchronize()
    launches = {n: c for n, c in _build.LAUNCHES.items() if c}
    again = whole()
    print(json.dumps({
        "line": "bwd", "src": str(args.src), "shape": list(SHAPE),
        "taps": TAPS, "dtype": args.dtype,
        "whole": spread(times_ms(whole, flush, args.reps)),
        "plain": spread(times_ms(lambda: conv1d_bwd_ref(x, w, b, dy), flush,
                                 5)),
        "library": spread(times_ms(lambda: torch.autograd.grad(
            lib, leaves, dyt, retain_graph=True), flush, args.reps)),
        "launches": launches,
        "bit_equal_twice": all(torch.equal(p, q)
                               for p, q in zip(first, again))}), flush=True)
    if hasattr(k5, "conv1d_bwd"):       # its parts: dx alone, dw and db alone
        print(json.dumps({
            "line": "parts", "src": str(args.src), "dtype": args.dtype,
            "dx_only": spread(times_ms(lambda: k5.conv1d_bwd(
                x, dy, w, b, need_wb=False), flush, args.reps)),
            "wb_only": spread(times_ms(lambda: k5.conv1d_bwd(
                x, dy, w, b, need_x=False), flush, args.reps)),
            "kernels": kernel_ms(whole, flush, args.reps)}), flush=True)
    if not args.sweep:
        return 0
    planned = k5.plan_bwd(*SHAPE, TAPS, x.element_size(), True)
    plans = [k5.BwdPlan(TAPS, r, t, a) for r in RUNS for t in THREADS
             for a in AHEADS if a <= r]
    plans += [k5.BwdPlan(0, k5.BWD_GENERIC_RUN, k5.BWD_GENERIC_THREADS, 1)]
    if planned not in plans:
        plans.append(planned)
    got = {p: [] for p in plans}
    equal = {}
    for turn in range(args.turns):
        for p in plans if turn % 2 == 0 else plans[::-1]:
            def run(p=p):
                return k5.conv1d_bwd(x, dy, w, b, launch=p)
            equal[p] = torch.equal(run()[0], first[0])
            got[p] += times_ms(run, flush, args.reps)
    for p in plans:
        print(json.dumps({
            "line": "sweep", "dtype": args.dtype, "instance": p.instance,
            "run": p.run, "threads": p.threads, "ahead": p.ahead,
            "planned": p == planned, "dx_bit_equal": equal[p],
            "cold": spread(got[p])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
