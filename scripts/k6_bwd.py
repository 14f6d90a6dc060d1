#!/usr/bin/env python3
"""Time K6's backward (``csrc/swa_bwd.cu``) at RecurrentGemma-2B's training
shape on one CUDA card: q (1, 10, 4096, 256) over k and v (1, 1, 4096,
256), window 2048, bf16 (the training step's type) or f32, as the model's
(B, S, H, D) projections viewed as (B, H, S, D).

    python3 scripts/k6_bwd.py                 # this checkout's K6 backward
    python3 scripts/k6_bwd.py --src DIR       # that of DIR's repro_torch
    python3 scripts/k6_bwd.py --dtype float32

One ``bwd`` line: min / median / max ms over ``--reps`` calls (CUDA events,
warm) of ``swa_bwd_dq``, of ``swa_bwd_dkdv`` as the op calls it, of its
kernel alone and of the fold of its partial sums where the checkout has
them in the type (``swa_bwd_dkdv_partial``, ``swa_bwd_fold``), of the
whole backward
(``swa_bwd_kernel``: every launch, ``sum``) and of the backward of
``scaled_dot_product_attention`` with the band as its mask (``library``,
q, k and v at once); the fold's device time alone (``fold_queued_ms``:
calls issued behind a sleeping kernel, as its ~13 µs are shorter than its
wrapper's host time); the launches one whole backward makes; and whether
two whole backward calls gave equal bits; and SHA-256 digests of the bytes
of the forward's output and of dq, dk and dv (``sha256``), the backward's
taken with a seeded normal tensor in place of the forward's output, so
that its bits depend on the backward's kernels alone.  With ``--src`` (another
checkout's ``src/``, such as its parent's from ``git archive`` into
``build/``, built into that checkout's ``build/``) the same line, so two
checkouts compare line for line: run both in one call, on one card, in
turns.  The card's name and power limit come first.
"""
import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
B, HQ, HKV, S, D, WINDOW = 1, 10, 1, 4096, 256, 2048


def times_ms(fn, reps: int) -> list[float]:
    for _ in range(3):
        fn()
    st = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    en = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(st, en):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in zip(st, en)]


def queued_ms(fn, reps: int) -> float:
    """Device ms a call: ``reps`` calls issued behind a sleeping kernel
    (~10 ms) between one pair of events, for a kernel shorter than its
    wrapper's host time."""
    for _ in range(3):
        fn()
    st, en = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(20_000_000)
    st.record()
    for _ in range(reps):
        fn()
    en.record()
    torch.cuda.synchronize()
    return st.elapsed_time(en) / reps


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def spread(t: list[float]) -> dict:
    return {"min": min(t), "median": statistics.median(t), "max": max(t)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src/ directory whose repro_torch to time")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    args = ap.parse_args()
    dtype = getattr(torch, args.dtype)
    if not torch.cuda.is_available():
        raise SystemExit("k6_bwd.py needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels import _build, sliding_window_attention
    from repro_torch.kernels.swa import kernel as k6

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    q, k, v, do = (torch.randn(B, S, h, D, generator=gen, device=dev).to(
        dtype).transpose(1, 2) for h in (HQ, HKV, HKV, HQ))
    o = sliding_window_attention(q, k, v, window=WINDOW, backend="cuda")
    _, lse, delta = k6.swa_bwd_dq(q, k, v, o, do, window=WINDOW)
    fns = {
        "dq": lambda: k6.swa_bwd_dq(q, k, v, o, do, window=WINDOW),
        "dkdv": lambda: k6.swa_bwd_dkdv(q, k, v, do, lse, delta,
                                        window=WINDOW),
        "sum": lambda: k6.swa_bwd_kernel(q, k, v, o, do, window=WINDOW)}
    try:
        part = k6.swa_bwd_dkdv_partial(q, k, v, do, lse, delta, window=WINDOW)
    except (AttributeError, ValueError):   # no partial sums in this type
        part = None
    if part is not None:
        fns["dkdv_kernel"] = lambda: k6.swa_bwd_dkdv_partial(
            q, k, v, do, lse, delta, window=WINDOW)
        fns["fold"] = lambda: k6.swa_bwd_fold(part, k, v)
    i = torch.arange(S, device=dev)[:, None]
    j = torch.arange(S, device=dev)[None, :]
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    lib = F.scaled_dot_product_attention(
        *leaves, attn_mask=(j <= i) & (j > i - WINDOW), enable_gqa=True)
    fns["library"] = lambda: torch.autograd.grad(lib, leaves, do,
                                                 retain_graph=True)
    _build.reset_launches()
    first = k6.swa_bwd_kernel(q, k, v, o, do, window=WINDOW)
    torch.cuda.synchronize()
    launches = {n: c for n, c in _build.LAUNCHES.items() if c}
    again = k6.swa_bwd_kernel(q, k, v, o, do, window=WINDOW)
    equal = all(torch.equal(a, b) for a, b in zip(first, again))
    o_seeded = torch.randn(o.shape, generator=gen, device=dev).to(dtype)
    sha = {"out": digest(o), **dict(zip(("dq", "dk", "dv"), map(digest, (
        k6.swa_bwd_kernel(q, k, v, o_seeded, do, window=WINDOW)))))}
    print(json.dumps({
        "line": "bwd", "src": str(args.src), "shape": [B, HQ, HKV, S, D],
        "window": WINDOW, "dtype": args.dtype,
        **{name: spread(times_ms(fn, args.reps)) for name, fn in fns.items()},
        **({"fold_queued_ms": queued_ms(fns["fold"], args.reps)}
           if "fold" in fns else {}),
        "launches": launches, "bit_equal_twice": equal, "sha256": sha}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
