#!/usr/bin/env python3
"""Time K6's f32 forward (``csrc/swa.cu``, ``swa_f32_kernel``) at
RecurrentGemma-2B's prefill shape on one CUDA card: q (2, 10, 4096, 256)
over k and v (2, 1, 4096, 256), window 2048, f32, as the model's
(B, S, H, D) projections viewed as (B, H, S, D).

    python3 scripts/k6_f32.py                 # this checkout's kernel
    python3 scripts/k6_f32.py --src DIR       # that of DIR's repro_torch
    python3 scripts/k6_f32.py --parts         # where the time goes

One ``fwd`` line: min / median / max ms over ``--reps`` calls (CUDA
events, warm) of the kernel as the op calls it (``swa_kernel``), of its
plain version (``swa_plain``) and of ``scaled_dot_product_attention`` in
f32 with the band as its mask and GQA (``library``); the bound (the band's
(query, key) pairs at 4·D flops each, the lesser of the FP32 cores' time
and three TF32 products' time, with the peak that sets it); the largest
difference from the plain version; whether two calls gave equal bits; the
launches one call makes; and ``ptxas``'s registers and spills of the f32
kernel at Dp = 256 where the build log names it.  With ``--src`` (another
checkout's ``src/``, such as its parent's from ``git archive`` into
``build/``, built into that checkout's ``build/``) the same line, so two
checkouts compare line for line: run them in one call, on one card, in
turns.  With ``--parts`` (this checkout only) one ``part`` line for each
copy of ``swa.cu`` and the shared headers patched to drop or change one
part of the work, built under the git-ignored ``build/k6_f32/``:
``tree`` as committed, ``one`` one TF32 product a product in place of
three, ``nomma`` no product (its operands kept live), ``nobar`` without
the pair's named barriers (wrong results: the time the pairs wait for
each other).  The card's name and power limit come first.
"""
import argparse
import hashlib
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
B, HQ, HKV, S, D, WINDOW = 2, 10, 1, 4096, 256, 2048
# dense peaks of the H100 SXM (NVIDIA's datasheet): FP32 cores, TF32 tensor
# cores
FP32_FLOPS, TF32_FLOPS = 67e12, 494.5e12
MMA3 = """  mma_tf32(c, a.lo, bh[0], bh[1]);
  mma_tf32(c, a.hi, bl[0], bl[1]);
  mma_tf32(c, a.hi, bh[0], bh[1]);"""
MMA3_APART = """  mma_tf32(small, a.lo, bh[0], bh[1]);
  mma_tf32(small, a.hi, bl[0], bl[1]);
  mma_tf32(big, a.hi, bh[0], bh[1]);"""
BAR = "bar_sync(1 + wr, 64);"


def keep(acc: str, frag: str, b0: str, b1: str) -> str:
    """An empty asm that reads a product's operands and its accumulator, so
    nothing feeding it is dropped."""
    return (f'  asm volatile("" : "+f"({acc}[0]), "+f"({acc}[1]), "+f"({acc}[2]), '
            f'"+f"({acc}[3]) : "r"({frag}[0]), "r"({frag}[1]), "r"({frag}[2]), '
            f'"r"({frag}[3]), "r"({b0}), "r"({b1}));')


# variant -> [(text, replacement, times it must occur in swa.cu and the
# headers together)]
PATCHES = {
    "tree": [],
    "one": [(MMA3, "  mma_tf32(c, a.hi, bh[0], bh[1]);", 1),
            (MMA3_APART, "  mma_tf32(big, a.hi, bh[0], bh[1]);", 1)],
    "nomma": [(MMA3, "\n".join(keep("c", f, b0, b1) for f, b0, b1 in (
                  ("a.lo", "bh[0]", "bh[1]"), ("a.hi", "bl[0]", "bl[1]"),
                  ("a.hi", "bh[0]", "bh[1]"))), 1),
              (MMA3_APART, "\n".join(keep(acc, f, b0, b1) for acc, f, b0, b1 in (
                  ("small", "a.lo", "bh[0]", "bh[1]"),
                  ("small", "a.hi", "bl[0]", "bl[1]"),
                  ("big", "a.hi", "bh[0]", "bh[1]"))), 1)],
    "nobar": [(BAR, "", 3)],
}


def band_pairs() -> int:
    """(query, key) pairs of the band: query i meets min(i + 1, window)
    keys, for each batch row and query head."""
    return B * HQ * sum(min(i + 1, WINDOW) for i in range(S))


def bound_ms() -> tuple[float, str]:
    flops = band_pairs() * 4 * D           # q·k and p·v, 2 D flops each
    return min((flops / FP32_FLOPS * 1e3, "FP32 cores"),
               (3 * flops / TF32_FLOPS * 1e3, "3xTF32 tensor cores"))


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


def spread(t: list[float]) -> dict:
    return {"min": min(t), "median": statistics.median(t), "max": max(t)}


def f32_ptxas(log: str) -> list[str]:
    """ptxas's lines of registers and spills for the f32 forward at
    Dp = 256, or for its CUDA-core instance of 8 columns a lane."""
    for entry in log.split("Compiling entry function")[1:]:
        head, _, body = entry.partition("\n")
        if re.search(r"swa_f32_kernelILi(256|8)E", head):
            return [ln.split(":", 1)[-1].strip() for ln in body.splitlines()
                    if "registers" in ln or "spill" in ln]
    return []


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def use_variant(build, name: str, csrc: Path) -> None:
    """Point the build at a copy of the sources patched for ``name``."""
    files = {p.name: p.read_text() for p in [csrc / "swa.cu", *csrc.glob("*.cuh")]}
    for old, new, times in PATCHES[name]:
        if sum(text.count(old) for text in files.values()) != times:
            raise SystemExit(f"variant {name}: its patch no longer applies")
        files = {n: text.replace(old, new) for n, text in files.items()}
    d = ROOT / "build" / "k6_f32" / name
    d.mkdir(parents=True, exist_ok=True)
    for n, text in files.items():
        (d / n).write_text(text)
    build.CSRC, build.BUILD_DIR = d, d / "lib"
    build._libs.clear()
    build.build("swa")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src/ directory whose repro_torch to time")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parts", action="store_true",
                    help="time patched copies of this checkout's kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k6_f32.py needs a CUDA device")
    if args.parts and args.src.resolve() != (ROOT / "src").resolve():
        raise SystemExit("--parts patches this checkout's sources only")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels import _build
    from repro_torch.kernels.swa.kernel import swa_kernel
    from repro_torch.kernels.swa.ops import swa_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    q, k, v = (torch.randn(B, S, h, D, generator=gen, device=dev).transpose(1, 2)
               for h in (HQ, HKV, HKV))
    run = lambda: swa_kernel(q, k, v, window=WINDOW)  # noqa: E731
    plain = swa_plain(q, k, v, window=WINDOW)
    ms, by = bound_ms()
    if args.parts:
        csrc = _build.CSRC
        for name in PATCHES:
            use_variant(_build, name, csrc)
            row = {"line": "part", "variant": name,
                   "ptxas_f32_dp256": f32_ptxas(_build.build_log("swa")),
                   "ms": spread(times_ms(run, args.reps))}
            if name == "tree":
                row["max_abs_err"] = (run() - plain).abs().max().item()
            print(json.dumps(row), flush=True)
        return 0
    i = torch.arange(S, device=dev)[:, None]
    j = torch.arange(S, device=dev)[None, :]
    band = (j <= i) & (j > i - WINDOW)
    _build.reset_launches()
    first = run()
    torch.cuda.synchronize()
    launches = {n: c for n, c in _build.LAUNCHES.items() if c}
    again = run()
    print(json.dumps({
        "line": "fwd", "src": str(args.src), "shape": [B, HQ, HKV, S, D],
        "window": WINDOW, "dtype": "float32",
        "ms": spread(times_ms(run, args.reps)),
        "bound_ms": ms, "bound_peak": by, "band_pairs": band_pairs(),
        "plain_ms": spread(times_ms(lambda: swa_plain(q, k, v, window=WINDOW),
                                    5)),
        "library_ms": spread(times_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=band, enable_gqa=True), 5)),
        "max_abs_err": (first - plain).abs().max().item(),
        "out_stride": list(first.stride()), "q_stride": list(q.stride()),
        "bit_equal_twice": torch.equal(first, again), "sha256": digest(first),
        "launches": launches,
        "ptxas_f32_dp256": f32_ptxas(_build.build_log("swa"))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
