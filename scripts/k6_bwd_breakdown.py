#!/usr/bin/env python3
"""Where K6's f32 backward spends its time (``csrc/swa_bwd.cu``,
``swa_bwd_dq_f32_kernel`` and ``swa_bwd_dkdv_f32_kernel``): time it as the
tree has it and in copies patched to drop or change one part of its work,
on one CUDA card at RecurrentGemma-2B's training shape, q (1, 10, 4096,
256) over k and v (1, 1, 4096, 256), window 2048, f32, the model's
(B, S, H, D) views.

    python3 scripts/k6_bwd_breakdown.py

Variants (each a copy of ``swa_bwd.cu`` and the shared headers under the
git-ignored ``build/k6_bwd_breakdown/`` with its own build):
- ``tree``: as committed; its gradients' norm-relative error against the
  plain version is printed;
- ``cvt``: operands split by ``cvt.rna.tf32.f32`` into two TF32 parts, as
  K2 splits them, in place of the two integer operations and one
  subtraction of ``split``;
- ``nosplit``: no split: the operand as hi, zero as lo (the split's share;
  the three products still run);
- ``one``: one TF32 product a product in place of three (two thirds of the
  tensor cores' work gone);
- ``nomma``: no product runs; its operands are kept live (what the loads,
  splits, softmax, barriers and stores take alone);
- ``parts2``: ``swa_bwd_dkdv`` split into bf16's 2 parts (F32_PARTS_WAVES
  1) in place of 6 (the balance of its blocks).
One JSON line per variant: median of 10 CUDA-event times after 3 warm-up
calls of ``swa_bwd_dq``, of ``swa_bwd_dkdv``'s kernel (partial sums) and of
the whole backward, and the ``ptxas`` registers and spills of the two f32
kernels at Dp = 256; the card's name and power limit first.
"""
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build, sliding_window_attention  # noqa: E402
from repro_torch.kernels.swa import kernel as k6  # noqa: E402
from repro_torch.kernels.swa.ref import swa_bwd_ref  # noqa: E402

EXP = ROOT / "build" / "k6_bwd_breakdown"
CSRC = ROOT / "src" / "repro_torch" / "csrc"
B, HQ, HKV, S, D, WINDOW = 1, 10, 1, 4096, 256, 2048
SPLIT = """  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));"""
MMA3 = """  mma_tf32(c, a.lo, bh[0], bh[1]);
  mma_tf32(c, a.hi, bl[0], bl[1]);
  mma_tf32(c, a.hi, bh[0], bh[1]);"""
MMA3_APART = """  mma_tf32(small, a.lo, bh[0], bh[1]);
  mma_tf32(small, a.hi, bl[0], bl[1]);
  mma_tf32(big, a.hi, bh[0], bh[1]);"""


def keep(acc: str, frag: str, b0: str, b1: str) -> str:
    """An empty asm that reads a product's operands and its accumulator, so
    nothing feeding it is dropped."""
    return (f'  asm volatile("" : "+f"({acc}[0]), "+f"({acc}[1]), "+f"({acc}[2]), '
            f'"+f"({acc}[3]) : "r"({frag}[0]), "r"({frag}[1]), "r"({frag}[2]), '
            f'"r"({frag}[3]), "r"({b0}), "r"({b1}));')


PATCHES = {
    "tree": [],
    "cvt": [(SPLIT, """  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(v));
  const float r = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(r));""")],
    "nosplit": [(SPLIT, """  hi = __float_as_uint(v);
  lo = 0u;""")],
    "one": [(MMA3, "  mma_tf32(c, a.hi, bh[0], bh[1]);"),
            (MMA3_APART, "  mma_tf32(big, a.hi, bh[0], bh[1]);")],
    "nomma": [(MMA3, "\n".join(keep("c", f, b0, b1) for f, b0, b1 in (
                  ("a.lo", "bh[0]", "bh[1]"), ("a.hi", "bl[0]", "bl[1]"),
                  ("a.hi", "bh[0]", "bh[1]")))),
              (MMA3_APART, "\n".join(keep(acc, f, b0, b1) for acc, f, b0, b1 in (
                  ("small", "a.lo", "bh[0]", "bh[1]"),
                  ("small", "a.hi", "bl[0]", "bl[1]"),
                  ("big", "a.hi", "bh[0]", "bh[1]"))))],
    "parts2": [],
}


def use_variant(name: str) -> None:
    """Point the build at a copy of the sources patched for ``name`` (each
    patch in ``swa_bwd.cu`` or a header, once)."""
    files = {p.name: p.read_text()
             for p in [CSRC / "swa_bwd.cu", *CSRC.glob("*.cuh")]}
    for old, new in PATCHES[name]:
        if sum(text.count(old) for text in files.values()) != 1:
            raise SystemExit(f"variant {name}: its patch no longer applies")
        files = {n: text.replace(old, new) for n, text in files.items()}
    d = EXP / (name if PATCHES[name] else "tree")
    d.mkdir(parents=True, exist_ok=True)
    for n, text in files.items():
        (d / n).write_text(text)
    _build.CSRC, _build.BUILD_DIR = d, d / "lib"
    _build._libs.clear()
    _build.build("swa_bwd")
    k6.F32_PARTS_WAVES = 1 if name == "parts2" else 3


def f32_ptxas() -> dict[str, list[str]]:
    """The registers and spills ptxas reported for the f32 kernels at
    Dp = 256 in the current build's log."""
    out = {}
    for entry in _build.build_log("swa_bwd").split("Compiling entry function")[1:]:
        head, _, body = entry.partition("\n")
        if "f32_kernelILi256" in head:
            out["dq" if "dq_f32" in head else "dkdv"] = [
                ln.split(":", 1)[-1].strip() for ln in body.splitlines()
                if "registers" in ln or "spill" in ln]
    return out


def median_ms(fn, reps: int = 10) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k6_bwd_breakdown.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn(B, S, h, D, generator=gen, device=dev
                               ).transpose(1, 2) for h in (HQ, HKV, HKV, HQ))
    o = sliding_window_attention(q, k, v, window=WINDOW, backend="cuda")
    for name in PATCHES:
        use_variant(name)
        _, lse, delta = k6.swa_bwd_dq(q, k, v, o, do, window=WINDOW)
        row = {"variant": name, "ptxas_f32_dp256": f32_ptxas(),
               "dq_ms": median_ms(lambda: k6.swa_bwd_dq(
                   q, k, v, o, do, window=WINDOW)),
               "dkdv_kernel_ms": median_ms(lambda: k6.swa_bwd_dkdv_partial(
                   q, k, v, do, lse, delta, window=WINDOW)),
               "sum_ms": median_ms(lambda: k6.swa_bwd_kernel(
                   q, k, v, o, do, window=WINDOW))}
        if name == "tree":
            got = k6.swa_bwd_kernel(q, k, v, o, do, window=WINDOW)
            want = swa_bwd_ref(q, k, v, do, window=WINDOW)
            row["rel_err"] = [(g - w).norm().item() / w.norm().item()
                              for g, w in zip(got, want)]
            del got, want
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
