#!/usr/bin/env python3
"""Time K1 (``csrc/stencil1d.cu``, ``variant="vpu"``) at a set of tiles
beside the one ``plan_1d_blocks`` picks, on one CUDA card at the deployment
shape (1024, 194400) with the paper's 17-pt taps, T = 1 and T = 4, f32 and
bf16: the measurement behind the vpu planner's limits (``MAX_BLOCK_B``,
``MAX_BLOCK_N`` in ``kernels/stencil1d/ops.py``).

    python3 scripts/k1_tiles.py

Tiles whose shared memory exceeds one block's are skipped.  One JSON line
per case: the tile, whether it is the planned one, its shared memory, the
blocks an SM that shared memory allows (the card reserves 1 KB a block),
the median of 20 CUDA-event times after 3 warm-up calls, and the max error
against the plain version.  The card's name and power limit come first.
"""
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import paper_stencil_1d  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.stencil1d.kernel import (smem_bytes,  # noqa: E402
                                                  stencil1d_kernel)
from repro_torch.kernels.stencil1d.ops import plan_1d_blocks  # noqa: E402
from repro_torch.kernels.stencil1d.ref import stencil1d_ref  # noqa: E402

SHAPE = (1024, 194400)
TILES = {1: [(16, 512), (8, 1024), (4, 1024), (2, 2048), (4, 2048),
             (8, 2048), (2, 4096), (4, 4096)],
         4: [(8, 512), (4, 512), (2, 1024), (4, 1024), (2, 2048), (4, 2048)]}


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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k1_tiles.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    limit = _build.smem_per_block(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    taps = paper_stencil_1d(dtype="float32").coeffs[0]
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(SHAPE, generator=gen, device=dev).to(dt)
        for t, tiles in TILES.items():
            plan = plan_1d_blocks(SHAPE[1], SHAPE[0], 8, t, "vpu", limit,
                                  x.element_size())
            want = stencil1d_ref(x, taps, t).float()
            for block in tiles + ([plan] if plan not in tiles else []):
                smem = smem_bytes("vpu", 8, t, *block, x.element_size())
                if smem > limit:
                    continue

                def run():
                    return stencil1d_kernel(x, taps, timesteps=t, block=block)
                err = (run().float() - want).abs().max().item()
                print(json.dumps({
                    "dtype": str(dt).removeprefix("torch."), "timesteps": t,
                    "block": block, "planned": block == plan, "smem": smem,
                    "blocks_per_sm": (limit + 1024) // (smem + 1024),
                    "ms": median_ms(run), "max_abs_err": err}), flush=True)
            del want
        del x
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
