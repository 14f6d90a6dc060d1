#!/usr/bin/env python3
"""One traced run of a cell of the port's benchmark with the program's own
spans and counters (bench/program_trace.py), on the card this machine
holds: the harness's ``--trace 1`` run with the traced pass and the
program's ranges in place of its profiled chunks.  Prints the result line
last, with the readers of ``program_trace.METRICS`` among its metrics and
the traced pass (µs a call by span, the work tally, K3's clocks) under
``"traced"``.

    python3 scripts/bench_trace.py --workload seismic2d-r12.shots16384-t1 \\
        --seed 7 --seconds 20 [--batch 256]

``--batch`` replaces the traffic's fields a call.  Caches stay under
``build/`` in this checkout, as ``bench/run.py`` keeps them.
"""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
CACHE = ROOT / "build" / "bench"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from bench import harness, program_trace  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--batch", type=int)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_trace: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, batch=args.batch)
    result = program_trace.run(cell, args.seed, args.seconds,
                               torch.device("cuda"))
    print(f"bench_trace: card {harness.yardstick.card_line()}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
