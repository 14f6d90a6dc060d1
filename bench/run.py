#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card this machine
holds, and print one JSON line of results as the last line of stdout.

    python3 bench/run.py --workload seismic2d-r12.shots16384-t1 --seed 7 \\
        --seconds 10 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (the same window, with a span around each call, then a
few chunks under ``torch.profiler``).  The comparison that decides
``correct`` runs after the window in both, and its numbers, each beside
its limit, are the result's last key and the last lines of stderr.  A host
without enough CUDA devices gets no result and a non-zero exit.  Every
build and kernel cache stays under ``build/`` in this checkout.
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

from bench import harness  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    chips = cell.spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda"))
    foreign = harness.foreign_modules()
    if foreign:
        print(f"bench: modules of the JAX side loaded: {foreign}",
              file=sys.stderr)
        return 3
    print(f"bench: card {harness.yardstick.card_line()}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    for line in harness.check_lines(result["checks"]):
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
