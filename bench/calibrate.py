#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card: short runs of
the cell at its own size over many seeds in one process, with the grids in
the configuration's type (the program, the lower reading) or in bfloat16
(the control, the program's own lower-precision path, the upper reading).
Not run by the benchmark's runs.

    python3 bench/calibrate.py --workload seismic2d-r12.shots16384-t1 \\
        --dtype float32 --seconds 2 --seeds 11 12 13

Prints one JSON line per seed, then the largest and least reading of each
number compared.
"""
import argparse
import json
import sys

import run  # noqa: F401  (the run's environment, caches and import path)
import torch

from bench import harness


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    readings: dict[str, list[float]] = {}
    for seed in args.seeds:
        r = harness.run(cell, seed, args.seconds, False, torch.device("cuda"),
                        dtype=args.dtype)
        for k, c in r["checks"].items():
            readings.setdefault(k, []).append(c["value"])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": args.dtype or cell.config["dtype"],
                          "correct": r["correct"], "attempted": r["attempted"],
                          "checks": r["checks"],
                          "metrics": {k: m["value"]
                                      for k, m in r["metrics"].items()}}),
              flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds),
                      "largest": {k: max(v) for k, v in readings.items()},
                      "least": {k: min(v) for k, v in readings.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
