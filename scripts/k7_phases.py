#!/usr/bin/env python3
"""Time K7 (``csrc/simbatch.cu``, the batched CGRA cycle engine) phase by
phase on one CUDA card, on the two sweeps ``chip_smoke.py`` launches it on:
the paper's 2D 449x960 stage-1 sweep (workers 1-5, capacities
auto/unbounded: 10 lanes) and the tuner's ``heat_2d(48, 96)`` stage-1 sweep
(84 configs, 30 kept).

    python3 scripts/k7_phases.py                  # this checkout's K7
    python3 scripts/k7_phases.py --items 4 32     # and those instances
    python3 scripts/k7_phases.py --src DIR        # the K7 of DIR's repro_torch

For each sweep, one launch of the whole batch as the main path launches it
(``default`` lines: min / median / max ms over ``--reps`` launches, the
longest lane's cycles, ns a cycle).  For this checkout also one launch of
the clocked instance (``clocked`` lines: its ms, each lane's device ns from
``%globaltimer``, and its carries checked bit for bit against the default
launch's), and ``phases`` lines: ns a cycle in each phase as thread 0 sees
it (``clock64()`` sums over the cycles, turned into ns by the lane's own
ns per clock) for the paper's w = 1 and w = 5 lanes and the heat2d sweep's
longest lane.  With ``--items``, each ``ITEMS`` instance of the kernel
forced on the whole batch (``items`` lines: ms, its carries checked
against the default launch's, each lane's device ns from its clocked
instance).  With ``--src`` (another checkout's ``src/``, such
as its parent's from ``git archive`` into ``build/``, built into that
checkout's ``build/``) only the ``default`` lines, so two checkouts compare
line for line; run both in one call, on one card.  The card's name and
power limit come first.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
MAX_CYCLES = 50_000_000            # simulate_batch's default
HEAT_BUDGETS = (2048, 8192)        # chip_smoke.py: SWEEP_BUDGETS


def sweeps() -> dict:
    """Each sweep's lanes as the main path hands them to K7:
    ``(label, compiled_plan, elems_per_cycle)``."""
    from repro_torch.core import CGRA, heat_2d, paper_stencil_2d
    from repro_torch.core.engine.common import mem_elems_per_cycle
    from repro_torch.core.engine.compile import compiled_for
    from repro_torch.explore import (SpaceOptions, as_target, enumerate_space,
                                     prune_space, tile_candidates)

    def lanes(target, opts):
        configs, analytic = enumerate_space(target, CGRA, opts)
        kept, _ = prune_space(target, CGRA, configs, opts, keep=analytic)
        out = []
        for c in kept:
            plan = target.build(c)
            tile = "x".join(map(str, c.tile)) if c.tile else "full"
            out.append((f"w{c.workers}-{c.capacity}-T{c.temporal}-{tile}",
                        compiled_for(plan),
                        mem_elems_per_cycle(plan.spec, CGRA, 1.0)))
        return out

    heat = heat_2d(48, 96, dtype="float64")
    return {
        "paper_2d": lanes(as_target(paper_stencil_2d()), SpaceOptions(
            capacities=("auto", "unbounded"), fabrics=())),
        "heat2d": lanes(as_target(heat, workload_timesteps=2), SpaceOptions(
            temporal=(1, 2), capacities=("auto", "unbounded"),
            tiles=(None,) + tuple(t for t in tile_candidates(
                heat, HEAT_BUDGETS) if t is not None), fabrics=()))}


def times_ms(fn, reps: int) -> list[float]:
    fn()                                           # warm-up
    out = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return out


def spread(t: list[float]) -> dict:
    return {"min": min(t), "median": statistics.median(t), "max": max(t)}


def carries(k7, d) -> list[dict]:
    torch.cuda.synchronize()
    return k7.unpack(d)


def same(a: list[dict], b: list[dict]) -> bool:
    return all(np.array_equal(np.asarray(x[k]), np.asarray(y[k]))
               for x, y in zip(a, b) for k in x)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src/ directory whose repro_torch to time")
    ap.add_argument("--items", type=int, nargs="*", default=[],
                    help="ITEMS instances to force on each sweep")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k7_phases.py needs a CUDA device")
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels.simbatch import kernel as k7

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    this = args.src.resolve() == (ROOT / "src").resolve()
    for name, lanes in sweeps().items():
        batch = [(cp, epc) for _, cp, epc in lanes]
        d = k7.upload(k7.pack(batch), dev)
        t = times_ms(lambda: k7.launch(d, MAX_CYCLES), args.reps)
        want = carries(k7, d)
        cycles = [int(c["cycles"]) for c in want]
        longest = max(cycles)
        print(json.dumps({
            "line": "default", "src": str(args.src), "sweep": name,
            "lanes": len(lanes), "threads": d.packed.threads,
            "items": getattr(d.packed, "items", None), "ms": spread(t),
            "longest_cycles": longest,
            "ns_per_cycle": statistics.median(t) * 1e6 / longest}),
            flush=True)
        if not this:
            continue
        clocks = torch.zeros((len(lanes), k7.CLOCK_WIDTH), dtype=torch.int64,
                             device=dev)
        tc = times_ms(lambda: k7.launch(d, MAX_CYCLES, clocks), 1)
        rec = clocks.cpu().numpy()
        f = {k: i for i, k in enumerate(k7.CLOCK_FIELDS)}
        lane_ns = (rec[:, f["end_ns"]] - rec[:, f["start_ns"]]).tolist()
        print(json.dumps({
            "line": "clocked", "sweep": name, "ms": tc[0],
            "bit_equal": same(carries(k7, d), want),
            "lane": [label for label, _, _ in lanes], "cycles": cycles,
            "device_ns": lane_ns}), flush=True)
        shown = ([i for i, (label, _, _) in enumerate(lanes)
                  if label.startswith(("w1-", "w5-"))]
                 if name == "paper_2d" else [int(np.argmax(cycles))])
        for i in shown:
            ns_per_clock = lane_ns[i] / max(int(rec[i, f["total"]]), 1)
            print(json.dumps({
                "line": "phases", "sweep": name, "lane": lanes[i][0],
                "nodes": lanes[i][1].n_nodes, "edges": lanes[i][1].n_edges,
                "cycles": cycles[i], "device_ns": lane_ns[i],
                "ns_per_clock": ns_per_clock,
                "ns_per_cycle": {p: rec[i, f[p]] * ns_per_clock / cycles[i]
                                 for p in k7.PHASES}}), flush=True)
        for items in args.items:
            di = k7.upload(k7.pack(batch, items=items), dev)
            ti = times_ms(lambda: k7.launch(di, MAX_CYCLES), args.reps)
            equal = same(carries(k7, di), want)
            k7.launch(di, MAX_CYCLES, clocks)
            rec = clocks.cpu().numpy()
            print(json.dumps({
                "line": "items", "sweep": name, "items": items,
                "threads": di.packed.threads, "ms": spread(ti),
                "bit_equal": equal, "device_ns": (
                    rec[:, f["end_ns"]] - rec[:, f["start_ns"]]).tolist()}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
