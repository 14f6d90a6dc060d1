#!/usr/bin/env python3
"""Where a halo exchange's time goes on one card: gloo ranks sharing it.

    PYTHONPATH=src python3 scripts/dist_exchange.py [--ranks 4] [--reps 10]

Spawns ``--ranks`` gloo ranks (``run_local_world``) on a line along one
mesh axis, as ``chip_smoke.py``'s ``distributed`` phase does, and for each
slab size (one side of one rank's exchange: the phase's 1D, 2D and 3D slabs
and two more) times, barrier to barrier, median of ``--reps`` after one
warm-up:

- ``host_ms``: ``halo_exchange`` of a CPU tensor (gloo alone);
- ``card_ms``: ``halo_exchange`` of a CUDA tensor (the transport rule's
  copies to the host and back included);
- ``copies_ms``: those copies alone (each slab to the host, then back).

Prints one JSON line a size, the card's name and power limit, and last
``{"ok": true, ...}``.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.distributed.halo import halo_exchange  # noqa: E402
from repro_torch.distributed.sharding import make_mesh_compat  # noqa: E402
from repro_torch.launch.mesh import run_local_world  # noqa: E402

# bytes of one slab: 1D (32 f32), 2D (48 rows of 4096), 3D (4 planes of
# 256 x 512), and two between and past them
SLAB_BYTES = (128, 32 << 10, 48 * 4096 * 4, 4 * 256 * 512 * 4, 8 << 20)
COLS = 4096


def _timed(fn, reps: int) -> float:
    times = []
    for _ in range(reps + 1):
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def rank_main(ranks: int, reps: int) -> list[dict]:
    mesh = make_mesh_compat((ranks,), ("data",))
    group = mesh.get_group("data")
    rows = []
    for nbytes in SLAB_BYTES:
        cols = min(COLS, nbytes // 4)
        halo = nbytes // 4 // cols
        host = torch.randn(2 * halo, cols)
        card = host.cuda()
        slab = card[:halo]

        def copies():
            for _ in range(2):                   # both sides' slabs
                slab.to("cpu").to(card.device)
        rows.append({
            "slab_bytes": halo * cols * 4,
            "host_ms": _timed(lambda: halo_exchange(host, halo, group, 0),
                              reps),
            "card_ms": _timed(lambda: halo_exchange(card, halo, group, 0),
                              reps),
            "copies_ms": _timed(copies, reps)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dist_exchange.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    ranks = run_local_world(rank_main, args.ranks, args.ranks, args.reps)
    for i, row in enumerate(ranks[0]):
        print(json.dumps({"ranks": args.ranks, **row,
                          "card_ms_by_rank": [r[i]["card_ms"]
                                              for r in ranks]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
