"""Heat diffusion (the paper's application domain) end-to-end, multi-device,
on the PyTorch port.

A 2D heat equation is stepped with the 5-pt Jacobi stencil:
  * sharded over a (2, 4) ("pod", "data") mesh of 8 ranks with halo
    exchange (point-to-point messages: the paper's PE-to-PE forwarding at
    device scale),
  * T time-steps fused per exchange (§IV temporal pipelining),
  * validated against the single-device oracle every fused block.

The script spawns its 8 ranks itself, one gloo world.  By default every
rank's shard lies on the card and is swept by K3 (``stencil2d``), the halo
slabs travelling through the host; ``--device cpu`` keeps the shards on the
CPU (the stencil's plain version).  Without a card and without
``--device cpu`` it exits non-zero: it never falls back.

Run:  PYTHONPATH=src python examples/heat2d_distributed_torch.py [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.core import heat_2d, stencil_reference_np
from repro_torch.distributed.halo import (distributed_stencil2d,
                                          halo_bytes_per_step)
from repro_torch.distributed.sharding import (PartitionSpec, make_mesh_compat,
                                              placements, shard_offsets)
from repro_torch.kernels import _build
from repro_torch.launch.mesh import run_local_world

MESH = ((2, 4), ("pod", "data"))
GRID = (256, 512)
FUSE_T = 4
BLOCKS = 3


def make_spec():
    return dataclasses.replace(heat_2d(*GRID, alpha=0.12), timesteps=FUSE_T)


def initial() -> np.ndarray:
    return np.random.default_rng(0).normal(size=GRID).astype(np.float32)


def rank_main(device: str) -> dict:
    """One rank: its shard of the grid stepped ``BLOCKS`` fused blocks;
    returns where its shard starts, the shard after each block, and the
    kernel launches it made."""
    mesh = make_mesh_compat(*MESH, device=device)
    step = distributed_stencil2d(make_spec(), mesh, axes=MESH[1])
    u = distribute_tensor(torch.from_numpy(initial()).to(device), mesh,
                          placements(PartitionSpec(*MESH[1]), mesh),
                          src_data_rank=None)
    _build.reset_launches()
    blocks = []
    for _ in range(BLOCKS):
        u = step(u)
        blocks.append(u.to_local().cpu().numpy())
    return {"start": shard_offsets(blocks[0].shape, mesh, u.placements,
                                   mesh.get_coordinate()),
            "blocks": blocks, "launches": dict(_build.LAUNCHES)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run with --device cpu for the "
                         "CPU ranks")
    spec = make_spec()
    print(f"mesh {dict(zip(MESH[1], MESH[0]))}; fusing T={FUSE_T} steps per "
          f"halo exchange; halo traffic/exchange = "
          f"{halo_bytes_per_step(spec, MESH[0]) / 1024:.1f} KiB "
          f"(vs {GRID[0] * GRID[1] * 4 / 1024:.0f} KiB full grid)")

    t0 = time.time()
    ranks = run_local_world(rank_main, 8, args.device)
    wall = time.time() - t0
    u_ref = initial()
    for block in range(BLOCKS):
        u = np.full(GRID, np.nan, np.float32)
        for r in ranks:
            y0, x0 = r["start"]
            a = r["blocks"][block]
            u[y0:y0 + a.shape[0], x0:x0 + a.shape[1]] = a
        u_ref = stencil_reference_np(u_ref, spec)
        err = float(np.abs(u - u_ref).max())
        print(f"fused block {block}: {FUSE_T} steps, max err vs oracle "
              f"{err:.2e}")
        assert err < 1e-4
    if args.device == "cuda":
        launched = [r["launches"].get("stencil2d", 0) for r in ranks]
        print(f"K3 launches per rank: {launched}")
        assert launched == [BLOCKS] * len(ranks)
    print(f"done in {wall:.2f}s (8 ranks spawned) — {BLOCKS * FUSE_T} heat "
          f"steps, {BLOCKS} halo exchanges (4x fewer messages than unfused)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
