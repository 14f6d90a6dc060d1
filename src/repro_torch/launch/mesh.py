"""Mesh factories (port of ``repro.launch.mesh``) and a world of ranks on
one host.

``make_production_mesh`` is a function, not a module-level constant, so that
importing this module touches no process group.  A mesh needs a world: the
ranks of ``torch.distributed``'s default group, which
:func:`run_local_world` spawns on this host (``torchrun`` or any other
launcher does the same across hosts).  The reference's ``TPU_PERF_FLAGS``
(XLA's latency-hiding scheduler and async collectives) has no counterpart:
no compiler schedules the port's collectives.
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import make_mesh_compat


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """(data=16, model=16), or (pod=2, data=16, model=16) with
    ``multi_pod``: the world must hold 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes, device)


def make_local_mesh(data: int = 1, model: int = 1, device: str = "cuda"):
    """Small (data, model) mesh over a world of ``data * model`` ranks
    (tests, examples)."""
    return make_mesh_compat((data, model), ("data", "model"), device)


def _rank_main(rank: int, nprocs: int, tmp: str, fn: Callable,
               args: tuple) -> None:
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(os.path.join(tmp, "store"), nprocs)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=nprocs)
    try:
        torch.save(fn(*args), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_local_world(fn: Callable, nprocs: int, *args,
                    timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` in ``nprocs`` spawned processes that form one gloo
    world (rendezvous through a file in a temporary directory, no port),
    and return what each rank returned, in rank order.

    ``fn`` must be importable by name (a module-level function).  Each rank
    takes card ``rank % device_count`` where there is one: gloo ranks may
    share a card (NCCL ranks may not).  A rank that raises, or a world not
    done within ``timeout`` seconds, raises here; every rank still running
    is killed before this returns."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(nprocs, tmp, fn, args),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=5.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks of {fn.__name__} "
                                       f"not done in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
