"""Training driver with the fault-tolerance loop (port of
``repro.launch.train``).

  * resume from the latest checkpoint (atomic manager; the position of
    the batches the loop consumed rides in the manifest, so the batch order
    and the losses survive restarts);
  * async checkpoints every --ckpt-every steps (the leaves are copied to
    the host before the next step updates them in place);
  * step-time EMA watchdog: a step beyond k sigma is logged and, with
    --watchdog-abort, checkpointed and exits 42 so a supervisor restarts
    the job from the last checkpoint;
  * microbatch gradient accumulation, remat, optional gradient compression;
  * --data-par D --model-par M: a world of D·M ranks on a
    ``make_local_mesh(D, M)``.  Rank (d, m) takes rows [d·B/D, (d+1)·B/D)
    of each global batch and holds its slice of every parameter that the
    sharding rules split over ``model`` (FSDP off, as the reference's
    trainer places nothing by "fsdp"); the step runs under
    ``mesh_context`` (``distributed/tensor_parallel.py``).  Tensor
    and data parallelism cover every family (the MoE's experts split
    over ``model``, or each expert's ``d_ff`` where the experts do not
    divide it; RWKV-6's WKV heads split over ``model``; whisper's
    encoder, decoder and cross-attention heads, each model rank of a
    data rank taking the same rows of the frames; qwen2-vl's heads, its
    tokens alone fed, as the reference's trainer feeds them).  The world
    is the default process group when one is initialized
    (``launch.mesh.run_local_world``, a test), else torchrun's
    environment (NCCL for ``--device cuda``, gloo for ``cpu``); rank 0
    alone prints and writes checkpoints;
  * elastic resume: checkpoints are mesh-agnostic whole arrays (gathered
    before the write), so --data-par/--model-par may differ across
    restarts.

--device defaults to ``cuda`` and raises when there is no GPU;
RecurrentGemma then trains through K5 and K6 and their backward kernels,
on each rank's shard.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir build/ck \\
      [--device cpu]
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.train --device cpu --reduced \\
      --data-par 2 --model-par 2
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.collectives import EFState
from repro_torch.models import params as pr
from repro_torch.models.registry import build_model
from repro_torch.train.optim import AdamWState, OptConfig, init_opt_state
from repro_torch.train.train_step import make_train_step

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the arch's reduced config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=["none", "full", "dots"])
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--watchdog-sigma", type=float, default=6.0)
    ap.add_argument("--watchdog-abort", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-pattern", default="markov",
                    choices=["uniform", "markov"])
    ap.add_argument("--override", action="append", default=[],
                    help="config overrides, e.g. --override num_layers=8 "
                         "--override d_model=512")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _config(args):
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    if args.override:
        kv = {}
        for ov in args.override:
            k, v = ov.split("=", 1)
            cur = getattr(cfg, k)
            kv[k] = type(cur)(v) if not isinstance(cur, bool) else v == "True"
        cfg = dataclasses.replace(cfg, **kv)
    return cfg


class World:
    """This rank's place in a run: the mesh (None on one device), its data
    index and count, its global rank, and whether the run opened the
    process group itself (and so closes it)."""

    def __init__(self, args, dev: torch.device):
        self.mesh, self.opened = None, False
        self.data, self.data_size, self.rank = 0, 1, 0
        n = args.data_par * args.model_par
        if n == 1:
            return
        if not dist.is_initialized():
            if not all(k in os.environ for k in TORCHRUN_ENV):
                raise SystemExit(
                    f"--data-par {args.data_par} --model-par "
                    f"{args.model_par} trains in a world of {n} ranks and "
                    "no process group is initialized: launch it as "
                    f"`torchrun --standalone --nproc-per-node {n} -m "
                    "repro_torch.launch.train ...`, or call run() in each "
                    "rank of an initialized world (e.g. "
                    "repro_torch.launch.mesh.run_local_world)")
            if dev.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
            self.opened = True
        if dist.get_world_size() != n:
            raise SystemExit(f"--data-par {args.data_par} x --model-par "
                             f"{args.model_par} = {n} ranks, but the world "
                             f"has {dist.get_world_size()}")
        from repro_torch.launch.mesh import make_local_mesh
        self.mesh = make_local_mesh(args.data_par, args.model_par,
                                    device=dev.type)
        axis = tp.data_axis(self.mesh)
        self.data = axis.rank if axis is not None else 0
        self.data_size, self.rank = args.data_par, dist.get_rank()

    def any(self, flag: bool, dev: torch.device) -> bool:
        """``flag`` of any rank (a max over the world); ``flag`` itself on
        one device."""
        if self.mesh is None:
            return flag
        axis = tp.Axis("world", None, self.rank, dist.get_world_size())
        return bool(tp.max_over(torch.tensor([float(flag)], device=dev),
                                axis)[0])

    def close(self) -> None:
        if self.opened:
            dist.destroy_process_group()


_KEEP = object()


def _map_state(tree: dict, fn, step=_KEEP) -> dict:
    """{params, opt} with ``fn(name, leaf)`` applied to each parameter's
    leaves (the parameter, its moments, its error feedback); the optimizer
    step as it is, or ``step``."""
    def each(d):
        return {n: fn(n, t) for n, t in d.items()}
    opt = tree["opt"]
    ef = (None if opt.ef is None else
          {n: EFState(fn(n, e.error)) for n, e in opt.ef.items()})
    return {"params": each(tree["params"]), "opt": AdamWState(
        step=opt.step if step is _KEEP else step, m=each(opt.m),
        v=each(opt.v), ef=ef)}


def run(argv=None, *, before_step: Callable | None = None,
        after_step: Callable | None = None) -> tuple[int, list[float]]:
    """Runs the loop: (exit code, the loss of each step this run took; in
    a world, the global batch's loss on every rank).  The programmatic
    interface; :func:`main` is the command line's.  ``before_step(step)``
    and ``after_step(step, info)`` (info: loss, aux, seconds, model, mesh)
    run around each step, for instrumentation."""
    args = parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device "
                         "(torch.cuda.is_available() is False); pass "
                         "--device cpu to run on the CPU")
    cfg = _config(args)
    if args.batch % (args.data_par * args.microbatches):
        raise SystemExit(f"--batch {args.batch} does not split into "
                         f"--data-par {args.data_par} x --microbatches "
                         f"{args.microbatches} equal parts")
    tp.check_moe_groups(cfg, args.batch, args.seq, args.data_par,
                        args.microbatches)
    world = World(args, dev)
    if world.mesh is not None and dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    try:
        with (contextlib.nullcontext() if world.mesh is None
              else _mesh_context(world.mesh)):
            return _train(args, cfg, dev, world, before_step, after_step)
    finally:
        world.close()


def _mesh_context(mesh):
    from repro_torch.distributed.sharding import mesh_context
    return mesh_context(mesh)


def _train(args, cfg, dev: torch.device, world: World, before_step,
           after_step) -> tuple[int, list[float]]:
    mesh, lead = world.mesh, world.rank == 0
    model = build_model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(args.seed))
    layout = None
    if mesh is not None:
        layout = tp.parameter_layout(model, mesh)
        tp.shard_parameters(model, layout, mesh)
    params = dict(model.named_parameters())

    opt_cfg = OptConfig(lr=args.lr, warmup_steps=args.warmup,
                        total_steps=args.steps,
                        compression=args.compression)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed,
                                  host_index=world.data,
                                  host_count=world.data_size,
                                  pattern=args.data_pattern))

    # --- init or resume ------------------------------------------------------
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    opt_state = init_opt_state(params, opt_cfg)
    start_step = 0
    if mgr and args.resume and mgr.latest_step() is not None:
        step = mgr.latest_step()
        tree = {"params": params, "opt": opt_state}
        if mesh is None:
            state, extra = mgr.restore(step, tree)
        else:       # whole leaves (meta), each rank given its slices
            specs = model.specs()
            state, extra = mgr.restore(
                step, _map_state(tree, lambda n, t: torch.empty(
                    specs[n].shape, dtype=t.dtype, device="meta")),
                _map_state(tree, lambda n, t: layout[n], step=None),
                mesh=mesh)
            state = _map_state(state, lambda n, t: t.to(dev),
                               step=state["opt"].step.to(dev))
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(state["params"][name])
        opt_state = state["opt"]
        data.restore(extra["data"])
        start_step = extra["train_step"]
        if lead:
            print(f"[resume] from checkpoint step {step} "
                  f"(train step {start_step})", flush=True)

    # The stream's position as of the batches this loop took.  The JAX
    # package saves data.state(), which the prefetch thread has already
    # moved up to depth + 1 batches ahead, so its resume skips batches; the
    # manifest's format ({"step": k}) is the same.
    consumed = data.state()["step"]

    def save(step: int, train_step: int, blocking: bool) -> None:
        tree = {"params": params, "opt": opt_state}
        if mesh is not None:    # every rank of a model group takes part
            tree = _map_state(tree, lambda n, t: tp.whole_of(t, mesh,
                                                             layout[n]))
        if lead:
            mgr.save(step, tree, extra={"data": {"step": consumed},
                                        "train_step": train_step},
                     blocking=blocking)

    step_fn = make_train_step(model, cfg, opt_cfg, remat=args.remat,
                              microbatches=args.microbatches)
    pf = Prefetcher(data, depth=2)
    ema, emvar = None, 0.0
    t_train0 = time.time()
    losses = []
    rows = args.batch // world.data_size
    try:
        for step in range(start_step, args.steps):
            if before_step:
                before_step(step)
            t0 = time.time()
            batch = {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
                     for k, v in pf.next_batch().items()}
            consumed += 1
            if cfg.family == "audio":
                rngf = np.random.default_rng(step)
                frames = rngf.normal(size=(args.batch, cfg.encoder_seq,
                                           cfg.d_model)) * 0.02
                frames = frames[world.data * rows:(world.data + 1) * rows]
                batch["frames"] = torch.from_numpy(frames).to(
                    device=dev, dtype=getattr(torch, cfg.dtype))
            opt_state, metrics = step_fn(opt_state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.time() - t0
            if after_step:
                after_step(step, {"loss": loss,
                                  "aux": float(metrics["aux_loss"]),
                                  "seconds": dt, "model": model,
                                  "mesh": mesh})

            # --- straggler watchdog (EMA + k-sigma) ------------------------
            slow = False
            if ema is None:
                ema = dt
            else:
                dev_t = dt - ema
                thresh = ema + args.watchdog_sigma * max(emvar ** 0.5,
                                                         0.1 * ema)
                slow = step > start_step + 5 and dt > thresh
                note = (f"[watchdog] step {step} took {dt:.2f}s "
                        f"(ema {ema:.2f}s, thresh {thresh:.2f}s)")
                ema = 0.9 * ema + 0.1 * dt
                emvar = 0.9 * emvar + 0.1 * dev_t * dev_t
            # every rank leaves at the same step, or the others would wait
            # in the next collective
            if world.any(slow, dev):
                if lead:
                    print(note if slow else f"[watchdog] step {step}: a "
                          "rank past its threshold", flush=True)
                if args.watchdog_abort:
                    if mgr:
                        save(step, step + 1, blocking=True)
                    return 42, losses  # supervisor restarts us

            if lead and (step % args.log_every == 0
                         or step == args.steps - 1):
                print(f"step {step:5d} loss {loss:.4f} "
                      f"aux {float(metrics['aux_loss']):.4f} "
                      f"{dt:.2f}s/step", flush=True)
            if mgr and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
                save(step + 1, step + 1, blocking=False)     # async writer
    finally:
        pf.close()

    if mgr:
        save(args.steps, args.steps, blocking=True)
        mgr.wait()
    n = pr.param_count(model.specs())
    dt_all = time.time() - t_train0
    if losses and lead:
        print(f"[done] {args.steps - start_step} steps, {n/1e6:.1f}M params, "
              f"{dt_all:.1f}s total; loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}", flush=True)
    return 0, losses


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
