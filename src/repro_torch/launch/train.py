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
  * microbatch gradient accumulation, remat, optional gradient compression.

One device: --data-par and --model-par take only 1 until the trainer's
parallel slice (its meshes and sharding rules are in ``launch/mesh.py``
and ``distributed/sharding.py``).  --device defaults to ``cuda`` and
raises when there is no GPU; RecurrentGemma then trains through K5 and K6
and their backward kernels.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir build/ck \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.models import params as pr
from repro_torch.models.registry import build_model
from repro_torch.train.optim import OptConfig, init_opt_state
from repro_torch.train.train_step import make_train_step


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


def run(argv=None) -> tuple[int, list[float]]:
    """Runs the loop: (exit code, the loss of each step this run took).
    The programmatic interface; :func:`main` is the command line's."""
    args = parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device "
                         "(torch.cuda.is_available() is False); pass "
                         "--device cpu to run on the CPU")
    if args.data_par != 1 or args.model_par != 1:
        raise SystemExit("--data-par and --model-par take only 1: the "
                         "trainer's parallel slice is not ported yet")
    cfg = _config(args)
    model = build_model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(args.seed))
    params = dict(model.named_parameters())

    opt_cfg = OptConfig(lr=args.lr, warmup_steps=args.warmup,
                        total_steps=args.steps,
                        compression=args.compression)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed,
                                  pattern=args.data_pattern))

    # --- init or resume ------------------------------------------------------
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    opt_state = init_opt_state(params, opt_cfg)
    start_step = 0
    if mgr and args.resume and mgr.latest_step() is not None:
        step = mgr.latest_step()
        state, extra = mgr.restore(step, {"params": params, "opt": opt_state})
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(state["params"][name])
        opt_state = state["opt"]
        data.restore(extra["data"])
        start_step = extra["train_step"]
        print(f"[resume] from checkpoint step {step} "
              f"(train step {start_step})", flush=True)

    # The stream's position as of the batches this loop took.  The JAX
    # package saves data.state(), which the prefetch thread has already
    # moved up to depth + 1 batches ahead, so its resume skips batches; the
    # manifest's format ({"step": k}) is the same.
    consumed = data.state()["step"]

    def save(step: int, train_step: int, blocking: bool) -> None:
        mgr.save(step, {"params": params, "opt": opt_state},
                 extra={"data": {"step": consumed}, "train_step": train_step},
                 blocking=blocking)

    step_fn = make_train_step(model, cfg, opt_cfg, remat=args.remat,
                              microbatches=args.microbatches)
    pf = Prefetcher(data, depth=2)
    ema, emvar = None, 0.0
    t_train0 = time.time()
    losses = []
    try:
        for step in range(start_step, args.steps):
            t0 = time.time()
            batch = {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
                     for k, v in pf.next_batch().items()}
            consumed += 1
            if cfg.family == "audio":
                rngf = np.random.default_rng(step)
                batch["frames"] = torch.from_numpy(
                    rngf.normal(size=(args.batch, cfg.encoder_seq,
                                      cfg.d_model)) * 0.02).to(
                    device=dev, dtype=getattr(torch, cfg.dtype))
            opt_state, metrics = step_fn(opt_state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.time() - t0

            # --- straggler watchdog (EMA + k-sigma) ------------------------
            if ema is None:
                ema = dt
            else:
                dev_t = dt - ema
                thresh = ema + args.watchdog_sigma * max(emvar ** 0.5,
                                                         0.1 * ema)
                if step > start_step + 5 and dt > thresh:
                    print(f"[watchdog] step {step} took {dt:.2f}s "
                          f"(ema {ema:.2f}s, thresh {thresh:.2f}s)",
                          flush=True)
                    if args.watchdog_abort:
                        if mgr:
                            save(step, step + 1, blocking=True)
                        return 42, losses  # supervisor restarts us
                ema = 0.9 * ema + 0.1 * dt
                emvar = 0.9 * emvar + 0.1 * dev_t * dev_t

            if step % args.log_every == 0 or step == args.steps - 1:
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
    if losses:
        print(f"[done] {args.steps - start_step} steps, {n/1e6:.1f}M params, "
              f"{dt_all:.1f}s total; loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}", flush=True)
    return 0, losses


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
