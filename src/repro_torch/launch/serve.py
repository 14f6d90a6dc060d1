"""Serving driver: batched requests through the BatchEngine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      [--reduced] [--device cuda]

``--arch`` takes every registered decoder-only arch; the audio family
(enc-dec) returns 1, as in the JAX package.

Weights are random, drawn from ``--seed`` with one ``torch.Generator`` on the
device; prompts from ``np.random.default_rng(seed)``.  ``--device`` defaults
to ``cuda`` and raises when there is no GPU.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import BatchEngine, Request


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device "
                         "(torch.cuda.is_available() is False); pass "
                         "--device cpu to run on the CPU")
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    if cfg.family == "audio":
        print("the serve CLI runs decoder-only archs; use examples for "
              "enc-dec")
        return 1
    model = build_model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)

    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=args.prompt_len).tolist(),
                    max_new=args.max_new)
            for i in range(args.requests)]
    engine = BatchEngine(model, cfg, batch_slots=args.slots,
                         cache_len=args.cache_len)
    t0 = time.time()
    done = engine.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    tok = sum(len(r.out) for r in done)
    print(f"[serve] {len(done)}/{len(reqs)} requests, {tok} tokens in "
          f"{dt:.1f}s ({tok/dt:.1f} tok/s)")
    for r in done[:3]:
        print(f"  rid={r.rid} out[:8]={r.out[:8]}")
    return 0 if len(done) == len(reqs) else 1


if __name__ == "__main__":
    sys.exit(main())
