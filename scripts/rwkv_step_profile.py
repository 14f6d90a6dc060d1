#!/usr/bin/env python3
"""Whether RWKV-6-7B's training step is bound by the host or by the card:
one step of ``chip_smoke.py``'s ``train_parallel`` rwkv case on one rank
(full width, 2 layers, (2, 1024), f32 weights, bf16 activations, through
``repro_torch.launch.train.run``) under ``torch.profiler``, for each remat
policy asked.

    python3 scripts/rwkv_step_profile.py [--remat dots none] [--seq 1024]

Three steps a policy; the second runs under the profiler and the third
without it.  One JSON line a policy: each step's host ms (the trainer's
own clock, ended by the loss's read, which synchronises), the profiled
step's device busy ms (the kernels' own device time, one stream), idle
share (1 - busy / the profiled step's host ms), kernels launched, top-level
aten ops dispatched, the ops dispatched most and the kernels that took
most; the card's name and power limit first.
"""
import argparse
import collections
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch import train  # noqa: E402

ARCH, LAYERS, BATCH, STEPS = "rwkv6-7b", 2, 2, 3


def profile_policy(remat: str, seq: int) -> dict:
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    host_ms = []

    def before(step):
        torch.cuda.synchronize()
        if step == 1:
            prof.start()

    def after(step, info):
        torch.cuda.synchronize()
        if step == 1:
            prof.stop()
        host_ms.append(info["seconds"] * 1e3)
    argv = ["--arch", ARCH, "--override", f"num_layers={LAYERS}",
            "--steps", str(STEPS), "--batch", str(BATCH), "--seq", str(seq),
            "--remat", remat, "--data-pattern", "markov", "--seed", "0",
            "--log-every", "100", "--ckpt-every", "0"]
    rc, losses = train.run(argv, before_step=before, after_step=after)
    events = prof.events()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    ops = [e for e in events
           if e.device_type.name == "CPU" and e.cpu_parent is None]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_kernel = collections.defaultdict(float)
    for e in kernels:
        by_kernel[e.name[:80]] += e.self_device_time_total / 1e3
    return {"remat": remat, "seq": seq, "rc": rc, "losses": losses,
            "host_ms": host_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / host_ms[1]),
            "kernels": len(kernels), "top_level_ops": len(ops),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "ops_most_dispatched": collections.Counter(
                e.name for e in ops).most_common(8),
            "kernels_most_time": sorted(by_kernel.items(),
                                        key=lambda kv: -kv[1])[:8]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--remat", nargs="+", default=["dots", "none"])
    ap.add_argument("--seq", type=int, default=1024)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    for remat in args.remat:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        print(json.dumps(profile_policy(remat, args.seq)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
