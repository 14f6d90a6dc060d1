"""What the trainer's parallel tests run in each rank of a spawned world
(``run_local_world`` imports a rank's function by name, so it lives in an
importable module without jax): every job of the world in turn, through
``repro_torch.launch.train.run``."""
import json
import os
import shutil

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch import train

STEPS = 3
BASE = ("--reduced", "--batch", "4", "--seq", "32", "--device", "cpu",
        "--log-every", "100", "--ckpt-every", "0")


def argv_of(arch, d, m, extra, ckpt, steps=STEPS):
    """``launch.train``'s arguments for one job at (d, m)."""
    return ["--arch", arch, *BASE, "--steps", str(steps), "--data-par",
            str(d), "--model-par", str(m), "--ckpt-dir", ckpt, *extra]


def keep_until(src: str, dst: str, step: int) -> str:
    """A copy of checkpoint directory ``src`` without the steps after
    ``step``."""
    shutil.copytree(src, dst)
    for s in CheckpointManager(dst).all_steps():
        if s > step:
            shutil.rmtree(os.path.join(dst, f"step_{s:08d}"))
    return dst


def rank_jobs(jobs: list) -> dict:
    """Every job of one world in this rank: (name, argv) -> its losses and
    the local parameter shapes at the first step, or the SystemExit's
    text."""
    torch.set_num_threads(1)
    out = {}
    for name, argv in jobs:
        shapes = {}

        def after(step, info):
            if not shapes:
                shapes.update({n: tuple(p.shape) for n, p in
                               info["model"].named_parameters()})
        try:
            rc, losses = train.run(argv, after_step=after)
            out[name] = {"rc": rc, "losses": losses, "shapes": shapes}
        except SystemExit as e:
            out[name] = {"exit": str(e)}
    return out


def final_params(ckpt: str) -> dict:
    """The parameters of the latest checkpoint in ``ckpt``, whole."""
    mgr = CheckpointManager(ckpt)
    step = mgr.latest_step()
    with open(os.path.join(ckpt, f"step_{step:08d}", "manifest.json")) as f:
        arrays = json.load(f)["arrays"]
    head = "['params']['"
    like = {a["name"][len(head):-2]: torch.empty(
        a["shape"], dtype=getattr(torch, a["dtype"]), device="meta")
        for a in arrays if a["name"].startswith(head)}
    return mgr.restore(step, {"params": like})[0]["params"]
