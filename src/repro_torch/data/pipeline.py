"""Data pipeline (a copy of ``repro.data.pipeline``, which is pure numpy;
the port imports nothing of the JAX package): deterministic synthetic LM
stream + host-sharded, resumable iterator with background prefetch.

Synthetic stream: token[b, s] at global step t is a splitmix-style integer
hash of (t, global_example_index, s) — fully deterministic, seekable to any
step (that's the checkpoint/restart property: resuming at step k reproduces
exactly the batches a never-restarted run would have seen), and shardable by
host without coordination.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    pattern: str = "uniform"      # "uniform" | "markov" (learnable stream)
    markov_noise: float = 0.05    # fraction of random transitions


class SyntheticLM:
    """Deterministic, seekable synthetic token stream."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.host_count == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.host_count
        self.step = 0

    def seek(self, step: int) -> None:
        self.step = step

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])

    def next_batch(self) -> dict:
        c = self.cfg
        t = self.step
        ex0 = c.host_index * self.local_batch
        b_idx = (np.arange(self.local_batch, dtype=np.uint64) + ex0)[:, None]
        s_idx = np.arange(c.seq_len, dtype=np.uint64)[None, :]
        key = (np.uint64(c.seed) * np.uint64(0x100000001B3)
               + np.uint64(t) * np.uint64(0x1000193)
               + b_idx * np.uint64(1_000_003) + s_idx)
        toks = (_splitmix64(key) % np.uint64(c.vocab_size)).astype(np.int32)
        if c.pattern == "markov":
            # learnable stream: deterministic affine walk with sparse noise —
            # a model that learns t_{s+1} = (a*t_s + 1) mod V reaches ~
            # -log(1 - noise) loss instead of the uniform ln(V) floor.
            a = 5
            start = toks[:, 0].astype(np.int64)
            walk = np.empty_like(toks, dtype=np.int64)
            walk[:, 0] = start
            for s_ in range(1, c.seq_len):
                walk[:, s_] = (a * walk[:, s_ - 1] + 1) % c.vocab_size
            noise_mask = (_splitmix64(key + np.uint64(0xABCDEF))
                          % np.uint64(10_000)).astype(np.float64) / 10_000.0
            toks = np.where(noise_mask < c.markov_noise, toks,
                            walk.astype(np.int32)).astype(np.int32)
        self.step += 1
        return {"tokens": toks, "labels": toks}


class Prefetcher:
    """Background-thread prefetch (depth-N) around any ``next_batch`` source;
    overlap host-side batch synthesis with device compute."""

    def __init__(self, source, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._worker, daemon=True)
        self.t.start()

    def _worker(self):
        while not self._stop.is_set():
            batch = self.source.next_batch()
            while not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def next_batch(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.t.join(timeout=2)
