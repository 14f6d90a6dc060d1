"""Minimal batched serving engine (port of ``repro.serving.engine``):
request queue -> fixed-batch decode loop with slot recycling.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.serving.serve_step import make_decode_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class BatchEngine:
    """Fixed B decode slots; prompts are fed token by token through the same
    decode step, then free-run until EOS/max_new.  Finished slots
    immediately take the next request."""

    def __init__(self, model, cfg, *, batch_slots: int, cache_len: int,
                 eos_id: int = -1):
        self.model, self.cfg = model, cfg
        self.b = batch_slots
        self.eos = eos_id
        self._step = make_decode_step(model, cfg)
        self.device = model.embed.device
        self.cache = model.init_cache(batch_slots, cache_len)
        self.slots: list[Optional[Request]] = [None] * batch_slots
        self.feed_pos = [0] * batch_slots
        self.step_count = 0

    def run(self, requests: list[Request], max_steps: int = 10_000
            ) -> list[Request]:
        queue = list(requests)
        done: list[Request] = []
        for _ in range(max_steps):
            # fill empty slots
            for i in range(self.b):
                if self.slots[i] is None and queue:
                    self.slots[i] = queue.pop(0)
                    self.feed_pos[i] = 0
            if all(s is None for s in self.slots) and not queue:
                break
            # choose the next input token per slot
            toks = np.zeros((self.b, 1), np.int64)
            for i, req in enumerate(self.slots):
                if req is None:
                    continue
                if self.feed_pos[i] < len(req.prompt):
                    toks[i, 0] = req.prompt[self.feed_pos[i]]
                else:
                    toks[i, 0] = (req.out[-1] if req.out else 0)
            nxt, _, self.cache = self._step(
                self.cache, torch.from_numpy(toks).to(self.device),
                self.step_count)
            self.step_count += 1
            nxt = nxt.cpu().numpy()
            for i, req in enumerate(self.slots):
                if req is None:
                    continue
                if self.feed_pos[i] < len(req.prompt) - 1:
                    self.feed_pos[i] += 1          # still consuming prompt
                    continue
                self.feed_pos[i] += 1
                tok = int(nxt[i, 0])
                req.out.append(tok)
                if tok == self.eos or len(req.out) >= req.max_new:
                    req.done = True
                    done.append(req)
                    self.slots[i] = None
        # NOTE: slot recycling reuses cache rows, and every row shares one
        # write position (KVCache.pos), as in the JAX engine: a recycled
        # slot sees the previous request's state.  Kept as the reference
        # has it.
        return done
