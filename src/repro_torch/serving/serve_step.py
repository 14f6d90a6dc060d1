"""Serve-step builders (port of ``repro.serving.serve_step``): prefill
(batch -> logits) and decode (one token against the cache).  Both run under
``torch.inference_mode()``: the CUDA kernels have no backward.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig


def make_decode_step(model, cfg: ArchConfig):
    """(cache, tokens (B,1)) -> (next_token (B,1), logits, cache), greedy."""

    @torch.inference_mode()
    def decode_step(cache, tokens: torch.Tensor):
        logits, cache = model.decode(cache, tokens)
        nxt = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        return nxt, logits, cache
    return decode_step


def make_prefill(model, cfg: ArchConfig):
    """(batch) -> logits; ``batch`` holds ``tokens`` and optionally
    ``positions``."""

    @torch.inference_mode()
    def prefill(batch: dict) -> torch.Tensor:
        logits, _ = model(batch["tokens"], positions=batch.get("positions"))
        return logits
    return prefill
