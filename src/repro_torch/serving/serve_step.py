"""Serve-step builders (port of ``repro.serving.serve_step``): prefill
(batch -> logits) and decode (one token against the cache).  Both run under
``torch.inference_mode()``: serving keeps no autograd graph (training takes
gradients through the kernels' backward, :mod:`repro_torch.train`).
"""
from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig


def make_decode_step(model, cfg: ArchConfig, *, greedy: bool = True):
    """(cache, tokens (B,1), step) -> (next_token (B,1), logits, cache),
    greedy whatever ``greedy`` says (the reference takes it and ignores it
    too).  M-RoPE configs rotate by ``step`` on all three components."""

    @torch.inference_mode()
    def decode_step(cache, tokens: torch.Tensor, step: int):
        positions = None
        if cfg.mrope_sections is not None:
            positions = torch.full((3, tokens.shape[0], 1), step,
                                   dtype=torch.int32, device=tokens.device)
        logits, cache = model.decode(cache, tokens, positions=positions)
        nxt = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        return nxt, logits, cache
    return decode_step


def make_prefill(model, cfg: ArchConfig):
    """(batch) -> logits; ``batch`` holds ``tokens`` and, by family,
    ``frames`` (audio) or ``patches`` and ``positions`` (vlm)."""

    @torch.inference_mode()
    def prefill(batch: dict) -> torch.Tensor:
        if cfg.family == "audio":
            logits, _ = model(batch["tokens"], batch["frames"])
        else:
            logits, _ = model(batch["tokens"],
                              positions=batch.get("positions"),
                              patches=batch.get("patches"))
        return logits
    return prefill
