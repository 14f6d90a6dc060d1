"""Model registry (port of ``repro.models.registry``): ArchConfig -> model,
and small real inputs for a (config x shape) cell."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import ArchConfig, ShapeSpec
from repro_torch.models.transformer import LM


def build_model(cfg: ArchConfig, *, device="cuda") -> LM:
    if cfg.family in ("audio", "vlm"):
        raise NotImplementedError(f"the {cfg.family} family is not ported yet "
                                  "(ROADMAP.md Queue 1, slice 4)")
    return LM(cfg, device=device)


def input_arrays(cfg: ArchConfig, shape: ShapeSpec, seed: int = 0, *,
                 device="cuda") -> dict[str, torch.Tensor]:
    """Token inputs with the cell's structure, drawn from
    ``np.random.default_rng(seed)`` in the JAX package's order: train gives
    tokens and labels, prefill tokens, decode one token per row."""
    if cfg.family in ("audio", "vlm"):
        raise NotImplementedError(f"inputs of the {cfg.family} family are not "
                                  "ported yet (ROADMAP.md Queue 1, slice 4)")
    rng = np.random.default_rng(seed)
    b, s = shape.global_batch, shape.seq_len
    names = {"train": ("tokens", "labels"), "prefill": ("tokens",),
             "decode": ("tokens",)}[shape.kind]
    size = (b, 1) if shape.kind == "decode" else (b, s)
    return {n: torch.as_tensor(rng.integers(0, cfg.vocab_size, size=size),
                               dtype=torch.int64, device=device)
            for n in names}
