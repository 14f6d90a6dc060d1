"""Model registry (port of ``repro.models.registry``): ArchConfig -> model,
input stand-ins for an (arch x shape) cell, and small real inputs with the
same structure."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import ArchConfig, ShapeSpec
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import LM


def build_model(cfg: ArchConfig, *, device="cuda") -> LM | EncDecLM:
    return (EncDecLM(cfg, device=device) if cfg.family == "audio"
            else LM(cfg, device=device))


def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict[str, torch.Tensor]:
    """Meta-device stand-ins for every model input of one cell, with the JAX
    package's shapes and types (tokens int32).

    train:   tokens + labels (+ stub patches / frames / mrope positions)
    prefill: tokens (+ stubs)
    decode:  one new token (+ mrope positions); the cache comes from
             ``model.init_cache``."""
    b, s = shape.global_batch, shape.seq_len
    tok = _meta((b, s), torch.int32)
    one = _meta((b, 1), torch.int32)
    dt = getattr(torch, cfg.dtype)

    if cfg.family == "audio":
        frames = _meta((b, cfg.encoder_seq, cfg.d_model), dt)
        if shape.kind == "train":
            return {"tokens": tok, "labels": tok, "frames": frames}
        if shape.kind == "prefill":
            return {"tokens": tok, "frames": frames}
        return {"tokens": one}

    if shape.kind == "train":
        out = {"tokens": tok, "labels": tok}
    elif shape.kind == "prefill":
        out = {"tokens": tok}
    else:
        out = {"tokens": one}
    if cfg.family == "vlm" and shape.kind in ("train", "prefill"):
        out["patches"] = _meta((b, cfg.vision_tokens, cfg.d_model), dt)
        out["positions"] = _meta((3, b, s), torch.int32)
    elif cfg.family == "vlm":
        out["positions"] = _meta((3, b, 1), torch.int32)
    return out


def input_arrays(cfg: ArchConfig, shape: ShapeSpec, seed: int = 0, *,
                 device="cuda") -> dict[str, torch.Tensor]:
    """Real inputs with the cell's structure, drawn from
    ``np.random.default_rng(seed)`` in the JAX package's order and recipe:
    tokens and labels uniform over the vocabulary (int64 here, torch's index
    type), positions the arange broadcast to (3, B, S), every other input
    ``normal * 0.02`` in the activation type."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, sd in input_specs(cfg, shape).items():
        if name in ("tokens", "labels"):
            a = rng.integers(0, cfg.vocab_size, size=sd.shape)
            out[name] = torch.as_tensor(a, dtype=torch.int64, device=device)
        elif name == "positions":
            a = np.broadcast_to(np.arange(sd.shape[-1]), sd.shape).copy()
            out[name] = torch.as_tensor(a, dtype=sd.dtype, device=device)
        else:
            a = rng.normal(size=sd.shape) * 0.02
            out[name] = torch.from_numpy(a).to(device=device, dtype=sd.dtype)
    return out
