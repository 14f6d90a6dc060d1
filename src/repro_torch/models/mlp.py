"""Gated dense MLP (port of ``repro.models.mlp``; MoE is not ported yet)."""
from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.common import activation
from repro_torch.models.params import Spec


def mlp_specs(cfg: ArchConfig) -> dict[str, Spec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi_gate": Spec((d, f), ("fsdp", "mlp")),
        "wi_up": Spec((d, f), ("fsdp", "mlp")),
        "wo": Spec((f, d), ("mlp", "fsdp")),
    }


def mlp(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    act = activation(cfg.act)
    g = x @ p["wi_gate"].to(x.dtype)
    u = x @ p["wi_up"].to(x.dtype)
    return (act(g) * u) @ p["wo"].to(x.dtype)
