"""Weights carried across from the JAX package.

``from_jax_params`` takes the JAX ``LM`` params pytree, its leaves as numpy
arrays, and returns a ``state_dict`` for :class:`repro_torch.models.
transformer.LM`: ``scan/p{p}`` leaves are stacked over periods, and their
row ``j`` becomes layer ``j·period + p``; ``tail/t{i}`` becomes layer
``n_full·period + i``.  Nested dicts flatten with ``.``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs import ArchConfig


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _flat(tree: dict, prefix: str) -> dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= _flat(v, f"{prefix}{k}.")
        else:
            out[f"{prefix}{k}"] = v
    return out


def from_jax_params(cfg: ArchConfig, tree: dict) -> dict[str, torch.Tensor]:
    """JAX params pytree (numpy leaves) -> float32 ``state_dict`` of the
    port's LM (``load_state_dict`` casts to the parameters' types)."""
    period = len(cfg.block_pattern)
    n_full = cfg.num_layers // period
    sd = {k: _tensor(v) for k, v in tree.items()
          if k not in ("scan", "tail")}
    for p, block in tree.get("scan", {}).items():
        slot = int(p[1:])
        for name, stacked in _flat(block, "").items():
            if np.shape(stacked)[0] != n_full:
                raise ValueError(f"scan/{p}/{name} stacks "
                                 f"{np.shape(stacked)[0]} periods, the config "
                                 f"{n_full}")
            for j in range(n_full):
                sd[f"layers.{j * period + slot}.{name}"] = _tensor(stacked[j])
    for t, block in tree.get("tail", {}).items():
        layer = n_full * period + int(t[1:])
        for name, leaf in _flat(block, "").items():
            sd[f"layers.{layer}.{name}"] = _tensor(leaf)
    return sd
