"""Weights carried across from the JAX package.

``from_jax_params`` takes a JAX params pytree, its leaves as numpy arrays,
and returns a ``state_dict`` for the port's model of the same config:
- :class:`repro_torch.models.transformer.LM`: ``scan/p{p}`` leaves are
  stacked over periods, and their row ``j`` becomes layer ``j·period + p``;
  ``tail/t{i}`` becomes layer ``n_full·period + i``;
- :class:`repro_torch.models.encdec.EncDecLM` (the audio family): the
  ``enc`` and ``dec`` trees are stacked over layers (no period, no tail),
  and their row ``i`` becomes ``enc.{i}`` / ``dec.{i}``.
Every other top-level leaf (``embed``, the norms, an untied ``unembed``)
keeps its name.  Nested dicts flatten with ``.``.
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


def _unstack(block: dict, n: int, where: str, name_of) -> dict[str, torch.Tensor]:
    """Rows of a tree stacked over ``n`` layers; row ``j`` of leaf ``leaf``
    goes to ``name_of(j, leaf)``."""
    sd = {}
    for leaf, stacked in _flat(block, "").items():
        if np.shape(stacked)[0] != n:
            raise ValueError(f"{where}/{leaf} stacks {np.shape(stacked)[0]} "
                             f"layers, the config {n}")
        for j in range(n):
            sd[name_of(j, leaf)] = _tensor(stacked[j])
    return sd


def from_jax_params(cfg: ArchConfig, tree: dict) -> dict[str, torch.Tensor]:
    """JAX params pytree (numpy leaves) -> float32 ``state_dict`` of the
    port's model (``load_state_dict`` casts to the parameters' types)."""
    stacks = ("enc", "dec") if cfg.family == "audio" else ("scan", "tail")
    sd = {k: _tensor(v) for k, v in tree.items() if k not in stacks}
    if cfg.family == "audio":
        sd |= _unstack(tree["enc"], cfg.encoder_layers, "enc",
                       lambda j, leaf: f"enc.{j}.{leaf}")
        sd |= _unstack(tree["dec"], cfg.num_layers, "dec",
                       lambda j, leaf: f"dec.{j}.{leaf}")
        return sd
    period = len(cfg.block_pattern)
    n_full = cfg.num_layers // period
    for p, block in tree.get("scan", {}).items():
        slot = int(p[1:])
        sd |= _unstack(block, n_full, f"scan/{p}",
                       lambda j, leaf: f"layers.{j * period + slot}.{leaf}")
    for t, block in tree.get("tail", {}).items():
        layer = n_full * period + int(t[1:])
        sd |= {f"layers.{layer}.{name}": _tensor(leaf)
               for name, leaf in _flat(block, "").items()}
    return sd
