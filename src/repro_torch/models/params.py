"""Parameter specs (port of ``repro.models.params``): shape, logical axis
names and init recipe for every parameter, and the five recipes drawn from
an explicit ``torch.Generator``.

The JAX package materialises a spec tree with ``jax.random``; the port fills
the tensors an ``nn.Module`` already holds, in place, from one generator in
a fixed order.  The two give different numbers from the same seed: tests
carry weights across with :mod:`repro_torch.models.convert` instead.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    init: str = "fan_in"        # fan_in | normal | zeros | ones | embed
    scale: float = 1.0
    dtype: str | None = None    # override (norm scales stay fp32)

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def _fan_in(shape: tuple[int, ...]) -> int:
    # convention: last dim is the output features; everything else is fan-in
    return max(1, math.prod(shape[:-1]))


def spec_dtype(spec: Spec, default_dtype: str) -> torch.dtype:
    return getattr(torch, spec.dtype or default_dtype)


@torch.no_grad()
def init_leaf_(t: torch.Tensor, spec: Spec,
               generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` (already of the spec's shape, type and device) in place."""
    if spec.init == "zeros":
        return t.zero_()
    if spec.init == "ones":
        return t.fill_(1.0)
    if spec.init in ("normal", "embed"):
        std = spec.scale
    elif spec.init == "fan_in":
        std = spec.scale / math.sqrt(_fan_in(spec.shape))
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    return t.normal_(0.0, std, generator=generator)


def _leaves(tree: dict):
    for v in tree.values():
        if is_spec(v):
            yield v
        else:
            yield from _leaves(v)


def _map(f, tree: dict) -> dict:
    return {k: f(v) if is_spec(v) else _map(f, v) for k, v in tree.items()}


def shape_tree(spec_tree: dict, default_dtype: str = "float32") -> dict:
    """Meta-device tensors of each spec's shape and type (the counterpart of
    ``jax.ShapeDtypeStruct``: nothing is allocated), same structure."""
    return _map(lambda s: torch.empty(s.shape, dtype=spec_dtype(
        s, default_dtype), device="meta"), spec_tree)


def logical_tree(spec_tree: dict) -> dict:
    """Each spec's logical axis names, same structure: the input of
    :func:`repro_torch.distributed.sharding.tree_shardings`."""
    return _map(lambda s: s.logical, spec_tree)


def param_count(spec_tree: dict) -> int:
    """Elements of every Spec in a (nested) dict of specs."""
    return sum(math.prod(s.shape) for s in _leaves(spec_tree))


def param_bytes(spec_tree: dict, default_dtype: str = "float32") -> int:
    """Bytes of every Spec in a (nested) dict of specs, each at its own type
    or ``default_dtype``."""
    return sum(math.prod(s.shape) * spec_dtype(s, default_dtype).itemsize
               for s in _leaves(spec_tree))
