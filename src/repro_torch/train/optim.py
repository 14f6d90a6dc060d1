"""Optimizer (port of ``repro.train.optim``): AdamW, cosine schedule,
global-norm clipping and optional gradient compression with error feedback.

Trees are dicts of tensors keyed by parameter name (``named_parameters()``
order).  The state holds f32 moments per parameter.  Unlike the JAX
package, :func:`apply_updates` updates the parameters and moments in place
and returns the new state: the 2.6 GB embedding of RecurrentGemma-2B would
otherwise be copied several times per step.  The arithmetic is the
reference's, in float32 tensors: the schedule and the bias corrections from
an int32 step (never Python floats, which would compute them in float64),
the clip scale ``min(1, clip / max(gn, 1e-9))``, and the update
``p - lr * (m̂ / (√v̂ + eps) + wd·p)`` cast back to the parameter's type
(``torch.optim.AdamW`` decays before the step, and by no rank rule).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.distributed import tensor_parallel
from repro_torch.distributed.collectives import (EFState, compress_decompress,
                                                 init_ef)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    compression: str = "none"          # none | int8 | topk
    topk_frac: float = 0.01


class AdamWState(NamedTuple):
    step: torch.Tensor                  # int32, 0-d
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]
    ef: Optional[dict[str, EFState]]    # error-feedback state (or None)


def init_opt_state(params: dict[str, torch.Tensor],
                   cfg: OptConfig) -> AdamWState:
    z = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
    dev = next(iter(params.values())).device
    ef = init_ef(params) if cfg.compression != "none" else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=z, v={k: t.clone() for k, t in z.items()}, ef=ef)


def schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Linear warm-up then cosine decay to ``min_lr_frac``, in float32."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def _norm(tree: dict[str, torch.Tensor], shards) -> torch.Tensor:
    """:func:`global_norm`; over the whole leaves where ``shards`` says
    some are this rank's slices (``tensor_parallel.sq_norm``)."""
    if shards is None:
        return global_norm(tree)
    return torch.sqrt(tensor_parallel.sq_norm(tree, shards))


@torch.no_grad()
def apply_updates(params: dict[str, torch.Tensor],
                  grads: dict[str, torch.Tensor], state: AdamWState,
                  cfg: OptConfig, decay: dict[str, bool] | None = None,
                  groups: list[list[str]] | None = None,
                  shards: dict[str, tuple] | None = None
                  ) -> AdamWState:
    """One AdamW step, in place on ``params`` and the moments (compression
    with error feedback first, as a compressed all-reduce would deliver the
    gradient).  ``decay``: which parameters take weight decay; by default
    those of rank >= 2 (the reference's rule on its own tree, where a
    stacked layer's norm scales and biases are rank 2:
    ``train_step.decay_mask`` gives a model's).  ``groups``: the names
    compressed as one leaf (``train_step.reference_leaves``).
    ``shards``: each name held as this rank's slice of a leaf -> the mesh
    axes that split it (``model``, ``data`` or both:
    ``tensor_parallel.split_axes``); the clipping norm and the compression
    take their statistics over the whole leaves."""
    ef = state.ef
    if cfg.compression != "none":
        grads, ef = compress_decompress(grads, ef, method=cfg.compression,
                                        topk_frac=cfg.topk_frac, groups=groups,
                                        shards=shards)
    gn = _norm(grads, shards)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
             if cfg.clip_norm > 0 else 1.0)
    lr = schedule(state.step, cfg)
    b1, b2 = cfg.betas
    bc1 = 1 - b1 ** (state.step + 1)
    bc2 = 1 - b2 ** (state.step + 1)
    for name, p in params.items():
        m, v = state.m[name], state.v[name]
        g = grads[name].float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        del g
        step_ = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        if cfg.weight_decay and (p.dim() >= 2 if decay is None
                                 else decay[name]):
            step_.add_(cfg.weight_decay * p.float())
        step_.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(step_)
        else:
            p.copy_((p.float() - step_).to(p.dtype))
    return AdamWState(step=state.step + 1, m=state.m, v=state.v, ef=ef)
