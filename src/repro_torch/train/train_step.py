"""Train and eval step builders (port of ``repro.train.train_step``).

``make_train_step`` returns ``(opt_state, batch) -> (opt_state, metrics)``:
the model's parameters are updated in place (the JAX package's pure
function returns new ones).  Microbatches accumulate gradients in float32
and average them with the loss and the aux loss, as the reference's scan
does; ``remat`` is the model's (``transformer.remat_call``).

Under ``mesh_context`` (the reference's trainer jits its step under it
too): the batch is this data rank's rows; the gradients, the loss and the
aux loss are averaged over the data axis before the update (a gradient
that FSDP reduce-scattered over ``data`` is not summed over it again),
and the optimizer takes the norm and the compression statistics of the
parameters split over ``model``, ``data`` or both over the whole leaves
(``distributed/tensor_parallel.py``).
"""
from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.transformer import xent_loss
from repro_torch.train.optim import OptConfig, apply_updates

AUX_WEIGHT = 0.01      # MoE load-balance loss weight
# profiler ranges around the loss's forward and the optimizer update, which
# chip_smoke.py's profile of a step splits out
LOSS_RANGE, OPTIMIZER_RANGE = "train.xent_loss", "train.apply_updates"


def make_loss_fn(model, cfg: ArchConfig, remat: str = "none"):
    """batch -> (loss + AUX_WEIGHT * aux, (loss, aux)), next-token
    prediction (labels shifted left)."""
    def loss_fn(batch: dict):
        if cfg.family == "audio":
            logits, aux = model(batch["tokens"], batch["frames"], remat=remat)
        else:
            logits, aux = model(batch["tokens"],
                                positions=batch.get("positions"),
                                patches=batch.get("patches"), remat=remat)
        labels = batch.get("labels", batch["tokens"])
        axis = tp.split_axis(logits.shape[-1], cfg.vocab_size)
        with torch.profiler.record_function(LOSS_RANGE):
            if axis is not None:
                loss = tp.vocab_parallel_xent(logits[:, :-1, :],
                                              labels[:, 1:], axis)
            else:
                loss = xent_loss(logits[:, :-1, :], labels[:, 1:])
        return loss + AUX_WEIGHT * aux, (loss, aux)
    return loss_fn


def decay_mask(model) -> dict[str, bool]:
    """Which parameters take weight decay: rank >= 2 in the JAX package's
    tree, where a stacked layer's parameters have one more axis than the
    port's (``model.reference_leaf`` names another leaf than their own)."""
    return {n: p.dim() + (model.reference_leaf(n) != n) >= 2
            for n, p in model.named_parameters()}


def reference_leaves(model) -> list[list[str]]:
    """The parameters' names grouped by the JAX package's leaf that holds
    them (a stacked leaf holds one parameter per stacked layer), in
    ``named_parameters()`` order: gradient compression takes one scale or
    threshold per leaf."""
    groups: dict[str, list[str]] = {}
    for n, _ in model.named_parameters():
        groups.setdefault(model.reference_leaf(n), []).append(n)
    return list(groups.values())


def split_microbatches(batch: dict, microbatches: int) -> list[dict]:
    """Every leaf split on axis 0, but M-RoPE positions (3, B, S) (any leaf
    of rank >= 2 with a leading 3, as the reference tells them) on axis 1."""
    def split(x: torch.Tensor) -> torch.Tensor:
        if x.dim() >= 2 and x.shape[0] == 3:
            return x.unflatten(1, (microbatches, -1)).movedim(1, 0)
        return x.unflatten(0, (microbatches, -1))
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(microbatches)]


def make_train_step(model, cfg: ArchConfig, opt_cfg: OptConfig, *,
                    remat: str = "dots", microbatches: int = 1):
    loss_fn = make_loss_fn(model, cfg, remat)
    params = dict(model.named_parameters())
    decay, groups = decay_mask(model), reference_leaves(model)
    data, shards = tp.data_axis(), tp.split_axes(model) or None
    # gradients that leave the backward pass summed over data (FSDP)
    summed = frozenset(n for n, axes in (shards or {}).items()
                       if "data" in [a.name for a in axes])

    def grads_of(batch):
        total, (loss, aux) = loss_fn(batch)
        gs = torch.autograd.grad(total, list(params.values()),
                                 allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), gs)}
        return grads, loss.detach(), aux.detach()

    def train_step(opt_state, batch: dict):
        if microbatches == 1:
            grads, loss, aux = grads_of(batch)
        else:
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.items()}
            dev = opt_state.step.device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            aux = torch.zeros((), dtype=torch.float32, device=dev)
            for mb in split_microbatches(batch, microbatches):
                g, l_mb, a_mb = grads_of(mb)
                for n in grads:
                    grads[n].add_(g[n])
                del g
                loss, aux = loss + l_mb, aux + a_mb
            for g in grads.values():
                g.div_(microbatches)
            loss, aux = loss / microbatches, aux / microbatches
        if data is not None:
            grads = tp.mean_grads_over_data(grads, data, summed)
            loss = tp.mean_over_data(loss, data)
            aux = tp.mean_over_data(aux, data)
        with torch.profiler.record_function(OPTIMIZER_RANGE):
            opt_state = apply_updates(params, grads, opt_state, opt_cfg,
                                      decay, groups, shards)
        metrics = {"loss": loss.float(), "aux_loss": aux.float(),
                   "step": opt_state.step}
        return opt_state, metrics

    return train_step


def make_eval_step(model, cfg: ArchConfig):
    loss_fn = make_loss_fn(model, cfg)

    @torch.no_grad()
    def eval_step(batch: dict) -> dict:
        _, (loss, aux) = loss_fn(batch)
        return {"loss": loss, "aux_loss": aux}
    return eval_step
