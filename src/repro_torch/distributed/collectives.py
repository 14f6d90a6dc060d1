"""Gradient compression with error feedback, and a quantized all-reduce
(port of ``repro.distributed.collectives``).

``compress_decompress`` applies quantize -> dequantize with an
error-feedback accumulator, so the effective gradient the optimizer sees is
what a compressed all-reduce would deliver; the error is re-injected next
step (Karimireddy et al., 2019).  Trees are dicts of tensors keyed by
parameter name; a group of names that the JAX package stacks into one leaf
is compressed as that one leaf.

``int8_psum`` is the explicit compressed all-reduce over one mesh axis: its
``axis_name`` is that axis's ``ProcessGroup`` (``mesh.get_group(name)``),
which stands where jax's ``shard_map`` resolved a name.  What a backend
carries decides where the payload lies (:func:`wire_device`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


class EFState(NamedTuple):
    error: torch.Tensor        # same shape and type as the gradient leaf


def init_ef(params: dict[str, torch.Tensor]) -> dict[str, EFState]:
    return {k: EFState(torch.zeros_like(p)) for k, p in params.items()}


def _quantize_int8(x: torch.Tensor, scale: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 codes of x and their f32 scale (max |x| / 127 unless given)."""
    if scale is None:
        scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _topk_mask(x: torch.Tensor, frac: float,
               thresh: torch.Tensor | None = None) -> torch.Tensor:
    """1 where |x| is at least the k-th largest magnitude, k = max(1,
    int(size * frac)) (or at least ``thresh``); only that value matters,
    so ties need no order."""
    if thresh is None:
        thresh = _topk_threshold([x], frac)
    return (x.abs() >= thresh).to(x.dtype)


def _topk_threshold(xs: list[torch.Tensor], frac: float) -> torch.Tensor:
    flat = torch.cat([x.abs().reshape(-1) for x in xs])
    k = max(1, int(flat.numel() * frac))
    return torch.topk(flat, k).values[-1]


def compress_decompress(grads: dict[str, torch.Tensor],
                        ef_state: dict[str, EFState], *, method: str = "int8",
                        topk_frac: float = 0.01,
                        groups: list[list[str]] | None = None
                        ) -> tuple[dict[str, torch.Tensor],
                                   dict[str, EFState]]:
    """Lossy compression with error feedback.  Returns (effective grads, new
    EF state).  ``method``: "int8" (int8 quantization, one scale a leaf),
    "topk" (keep the top ``topk_frac`` magnitudes of a leaf) or "none"
    (identity).  ``groups``: lists of names compressed as one leaf (the JAX
    package's leaf that stacks those layers: one scale, one threshold over
    all of them); by default each name alone."""
    if method == "none":
        return grads, ef_state
    if method not in ("int8", "topk"):
        raise ValueError(method)
    effective, new_ef = {}, {}
    for names in groups or [[n] for n in grads]:
        corrected = [grads[n].float() + ef_state[n].error.float()
                     for n in names]
        if method == "int8":
            scale = torch.clamp(torch.stack([c.abs().max()
                                             for c in corrected]).max(),
                                min=1e-12) / 127.0
            sent = [_dequantize_int8(_quantize_int8(c, scale)[0], scale)
                    for c in corrected]
        else:
            thresh = _topk_threshold(corrected, topk_frac)
            sent = [c * _topk_mask(c, topk_frac, thresh) for c in corrected]
        for n, c, snt in zip(names, corrected, sent):
            effective[n] = snt.to(grads[n].dtype)
            new_ef[n] = EFState((c - snt).to(grads[n].dtype))
    return effective, new_ef


def wire_device(group, device: torch.device) -> torch.device:
    """Where a payload of a tensor on ``device`` lies while ``group``'s
    backend carries it: NCCL sends CUDA tensors where they are; gloo's send
    and receive read host memory, so a shard on the card is copied to the
    host and back (gloo ranks may share one card, NCCL ranks may not).
    Chosen from the backend, never on an error; any other pairing raises."""
    backend = dist.get_backend(group)
    if backend == "gloo":
        return torch.device("cpu")
    if backend == "nccl" and device.type == "cuda":
        return device
    raise ValueError(f"no transport for {device.type} tensors over a "
                     f"{backend} process group")


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    wire = x.to(wire_device(group, x.device))
    dist.all_reduce(wire, op=op, group=group)
    return wire.to(x.device)


def int8_psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Quantized all-reduce over the ranks of ``axis_name`` (a
    ``ProcessGroup``): transmit int8 codes and one shared f32 scale instead
    of f32 payloads.  The scale, in x's type, is the largest
    ``max(max |x|, 1e-12)`` over the ranks / 127, so the int8 sum cannot overflow int32 for fewer than
    2^24 / 127 ranks; the sum is taken in int32 and returned in f32 times
    the scale, the reference's order of operations."""
    amax = torch.clamp(x.abs().max(), min=1e-12).reshape(1)
    scale = _all_reduce(amax, dist.ReduceOp.MAX, axis_name)[0] / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    total = _all_reduce(q.to(torch.int32), dist.ReduceOp.SUM, axis_name)
    return total.float() * scale


def compressed_psum_tree(grads: dict[str, torch.Tensor],
                         axis_name) -> dict[str, torch.Tensor]:
    """:func:`int8_psum` of every leaf of a dict of gradients."""
    return {k: int8_psum(g, axis_name) for k, g in grads.items()}
