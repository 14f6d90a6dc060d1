"""Data and tensor parallelism by hand: what GSPMD derives for the JAX
package from its ``constrain`` anchors, written out for the port's layers.

The ambient mesh is the ``DeviceMesh`` that
:func:`repro_torch.distributed.sharding.mesh_context` installs (the
reference's trainer runs its step under ``mesh_context`` too).  With no
mesh, or an axis of size 1, every function here leaves the one-device
computation as it is.

Layout: a parameter is split as the sharding rules place it
(:func:`parameter_layout`, :func:`shard_parameters`); a rank holds its
slice as a plain tensor.  The trainer's rules (:data:`FSDP_OFF`, as the
reference's trainer places nothing by ``"fsdp"``) split parameters over
``model`` alone; ``DEFAULT_RULES`` also split each parameter's ``"fsdp"``
dim over ``data`` (FSDP), as the dry run lays them out.  A layer sees
that a parameter is split over ``model`` from its shape
(:func:`split_axis`): the layout is never chosen here.

FSDP: a module's parameters are gathered whole over ``data`` a layer at a
time, in their own dtype, just before the layer runs (:func:`unshard`,
inside the layer's remat region, so remat gathers them again in the
backward pass rather than keep them), and each gathered weight's
gradient leaves the backward pass reduce-scattered over ``data`` (summed
in float32): the rank's slice of the data ranks' sum.  A layer after
:func:`unshard` sees exactly the model-axis shapes of the trainer's
layout.

The residual stream is replicated over ``model``.  A layer whose
parameters are split runs in the Megatron pattern (Shoeybi et al., 2019):
every tensor that enters the split region from the replicated one, an
activation or a replicated parameter, passes :func:`copy_in` (identity
forward, all-reduce of the gradient), and every partial sum that leaves
it passes :func:`reduce_out` (all-reduce forward, identity backward).  So
after the backward pass each rank holds the whole gradient of every
parameter it holds, split or replicated.  Partial products are summed in
float32 and cast once.

The MoE (``models/mlp.moe``) runs its routing replicated: a router split
over the experts is gathered whole (:func:`gather_weight`, whose backward
takes the rank's slice), so every rank's top-k is one device's; the
token activations and the gates enter the experts' region through
:func:`copy_in`, and the rank's partial output, over its experts (EP) or
its experts' ``d_ff`` columns (FF), leaves it through :func:`reduce_out`
after the combine.  The aux loss stays on the replicated path, so its
gradient is counted once.

RWKV-6 (``models/rwkv6``) runs its time mix on the rank's whole heads
(``wr``'s columns and ``u``'s heads split; a split that cuts heads
raises), the recurrence on its heads' slice of the state, ``wo``
row-parallel.  Its channel mix splits the value half over ``d_ff`` (the
output summed by :func:`reduce_out`) and the receptance over d_model,
gathered whole by :func:`gather_weight` for the product with the value;
each half's mixed input enters its split region alone, so a half held
whole stays on the replicated path.

The encoder-decoder (``models/encdec``, whisper) splits its encoder's
and decoder's attention over heads and their MLPs over ``d_ff`` as the
decoder-only stack does.  Its cross-attention takes the rank's heads of
``wq`` and ``wo`` and the K/V that the rank's heads of ``wk``/``wv`` make
from the encoder output, which enters the split region through one
:func:`copy_in` before the decoder stack: every layer's partial gradient
of it adds up on the rank before the one all-reduce.  Decode's cross K/V
cache is placed by the rules' cross rule, over the encoder's frames
where ``model`` divides them (``cache_seq`` comes first), else over its
KV heads, else whole; over frames, each rank attends every query head
over its frames and :func:`merge_softmax` combines the partials, as a
KV cache split over its positions is attended.

The VLM (qwen2-vl) is the decoder-only stack: its patches replace the
first positions after the (vocabulary-parallel) embedding, an input
replicated over ``model`` as the M-RoPE positions (3, B, S) are; every
head's rotation by its three position components is local to the head,
so a head split needs nothing more, and the q/k/v biases, split with
their heads or, held whole, entering the split region as the other
replicated parameters do (:func:`enter`).  A split that cannot be made
(RWKV-6's heads cut mid-head) raises in the layer.

Decode of a split model (``models/attention.decode_step``): where the
KV cache is split over its positions (``cache_seq``, the rules' choice
whenever ``model`` does not divide the KV heads), each rank attends every
query head (:func:`gather_cat` where ``wq`` is split) over its own slots,
and :func:`merge_softmax` combines the ranks' partials by their maxima;
the greedy token of logits split over the vocabulary is
:func:`vocab_parallel_argmax`.  :func:`shard_cache` gives a rank its
slice of a cache.

Data parallelism: rank ``(d, m)`` takes rows ``[d·B/D, (d+1)·B/D)`` of each
global batch, ``d`` its index along the axes the batch is split over
(:func:`data_axis`: ``data``, or ``pod`` and ``data`` flattened into one
group on the multi-pod mesh); :func:`mean_grads_over_data` averages the
gradients (float32, sum then ``/ D``) and :func:`mean_over_data` the loss
and the aux loss.  A gradient that FSDP reduce-scattered over ``data`` is
summed over ``pod`` alone, then divided by the whole ``D``.
Payloads cross the wire as
:func:`repro_torch.distributed.collectives.wire_device` says.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import wire_device

# the trainer's layout: the rules' model-axis splits, no FSDP over data
FSDP_OFF = {"fsdp": [()]}
BUCKET_BYTES = 256 << 20          # data-parallel gradients per all-reduce

_MESH: list = [None]              # the ambient DeviceMesh (mesh_context)
# bytes and calls over each mesh axis since reset_wire(): an all-reduce's
# payload, an all-gather's gathered whole
WIRE: dict[str, list[int]] = {}


class Axis(NamedTuple):
    """One mesh axis seen from this rank: its name, ``ProcessGroup``, this
    rank's index along it and its size."""
    name: str
    group: object
    rank: int
    size: int


def set_mesh(mesh) -> None:
    _MESH[0] = mesh


def ambient_mesh():
    return _MESH[0]


def mesh_axis(name: str, mesh=None) -> Axis | None:
    """The axis ``name`` of ``mesh`` (the ambient one by default), or None
    (no mesh, no such axis, or an axis of size 1)."""
    mesh = _MESH[0] if mesh is None else mesh
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None
    size = mesh.size(mesh.mesh_dim_names.index(name))
    if size == 1:
        return None
    return Axis(name, mesh.get_group(name), mesh.get_local_rank(name), size)


def model_axis() -> Axis | None:
    return mesh_axis("model")


def batch_axes(mesh) -> tuple[str, ...]:
    """The mesh axes the batch is split over: the first candidate of
    ``DEFAULT_RULES["batch"]`` with an axis in ``mesh``, cut to the axes
    ``mesh`` has (``resolve_spec``'s reading): ("pod", "data") on the
    multi-pod mesh, ("data",) on a (data, model) mesh."""
    from repro_torch.distributed.sharding import DEFAULT_RULES
    names = mesh.mesh_dim_names or ()
    for cand in DEFAULT_RULES["batch"]:
        axes = tuple(a for a in cand if a in names)
        if axes:
            return axes
    return ()


def data_axis(mesh=None) -> Axis | None:
    """The axis the batch's rows are split over on ``mesh`` (the ambient
    one by default): :func:`batch_axes`, several of them flattened into one
    group in the mesh's order (32 ranks on the multi-pod mesh, rank
    ``pod·16 + data``); None where that is one rank."""
    mesh = _MESH[0] if mesh is None else mesh
    axes = () if mesh is None else batch_axes(mesh)
    if len(axes) < 2:
        return mesh_axis(axes[0], mesh) if axes else None
    flat = mesh[axes]._flatten()        # one group per mesh, made once
    if flat.size() == 1:
        return None
    return Axis(flat.mesh_dim_names[0], flat.get_group(),
                flat.get_local_rank(), flat.size())


def split_axis(local: int, whole: int) -> Axis | None:
    """The model axis where a parameter dim of the whole size ``whole`` is
    held as ``local`` (split), None where it is whole.  A split dim outside
    a mesh with that split raises: the layer cannot sum its partial
    products."""
    if local == whole:
        return None
    axis = model_axis()
    if axis is None or local * axis.size != whole:
        raise ValueError(f"a parameter dim of {whole} held as {local} needs "
                         f"a model axis of {whole // max(local, 1)} ranks "
                         "in mesh_context; the ambient mesh has "
                         f"{axis.size if axis else 1}")
    return axis


def reset_wire() -> None:
    WIRE.clear()


def wire_bytes() -> dict[str, dict[str, int]]:
    """Bytes and calls per mesh axis since :func:`reset_wire`."""
    return {a: {"bytes": b, "calls": c} for a, (b, c) in WIRE.items()}


def _count(axis: Axis, nbytes: int) -> None:
    rec = WIRE.setdefault(axis.name, [0, 0])
    rec[0] += nbytes
    rec[1] += 1


def _reduce(x: torch.Tensor, axis: Axis,
            op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce of a copy of ``x`` over ``axis`` (never in place: the
    input may be held for the backward pass), counted in :data:`WIRE`."""
    _count(axis, x.numel() * x.element_size())
    wire = x.detach().to(wire_device(axis.group, x.device), copy=True)
    dist.all_reduce(wire, op=op, group=axis.group)
    return wire.to(x.device)


def _sum_f32(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _reduce(x.float(), axis).to(x.dtype)


def reduce_scatter(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of ``x`` over ``axis``
    (equal slices in rank order), summed in float32 and cast back to x's
    type: a reduce-scatter, counted in :data:`WIRE` by the bytes it
    reduces (x's, in float32)."""
    whole = x.float().movedim(dim, 0).contiguous()
    _count(axis, whole.numel() * whole.element_size())
    wire = whole.to(wire_device(axis.group, x.device))
    out = wire.new_empty((wire.shape[0] // axis.size, *wire.shape[1:]))
    # the op's newer name where this torch has it (reduce_scatter_tensor,
    # which torch 2.11 has, warns that it is deprecated in 2.13)
    op = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    op(out, wire, group=axis.group)
    return out.to(x.device).movedim(0, dim).contiguous().to(x.dtype)


class _CopyIn(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the model axis."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.axis), None


class _ReduceOut(torch.autograd.Function):
    """All-reduce forward (in float32); identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        return _sum_f32(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherWeight(torch.autograd.Function):
    """All-gather of a tensor split over the model axis; the gradient, the
    whole one on every rank, sliced back to this rank's part."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return gather_cat(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n), None, None


class _GatherData(torch.autograd.Function):
    """All-gather of a parameter split over the data axis (FSDP); its
    gradient, each data rank's own, reduce-scattered back to this rank's
    slice of their sum."""

    @staticmethod
    def forward(ctx, w, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return gather_cat(w, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.axis, ctx.dim), None, None


def copy_in(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` entering the split region (a column-parallel input)."""
    return _CopyIn.apply(x, axis)


def reduce_out(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum over the model axis of partial sums ``x`` (a row-parallel
    output), in x's type, summed in float32."""
    return _ReduceOut.apply(x, axis)


def gather_weight(w: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The whole of a tensor split over the model axis along ``dim``, for
    a computation every rank runs replicated: a weight (the MoE's router)
    or an activation leaving a split region (RWKV's receptance): an
    all-gather, counted in :data:`WIRE`.  Its backward takes this rank's
    slice of the gradient, which the replicated computation gives whole on
    every rank."""
    return _GatherWeight.apply(w, axis, dim)


def fsdp_dim(spec) -> int | None:
    """The dim of a parameter spec whose logical name is ``"fsdp"`` (the
    one the rules may split over ``data``), or None."""
    return spec.logical.index("fsdp") if "fsdp" in spec.logical else None


def gather_fsdp(w: torch.Tensor, spec) -> torch.Tensor:
    """Parameter ``w`` whole along its spec's ``"fsdp"`` dim: gathered over
    the data axis of the ambient mesh where it is held there as ``whole /
    D``, in its own dtype (:class:`_GatherData`: the backward pass
    reduce-scatters its gradient); as it is where that dim is whole.  Any
    other size raises, as :func:`split_axis` does: outside a mesh with
    that data axis the layer cannot gather it."""
    dim = fsdp_dim(spec)
    if dim is None or w.shape[dim] == spec.shape[dim]:
        return w
    axis = mesh_axis("data")
    if axis is None or w.shape[dim] * axis.size != spec.shape[dim]:
        need = spec.shape[dim] // max(w.shape[dim], 1)
        raise ValueError(f"a parameter of {tuple(spec.shape)} held as "
                         f"{tuple(w.shape)} along its fsdp dim {dim} needs "
                         f"a data axis of {need} ranks in mesh_context; the "
                         f"ambient mesh has {axis.size if axis else 1}")
    return _GatherData.apply(w, axis, dim)


def unshard(module) -> dict:
    """``module``'s own parameters, nested as its ``param_specs`` (a dict
    for each ``ParameterDict``), with every FSDP dim gathered whole
    (:func:`gather_fsdp`): what a layer runs on, at exactly the model-axis
    shapes of the trainer's layout.  Called where the layer runs, inside
    its remat region, so that the gathered weights live for one layer."""
    def walk(held, specs: dict) -> dict:
        return {k: walk(getattr(held, k), s) if isinstance(s, dict)
                else gather_fsdp(getattr(held, k), s)
                for k, s in specs.items()}
    return walk(module, module.param_specs)


def enter(p, specs: dict, axis: Axis) -> dict[str, torch.Tensor]:
    """A layer's parameters inside its split region: each one held whole
    (replicated) passes :func:`copy_in`, so its gradient, partial on each
    rank, is summed; the split ones as they are."""
    return {k: copy_in(v, axis) if tuple(v.shape) == specs[k].shape else v
            for k, v in p.items()}


def row_parallel(a: torch.Tensor, w: torch.Tensor,
                 axis: Axis) -> torch.Tensor:
    """``a @ w.to(a.dtype)`` with the contracted dim split over the model
    axis: each rank's product of the values in a's type, accumulated and
    summed over the ranks in float32, cast once."""
    part = a.float() @ w.to(a.dtype).float()
    return reduce_out(part, axis).to(a.dtype)


def local_slice(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This rank's even slice of the last dim of ``x``."""
    n = x.shape[-1] // axis.size
    return x.narrow(-1, axis.rank * n, n)


def scatter_sum(part: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This rank's slice of the last dim of the sum of ``part`` over the
    model axis (a reduce-scatter as an all-reduce, then a slice: gloo and
    NCCL both take it).  The slice's gradient, zero elsewhere, is summed
    over the ranks, so each rank's ``part`` gets the whole gradient."""
    return local_slice(copy_in(reduce_out(part, axis), axis), axis)


def kv_select(heads: int, kv_heads: int, q_per_kv: int,
              axis: Axis) -> tuple[list[int], int]:
    """The KV heads that this rank's ``heads`` local query heads (global
    ``rank·heads ...``) attend with, where the KV heads are held whole:
    global query head ``j`` reads KV head ``j // q_per_kv``.  Returns
    (their indices, the local query heads per KV head); where the local
    heads do not share their KV heads evenly, one KV head per query head
    (a group of 1)."""
    per = [j // q_per_kv for j in range(axis.rank * heads,
                                         (axis.rank + 1) * heads)]
    uniq = sorted(set(per))
    group = heads // len(uniq)
    if per == [u for u in uniq for _ in range(group)]:
        return uniq, group
    return per, 1


def vocab_parallel_embed(table: torch.Tensor, tokens: torch.Tensor,
                         dtype: torch.dtype, axis: Axis) -> torch.Tensor:
    """Rows of a table split over the vocabulary: each rank looks up the
    tokens in its rows (zeros elsewhere), the ranks' rows are summed (one
    is non-zero, so the sum is exact), then cast."""
    n = table.shape[0]
    local = tokens - axis.rank * n
    mine = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)] * mine[..., None]
    return reduce_out(rows, axis).to(dtype)


def vocab_parallel_xent(logits: torch.Tensor, labels: torch.Tensor,
                        axis: Axis, z_loss: float = 1e-4) -> torch.Tensor:
    """``transformer.xent_loss`` of logits split over the vocabulary (f32,
    each rank its ``V / M`` columns): the max, the sum of exponentials and
    the target logit each reduced over the model axis."""
    n = logits.shape[-1]
    top = _reduce(logits.detach().amax(-1), axis, dist.ReduceOp.MAX)
    s = reduce_out(torch.exp(logits - top[..., None]).sum(-1), axis)
    lse = top + torch.log(s)
    local = labels.long() - axis.rank * n
    mine = (local >= 0) & (local < n)
    ll = torch.take_along_dim(logits, local.clamp(0, n - 1)[..., None],
                              dim=-1)[..., 0]
    ll = reduce_out(ll * mine, axis)
    loss = torch.mean(lse - ll)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss


def mean_over_data(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The mean over the data axis, in float32 (sum, then ``/ D``)."""
    return _reduce(x.float(), axis) / axis.size


def _mean_buckets(grads: dict[str, torch.Tensor], names: list[str],
                  axis: Axis | None, size: int) -> dict[str, torch.Tensor]:
    """``names``' gradients summed over ``axis`` (none: as they are) and
    divided by ``size`` in float32, cast back; the leaves packed into
    all-reduces of at most :data:`BUCKET_BYTES`."""
    out: dict[str, torch.Tensor] = {}
    start = 0
    while start < len(names):
        end, nbytes = start, 0
        while end < len(names) and (end == start or nbytes + 4 * grads[
                names[end]].numel() <= BUCKET_BYTES):
            nbytes += 4 * grads[names[end]].numel()
            end += 1
        chunk = names[start:end]
        flat = torch.cat([grads[n].float().reshape(-1) for n in chunk])
        if axis is not None:
            flat = _reduce(flat, axis)
        flat = flat / size
        for n, part in zip(chunk, flat.split([grads[n].numel()
                                              for n in chunk])):
            out[n] = part.view(grads[n].shape).to(grads[n].dtype)
        del flat
        start = end
    return out


def mean_grads_over_data(grads: dict[str, torch.Tensor], axis: Axis,
                         summed=frozenset()) -> dict[str, torch.Tensor]:
    """Each gradient's mean over the data axis ``axis`` (float32 sum, then
    ``/ D``, cast back), the leaves packed into all-reduces of at most
    :data:`BUCKET_BYTES`.  ``summed``: the leaves whose gradient FSDP has
    already reduce-scattered over ``data`` (:func:`gather_fsdp`); those
    are summed over the batch's other axis alone (``pod`` on the multi-pod
    mesh, none on a (data, model) mesh), then divided by the same D."""
    # the batch rule's axes are ("pod", "data") or ("data",)
    others = [a for a in batch_axes(_MESH[0]) if a != "data"] if summed \
        else []
    outer = mesh_axis(others[0]) if others else None
    out = _mean_buckets(grads, [n for n in grads if n not in summed], axis,
                        axis.size)
    out |= _mean_buckets(grads, [n for n in grads if n in summed], outer,
                         axis.size)
    return {n: out[n] for n in grads}


def sq_norm(tree: dict[str, torch.Tensor],
            shards: dict[str, tuple[Axis, ...]]) -> torch.Tensor:
    """The squared global norm of a tree laid out as ``shards`` says (each
    leaf held as a slice -> the axes that split it, :func:`split_axes`):
    the local sums of squares of the leaves split over the same axes added
    together, then over each of those axes; the replicated leaves counted
    once."""
    dev = next(iter(tree.values())).device
    groups: dict[tuple, list[str]] = {}
    for n in tree:
        groups.setdefault(tuple(a.name for a in shards.get(n, ())),
                          []).append(n)
    total = torch.zeros((), device=dev)
    for names in groups.values():
        part = sum((torch.sum(torch.square(tree[n].float())) for n in names),
                   torch.zeros((), device=dev))
        for axis in shards.get(names[0], ()):
            part = _reduce(part, axis)
        total = total + part
    return total


def max_over(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _reduce(x, axis, dist.ReduceOp.MAX)


def gather_over(x: torch.Tensor, axis: Axis) -> list[torch.Tensor]:
    """Every rank's ``x`` (all of one shape) along ``axis``, in rank order,
    on x's device (not counted in :data:`WIRE`: the checkpoint's gather)."""
    wire = x.detach().to(wire_device(axis.group, x.device), copy=True)
    parts = [torch.empty_like(wire) for _ in range(axis.size)]
    dist.all_gather(parts, wire, group=axis.group)
    return [t.to(x.device) for t in parts]


def gather_cat(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """Every rank's ``x`` (all of one shape) concatenated along ``dim`` in
    rank order: an all-gather, counted in :data:`WIRE` by the bytes
    gathered."""
    _count(axis, x.numel() * x.element_size() * axis.size)
    return torch.cat(gather_over(x, axis), dim=dim)


def merge_softmax(m: torch.Tensor, s: torch.Tensor, o: torch.Tensor,
                  axis: Axis) -> torch.Tensor:
    """The softmax-weighted sum over every rank's slots, from each rank's
    partial over its own (float32): ``m`` (...,) the slots' largest logit,
    ``s`` (...,) the sum of ``exp(logit - m)``, ``o`` (..., d) the sum of
    ``exp(logit - m)·v``.  The ranks' maxima are reduced first, then each
    rank's ``s`` and ``o`` rescaled by ``exp(m - max)`` and summed in one
    all-reduce; the division is the last step.  A rank whose slots are all
    masked (logits ``NEG_INF``, finite) gets weight 0."""
    top = _reduce(m, axis, dist.ReduceOp.MAX)
    w = torch.exp(m - top)
    both = _reduce(torch.cat([(o * w[..., None]).reshape(-1),
                              (s * w).reshape(-1)]), axis)
    o_sum, s_sum = both.split([o.numel(), s.numel()])
    return o_sum.view(o.shape) / s_sum.view(s.shape)[..., None]


def vocab_parallel_argmax(logits: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The argmax over the last dim of logits split over the vocabulary
    (each rank its ``V / M`` columns), as a global index: each rank's
    first largest column, the ranks' largest value (a max), then the
    lowest global index holding it (a min).  Ties go to the lowest
    index, as ``torch.argmax`` and ``jnp.argmax`` break them."""
    n = logits.shape[-1]
    idx = torch.argmax(logits, dim=-1)
    val = torch.take_along_dim(logits, idx[..., None], dim=-1)[..., 0]
    top = _reduce(val, axis, dist.ReduceOp.MAX)
    cand = torch.where(val == top, idx + axis.rank * n, n * axis.size)
    return _reduce(cand, axis, dist.ReduceOp.MIN)


def shard_cache(cache, mesh):
    """This rank's slice of a whole decode cache, each tensor placed by
    ``sharding.cache_placements`` (the reference's ``cache_shardings``
    rule): a list (one state a layer), or the encoder-decoder's dict
    (``self``, such a list of KV caches, and ``cross_k``/``cross_v``
    (L, B, T, KV, hd), placed by the cross rule).  A KV cache split over
    its positions records its place: ``start``, the first slot it holds,
    and ``capacity``, the whole cache's slots; cross K/V split over the
    frames record the whole frame count as ``cross_frames``."""
    from repro_torch.distributed.sharding import (cache_placements,
                                                  shard_offsets)
    if isinstance(cache, dict):
        place = cache_placements(mesh, cache)
        out = {k: shard_cache(v, mesh) if k == "self"
               else shard_of(v, mesh, place[k]) for k, v in cache.items()}
        frames = cache["cross_k"].shape[2]
        if out["cross_k"].shape[2] != frames:
            out["cross_frames"] = frames
        return out
    out = []
    for state, place in zip(cache, cache_placements(mesh, cache)):
        new = state._replace(**{
            f: shard_of(t, mesh, p) for f, t, p in zip(state._fields, state,
                                                       place)
            if isinstance(t, torch.Tensor)})
        if "capacity" in state._fields and new.k.shape[2] != state.k.shape[2]:
            start = shard_offsets(new.k.shape, mesh, place.k,
                                  mesh.get_coordinate())[2]
            new = new._replace(start=start, capacity=state.k.shape[2])
        out.append(new)
    return out


def parameter_layout(model, mesh, rules=None) -> dict[str, tuple]:
    """Each parameter's placements on ``mesh``: ``tree_shardings`` over the
    model's ``shape_tree`` and ``logical_tree`` under ``rules``; by default
    the trainer's, the rules with FSDP off (model-axis splits only).
    ``DEFAULT_RULES`` also split each ``"fsdp"`` dim over ``data``."""
    from repro_torch.distributed.sharding import DEFAULT_RULES, tree_shardings
    from repro_torch.models import params as pr
    specs = model.specs()
    return tree_shardings(pr.shape_tree(specs), pr.logical_tree(specs), mesh,
                          rules or {**DEFAULT_RULES, **FSDP_OFF})


def shard_of(x: torch.Tensor, mesh, place: tuple) -> torch.Tensor:
    """This rank's slice of a whole tensor laid out ``place`` on ``mesh``
    (a copy, contiguous)."""
    from torch.distributed.tensor import Shard

    from repro_torch.distributed.sharding import mesh_sizes, shard_offsets
    sizes = list(mesh_sizes(mesh).values())
    local = list(x.shape)
    for n, p in zip(sizes, place):
        if isinstance(p, Shard):
            local[p.dim] //= n
    starts = shard_offsets(local, mesh, place, mesh.get_coordinate())
    for dim, (s, n) in enumerate(zip(starts, local)):
        x = x.narrow(dim, s, n)
    return x.contiguous()


def whole_of(x: torch.Tensor, mesh, place: tuple) -> torch.Tensor:
    """The whole tensor of this rank's slice ``x`` laid out ``place`` on
    ``mesh``, gathered over each axis that splits it (every rank of the
    axis takes part), on x's device."""
    from torch.distributed.tensor import Shard
    names = mesh.mesh_dim_names
    for i in reversed(range(len(names))):
        p = place[i]
        if isinstance(p, Shard) and mesh.size(i) > 1:
            axis = Axis(names[i], mesh.get_group(names[i]),
                        mesh.get_local_rank(names[i]), mesh.size(i))
            x = torch.cat(gather_over(x, axis), dim=p.dim)
    return x


@torch.no_grad()
def shard_parameters(model, layout: dict[str, tuple], mesh) -> None:
    """Replace each parameter of ``model`` by this rank's slice of it under
    ``layout`` (:func:`parameter_layout`), in place of the whole one."""
    for name, place in layout.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        whole = getattr(mod, leaf) if not isinstance(
            mod, torch.nn.ParameterDict) else mod[leaf]
        part = shard_of(whole.detach(), mesh, place)
        if part.shape != whole.shape:
            new = torch.nn.Parameter(part, requires_grad=whole.requires_grad)
            if isinstance(mod, torch.nn.ParameterDict):
                mod[leaf] = new
            else:
                setattr(mod, leaf, new)


def split_axes(model) -> dict[str, tuple[Axis, ...]]:
    """Each parameter held as a slice (its shape differs from its spec's)
    -> the axes of the ambient mesh that split it, ``model`` before
    ``data``: ``data`` where its ``"fsdp"`` dim is held split (FSDP),
    ``model`` where any other dim is."""
    specs = model.specs()
    out = {}
    for n, p in model.named_parameters():
        spec = specs[n]
        fsdp = {spec.logical[d] == "fsdp"
                for d, (a, b) in enumerate(zip(p.shape, spec.shape))
                if a != b}
        axes = ((model_axis(),) if False in fsdp else ()) + (
            (mesh_axis("data"),) if True in fsdp else ())
        if None in axes:
            raise ValueError(f"{n} is held as {tuple(p.shape)} of "
                             f"{spec.shape}: the ambient mesh does not "
                             "split it so")
        if axes:
            out[n] = axes
    return out


def check_moe_groups(cfg, batch: int, seq: int, data: int,
                     microbatches: int) -> None:
    """A data rank's tokens must form the MoE groups the global batch
    forms (``moe`` groups ``min(moe_group_size, b·s)`` flattened tokens of
    a microbatch): otherwise the routing, and with it the loss, would
    change."""
    if not cfg.num_experts or data == 1:
        return
    rows = batch // microbatches
    g = min(cfg.moe_group_size, rows * seq)
    local = rows // data * seq
    if rows % data or local % g:
        raise SystemExit(
            f"--data-par {data}: a rank's {local} tokens a microbatch "
            f"(batch {batch} / microbatches {microbatches} / data "
            f"{data} x seq {seq}) do not form whole MoE groups of {g} "
            f"tokens, the global batch's (min(moe_group_size "
            f"{cfg.moe_group_size}, {rows * seq})), so the routing would "
            "differ from one device's; pick a batch and seq whose rank "
            "share is a multiple of the group")
