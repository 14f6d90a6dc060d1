"""Logical-axis sharding rules with divisibility fallback (port of
``repro.distributed.sharding``).

Every tensor dim is annotated with a *logical* name ("batch", "heads",
"mlp", ...).  Rules map logical names to an ordered list of mesh-axis
candidates; the first candidate whose size divides the dim is chosen, else
the dim is replicated.  This is what lets every registered architecture lay
out on the same (data=16, model=16) / (pod=2, data=16, model=16) meshes even
where e.g. kv_heads=8 cannot split 16 ways.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` (axis names
from ``mesh_dim_names``, sizes from ``mesh.mesh.shape``) or anything whose
``.shape`` maps axis names to sizes.  A spec is a :class:`PartitionSpec`,
the tuple jax's ``PartitionSpec`` is; :func:`named_sharding` turns it into
the DTensor placements of a ``DeviceMesh``.  The port has no SPMD
partitioner: :func:`constrain` returns its input.
"""
from __future__ import annotations

import math
from typing import Mapping, Sequence

import torch
from torch.distributed.tensor import Replicate, Shard

# candidates are tuples-of-mesh-axes (a tuple shards a dim over several axes)
Rules = Mapping[str, Sequence[tuple[str, ...]]]

DEFAULT_RULES: Rules = {
    # activations
    "batch":      [("pod", "data"), ("data",)],
    "seq":        [()],                       # replicated (SP via halo path)
    "seq_shard":  [("data",)],                # sequence parallelism opt-in
    "embed":      [()],
    # params
    "vocab":      [("model",)],
    "heads":      [("model",)],
    "kv_heads":   [("model",)],
    "head_dim":   [()],
    "mlp":        [("model",)],
    "experts":    [("model",)],
    "expert_cap": [("model",)],   # MoE fallback: shard capacity when E can't
    "cache_seq":  [("model",)],   # KV-cache positions: kv_heads never divide
                                  # 16 on the registered archs, so decode
                                  # shards the cache *sequence* instead
    "fsdp":       [("data",)],                # param leading-dim FSDP
    "conv_k":     [()],
    "stencil_x":  [("data",)],                # distributed stencil strips
    "stencil_y":  [("pod",)],
}


# Serving layout: identical to DEFAULT_RULES except params are NOT
# FSDP-sharded: decode would otherwise re-gather every weight on every step.
INFERENCE_RULES: Rules = {**DEFAULT_RULES, "fsdp": [()]}


class PartitionSpec(tuple):
    """Per tensor dim: ``None`` (replicated), a mesh axis name, or a tuple of
    names (the dim split over several axes, the first outermost); trailing
    ``None``s dropped.  Equal to jax's ``PartitionSpec`` as a tuple."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size, in the mesh's axis order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


def make_mesh_compat(shape: tuple[int, ...], axes: tuple[str, ...],
                     device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group's ranks, its tensors on ``device`` ("cuda": the card; "cpu")."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def _axes_size(sizes: Mapping[str, int], axes: tuple[str, ...]) -> int:
    return math.prod(sizes[a] for a in axes)


def resolve_spec(shape: tuple[int, ...], logical: tuple[str | None, ...],
                 mesh, rules: Rules | None = None) -> PartitionSpec:
    """Pick a PartitionSpec for ``shape`` given per-dim logical names.

    Falls back to replication when no candidate divides the dim or the mesh
    lacks the axis.  A mesh axis is used at most once per tensor; earlier
    dims win.
    """
    rules = rules or DEFAULT_RULES
    if len(shape) != len(logical):
        raise ValueError(f"shape {shape} and logical axes {logical} differ "
                         f"in rank")
    sizes = mesh_sizes(mesh)
    used: set[str] = set()
    parts = []
    for dim, name in zip(shape, logical):
        chosen: tuple[str, ...] | None = None
        if name:
            for cand in rules.get(name, [()]):
                cand = tuple(a for a in cand if a in sizes)
                if not cand or any(a in used for a in cand):
                    continue
                if dim % _axes_size(sizes, cand) == 0:
                    chosen = cand
                    break
        if chosen:
            used.update(chosen)
            parts.append(chosen if len(chosen) > 1 else chosen[0])
        else:
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


def placements(spec: PartitionSpec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on each
    mesh axis that ``spec`` names for tensor dim ``dim``, ``Replicate()`` on
    every other.  A dim split over several axes is split in the mesh's axis
    order, which must be the order the spec names them in."""
    out = {a: Replicate() for a in mesh_sizes(mesh)}
    for dim, part in enumerate(spec):
        axes = (part,) if isinstance(part, str) else tuple(part or ())
        if list(axes) != [a for a in out if a in axes]:
            raise ValueError(f"{spec} splits dim {dim} over {axes}, not in "
                             f"the mesh's axis order {tuple(out)}")
        for a in axes:
            out[a] = Shard(dim)
    return tuple(out.values())


def shard_offsets(local_shape: Sequence[int], mesh, place: Sequence,
                  coordinate: Sequence[int]) -> tuple[int, ...]:
    """Where the shard of ``local_shape`` held at mesh ``coordinate`` starts
    in the whole tensor laid out ``place`` on ``mesh`` (even splits; a dim
    split over several mesh axes is split in their order)."""
    index = [0] * len(local_shape)
    for size, p, c in zip(mesh_sizes(mesh).values(), place, coordinate):
        if isinstance(p, Shard):
            index[p.dim] = index[p.dim] * size + c
    return tuple(i * n for i, n in zip(index, local_shape))


def named_sharding(shape: tuple[int, ...], logical: tuple[str | None, ...],
                   mesh, rules: Rules | None = None) -> tuple:
    """The DTensor placements on ``mesh`` of :func:`resolve_spec`'s spec
    (the counterpart of jax's ``NamedSharding``): pass them with the mesh to
    ``torch.distributed.tensor.distribute_tensor``."""
    return placements(resolve_spec(shape, logical, mesh, rules), mesh)


def constrain(x, logical: tuple, rules: Rules | None = None):
    """Activation sharding constraint by logical names: ``x`` unchanged.
    The port has no SPMD partitioner to anchor, which is the reference's
    behaviour when no mesh is set."""
    return x


def _is_logical(x) -> bool:
    return isinstance(x, (tuple, list)) and (
        not x or not isinstance(x[0], (tuple, list)))


def tree_shardings(tree_of_shapes, tree_of_logical, mesh,
                   rules: Rules | None = None):
    """Map (shape tree, logical tree) -> placements tree (same structure).
    The trees are dicts, nested or flat; a shape leaf is a tuple of ints or
    a tensor (e.g. :func:`repro_torch.models.params.shape_tree`'s)."""
    if _is_logical(tree_of_logical):
        shape = tuple(getattr(tree_of_shapes, "shape", tree_of_shapes))
        return named_sharding(shape, tuple(tree_of_logical), mesh, rules)
    return {k: tree_shardings(tree_of_shapes[k], v, mesh, rules)
            for k, v in tree_of_logical.items()}
