"""Multi-device halo exchange for distributed stencils (port of
``repro.distributed.halo``).

The paper's PE-to-PE producer-consumer links, lifted to device scale: when a
stencil grid is sharded into strips across a mesh, each fused block of T
sweeps needs only ``r * T`` boundary planes from the two neighbour shards, a
pair of point-to-point messages (``torch.distributed.batch_isend_irecv``,
the counterpart of ``jax.lax.ppermute``), not a gather.  Shards at the global
edges receive zeros, which *is* the oracle's boundary convention.

Each shard's fused sweep runs the port's own stencil ops on the haloed
shard: ``stencil1d`` (K1), ``stencil2d`` (K3) and ``stencil3d`` (K4), which
launch their kernels on CUDA tensors and run their plain versions on CPU
tensors.  An op zeroes a rim of ``r * t`` of the haloed extent after sweep
``t``: that rim is the halo, which is sliced away, and every output of the
centre depends only on inputs within ``r * T`` (the oracle's rule), so the
centre equals the single-device answer.  The global rim is then masked, as
the reference masks it.

A mesh axis is given by name to the public functions and as its
``ProcessGroup`` (``mesh.get_group(name)``) to :func:`halo_exchange`, where
jax's ``shard_map`` resolved the name.  The callables that
``distributed_stencil{1,2,3}d`` return take and return a DTensor of the
whole grid, laid out as the reference lays it out; ``to_local()`` is the
shard.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core.spec import StencilSpec
from repro_torch.distributed.collectives import wire_device
from repro_torch.distributed.sharding import (PartitionSpec, mesh_sizes,
                                              placements)
from repro_torch.kernels import stencil1d, stencil2d, stencil3d


# --------------------------------------------------------------------------
# per rank: exchange + local sweeps
# --------------------------------------------------------------------------
def _position(group) -> tuple[int, int]:
    """(this rank's index along the group's mesh axis, the axis's size)."""
    return dist.get_group_rank(group, dist.get_rank()), dist.get_world_size(group)


def halo_exchange(x: torch.Tensor, halo: int, axis_name,
                  array_axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (left_halo, right_halo) received from the neighbours along
    the mesh axis whose ``ProcessGroup`` is ``axis_name``; zeros at the
    global edges.  The slabs travel as :func:`wire_device` says (through
    the host over gloo) and come back on ``x``'s device."""
    i, n = _position(axis_name)
    wire = wire_device(axis_name, x.device)
    extent = x.shape[array_axis]
    shape = list(x.shape)
    shape[array_axis] = halo
    from_left = torch.zeros(shape, dtype=x.dtype, device=wire)
    from_right = torch.zeros(shape, dtype=x.dtype, device=wire)
    ops = []
    if halo and i + 1 < n:          # my right edge -> right neighbour
        peer = dist.get_global_rank(axis_name, i + 1)
        edge = x.narrow(array_axis, extent - halo, halo).contiguous().to(wire)
        ops += [dist.P2POp(dist.isend, edge, peer, axis_name),
                dist.P2POp(dist.irecv, from_right, peer, axis_name)]
    if halo and i > 0:              # my left edge -> left neighbour
        peer = dist.get_global_rank(axis_name, i - 1)
        edge = x.narrow(array_axis, 0, halo).contiguous().to(wire)
        ops += [dist.P2POp(dist.isend, edge, peer, axis_name),
                dist.P2POp(dist.irecv, from_left, peer, axis_name)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return from_left.to(x.device), from_right.to(x.device)


def _extend(x: torch.Tensor, halo: int, group, axis: int) -> torch.Tensor:
    """``x`` with its neighbours' ``halo`` planes on both sides of ``axis``."""
    left, right = halo_exchange(x, halo, group, axis)
    return torch.cat([left, x, right], dim=axis)


def _zero_rim(y: torch.Tensor, axis: int, index: int, total: int,
              rim: int) -> None:
    """Zero, in place, what lies within ``rim`` of the global grid's faces
    along ``axis``, ``y`` being shard ``index`` of a ``total``-long axis."""
    n = y.shape[axis]
    start = index * n
    lo = min(max(rim - start, 0), n)            # global position < rim
    hi = max(min(total - rim - start, n), lo)   # global position >= total - rim
    if lo:
        y.narrow(axis, 0, lo).zero_()
    if hi < n:
        y.narrow(axis, hi, n - hi).zero_()


def sweep(x: torch.Tensor, spec: StencilSpec) -> torch.Tensor:
    """``spec.timesteps`` fused sweeps of ``x`` (a whole grid or a haloed
    shard) by the port's op for the spec's rank: ``stencil1d`` (K1),
    ``stencil2d`` (K3) or ``stencil3d`` (K4, a launch a sweep)."""
    if spec.ndim == 1:
        return stencil1d(x, spec.coeffs[0], timesteps=spec.timesteps)
    if spec.ndim == 2:
        return stencil2d(x, *spec.coeffs, timesteps=spec.timesteps)
    return stencil3d(x, *spec.coeffs, timesteps=spec.timesteps)


def _local_stencil(x: torch.Tensor, spec: StencilSpec, groups) -> torch.Tensor:
    """Local shard of the fused stencil, sharded along its leading
    ``len(groups)`` axes, with one halo exchange a mesh axis.  Each
    exchange extends the already-extended shard, so the corners ride along
    (fused star sweeps have diamond composite support).  The haloed shard
    is swept, its centre kept and the global rim zeroed along each sharded
    axis; an unsharded axis (3D's x) is whole, and the op zeroed its rim."""
    lead = x.ndim - spec.ndim
    halos = [r * spec.timesteps for r in spec.radii[:len(groups)]]
    ext = x
    for axis, (halo, group) in enumerate(zip(halos, groups), lead):
        ext = _extend(ext, halo, group, axis)
    y = sweep(ext, spec)
    for axis, halo in enumerate(halos, lead):
        y = y.narrow(axis, halo, x.shape[axis])
    y = y.contiguous()
    for axis, (halo, group) in enumerate(zip(halos, groups), lead):
        i, n = _position(group)
        _zero_rim(y, axis, i, n * x.shape[axis], halo)
    return y


# --------------------------------------------------------------------------
# public API: mesh-level distributed stencils
# --------------------------------------------------------------------------
def _check_shards(spec: StencilSpec, shards: Sequence[int]) -> None:
    """The reference's asserts on each mesh-mapped axis, as ValueError."""
    for ax, (n, r, s) in enumerate(zip(spec.grid_shape, spec.radii, shards)):
        if n % s:
            raise ValueError(f"axis {ax} of {n} does not split into {s} "
                             f"shards")
        if n // s < r * spec.timesteps:
            raise ValueError(f"axis {ax}: a shard of {n // s} is narrower "
                             f"than the halo r*T = {r * spec.timesteps}; "
                             f"reduce timesteps or shards")


def _sharded(spec: StencilSpec, mesh, axes: tuple[str, ...],
             ndim: int) -> Callable[[DTensor], DTensor]:
    if spec.ndim != ndim:
        raise ValueError(f"a {ndim}D distributed stencil needs a {ndim}D "
                         f"spec, got {spec.ndim}D")
    sizes = mesh_sizes(mesh)
    _check_shards(spec, [sizes[a] for a in axes])
    groups = tuple(mesh.get_group(a) for a in axes)
    place = placements(PartitionSpec(*axes), mesh)

    def step(x: DTensor) -> DTensor:
        if not (isinstance(x, DTensor) and tuple(x.shape) == spec.grid_shape
                and tuple(x.placements) == place):
            raise ValueError(f"expected a DTensor of shape {spec.grid_shape} "
                             f"placed {place} on the stencil's mesh, got "
                             f"{type(x).__name__} {tuple(x.shape)} "
                             f"{getattr(x, 'placements', None)}")
        return DTensor.from_local(_local_stencil(x.to_local(), spec, groups),
                                  mesh, place, run_check=False)
    return step


def distributed_stencil1d(spec: StencilSpec, mesh, axis: str = "data"):
    """f(x) running the fused 1D stencil sharded into strips along ``axis``
    of ``mesh`` (a ``DeviceMesh``).  x: a DTensor of (N,), N divisible by
    the axis's size, laid out ``PartitionSpec(axis)``; returns one alike."""
    return _sharded(spec, mesh, (axis,), 1)


def distributed_stencil2d(spec: StencilSpec, mesh,
                          axes: tuple[str, str] = ("pod", "data")):
    """Fused 2D stencil sharded (y over axes[0], x over axes[1]), on DTensors
    laid out ``PartitionSpec(*axes)``."""
    return _sharded(spec, mesh, tuple(axes), 2)


def distributed_stencil3d(spec: StencilSpec, mesh,
                          axes: tuple[str, str] = ("pod", "data")):
    """Fused 3D star stencil sharded (z over axes[0], y over axes[1], x
    unsharded: the innermost axis keeps its locality), on DTensors laid out
    ``PartitionSpec(*axes)``."""
    return _sharded(spec, mesh, tuple(axes), 3)


def halo_bytes_per_step(spec: StencilSpec, shards: Sequence[int]) -> int:
    """Collective traffic of one fused exchange (for roofline accounting)."""
    b = spec.bytes_per_elem
    total = 0
    for ax, (n, r, s) in enumerate(zip(spec.grid_shape, spec.radii, shards)):
        if s <= 1:
            continue
        other = 1
        for a2, n2 in enumerate(spec.grid_shape):
            if a2 != ax:
                other *= n2
        total += 2 * (s - 1) * r * spec.timesteps * other * b
    return total
