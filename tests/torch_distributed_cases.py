"""What each rank of a gloo world runs for tests/test_torch_distributed.py
and tests/test_torch_distributed_parity.py: the cases of
tests/test_distributed.py (same specs, same draws from one seed) through the
port's distributed stencils and ``int8_psum``.  No jax: the ranks are
spawned processes that import this module by name.  Not a test file."""
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.core.spec import StencilSpec
from repro_torch.distributed.collectives import int8_psum
from repro_torch.distributed.halo import (distributed_stencil1d,
                                          distributed_stencil2d,
                                          distributed_stencil3d)
from repro_torch.distributed.sharding import (PartitionSpec, make_mesh_compat,
                                              named_sharding, placements,
                                              shard_offsets)
from repro_torch.launch.mesh import make_local_mesh

MESH = ((2, 4), ("pod", "data"))


def inputs(seed: int = 0) -> dict:
    """The specs and inputs of tests/test_distributed.py's subprocess, drawn
    from ``default_rng(seed)`` in its order."""
    rng = np.random.default_rng(seed)
    c1 = tuple((rng.normal(size=7) / 7).tolist())
    s1 = StencilSpec((512,), (3,), (c1,), dtype="float32", timesteps=2)
    x1 = rng.normal(size=512).astype(np.float32)
    cx = rng.normal(size=5) / 5
    cx[2] = 0.0
    s2 = StencilSpec((64, 96), (2, 2),
                     (tuple((rng.normal(size=5) / 5).tolist()), tuple(cx)),
                     dtype="float32", timesteps=2)
    x2 = rng.normal(size=(64, 96)).astype(np.float32)
    cz3 = rng.normal(size=3) / 3
    cy3 = rng.normal(size=3) / 3
    cy3[1] = 0.0
    cx3 = rng.normal(size=3) / 3
    cx3[1] = 0.0
    s3 = StencilSpec((16, 32, 48), (1, 1, 1),
                     (tuple(cz3), tuple(cy3), tuple(cx3)),
                     dtype="float32", timesteps=2)
    x3 = rng.normal(size=(16, 32, 48)).astype(np.float32)
    xq = rng.normal(size=(8, 64)).astype(np.float32)
    return {"d1": (s1, x1), "d2": (s2, x2), "d3": (s3, x3), "psum": xq}


def shard_of(x: torch.Tensor, mesh, pspec: PartitionSpec) -> DTensor:
    """This rank's shard of ``x`` (whole on every rank) as a DTensor laid
    out ``pspec``, cut without communication."""
    return distribute_tensor(x, mesh, placements(pspec, mesh),
                             src_data_rank=None)


def local_part(y: DTensor) -> tuple[tuple[int, ...], np.ndarray]:
    """(where this rank's shard starts in the whole, the shard on the host)."""
    local = y.to_local()
    start = shard_offsets(local.shape, y.device_mesh, y.placements,
                          y.device_mesh.get_coordinate())
    return start, local.cpu().numpy()


def assemble(parts, shape) -> np.ndarray:
    """The whole array from every rank's :func:`local_part`."""
    out = np.full(shape, np.nan, np.float32)
    for start, a in parts:
        out[tuple(slice(s, s + n) for s, n in zip(start, a.shape))] = a
    return out


def _cut(spec: StencilSpec, shards: int) -> StencilSpec:
    """``spec`` on a grid whose shards (n / shards) are one narrower than
    the halo r*T."""
    n = shards * (spec.radii[0] * spec.timesteps - 1)
    return StencilSpec((n,), spec.radii, spec.coeffs, dtype=spec.dtype,
                       timesteps=spec.timesteps)


def world_cases(seed: int = 0) -> dict:
    """Run in each rank of an 8-rank world on the CPU: the three stencils on
    a (2, 4) ("pod", "data") mesh, ``int8_psum`` over an (8,) mesh, a
    too-narrow shard, and a ``named_sharding`` round trip.  Returns this
    rank's parts of each output."""
    case = inputs(seed)
    mesh = make_mesh_compat(*MESH, device="cpu")
    out = {}
    for name, build, pspec in (
            ("d1", lambda s: distributed_stencil1d(s, mesh, axis="data"),
             PartitionSpec("data")),
            ("d2", lambda s: distributed_stencil2d(s, mesh, axes=MESH[1]),
             PartitionSpec(*MESH[1])),
            ("d3", lambda s: distributed_stencil3d(s, mesh, axes=MESH[1]),
             PartitionSpec(*MESH[1]))):
        spec, x = case[name]
        y = build(spec)(shard_of(torch.from_numpy(x), mesh, pspec))
        out[name] = local_part(y)
    mesh1 = make_mesh_compat((8,), ("d",), device="cpu")
    q = shard_of(torch.from_numpy(case["psum"]), mesh1, PartitionSpec("d"))
    out["psum"] = int8_psum(q.to_local(), mesh1.get_group("d")).numpy()
    spec1 = case["d1"][0]
    try:
        distributed_stencil1d(_cut(spec1, 4), mesh, axis="data")
        out["narrow_raises"] = False
    except ValueError:
        out["narrow_raises"] = True
    x = torch.from_numpy(case["d2"][1])
    place = named_sharding((64, 96), ("stencil_y", "stencil_x"), mesh)
    dt = distribute_tensor(x, mesh, place, src_data_rank=None)
    out["round_trip"] = (tuple(place), tuple(dt.to_local().shape),
                         bool(torch.equal(dt.full_tensor(), x)))
    return out


def mesh_world() -> dict:
    """Run in each rank of a 4-rank world: ``make_local_mesh(2, 2)`` on the
    CPU and one halo-exchanged step along its "data" axis."""
    mesh = make_local_mesh(2, 2, device="cpu")
    spec = StencilSpec((16,), (1,), ((0.25, 0.5, 0.25),), timesteps=2)
    x = torch.arange(16, dtype=torch.float32)
    y = distributed_stencil1d(spec, mesh, axis="data")(
        shard_of(x, mesh, PartitionSpec("data")))
    return {"names": mesh.mesh_dim_names, "shape": tuple(mesh.mesh.shape),
            "groups": {a: dist.get_process_group_ranks(mesh.get_group(a))
                       for a in mesh.mesh_dim_names},
            "part": local_part(y)}
