"""The port's multi-device slice on the CPU, no jax: halo-exchanged stencils
equal the single-device oracle, ``int8_psum``, the sharding rules, meshes.

The ranks are spawned processes of one gloo world (``run_local_world``,
rendezvous through a file, no port), spawned once per module: 8 ranks for
tests/test_distributed.py's cases on a (2, 4) ("pod", "data") mesh, 4 for
``make_local_mesh(2, 2)``.  Each rank sweeps its haloed shard with the
stencil ops' plain versions (CPU tensors)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_distributed_cases as cases
from repro_torch.configs import get_reduced_config
from repro_torch.core import heat_2d, stencil_reference_np
from repro_torch.core.spec import StencilSpec
from repro_torch.distributed.halo import halo_bytes_per_step
from repro_torch.distributed.sharding import (INFERENCE_RULES, PartitionSpec,
                                              constrain, resolve_spec,
                                              tree_shardings)
from repro_torch.launch.mesh import run_local_world
from repro_torch.models import params as pr
from repro_torch.models.registry import build_model

WORLD_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def world():
    return run_local_world(cases.world_cases, 8, 0, timeout=WORLD_TIMEOUT_S)


@pytest.fixture(scope="module")
def world4():
    return run_local_world(cases.mesh_world, 4, timeout=WORLD_TIMEOUT_S)


@pytest.mark.parametrize("name", ["d1", "d2", "d3"])
def test_distributed_stencil_matches_oracle(world, name):
    spec, x = cases.inputs(0)[name]
    got = cases.assemble([r[name] for r in world], spec.grid_shape)
    np.testing.assert_allclose(got, stencil_reference_np(x, spec), rtol=0,
                               atol=1e-5)


def test_int8_psum_accuracy(world):
    xq = cases.inputs(0)["psum"]
    true = xq.sum(axis=0)
    y = world[0]["psum"]
    assert y.shape == (1, 64) and y.dtype == np.float32
    assert np.abs(y[0] - true).max() / np.abs(true).max() < 0.05
    assert all(np.array_equal(r["psum"], y) for r in world)


def test_shard_narrower_than_the_halo_raises(world):
    assert all(r["narrow_raises"] for r in world)


def test_named_sharding_round_trip(world):
    place, local_shape, equal = world[0]["round_trip"]
    assert [str(p) for p in place] == ["S(0)", "S(1)"]
    assert local_shape == (32, 24)
    assert all(r["round_trip"][2] for r in world)


def test_make_local_mesh(world4):
    assert all(r["names"] == ("data", "model") and r["shape"] == (2, 2)
               for r in world4)
    assert [r["groups"] for r in world4] == [
        {"data": [0, 2], "model": [0, 1]}, {"data": [1, 3], "model": [0, 1]},
        {"data": [0, 2], "model": [2, 3]}, {"data": [1, 3], "model": [2, 3]}]
    spec = StencilSpec((16,), (1,), ((0.25, 0.5, 0.25),), timesteps=2)
    got = cases.assemble([r["part"] for r in world4], (16,))
    want = stencil_reference_np(np.arange(16, dtype=np.float32), spec)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("spec,shards,want", [
    (cases.inputs(0)["d2"][0], (2, 4), 9216),
    (heat_2d(256, 512), (2, 4), 10240),
    (StencilSpec((256, 512), (1, 1), ((0.1, 0.6, 0.1), (0.1, 0.0, 0.1)),
                 timesteps=4), (2, 4), 40960),
    (cases.inputs(0)["d3"][0], (2, 4, 1), 61440),
    (cases.inputs(0)["d1"][0], (4,), 144),
    (heat_2d(64, 64), (1, 1), 0),
])
def test_halo_bytes_per_step(spec, shards, want):
    assert halo_bytes_per_step(spec, shards) == want


# ---- sharding rules (mesh-shape only; no processes) -------------------------
MESH = SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16})


def test_rules_batch_over_pod_and_data():
    assert resolve_spec((256, 4096), ("batch", None), MESH) == (("pod", "data"),)


def test_rules_divisibility_fallback():
    # kv_heads=8 cannot split 16 -> replicated
    assert resolve_spec((8, 128), ("kv_heads", None), MESH) == ()
    # odd vocab -> replicated
    assert resolve_spec((49155, 1024), ("vocab", "fsdp"), MESH) == (None, "data")
    # heads=96 divides 16
    assert resolve_spec((96, 128), ("heads", None), MESH) == ("model",)


def test_rules_no_axis_reuse():
    # both dims want 'model'; second falls back
    assert resolve_spec((32, 32), ("heads", "mlp"), MESH) == ("model",)


def test_inference_rules_keep_tp_drop_fsdp():
    assert resolve_spec((4096, 4096), ("fsdp", "mlp"), MESH,
                        INFERENCE_RULES) == (None, "model")
    assert resolve_spec((4096, 4096), ("fsdp", "mlp"), MESH) == ("data", "model")


def test_cache_seq_and_expert_cap_fallbacks():
    got = resolve_spec((128, 8, 32768, 128),
                       ("batch", "kv_heads", "cache_seq", None), MESH)
    assert got == (("pod", "data"), None, "model")
    got = resolve_spec((128, 32, 160, 1024),
                       ("batch", "experts", "expert_cap", None), MESH)
    assert got == (("pod", "data"), "model")
    got = resolve_spec((128, 40, 160, 1024),
                       ("batch", "experts", "expert_cap", None), MESH)
    assert got == (("pod", "data"), None, "model")


def test_partition_spec_is_a_tuple():
    spec = resolve_spec((256, 4096), ("batch", "mlp"), MESH)
    assert isinstance(spec, PartitionSpec) and isinstance(spec, tuple)
    assert repr(spec) == "PartitionSpec(('pod', 'data'), 'model')"


def test_shape_tree_logical_tree_and_tree_shardings():
    """A reduced model's spec tree: meta tensors of each spec's shape and
    type, its logical names, and placements on a mesh of shapes alone."""
    cfg = get_reduced_config("tinyllama-1.1b")
    specs = build_model(cfg, device="cpu").specs()
    shapes = pr.shape_tree(specs, cfg.param_dtype)
    logical = pr.logical_tree(specs)
    assert shapes.keys() == logical.keys() == specs.keys()
    for name, s in specs.items():
        t = shapes[name]
        assert t.is_meta and tuple(t.shape) == s.shape
        assert t.dtype == pr.spec_dtype(s, cfg.param_dtype)
        assert logical[name] == s.logical
    mesh = SimpleNamespace(shape={"data": 2, "model": 2})
    place = tree_shardings(shapes, logical, mesh)
    assert place.keys() == specs.keys()
    for name, p in place.items():
        spec = resolve_spec(specs[name].shape, specs[name].logical, mesh)
        dims = {a: d for d, part in enumerate(spec)
                for a in ((part,) if isinstance(part, str) else part or ())}
        assert [getattr(q, "dim", None) for q in p] == [
            dims.get(a) for a in ("data", "model")], name


def test_constrain_returns_its_input():
    x = torch.zeros(4, 8)
    assert constrain(x, ("batch", "embed")) is x
