"""The port's multi-device slice against the JAX package's, on the CPU.

The same inputs (tests/test_distributed.py's specs and draws) go through the
reference on 8 fake host devices in a subprocess and through the port's
8-rank gloo world: each 1D/2D/3D output within 1e-5, ``int8_psum`` bit for
bit on the same shards.  ``resolve_spec`` equals the reference's on every
leaf of every registered config's spec tree, on both production meshes,
under both rule sets; ``halo_bytes_per_step``, ``shape_tree`` and
``logical_tree`` equal the reference's."""
import dataclasses
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch_distributed_cases as cases  # noqa: E402
from repro.configs import get_config, list_archs  # noqa: E402
from repro.core import spec as ref_spec  # noqa: E402
from repro.distributed import halo as ref_halo  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.models import params as ref_params  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro_torch.core.spec import StencilSpec  # noqa: E402
from repro_torch.distributed import halo, sharding  # noqa: E402
from repro_torch.launch.mesh import run_local_world  # noqa: E402
from repro_torch.models import params as pr  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 300

# the reference's subprocess of tests/test_distributed.py, its outputs saved
_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core.spec import StencilSpec
from repro.distributed.halo import (distributed_stencil1d,
                                    distributed_stencil2d,
                                    distributed_stencil3d)
from repro.distributed.collectives import int8_psum
from repro.distributed.sharding import make_mesh_compat, shard_map_compat

mesh = make_mesh_compat((2, 4), ("pod", "data"))
case = {k: tuple(v) for k, v in np.load(sys.argv[1], allow_pickle=True)
        .item().items()}
out = {}
for name, build in (
        ("d1", lambda s: distributed_stencil1d(s, mesh, axis="data")),
        ("d2", lambda s: distributed_stencil2d(s, mesh, axes=("pod", "data"))),
        ("d3", lambda s: distributed_stencil3d(s, mesh, axes=("pod", "data")))):
    fields, x = case[name]
    out[name] = np.asarray(build(StencilSpec(**fields))(jnp.asarray(x)))
mesh1 = make_mesh_compat((8,), ("d",))
g = jax.jit(shard_map_compat(lambda v: int8_psum(v, "d"), mesh=mesh1,
                             in_specs=P("d"), out_specs=P("d")))
out["psum"] = np.asarray(g(jnp.asarray(case["psum"][0])))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """(the reference's outputs, the port's ranks' parts) on the same
    inputs."""
    tmp = tmp_path_factory.mktemp("parity")
    case = cases.inputs(0)
    fields = {k: (dataclasses.asdict(case[k][0]), case[k][1])
              for k in ("d1", "d2", "d3")}
    fields["psum"] = (case["psum"],)
    np.save(tmp / "in.npy", fields, allow_pickle=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp / "in.npy"),
         str(tmp / "out.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        port = run_local_world(cases.world_cases, 8, 0,
                               timeout=WORLD_TIMEOUT_S)
        _, err = proc.communicate(timeout=WORLD_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-2000:]
    with np.load(tmp / "out.npz") as ref:
        return {k: ref[k] for k in ref.files}, port


@pytest.mark.parametrize("name", ["d1", "d2", "d3"])
def test_distributed_stencil_matches_the_reference(outputs, name):
    ref, port = outputs
    got = cases.assemble([r[name] for r in port], ref[name].shape)
    np.testing.assert_allclose(got, ref[name], rtol=0, atol=1e-5)


def test_int8_psum_bit_for_bit(outputs):
    ref, port = outputs
    got = np.concatenate([r["psum"] for r in port])
    assert got.dtype == ref["psum"].dtype and got.shape == ref["psum"].shape
    assert got.tobytes() == ref["psum"].tobytes()


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


PRODUCTION = {"single_pod": SimpleNamespace(shape={"data": 16, "model": 16}),
              "multi_pod": SimpleNamespace(shape={"pod": 2, "data": 16,
                                                  "model": 16})}


@pytest.mark.parametrize("arch", list_archs())
def test_resolve_spec_equals_the_reference(arch):
    """Every leaf of the reference's spec tree, both production meshes,
    both rule sets; the PartitionSpec as a tuple."""
    specs = build_model(get_config(arch)).specs()
    n = 0
    for mesh_name, mesh in PRODUCTION.items():
        for rules in ("DEFAULT_RULES", "INFERENCE_RULES"):
            for path, s in _leaves(specs):
                want = tuple(ref_sharding.resolve_spec(
                    s.shape, s.logical, mesh, getattr(ref_sharding, rules)))
                got = sharding.resolve_spec(s.shape, s.logical, mesh,
                                            getattr(sharding, rules))
                assert got == want, (arch, mesh_name, rules, path)
                n += 1
    assert n > 0


def test_rule_tables_equal_the_reference():
    for rules in ("DEFAULT_RULES", "INFERENCE_RULES"):
        assert ({k: [tuple(c) for c in v]
                 for k, v in getattr(sharding, rules).items()}
                == {k: [tuple(c) for c in v]
                    for k, v in getattr(ref_sharding, rules).items()})


@pytest.mark.parametrize("arch", list_archs())
def test_shape_tree_and_logical_tree_equal_the_reference(arch):
    """The reference's spec tree, carried over to the port's ``Spec``: the
    same shapes, types and logical names leaf by leaf."""
    cfg = get_config(arch)
    specs = build_model(cfg).specs()

    def carry(tree):
        return {k: carry(v) if isinstance(v, dict)
                else pr.Spec(**dataclasses.asdict(v)) for k, v in tree.items()}

    port_specs = carry(specs)
    want_shapes = dict(_leaves(ref_params.shape_tree(specs, cfg.param_dtype)))
    want_logical = dict(_leaves(ref_params.logical_tree(specs)))
    got_shapes = dict(_leaves(pr.shape_tree(port_specs, cfg.param_dtype)))
    got_logical = dict(_leaves(pr.logical_tree(port_specs)))
    assert got_shapes.keys() == want_shapes.keys() == got_logical.keys()
    for path, sd in want_shapes.items():
        t = got_shapes[path]
        assert t.is_meta and tuple(t.shape) == tuple(sd.shape), path
        assert str(t.dtype).removeprefix("torch.") == str(sd.dtype), path
        assert got_logical[path] == want_logical[path], path


def _spec_pairs():
    rng = np.random.default_rng(1)
    for grid, radii, t, dtype in (((512,), (3,), 2, "float32"),
                                  ((64, 96), (2, 2), 2, "float32"),
                                  ((449, 960), (12, 12), 4, "float32"),
                                  ((256, 512), (1, 1), 4, "bfloat16"),
                                  ((16, 32, 48), (1, 1, 1), 2, "float32"),
                                  ((512, 512, 512), (2, 2, 2), 2, "float64")):
        coeffs = tuple(tuple(rng.normal(size=2 * r + 1).tolist())
                       for r in radii)
        yield (StencilSpec(grid, radii, coeffs, dtype=dtype, timesteps=t),
               ref_spec.StencilSpec(grid, radii, coeffs, dtype=dtype,
                                    timesteps=t))


@pytest.mark.parametrize("shards", [(1, 1, 1), (2, 1, 1), (4, 2, 1),
                                    (2, 4, 1), (8, 8, 8), (16, 1, 2)])
def test_halo_bytes_per_step_equals_the_reference(shards):
    for port_spec, ref in _spec_pairs():
        s = shards[:len(port_spec.grid_shape)]
        assert (halo.halo_bytes_per_step(port_spec, s)
                == ref_halo.halo_bytes_per_step(ref, s))
