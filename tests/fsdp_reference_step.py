"""The JAX package's FSDP training step on 4 fake host devices, for
``tests/test_torch_fsdp.py`` (run as a script in a subprocess: XLA's host
device count must be set before jax starts).

First, for each architecture named, the reduced config's parameters from
``init(PRNGKey(0))``, written as numpy to ``OUT/params.pkl`` (renamed into
place once whole, so a reader may start from them while the steps
compile).  Then, for each of them: the parameters laid
out with the AdamW moments by ``DEFAULT_RULES`` on a (data 2, model 2)
mesh (each ``"fsdp"`` dim over ``data``), as ``repro.launch.dryrun`` lays
them out but on real arrays, and one ``make_train_step`` (remat "dots")
jitted with those ``in_shardings``; the step's loss and the compiled
step's all-gathers to ``OUT/steps.pkl``.

Usage: python tests/fsdp_reference_step.py OUT BATCHES.pkl
(BATCHES: {arch: {input name: numpy array}}).
"""
import os
import pickle
import re
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from repro.configs import get_reduced_config  # noqa: E402
from repro.distributed.sharding import (  # noqa: E402
    DEFAULT_RULES, mesh_context, resolve_spec)
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models import params as pr  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.train.optim import (  # noqa: E402
    AdamWState, OptConfig, init_opt_state)
from repro.train.train_step import make_train_step  # noqa: E402


def _dump(obj, path: str) -> None:
    with open(path + ".tmp", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".tmp", path)


def main(out_dir: str, batches_path: str) -> None:
    with open(batches_path, "rb") as f:
        batches = pickle.load(f)
    models = {arch: build_model(get_reduced_config(arch)) for arch in batches}
    inits = {arch: m.init(jax.random.PRNGKey(0))
             for arch, m in models.items()}
    _dump({arch: jax.tree.map(np.asarray, p) for arch, p in inits.items()},
          os.path.join(out_dir, "params.pkl"))
    mesh = make_local_mesh(2, 2)
    out = {}
    for arch, batch in batches.items():
        cfg, model, params = get_reduced_config(arch), models[arch], \
            inits[arch]
        specs = model.specs()
        p_shard = jax.tree.map(
            lambda sd, lg: NamedSharding(mesh, resolve_spec(
                tuple(sd.shape), lg, mesh, DEFAULT_RULES)),
            pr.shape_tree(specs, cfg.param_dtype), pr.logical_tree(specs))
        opt_cfg = OptConfig()
        opt_state = init_opt_state(params, opt_cfg)
        opt_shard = AdamWState(step=NamedSharding(mesh, P()), m=p_shard,
                               v=p_shard, ef=None)
        b_shard = {k: NamedSharding(mesh, P("data")) for k in batch}
        with mesh_context(mesh):
            step = jax.jit(make_train_step(model, cfg, opt_cfg,
                                           remat="dots"),
                           in_shardings=(p_shard, opt_shard, b_shard))
            text = step.lower(params, opt_state, batch).compile().as_text()
            _, _, metrics = step(params, opt_state, batch)
        out[arch] = {
            "loss": float(metrics["loss"]),
            "all_gathers": len(re.findall(r"= \S+ all-gather(-start)?\(",
                                          text))}
    _dump(out, os.path.join(out_dir, "steps.pkl"))


if __name__ == "__main__":
    main(*sys.argv[1:3])
