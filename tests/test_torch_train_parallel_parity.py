"""The port's parallel trainer against the JAX package's, on the CPU.

The reference's ``repro.launch.train`` runs reduced tinyllama-1.1b,
recurrentgemma-2b, granite-moe-1b-a400m, rwkv6-7b, whisper-tiny and
qwen2-vl-2b at ``--data-par 2 --model-par 2`` (batch 4, seq 32, 3 steps;
granite seq 256, so that a data rank holds a whole 512-token routing
group, and its 4 experts split 2 a rank; rwkv6's 4 WKV heads 2 a rank;
whisper's 4 heads, its cross-attention's too, 2 a rank, each step's
frames seeded by the step; qwen2-vl's 4 heads and 2 KV heads 2 and 1 a
rank) in a subprocess on 4 fake host devices, its step's losses
recorded.  Both trainers feed qwen2-vl tokens alone.  The reference's
forward then rotates by its default positions (1, S), which its M-RoPE
cannot take (``apply_rope`` raises on the (S, hd/2) angles), so here its
step is given the text-only positions (3, B, S), every component the
token index, made inside the jitted step: what the port's forward takes
when it is given none (``transformer.LM.forward``).
The port starts from the same weights (the reference's init, carried
across with ``convert.from_jax_params`` into a step-0 checkpoint that the
run resumes) and trains the same command in a 4-rank gloo world: each
step's loss within ``LOSS_RTOL`` 1e-5, relative (set before the runs; the
one-device parity bar of ``tests/test_torch_train.py``)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from repro.models.registry import build_model as jbuild_model  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.launch.mesh import run_local_world  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.train.optim import OptConfig, init_opt_state  # noqa: E402
from torch_train_cases import STEPS, argv_of, rank_jobs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 300
LOSS_RTOL = 1e-5
# arch -> the sequence length of its run
SEQ = {"tinyllama-1.1b": 32, "recurrentgemma-2b": 32,
       "granite-moe-1b-a400m": 256, "rwkv6-7b": 32, "whisper-tiny": 32,
       "qwen2-vl-2b": 32}
ARCHS = tuple(SEQ)

# the reference's trainer on 4 fake host devices; jax.jit is wrapped so
# that each step's loss is recorded as the step returns it, and an M-RoPE
# config's step takes the text-only positions (3, B, S)
_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
import repro.launch.train as T
losses, real_jit, real_step = [], jax.jit, T.make_train_step


def make_train_step(model, cfg, *a, **k):
    step = real_step(model, cfg, *a, **k)
    if cfg.mrope_sections is None:
        return step

    def with_positions(params, opt_state, batch):
        b, s = batch["tokens"].shape
        pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (3, b, s))
        return step(params, opt_state, {**batch, "positions": pos})
    return with_positions


T.make_train_step = make_train_step

def jit(f, *a, **k):
    g = real_jit(f, *a, **k)
    def call(*args):
        out = g(*args)
        if isinstance(out, tuple) and len(out) == 3 and "loss" in out[2]:
            losses.append(float(out[2]["loss"]))
        return out
    return call

jax.jit = jit
out = {}
for arch, seq in json.loads(sys.argv[2]).items():
    losses.clear()
    assert T.main(["--arch", arch, "--reduced", "--steps", "%d", "--batch",
                   "4", "--seq", str(seq), "--data-par", "2", "--model-par",
                   "2", "--log-every", "100"]) == 0
    out[arch] = list(losses)
json.dump(out, open(sys.argv[1], "w"))
""" % STEPS


def _leaves_np(tree):
    return jax.tree.map(np.asarray, tree)


def step0_checkpoint(arch: str, ckpt: str) -> None:
    """The reference's initial weights (seed 0) in the port's checkpoint
    format at step 0, with zero moments, for the port's run to resume."""
    jp = jbuild_model(jget_reduced(arch)).init(jax.random.PRNGKey(0))
    cfg = get_reduced_config(arch)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_jax_params(cfg, _leaves_np(jp)))
    params = dict(model.named_parameters())
    opt = init_opt_state(params, OptConfig(total_steps=STEPS))
    CheckpointManager(ckpt).save(0, {"params": params, "opt": opt},
                                 extra={"data": {"step": 0},
                                        "train_step": 0})


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "losses.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    subprocess.run([sys.executable, "-c", _REFERENCE, str(out),
                    json.dumps(SEQ)],
                   env=env, check=True, capture_output=True, timeout=600)
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port")
    jobs = []
    for arch in ARCHS:
        ck = str(tmp / arch)
        step0_checkpoint(arch, ck)
        jobs.append((arch, argv_of(arch, 2, 2, ("--resume", "--seq",
                                                str(SEQ[arch])), ck)))
    return run_local_world(rank_jobs, 4, jobs, timeout=WORLD_TIMEOUT_S)


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2_losses_match_the_reference_mesh_run(arch, reference, port):
    want = reference[arch]
    assert len(want) == STEPS
    for r in port:
        got = r[arch]
        assert got.get("rc") == 0, got
        assert len(got["losses"]) == STEPS
        rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want))
        assert rel <= LOSS_RTOL, (got["losses"], want)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_port_holds_its_shards_at_2x2(arch, port):
    """Every split leaf at half its size on each rank (model = 2)."""
    cfg = get_reduced_config(arch)
    specs = build_model(cfg, device="meta").specs()
    for r in port:
        shapes = r[arch]["shapes"]
        halves = [n for n, s in specs.items() if shapes[n] != s.shape]
        assert halves
        for n in halves:
            assert np.prod(shapes[n]) * 2 == np.prod(specs[n].shape), n
        assert shapes["embed"][0] * 2 == cfg.vocab_size
