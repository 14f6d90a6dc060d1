"""The MoE split over the ``model`` axis, on the CPU, no jax: gloo worlds
from ``run_local_world``, each rank holding its slice of reduced
granite-moe-1b-a400m's weights (``tensor_parallel.shard_parameters`` under
the trainer's rules), running the forward pass and the train loss's
gradients on the same tokens; held to the whole model's in this process.

The layouts (``mlp.moe_split``), as the rules place them:
- EP: 4 experts over 2 or 4 ranks (2 or 1 a rank), the router split over
  the experts and gathered whole for the routing;
- FF: ``num_experts`` 5, which 2 does not divide: every expert whole on
  each rank with 32 of its 64 ``d_ff`` columns, the router whole.  Before
  the MoE read its layout from its weights' shapes, each rank returned its
  columns' partial output unsummed: the logits differed from the whole
  model's, with no error.

The 128 tokens of a step form one group of 128, above the dropless 64, so
the capacity binds (80 slots an expert under EP, 64 under FF) and tokens
are dropped, as at training sizes.

Tolerances, set before the runs: the logits (gathered over the
vocabulary) within ``LOGITS_TOL`` 1e-5 of the whole model's and the aux
loss within 1e-6 (float32; a split product sums its parts in another
order); each parameter's gradient (gathered whole) within ``GRAD_RTOL``
1e-5 of the whole model's, relative to that leaf's largest element: a
gradient summed once too few or too many times over the ranks is off by
a factor of 2 or more.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import mesh_context, named_sharding
from repro_torch.launch.mesh import make_local_mesh, run_local_world
from repro_torch.models import mlp
from repro_torch.models.registry import build_model
from repro_torch.train.train_step import make_loss_fn

WORLD_TIMEOUT_S = 300
LOGITS_TOL = 1e-5
AUX_TOL = 1e-6
GRAD_RTOL = 1e-5
SEED = 0
MOE = "granite-moe-1b-a400m"
BATCH, SEQ = 2, 64
# name -> (model ranks, config overrides, the layout the rules give)
CASES = {
    "ep_1x2": (2, {}, "EP"),
    "ff_1x2": (2, {"num_experts": 5}, "FF"),
    "ep_1x4": (4, {}, "EP"),
    "ff_1x4": (4, {"num_experts": 5}, "FF"),
}


def _model(overrides: dict):
    cfg = dataclasses.replace(get_reduced_config(MOE), **overrides)
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(SEED))
    return cfg, model


def _tokens(cfg) -> torch.Tensor:
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, SEQ)))


def _run(model, cfg, tokens):
    """(logits, aux, each parameter's gradient of the train loss)."""
    with torch.no_grad():
        logits, aux = model(tokens)
    total, _ = make_loss_fn(model, cfg)({"tokens": tokens})
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(total, list(params.values()))
    return logits, aux, dict(zip(params, grads))


def rank_moe(cases: dict) -> dict:
    """Every case of one world in this rank: the logits and gradients
    gathered whole, the aux loss, and each MoE layer's layout."""
    torch.set_num_threads(1)
    out = {}
    for name, (m, overrides, _) in cases.items():
        cfg, model = _model(overrides)
        mesh = make_local_mesh(1, m, device="cpu")
        layout = tp.parameter_layout(model, mesh)
        tp.shard_parameters(model, layout, mesh)
        with mesh_context(mesh):
            logits, aux, grads = _run(model, cfg, _tokens(cfg))
            split = mlp.moe_split(model.layers[0].mlp, cfg)
        cols = named_sharding(tuple(logits.shape), ("batch", None, "vocab"),
                              mesh)
        out[name] = {
            "logits": tp.whole_of(logits, mesh, cols), "aux": float(aux),
            "grads": {n: tp.whole_of(g, mesh, layout[n])
                      for n, g in grads.items()},
            "split": (split.first, split.count, split.router is not None),
            "wi_gate": tuple(model.layers[0].mlp["wi_gate"].shape)}
    return out


@pytest.fixture(scope="module")
def worlds():
    torch.set_num_threads(2)
    return {m: run_local_world(
        rank_moe, m, {n: c for n, c in CASES.items() if c[0] == m},
        timeout=WORLD_TIMEOUT_S) for m in (2, 4)}


@pytest.fixture(scope="module")
def whole():
    torch.set_num_threads(2)
    out = {}
    for name, (_, overrides, _) in CASES.items():
        cfg, model = _model(overrides)
        out[name] = _run(model, cfg, _tokens(cfg))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_split_moe_forward_matches_the_whole_model(name, worlds, whole):
    want_logits, want_aux, _ = whole[name]
    for rank in worlds[CASES[name][0]]:
        got = rank[name]
        assert got["logits"].shape == want_logits.shape
        err = (got["logits"] - want_logits).abs().max().item()
        assert err <= LOGITS_TOL, (name, err)
        assert abs(got["aux"] - float(want_aux)) <= AUX_TOL, name


@pytest.mark.parametrize("name", list(CASES))
def test_split_moe_gradients_match_the_whole_model(name, worlds, whole):
    want = whole[name][2]
    for rank in worlds[CASES[name][0]]:
        got = rank[name]["grads"]
        assert set(got) == set(want)
        for n, w in want.items():
            assert got[n].shape == w.shape, n
            scale = w.abs().max().item()
            err = (got[n] - w).abs().max().item()
            assert err <= GRAD_RTOL * scale, (name, n, err, scale)


@pytest.mark.parametrize("name", list(CASES))
def test_split_moe_layout_is_the_rules(name, worlds):
    """EP: rank r holds experts [r·E/M, (r+1)·E/M) and the router's
    columns; FF: every expert, its d_ff / M columns, the router whole."""
    m, overrides, kind = CASES[name]
    cfg = get_reduced_config(MOE)
    e = overrides.get("num_experts", cfg.num_experts)
    for r, rank in enumerate(worlds[m]):
        if kind == "EP":
            assert rank[name]["split"] == (r * e // m, e // m, True)
            assert rank[name]["wi_gate"] == (e // m, cfg.d_model, cfg.d_ff)
        else:
            assert rank[name]["split"] == (0, e, False)
            assert rank[name]["wi_gate"] == (e, cfg.d_model, cfg.d_ff // m)


@pytest.mark.parametrize("leaf,dim", [("wi_gate", 0), ("wi_gate", 2),
                                      ("router", 1)])
def test_a_split_moe_weight_outside_its_mesh_raises(leaf, dim):
    """Half the experts, half of d_ff or half the router's columns with no
    mesh: the layer cannot sum the other half, so it raises rather than
    return a rank's partial output."""
    cfg, model = _model({})
    p = {k: v.detach() for k, v in model.layers[0].mlp.items()}
    if leaf == "wi_gate":
        p = {k: (v.narrow(2 if k != "wo" else 1, 0, cfg.d_ff // 2)
                 if dim == 2 else v.narrow(0, 0, cfg.num_experts // 2))
             if k != "router" else v for k, v in p.items()}
    else:
        p["router"] = p["router"].narrow(1, 0, cfg.num_experts // 2)
    x = torch.zeros(1, 4, cfg.d_model)
    with pytest.raises(ValueError, match="model axis"):
        mlp.moe(p, x, cfg)
