"""Parity of the PyTorch port's training (slice 13: ``train/``, ``data/``,
``checkpoint/``, ``distributed/collectives``, ``launch/train``, the
backward of K5 and K6) with the JAX package, on CPU.

The same seeded numpy inputs and the reference's weights (carried across
with ``repro_torch.models.convert.from_jax_params``) go through ``repro``
and ``repro_torch``.  Tolerances:
- ``LOSS_RTOL`` 1e-5: loss and aux loss, relative (f32 forward in another
  summation order; the reduced configs run f32 activations);
- ``GRAD_RTOL`` 1e-4: each gradient leaf, ||g - g_ref|| / ||g_ref||
  (absolute below a norm of 1e-6);
- updated parameters within ``2 x`` the steps' summed learning rate: an
  Adam step moves each element by up to about lr whatever the size of its
  gradient, so a last-bit difference in a gradient near 0 can move it by
  that much;
- ``EXACT`` 1e-6 where the arithmetic is the same f32 formula (schedule,
  compression, the decay rule's update, the vector-Jacobian products in f32
  against autograd); data batches and checkpoints bit for bit.
"""
import dataclasses
import functools
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import ShapeSpec as JShapeSpec  # noqa: E402
from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from repro.configs import list_archs as jlist_archs  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.distributed.collectives import \
    compress_decompress as jcompress_decompress  # noqa: E402
from repro.distributed.collectives import init_ef as jinit_ef  # noqa: E402
from repro.kernels.swa.ref import swa_ref as jswa_ref  # noqa: E402
from repro.models.registry import build_model as jbuild_model  # noqa: E402
from repro.models.registry import input_arrays as jinput_arrays  # noqa: E402
from repro.models.transformer import xent_loss as jxent_loss  # noqa: E402
from repro.train.optim import OptConfig as JOptConfig  # noqa: E402
from repro.train.optim import apply_updates as japply_updates  # noqa: E402
from repro.train.optim import init_opt_state as jinit_opt_state  # noqa: E402
from repro.train.optim import schedule as jschedule  # noqa: E402
from repro.train.train_step import make_loss_fn as jmake_loss_fn  # noqa: E402
from repro.train.train_step import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import ShapeSpec, get_reduced_config  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, Prefetcher,  # noqa: E402
                                       SyntheticLM)
from repro_torch.distributed.collectives import (compress_decompress,  # noqa: E402
                                                 init_ef)
from repro_torch.kernels import causal_conv1d, sliding_window_attention  # noqa: E402
from repro_torch.kernels.conv1d.ref import conv1d_bwd_ref, conv1d_ref  # noqa: E402
from repro_torch.kernels.swa.ref import swa_bwd_ref  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.registry import build_model, input_arrays  # noqa: E402
from repro_torch.models.transformer import REMAT, xent_loss  # noqa: E402
from repro_torch.train.optim import (OptConfig, apply_updates,  # noqa: E402
                                     global_norm, init_opt_state, schedule)
from repro_torch.train.train_step import (AUX_WEIGHT, decay_mask,  # noqa: E402
                                          make_eval_step, make_loss_fn,
                                          make_train_step, reference_leaves,
                                          split_microbatches)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
EXACT = 1e-6
SHAPE = ("smoke", 32, 2, "train")       # tests/test_models.py's SMOKE
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)   # ... and its OptConfig
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _leaves_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _rel(got, want) -> float:
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    norm = np.linalg.norm(w)
    diff = np.linalg.norm(g - w)
    return diff / norm if norm > 1e-6 else diff


def _inputs(cfg, jcfg, seed):
    jin = jinput_arrays(jcfg, JShapeSpec(*SHAPE), seed=seed)
    tin = input_arrays(cfg, ShapeSpec(*SHAPE), seed=seed, device="cpu")
    return jin, tin


def _built(arch, **overrides):
    jcfg = dataclasses.replace(jget_reduced(arch), **overrides)
    cfg = dataclasses.replace(get_reduced_config(arch), **overrides)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(from_jax_params(cfg, _leaves_np(jp)))
    return jcfg, cfg, jm, jp, tm


@functools.cache
def _two_steps(arch):
    """Two train steps in each package from the same weights on the same
    two batches, and each step's gradients taken on their own at the same
    weights: the reference's before the step (a second port model carries
    them across, so step 2's gradients are compared at one point, not at
    two weights one Adam step apart)."""
    jcfg, cfg, jm, jp, tm = _built(arch)
    jopt_cfg, opt_cfg = JOptConfig(**OPT), OptConfig(**OPT)
    jstep = jax.jit(jmake_train_step(jm, jcfg, jopt_cfg, remat="none"))
    jgrad = jax.jit(jax.value_and_grad(jmake_loss_fn(jm, jcfg), has_aux=True))
    tstep = make_train_step(tm, cfg, opt_cfg)          # remat "dots"
    tg = build_model(cfg, device="cpu")
    tloss = make_loss_fn(tg, cfg)
    params = dict(tm.named_parameters())
    jopt, topt = jinit_opt_state(jp, jopt_cfg), init_opt_state(params,
                                                                 opt_cfg)
    out = []
    for seed in (1, 2):
        jin, tin = _inputs(cfg, jcfg, seed)
        _, jgr = jgrad(jp, jin)
        tg.load_state_dict(from_jax_params(cfg, _leaves_np(jp)))
        total, _ = tloss(tin)
        tgr = torch.autograd.grad(total, list(tg.parameters()),
                                  allow_unused=True)
        jp, jopt, jmet = jstep(jp, jopt, jin)
        topt, tmet = tstep(topt, tin)
        out.append(dict(
            jgrads=from_jax_params(cfg, _leaves_np(jgr)),
            tgrads={n: torch.zeros_like(p) if g is None else g.detach()
                    for (n, p), g in zip(tg.named_parameters(), tgr)},
            jparams=from_jax_params(cfg, _leaves_np(jp)),
            tparams={n: p.detach().clone() for n, p in params.items()},
            jloss=float(jmet["loss"]), tloss=float(tmet["loss"]),
            jaux=float(jmet["aux_loss"]), taux=float(tmet["aux_loss"]),
            jstep=int(jmet["step"]), tstep=int(tmet["step"])))
    lrs = [float(jschedule(jnp.asarray(s), jopt_cfg)) for s in (0, 1)]
    return out, lrs


# --------------------------------------------------------------------------
# one and two make_train_step calls per reduced config
@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("arch", jlist_archs())
def test_train_steps_match_reference(arch, steps):
    """Loss, aux, every gradient leaf and every updated parameter after
    ``steps`` calls of make_train_step (the port's with remat "dots", the
    reference's jitted without remat)."""
    out, lrs = _two_steps(arch)
    for i in range(steps):
        r = out[i]
        assert r["tstep"] == r["jstep"] == i + 1
        assert abs(r["tloss"] - r["jloss"]) <= LOSS_RTOL * abs(r["jloss"])
        assert abs(r["taux"] - r["jaux"]) <= LOSS_RTOL * max(abs(r["jaux"]),
                                                             1e-3)
        assert set(r["tgrads"]) == set(r["jgrads"])
        bad = {n: _rel(r["tgrads"][n], w) for n, w in r["jgrads"].items()
               if _rel(r["tgrads"][n], w) > GRAD_RTOL}
        assert not bad, f"step {i + 1}: gradients off {bad}"
        bound = 2 * sum(lrs[:i + 1])
        worst = max(np.abs(_np(r["tparams"][n]) - _np(w)).max()
                    for n, w in r["jparams"].items())
        assert worst <= bound, (worst, bound)


def test_train_step_moves_every_config_like_the_reference():
    """The step changes the parameters (tests/test_models.py's check) and
    the two packages' losses fall or rise together over the two steps."""
    for arch in ("tinyllama-1.1b", "recurrentgemma-2b"):
        out, _ = _two_steps(arch)
        assert any(not torch.equal(out[0]["tparams"][n], out[1]["tparams"][n])
                   for n in out[0]["tparams"])
        assert np.sign(out[1]["tloss"] - out[0]["tloss"]) == np.sign(
            out[1]["jloss"] - out[0]["jloss"])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-vl-2b",
                                  "granite-moe-1b-a400m"])
def test_microbatches_match_reference(arch):
    """microbatches=2: loss, aux and updated parameters against the
    reference's scan over microbatches (qwen2-vl splits its M-RoPE
    positions (3, B, S) on axis 1)."""
    jcfg, cfg, jm, jp, tm = _built(arch)
    jopt_cfg, opt_cfg = JOptConfig(**OPT), OptConfig(**OPT)
    jin, tin = _inputs(cfg, jcfg, 1)
    jp2, _, jmet = jax.jit(jmake_train_step(
        jm, jcfg, jopt_cfg, remat="none", microbatches=2))(
        jp, jinit_opt_state(jp, jopt_cfg), jin)
    params = dict(tm.named_parameters())
    _, tmet = make_train_step(tm, cfg, opt_cfg, microbatches=2)(
        init_opt_state(params, opt_cfg), tin)
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= \
        LOSS_RTOL * abs(float(jmet["loss"]))
    assert abs(float(tmet["aux_loss"]) - float(jmet["aux_loss"])) <= \
        LOSS_RTOL * max(abs(float(jmet["aux_loss"])), 1e-3)
    bound = 2 * float(jschedule(jnp.asarray(0), jopt_cfg))
    for n, w in from_jax_params(cfg, _leaves_np(jp2)).items():
        assert np.abs(_np(params[n]) - _np(w)).max() <= bound, n


def test_split_microbatches_splits_positions_on_axis_one():
    batch = {"tokens": torch.arange(24).reshape(4, 6),
             "positions": torch.arange(72).reshape(3, 4, 6)}
    parts = split_microbatches(batch, 2)
    assert [p["tokens"].shape for p in parts] == [(2, 6), (2, 6)]
    assert [p["positions"].shape for p in parts] == [(3, 2, 6), (3, 2, 6)]
    assert torch.equal(parts[1]["positions"], batch["positions"][:, 2:])
    assert torch.equal(parts[1]["tokens"], batch["tokens"][2:])


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-tiny",
                                  "granite-moe-1b-a400m", "rwkv6-7b"])
def test_gradients_do_not_depend_on_remat(arch):
    """remat "none", "full" and "dots" give the same gradients, bit for bit
    (the recomputation repeats the same CPU arithmetic)."""
    cfg = get_reduced_config(arch)
    tm = build_model(cfg, device="cpu")
    tm.init(torch.Generator().manual_seed(0))
    tin = input_arrays(cfg, ShapeSpec(*SHAPE), seed=1, device="cpu")
    params = list(tm.parameters())
    grads = {}
    for remat in REMAT:
        total, _ = make_loss_fn(tm, cfg, remat)(tin)
        grads[remat] = torch.autograd.grad(total, params, allow_unused=True)
    for remat in ("full", "dots"):
        for a, b in zip(grads["none"], grads[remat]):
            assert (a is None and b is None) or torch.equal(a, b), remat
    with pytest.raises(ValueError, match="remat"):
        make_loss_fn(tm, cfg, "some")(tin)


def test_remat_dots_keeps_the_matrix_products():
    """Under "dots" the backward runs as many matrix products as without
    remat (the products without batch dimensions are kept, not
    recomputed); under "full" it recomputes them."""
    from torch.utils._python_dispatch import TorchDispatchMode
    cfg = get_reduced_config("tinyllama-1.1b")
    tm = build_model(cfg, device="cpu")
    tm.init(torch.Generator().manual_seed(0))
    tin = input_arrays(cfg, ShapeSpec(*SHAPE), seed=1, device="cpu")

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
                self.mm += 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for remat in REMAT:
        total, _ = make_loss_fn(tm, cfg, remat)(tin)
        with Count() as c:
            torch.autograd.grad(total, list(tm.parameters()))
        counts[remat] = c.mm
    assert counts["none"] == counts["dots"] < counts["full"]


# --------------------------------------------------------------------------
# optimizer
def test_decay_follows_the_reference_rank():
    """RecurrentGemma at num_layers=5: one stacked period (layers 0-2) and a
    2-layer tail (3-4).  The reference decays its rank >= 2 leaves, so a
    stacked layer's norm scales, biases and conv_b are decayed and the
    tail's and final_norm are not; the mask agrees leaf for leaf, and one
    update with zero gradients (decay alone moves the weights) agrees with
    the reference's."""
    jcfg, cfg, jm, jp, tm = _built("recurrentgemma-2b", num_layers=5)
    assert (tm.n_full, tm.n_tail) == (1, 2)
    ranks = from_jax_params(cfg, jax.tree.map(
        lambda p: np.full(p.shape, p.ndim >= 2, np.float32), jp))
    mask = decay_mask(tm)
    assert mask == {n: bool(t.all()) for n, t in ranks.items()}
    # and the reference's leaves: each port group is one JAX leaf's rows
    ids = jax.tree.map(lambda p: np.zeros(p.shape, np.float32), jp)
    ids = jax.tree.unflatten(jax.tree.structure(ids), [
        np.full(a.shape, i, np.float32)
        for i, a in enumerate(jax.tree.leaves(ids))])
    leaf_of = {n: float(t.flatten()[0])
               for n, t in from_jax_params(cfg, ids).items()}
    groups = reference_leaves(tm)
    assert len(groups) == len(jax.tree.leaves(jp))
    for names in groups:
        assert len({leaf_of[n] for n in names}) == 1
    assert sorted(len(g) for g in groups)[-1] == tm.n_full
    assert mask["layers.0.ln1"] and mask["layers.2.rec.conv_b"] \
        if cfg.kind_of_layer(2) == "rglru" else mask["layers.0.rec.conv_b"]
    assert not mask["layers.3.ln1"] and not mask["layers.4.rec.conv_b"]
    assert not mask["final_norm"] and mask["embed"]
    jopt_cfg = JOptConfig(lr=0.5, warmup_steps=0, total_steps=10)
    opt_cfg = OptConfig(lr=0.5, warmup_steps=0, total_steps=10)
    jp2, _ = jax.jit(functools.partial(japply_updates, cfg=jopt_cfg))(
        jp, jax.tree.map(jnp.zeros_like, jp), jinit_opt_state(jp, jopt_cfg))
    params = dict(tm.named_parameters())
    apply_updates(params, {n: torch.zeros_like(p) for n, p in params.items()},
                  init_opt_state(params, opt_cfg), opt_cfg, mask)
    for n, w in from_jax_params(cfg, _leaves_np(jp2)).items():
        np.testing.assert_allclose(_np(params[n]), _np(w), atol=EXACT,
                                   rtol=EXACT, err_msg=n)


def test_encdec_stacks_every_layer():
    cfg = get_reduced_config("whisper-tiny")
    tm = build_model(cfg, device="cpu")
    mask = decay_mask(tm)
    assert mask["enc.0.ln1"] and mask["dec.0.ln2"]
    assert not mask["enc_norm"] and not mask["final_norm"]


def test_schedule_matches_reference():
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100),
               dict(lr=3e-4, warmup_steps=0, total_steps=1),
               dict(lr=1e-3, warmup_steps=2, total_steps=10)):
        jc, tc = JOptConfig(**kw), OptConfig(**kw)
        for s in range(0, 130, 3):
            got = schedule(torch.tensor(s, dtype=torch.int32), tc)
            want = jschedule(jnp.asarray(s, jnp.int32), jc)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=EXACT,
                                       atol=0)


def test_apply_updates_matches_reference_with_clipping():
    """Random params and grads, three steps: the clip scale (a large
    gradient), bias corrections and decay as the reference computes them."""
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}
    kw = dict(lr=0.1, warmup_steps=1, total_steps=5, clip_norm=1.0)
    jc, tc = JOptConfig(**kw), OptConfig(**kw)
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    js, ts = jinit_opt_state(jp, jc), init_opt_state(tp, tc)
    for i in range(3):
        g = {k: (rng.normal(size=v.shape) * 10).astype(np.float32)
             for k, v in tree.items()}
        jp, js = japply_updates(jp, {k: jnp.asarray(v) for k, v in g.items()},
                                js, jc)
        ts = apply_updates(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tc)
        np.testing.assert_allclose(float(global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()})),
            float(jnp.sqrt(sum(jnp.sum(jnp.square(jnp.asarray(v)))
                               for v in g.values()))), rtol=EXACT)
        for k in tree:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=EXACT, rtol=EXACT)
            np.testing.assert_allclose(ts.m[k].numpy(), np.asarray(js.m[k]),
                                       atol=EXACT, rtol=EXACT)
    assert int(ts.step) == int(js.step) == 3


@pytest.mark.parametrize("method,frac", [("int8", 0.01), ("topk", 0.2),
                                         ("topk", 0.01)])
def test_compression_matches_reference(method, frac):
    """Three rounds of compress_decompress with error feedback on the same
    gradients: effective gradients and the carried error."""
    rng = np.random.default_rng(1)
    shapes = {"a": (40, 7), "b": (13,)}
    jef = jinit_ef({k: jnp.zeros(s) for k, s in shapes.items()})
    tef = init_ef({k: torch.zeros(s) for k, s in shapes.items()})
    for _ in range(3):
        g = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
        jeff, jef = jcompress_decompress({k: jnp.asarray(v)
                                          for k, v in g.items()}, jef,
                                         method=method, topk_frac=frac)
        teff, tef = compress_decompress({k: torch.from_numpy(v)
                                         for k, v in g.items()}, tef,
                                        method=method, topk_frac=frac)
        for k in shapes:
            np.testing.assert_allclose(teff[k].numpy(), np.asarray(jeff[k]),
                                       atol=EXACT, rtol=0)
            np.testing.assert_allclose(tef[k].error.numpy(),
                                       np.asarray(jef[k].error), atol=EXACT,
                                       rtol=0)
    none, same = compress_decompress({"a": torch.ones(2)}, tef, method="none")
    assert same is tef and torch.equal(none["a"], torch.ones(2))


def test_compressed_train_step_matches_reference():
    """The optimizer's --compression path inside one train step, each
    stacked leaf of the reference compressed as one (one int8 scale over
    its layers): the loss, the updated parameters, and the carried error
    within one int8 quantum (2 max |error| / 127 here) of the reference's:
    a gradient element within rounding of a quantization midpoint may round
    the other way."""
    jcfg, cfg, jm, jp, tm = _built("tinyllama-1.1b")
    kw = dict(OPT, compression="int8")
    jopt_cfg, opt_cfg = JOptConfig(**kw), OptConfig(**kw)
    params = dict(tm.named_parameters())
    jin, tin = _inputs(cfg, jcfg, 1)
    jp, jopt, jmet = jax.jit(jmake_train_step(jm, jcfg, jopt_cfg,
                                              remat="none"))(
        jp, jinit_opt_state(jp, jopt_cfg), jin)
    topt, tmet = make_train_step(tm, cfg, opt_cfg)(
        init_opt_state(params, opt_cfg), tin)
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= \
        LOSS_RTOL * abs(float(jmet["loss"]))
    bound = 2 * float(jschedule(jnp.asarray(0), jopt_cfg))
    for n, w in from_jax_params(cfg, _leaves_np(jp)).items():
        assert np.abs(_np(params[n]) - _np(w)).max() <= bound, n
    jerr = from_jax_params(cfg, _leaves_np(jax.tree.map(
        lambda e: e.error, jopt.ef,
        is_leaf=lambda x: type(x).__name__ == "EFState")))
    for names in reference_leaves(tm):
        # |error| <= scale / 2 in a leaf, so 2 max |error| <= one quantum
        quantum = 2 * max(np.abs(_np(jerr[n])).max() for n in names)
        for n in names:
            diff = np.abs(_np(topt.ef[n].error) - _np(jerr[n]))
            assert diff.max() <= quantum * (1 + 1e-6), n
            assert (diff > 1e-3 * quantum).mean() < 1e-3, n


def test_xent_loss_matches_reference():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(2, 9, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, size=(2, 9))
    for z in (1e-4, 0.0):
        got = xent_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                        z_loss=z)
        want = jxent_loss(jnp.asarray(logits), jnp.asarray(labels), z_loss=z)
        np.testing.assert_allclose(float(got), float(want), rtol=EXACT)


def test_eval_step_matches_loss_fn():
    cfg = get_reduced_config("granite-moe-1b-a400m")
    tm = build_model(cfg, device="cpu")
    tm.init(torch.Generator().manual_seed(0))
    tin = input_arrays(cfg, ShapeSpec(*SHAPE), seed=1, device="cpu")
    out = make_eval_step(tm, cfg)(tin)
    total, (loss, aux) = make_loss_fn(tm, cfg)(tin)
    assert float(out["loss"]) == float(loss.detach())
    assert float(aux.detach()) > 0
    assert float(total.detach()) == pytest.approx(float(loss.detach())
                                         + AUX_WEIGHT * float(aux.detach()))


# --------------------------------------------------------------------------
# data and checkpoints
@pytest.mark.parametrize("pattern", ["uniform", "markov"])
def test_synthetic_batches_match_reference_bit_for_bit(pattern):
    kw = dict(vocab_size=997, seq_len=33, global_batch=4, seed=5,
              pattern=pattern)
    for host in (dict(), dict(host_index=1, host_count=2)):
        a, b = SyntheticLM(DataConfig(**kw, **host)), \
            JSyntheticLM(JDataConfig(**kw, **host))
        a.seek(7)
        b.seek(7)
        for _ in range(3):
            x, y = a.next_batch(), b.next_batch()
            assert x.keys() == y.keys()
            for k in x:
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])
        assert a.state() == b.state()


def _mixed_tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16),
                  "i": torch.tensor([7, -1], dtype=torch.int32),
                  "n": torch.tensor(3, dtype=torch.int32)}}


def _jax_tree(t):
    return {"a": jnp.asarray(t["a"].numpy()),
            "b": {"c": jnp.asarray(t["b"]["c"].float().numpy(), jnp.bfloat16),
                  "i": jnp.asarray(t["b"]["i"].numpy()),
                  "n": jnp.asarray(t["b"]["n"].numpy())}}


def test_checkpoints_cross_between_packages(tmp_path):
    """A nested dict with bf16 and int leaves, written by either manager
    and restored by the other, bit for bit, with the manifest's extra."""
    tree = _mixed_tree()
    CheckpointManager(str(tmp_path / "t")).save(4, tree, extra={"k": 1})
    got, extra = JCheckpointManager(str(tmp_path / "t")).restore(
        4, _jax_tree(tree))
    assert extra == {"k": 1}
    assert got["b"]["c"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["b"]["c"], np.float32),
                                  tree["b"]["c"].float().numpy())
    np.testing.assert_array_equal(np.asarray(got["b"]["i"]), [7, -1])
    assert int(got["b"]["n"]) == 3
    JCheckpointManager(str(tmp_path / "j")).save(2, _jax_tree(tree),
                                                 extra={"k": 2})
    like = {"a": torch.zeros(2, 3), "b": {
        "c": torch.zeros(3, dtype=torch.bfloat16),
        "i": torch.zeros(2, dtype=torch.int32),
        "n": torch.zeros((), dtype=torch.int32)}}
    back, extra = CheckpointManager(str(tmp_path / "j")).restore(2, like)
    assert extra == {"k": 2}
    for path in (("a",), ("b", "c"), ("b", "i"), ("b", "n")):
        g, w = back, tree
        for k in path:
            g, w = g[k], w[k]
        assert g.dtype == w.dtype and torch.equal(g, w)
    # the same files: manifests name the same paths
    import json
    names = [json.load(open(tmp_path / d / f"step_{s:08d}" / "manifest.json"))
             for d, s in (("t", 4), ("j", 2))]
    assert [a["name"] for a in names[0]["arrays"]] == \
        [a["name"] for a in names[1]["arrays"]]
    assert [a["dtype"] for a in names[0]["arrays"]] == \
        [a["dtype"] for a in names[1]["arrays"]]


def test_checkpoint_restores_named_tuples_and_none():
    from repro_torch.train.optim import AdamWState
    with tempfile.TemporaryDirectory() as d:
        st = AdamWState(torch.tensor(3, dtype=torch.int32),
                        {"w": torch.ones(2)}, {"w": torch.full((2,), 2.0)},
                        None)
        mgr = CheckpointManager(d)
        mgr.save(1, {"opt": st})
        like = {"opt": AdamWState(torch.zeros((), dtype=torch.int32),
                                  {"w": torch.zeros(2)},
                                  {"w": torch.zeros(2)}, None)}
        got, _ = mgr.restore(1, like)
        assert isinstance(got["opt"], AdamWState) and got["opt"].ef is None
        assert int(got["opt"].step) == 3
        assert torch.equal(got["opt"].v["w"], torch.full((2,), 2.0))


def test_async_save_writes_the_tree_as_it_was_at_the_call(tmp_path,
                                                          monkeypatch):
    """save(blocking=False) on CPU tensors, then the tree updated in place
    before the writer thread writes (held back by an event): the restore
    gives the values as they were at the call, bf16 and int leaves too."""
    import threading
    tree = _mixed_tree()
    before = {"a": tree["a"].clone(),
              "b": {k: v.clone() for k, v in tree["b"].items()}}
    go = threading.Event()
    write = CheckpointManager._write

    def held_write(self, *args):
        go.wait(timeout=60)
        write(self, *args)

    monkeypatch.setattr(CheckpointManager, "_write", held_write)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree, blocking=False)
    with torch.no_grad():
        tree["a"].add_(1.0)
        tree["b"]["c"].mul_(2.0)
        tree["b"]["i"].add_(5)
        tree["b"]["n"].add_(1)
    go.set()
    mgr.wait()
    got, _ = mgr.restore(1, before)
    for path in (("a",), ("b", "c"), ("b", "i"), ("b", "n")):
        g, w = got, before
        for k in path:
            g, w = g[k], w[k]
        assert g.dtype == w.dtype and torch.equal(g, w), path


# --------------------------------------------------------------------------
# the backward of K5 and K6: plain versions
def test_conv1d_input_gradient_is_the_conv_on_the_flipped_gradient():
    """dx = flip(conv1d(flip(dy), w)): the identity the op's CUDA backward
    relies on, against autograd of conv1d_ref, for several K."""
    g = torch.Generator().manual_seed(0)
    for kk in (1, 2, 4, 7):
        x = torch.randn(2, 19, 5, generator=g)
        w = torch.randn(kk, 5, generator=g)
        dy = torch.randn(2, 19, 5, generator=g)
        dx, _, _ = conv1d_bwd_ref(x, w, None, dy)
        np.testing.assert_allclose(
            conv1d_ref(dy.flip(1), w).flip(1).numpy(), dx.numpy(),
            atol=EXACT, rtol=EXACT)


def test_conv1d_op_backward_on_cpu_is_the_plain_vjp():
    """The op's autograd Function on CPU tensors: bias or none, strided
    input, each input's need for a gradient."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 23, 12, generator=g)[..., ::2]        # strided
    w = torch.randn(4, 6, generator=g)
    b = torch.randn(6, generator=g)
    dy = torch.randn(2, 23, 6, generator=g)
    for bias in (b, None):
        leaves = [t.clone().requires_grad_() for t in (x, w)]
        if bias is not None:
            leaves.append(bias.clone().requires_grad_())
        got = torch.autograd.grad(causal_conv1d(*leaves), leaves, dy)
        want = conv1d_bwd_ref(x, w, bias, dy)
        for a, c in zip(got, want):
            assert torch.equal(a, c)
    xr = x.clone().requires_grad_()
    (dx,) = torch.autograd.grad(causal_conv1d(xr, w, b), [xr], dy)
    assert torch.equal(dx, conv1d_bwd_ref(x, w, b, dy)[0])


@pytest.mark.parametrize("dtype,tol", [("float32", EXACT), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("b,hq,hkv,s,d,w", [(1, 4, 2, 40, 16, 7),
                                            (2, 2, 1, 33, 32, 64),
                                            (1, 3, 3, 17, 8, 1)])
def test_swa_bwd_ref_matches_jax_vjp(b, hq, hkv, s, d, w, dtype, tol):
    """swa_bwd_ref (autograd of swa_ref) against jax.vjp of the reference's
    swa_ref, on the same inputs; bf16 norm-relative."""
    rng = np.random.default_rng(2)
    arrs = [rng.normal(size=sh).astype(np.float32)
            for sh in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d),
                       (b, hq, s, d))]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    t = [torch.from_numpy(a).to(tdt) for a in arrs]
    j = [jnp.asarray(a, jdt) for a in arrs]
    got = swa_bwd_ref(*t[:3], t[3], window=w)
    _, vjp = jax.vjp(lambda q, k, v: jswa_ref(q, k, v, window=w), *j[:3])
    for a, c in zip(got, vjp(j[3])):
        assert a.dtype == tdt
        assert _rel(a, c) <= tol


def test_swa_op_backward_on_cpu_is_the_plain_vjp():
    """The op's autograd Function on CPU tensors, on (B, S, H, D) views as
    the model passes them, with one input not needing a gradient."""
    g = torch.Generator().manual_seed(2)
    q, k, v, do = (torch.randn(2, 30, h, 16, generator=g).transpose(1, 2)
                   for h in (4, 2, 2, 4))
    leaves = [t.clone().requires_grad_() for t in (q, k)]
    got = torch.autograd.grad(sliding_window_attention(*leaves, v, window=9),
                              leaves, do)
    want = swa_bwd_ref(q, k, v, do, window=9)
    for a, c in zip(got, want):
        assert torch.equal(a, c)


# --------------------------------------------------------------------------
# tests/test_substrates.py on the port
def test_adamw_converges_quadratic():
    opt_cfg = OptConfig(lr=0.05, warmup_steps=5, total_steps=200,
                        weight_decay=0.0, clip_norm=0.0)
    target = torch.from_numpy(
        np.random.default_rng(0).normal(size=(8, 8)).astype(np.float32))
    params = {"w": torch.zeros((8, 8), requires_grad=True)}
    state = init_opt_state(params, opt_cfg)
    l0 = None
    for _ in range(200):
        loss = torch.mean((params["w"] - target) ** 2)
        (g,) = torch.autograd.grad(loss, [params["w"]])
        l0 = l0 or float(loss)
        state = apply_updates(params, {"w": g}, state, opt_cfg)
    assert float(loss) < 1e-3 * l0


def test_compressed_training_still_converges():
    opt_cfg = OptConfig(lr=0.05, warmup_steps=5, total_steps=300,
                        weight_decay=0.0, clip_norm=0.0, compression="int8")
    target = torch.from_numpy(
        np.random.default_rng(0).normal(size=(8, 8)).astype(np.float32))
    params = {"w": torch.zeros((8, 8), requires_grad=True)}
    state = init_opt_state(params, opt_cfg)
    for _ in range(300):
        loss = torch.mean((params["w"] - target) ** 2)
        (g,) = torch.autograd.grad(loss, [params["w"]])
        state = apply_updates(params, {"w": g}, state, opt_cfg)
    assert float(loss) < 1e-2


def test_error_feedback_invariant():
    ef = init_ef({"w": torch.zeros(16)})
    rng = np.random.default_rng(0)
    tot_g, tot_e = torch.zeros(16), torch.zeros(16)
    for _ in range(40):
        g = {"w": torch.from_numpy(rng.normal(size=16).astype(np.float32))}
        eff, ef = compress_decompress(g, ef, method="topk", topk_frac=0.2)
        tot_g, tot_e = tot_g + g["w"], tot_e + eff["w"]
    np.testing.assert_allclose((tot_g - tot_e).numpy(), ef["w"].error.numpy(),
                               atol=1e-4)


def test_schedule_shape():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    lrs = [float(schedule(torch.tensor(s), cfg)) for s in range(100)]
    assert lrs[0] < 0.2 and abs(max(lrs) - 1.0) < 0.01
    assert lrs[-1] < 0.2 and lrs[-1] >= 0.09


def test_data_determinism_and_seek():
    cfg = DataConfig(vocab_size=1000, seq_len=16, global_batch=4)
    a, b = SyntheticLM(cfg), SyntheticLM(cfg)
    for _ in range(3):
        a.next_batch()
    b.seek(3)
    np.testing.assert_array_equal(a.next_batch()["tokens"],
                                  b.next_batch()["tokens"])


def test_data_host_sharding_partitions_batch():
    full = SyntheticLM(DataConfig(vocab_size=97, seq_len=8, global_batch=4))
    h0 = SyntheticLM(DataConfig(vocab_size=97, seq_len=8, global_batch=4,
                                host_index=0, host_count=2))
    h1 = SyntheticLM(DataConfig(vocab_size=97, seq_len=8, global_batch=4,
                                host_index=1, host_count=2))
    f = full.next_batch()["tokens"]
    np.testing.assert_array_equal(f[:2], h0.next_batch()["tokens"])
    np.testing.assert_array_equal(f[2:], h1.next_batch()["tokens"])


def test_prefetcher_delivers_in_order():
    src = SyntheticLM(DataConfig(vocab_size=50, seq_len=4, global_batch=2))
    ref = SyntheticLM(DataConfig(vocab_size=50, seq_len=4, global_batch=2))
    pf = Prefetcher(src, depth=2)
    try:
        for _ in range(5):
            np.testing.assert_array_equal(pf.next_batch()["tokens"],
                                          ref.next_batch()["tokens"])
    finally:
        pf.close()
    assert not pf.t.is_alive()


def test_checkpoint_atomic_keepn_resume():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep_n=2)
        tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                "b": {"c": torch.ones((4,), dtype=torch.bfloat16)}}
        for step in (1, 2, 3):
            mgr.save(step, tree, extra={"step": step},
                     blocking=step != 2)
        mgr.wait()
        assert mgr.all_steps() == [2, 3]           # keep-N GC
        restored, extra = mgr.restore(3, tree)
        assert torch.equal(restored["a"], tree["a"])
        assert extra["step"] == 3
        assert not [f for f in os.listdir(d) if f.startswith(".tmp")]


def test_checkpoint_shape_mismatch_raises():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(1, {"a": torch.ones((2, 2))})
        with pytest.raises(ValueError):
            mgr.restore(1, {"a": torch.ones((3, 3))})


def test_train_driver_end_to_end_with_resume(tmp_path):
    """launch/train.py's fault-tolerance loop on the CPU: run 8 steps with a
    checkpoint every 3, drop the checkpoints after step 3, resume: the
    resumed run repeats steps 3-7's losses bit for bit (the same --steps,
    so the same schedule); then resume to a longer run, as
    tests/test_substrates.py does."""
    from repro_torch.launch.train import run as train_run
    ck = str(tmp_path / "ck")
    argv = ["--arch", "tinyllama-1.1b", "--reduced", "--steps", "8",
            "--batch", "2", "--seq", "32", "--ckpt-dir", ck,
            "--ckpt-every", "3", "--log-every", "100", "--device", "cpu"]
    rc, first = train_run(argv)
    assert rc == 0
    mgr = CheckpointManager(ck)
    assert mgr.all_steps() == [3, 6, 8]
    import shutil
    for s in (6, 8):
        shutil.rmtree(os.path.join(ck, f"step_{s:08d}"))
    rc, again = train_run(argv + ["--resume"])
    assert rc == 0
    assert len(first) == 8 and again == first[3:]
    rc, longer = train_run([a if a != "8" else "10" for a in argv]
                           + ["--resume"])
    assert rc == 0 and len(longer) == 2
    assert 10 in CheckpointManager(ck).all_steps()


def test_train_driver_runs_microbatches_remat_and_compression(tmp_path):
    from repro_torch.launch.train import run as train_run
    rc, losses = train_run(["--arch", "recurrentgemma-2b", "--reduced",
                            "--steps", "3", "--batch", "2", "--seq", "48",
                            "--microbatches", "2", "--remat", "full",
                            "--compression", "topk", "--device", "cpu",
                            "--log-every", "1"])
    assert rc == 0 and len(losses) == 3 and all(np.isfinite(losses))


def test_train_driver_audio_family(tmp_path):
    from repro_torch.launch.train import run as train_run
    rc, losses = train_run(["--arch", "whisper-tiny", "--reduced", "--steps",
                            "2", "--batch", "2", "--seq", "16", "--device",
                            "cpu"])
    assert rc == 0 and len(losses) == 2 and all(np.isfinite(losses))


def test_watchdog_abort_checkpoints_and_exits_42(tmp_path):
    """A threshold below every step time (sigma -100) trips the watchdog
    past step 5: it checkpoints the next train step and returns 42."""
    from repro_torch.launch.train import main as train_main
    ck = str(tmp_path / "ck")
    rc = train_main(["--arch", "tinyllama-1.1b", "--reduced", "--steps", "20",
                     "--batch", "2", "--seq", "16", "--ckpt-dir", ck,
                     "--ckpt-every", "0", "--watchdog-sigma", "-100",
                     "--watchdog-abort", "--device", "cpu"])
    assert rc == 42
    mgr = CheckpointManager(ck)
    step = mgr.latest_step()
    assert step == 6
    import json
    with open(os.path.join(ck, f"step_{step:08d}", "manifest.json")) as f:
        extra = json.load(f)["extra"]
    assert extra == {"data": {"step": 7}, "train_step": 7}


def test_train_cli_runs_as_a_module_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--reduced", "--steps", "2", "--batch", "2",
                          "--seq", "16", "--device", "cpu"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[done] 2 steps" in out.stdout


def test_train_cli_needs_a_world_of_data_times_model_ranks(tmp_path,
                                                          monkeypatch):
    """--data-par 2 with no process group and no torchrun environment
    raises, naming how to launch; in a world of 1 rank it raises too (the
    parallel runs themselves: tests/test_torch_train_parallel.py)."""
    import torch.distributed as dist
    from repro_torch.launch.train import TORCHRUN_ENV
    from repro_torch.launch.train import main as train_main
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    argv = ["--reduced", "--device", "cpu", "--steps", "1", "--data-par", "2"]
    with pytest.raises(SystemExit, match="--nproc-per-node 2"):
        train_main(argv)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(SystemExit, match="the world has 1"):
            train_main(argv + ["--model-par", "2"])
    finally:
        dist.destroy_process_group()
