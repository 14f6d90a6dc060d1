"""Parity of the PyTorch port's other LM families (dense, MoE, RWKV-6, VLM,
enc-dec) with the JAX package, on CPU, at every ``reduced()`` config.

Weights are drawn by the JAX package and carried across with
``repro_torch.models.convert.from_jax_params``; inputs come from each
package's ``input_arrays`` with one seed (held equal below).  None of these
paths reaches a Pallas kernel: the JAX package runs them as XLA einsums, the
port as PyTorch ones.
Tolerances: the whole model 5e-4 (``MODEL_TOL``, the bar of
``tests/test_models.py`` for decode against forward, as in
``tests/test_torch_lm.py``), logits and the MoE aux loss alike; single
blocks in f32 2e-5 (summation order), the MoE in bf16 3e-2 (the ``TOL``
table of ``tests/test_kernels.py``); elementwise functions 1e-6 (the same
formula in f32); a sequence split across calls of one package 1e-5 (the
same arithmetic in another order).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import ShapeSpec as JShapeSpec  # noqa: E402
from repro.configs import cells as jcells  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from repro.configs import list_archs as jlist_archs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models.registry import build_model as jbuild_model  # noqa: E402
from repro.models.registry import input_arrays as jinput_arrays  # noqa: E402
from repro.models.registry import input_specs as jinput_specs  # noqa: E402
from repro.serving.engine import BatchEngine as JBatchEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import (SHAPES, ShapeSpec, cells,  # noqa: E402
                                 get_config, get_reduced_config, list_archs)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.registry import (build_model, input_arrays,  # noqa: E402
                                         input_specs)
from repro_torch.serving.engine import BatchEngine, Request  # noqa: E402
from repro_torch.serving.serve_step import make_prefill  # noqa: E402

NEW_ARCHS = [a for a in jlist_archs() if a != "recurrentgemma-2b"]
DECODER_ARCHS = [a for a in NEW_ARCHS if a != "whisper-tiny"]
MODEL_TOL = 5e-4
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
FN_TOL = 1e-6
SPLIT_TOL = 1e-5
S_FWD = 32              # past qwen2-vl's 16 reduced vision tokens
S_DEC = 10              # tests/test_models.py's decode length


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def _t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


def _leaves_np(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------------
# configs
@pytest.mark.parametrize("arch", jlist_archs())
def test_config_and_reduced_config_match_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(get_reduced_config(arch)) == \
        dataclasses.asdict(jget_reduced(arch))


def test_registry_and_cells_match_jax():
    assert list_archs() == jlist_archs()
    assert cells() == jcells()
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}


# --------------------------------------------------------------------------
# the whole model per family, on weights carried across
@functools.cache
def _built(arch: str, seed: int = 0):
    """Both packages' reduced model, the JAX weights carried across."""
    jcfg, cfg = jget_reduced(arch), get_reduced_config(arch)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(from_jax_params(cfg, _leaves_np(jp)))
    return jcfg, cfg, jm, jp, tm


@pytest.fixture(scope="module", params=NEW_ARCHS)
def fam(request):
    arch = request.param
    jcfg, cfg, jm, jp, tm = _built(arch)
    shape = ("smoke", S_FWD, 2, "prefill")
    jin = jinput_arrays(jcfg, JShapeSpec(*shape), seed=1)
    tin = input_arrays(cfg, ShapeSpec(*shape), seed=1, device="cpu")
    if cfg.family == "audio":
        jlogits, jaux = jm.forward(jp, jin["tokens"], jin["frames"])
    else:
        jlogits, jaux = jm.forward(jp, jin["tokens"],
                                   positions=jin.get("positions"),
                                   patches=jin.get("patches"))
    with torch.inference_mode():
        if cfg.family == "audio":
            tlogits, taux = tm(tin["tokens"], tin["frames"])
        else:
            tlogits, taux = tm(tin["tokens"], positions=tin.get("positions"),
                               patches=tin.get("patches"))
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, jm=jm, jp=jp, tm=tm, tin=tin,
                jlogits=np.asarray(jlogits), jaux=float(jaux),
                tlogits=tlogits, taux=float(taux))


def test_param_specs_match_jax(fam):
    jm, tm, cfg = fam["jm"], fam["tm"], fam["cfg"]
    specs = tm.specs()
    assert tparams.param_count(specs) == jparams.param_count(jm.specs())
    assert tparams.param_bytes(specs, cfg.param_dtype) == \
        jparams.param_bytes(jm.specs(), cfg.param_dtype)
    assert set(specs) == set(dict(tm.named_parameters()))
    assert set(specs) == set(from_jax_params(cfg, _leaves_np(fam["jp"])))
    assert all(tparams.is_spec(s) for s in specs.values())


def test_forward_and_aux_match_jax(fam):
    cfg, tlogits = fam["cfg"], fam["tlogits"]
    assert tlogits.shape == fam["jlogits"].shape == (2, S_FWD, cfg.vocab_size)
    assert tlogits.dtype == torch.float32
    _close(tlogits, fam["jlogits"], MODEL_TOL)
    assert abs(fam["taux"] - fam["jaux"]) < MODEL_TOL
    assert (fam["jaux"] > 0) == bool(cfg.num_experts)


def test_prefill_entry_point_matches_forward(fam):
    got = make_prefill(fam["tm"], fam["cfg"])(fam["tin"])
    _close(got, fam["tlogits"], 0.0)


def _decode_kw(cfg, t):
    if cfg.family != "vlm":
        return {}
    return {"positions": np.full((3, 2, 1), t, np.int32)}


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_decode_matches_forward_and_jax_decode(arch):
    """Token by token (tests/test_models.py's case; vlm on the text path
    with explicit M-RoPE positions): the port's decode against its own
    forward and against the JAX package's jitted decode."""
    jcfg, cfg, jm, jp, tm = _built(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             size=(2, S_DEC))
    fwd_kw = {}
    if cfg.family == "vlm":
        fwd_kw = {"positions": np.broadcast_to(np.arange(S_DEC),
                                               (3, 2, S_DEC)).astype(np.int32)}
    jdecode = jax.jit(jm.decode)
    jcache = jm.init_cache(2, S_DEC)
    with torch.inference_mode():
        full, _ = tm(torch.as_tensor(toks),
                     **{k: torch.as_tensor(v) for k, v in fwd_kw.items()})
        tcache = tm.init_cache(2, S_DEC)
        err_fwd = err_jax = 0.0
        for t in range(S_DEC):
            kw = _decode_kw(cfg, t)
            tl, tcache = tm.decode(tcache, torch.as_tensor(toks[:, t:t + 1]),
                                   **{k: torch.as_tensor(v)
                                      for k, v in kw.items()})
            jl, jcache = jdecode(jp, jcache,
                                 jnp.asarray(toks[:, t:t + 1], jnp.int32),
                                 **{k: jnp.asarray(v) for k, v in kw.items()})
            err_fwd = max(err_fwd, float((tl[:, 0] - full[:, t]).abs().max()))
            err_jax = max(err_jax, float(np.abs(_np(tl) - np.asarray(jl)).max()))
    assert err_fwd < MODEL_TOL, err_fwd
    assert err_jax < MODEL_TOL, err_jax


def test_whisper_decode_matches_forward_and_jax_decode():
    """tests/test_models.py's whisper case: cross K/V primed from the
    encoder output, then the decoder token by token."""
    jcfg, cfg, jm, jp, tm = _built("whisper-tiny")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 8))
    frames = (rng.normal(size=(2, cfg.encoder_seq, cfg.d_model))
              * 0.02).astype(np.float32)
    jfull, _ = jm.forward(jp, jnp.asarray(toks, jnp.int32),
                          jnp.asarray(frames))
    jenc = jm.encode(jp, jnp.asarray(frames))

    def xkv(bp):
        return (jnp.einsum("btd,dhk->bthk", jenc, bp["cross"]["wk"]),
                jnp.einsum("btd,dhk->bthk", jenc, bp["cross"]["wv"]))

    jcache = jm.init_cache(2, 8)
    jcache["cross_k"], jcache["cross_v"] = jax.vmap(xkv)(jp["dec"])
    with torch.inference_mode():
        full, _ = tm(torch.as_tensor(toks), torch.from_numpy(frames))
        _close(full, jfull, MODEL_TOL)
        enc = tm.encode(torch.from_numpy(frames))
        _close(enc, jenc, TOL["float32"])
        tcache = tm.init_cache(2, 8)
        assert tcache["cross_k"].shape == jcache["cross_k"].shape
        assert float(tcache["cross_k"].abs().max()) == 0.0
        kv = [tm._cross_kv(bp, enc) for bp in tm.dec]
        tcache["cross_k"] = torch.stack([k for k, _ in kv])
        tcache["cross_v"] = torch.stack([v for _, v in kv])
        _close(tcache["cross_k"], jcache["cross_k"], TOL["float32"])
        for t in range(8):
            tl, tcache = tm.decode(tcache, torch.as_tensor(toks[:, t:t + 1]))
            jl, jcache = jm.decode(jp, jcache,
                                   jnp.asarray(toks[:, t:t + 1], jnp.int32))
            _close(tl[:, 0], full[:, t], MODEL_TOL)
            _close(tl, jl, MODEL_TOL)
    assert tcache["self"][0].pos == 8


def test_whisper_decode_of_a_shorter_encoder_output_matches_jax():
    """A cross K/V of 24 frames (``encoder_seq`` 32), whole, with no mesh:
    each decoded token's logits equal the reference's decode on the same
    cache, which attends a cross K/V of any frame count."""
    jcfg, cfg, jm, jp, tm = _built("whisper-tiny")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 6))
    frames = (rng.normal(size=(2, 24, cfg.d_model)) * 0.02).astype(
        np.float32)
    jenc = jm.encode(jp, jnp.asarray(frames))

    def xkv(bp):
        return (jnp.einsum("btd,dhk->bthk", jenc, bp["cross"]["wk"]),
                jnp.einsum("btd,dhk->bthk", jenc, bp["cross"]["wv"]))

    jcache = jm.init_cache(2, 6)
    jcache["cross_k"], jcache["cross_v"] = jax.vmap(xkv)(jp["dec"])
    with torch.inference_mode():
        tcache = tm.init_cache(2, 6)
        tcache["cross_k"] = torch.from_numpy(np.asarray(jcache["cross_k"]))
        tcache["cross_v"] = torch.from_numpy(np.asarray(jcache["cross_v"]))
        for t in range(6):
            tl, tcache = tm.decode(tcache, torch.as_tensor(toks[:, t:t + 1]))
            jl, jcache = jm.decode(jp, jcache,
                                   jnp.asarray(toks[:, t:t + 1], jnp.int32))
            _close(tl, jl, MODEL_TOL)


def test_vlm_patch_merge_matches_jax():
    """tests/test_models.py's case: a changed patch changes the prefix
    logits, in both packages alike."""
    jcfg, cfg, jm, jp, tm = _built("qwen2-vl-2b")
    shape = ("smoke", S_FWD, 2, "train")
    jin = jinput_arrays(jcfg, JShapeSpec(*shape))
    tin = input_arrays(cfg, ShapeSpec(*shape), device="cpu")
    jp2 = jin["patches"].at[:, 0, :].add(1.0)
    tp2 = tin["patches"].clone()
    tp2[:, 0, :] += 1.0
    jl2, _ = jm.forward(jp, jin["tokens"], patches=jp2,
                        positions=jin["positions"])
    with torch.inference_mode():
        tl, _ = tm(tin["tokens"], patches=tin["patches"],
                   positions=tin["positions"])
        tl2, _ = tm(tin["tokens"], patches=tp2, positions=tin["positions"])
    assert float((tl2[:, 0] - tl[:, 0]).abs().max()) > 1e-4
    _close(tl2, jl2, MODEL_TOL)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_input_specs_and_arrays_match_jax(arch, kind):
    cfg, jcfg = get_reduced_config(arch), jget_reduced(arch)
    shape = ("smoke", S_FWD, 2, kind)
    specs, jspecs = input_specs(cfg, ShapeSpec(*shape)), \
        jinput_specs(jcfg, JShapeSpec(*shape))
    assert list(specs) == list(jspecs)
    for name, sd in specs.items():
        assert sd.device.type == "meta"
        assert tuple(sd.shape) == jspecs[name].shape
        assert str(sd.dtype).removeprefix("torch.") == str(jspecs[name].dtype)
    got = input_arrays(cfg, ShapeSpec(*shape), seed=4, device="cpu")
    want = jinput_arrays(jcfg, JShapeSpec(*shape), seed=4)
    assert list(got) == list(want)
    for name in got:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-1b-a400m",
                                  "qwen2-vl-2b", "rwkv6-7b"])
def test_batch_engine_returns_the_jax_tokens(arch):
    """Slot recycling, the MoE's dropless decode groups, M-RoPE positions
    from the engine's step and the RWKV state, against the JAX engine."""
    jcfg, cfg, jm, jp, tm = _built(arch, seed=2)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=5).tolist()
               for _ in range(4)]
    jdone = JBatchEngine(jm, jcfg, jp, batch_slots=3, cache_len=32).run(
        [JRequest(rid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)])
    tdone = BatchEngine(tm, cfg, batch_slots=3, cache_len=32).run(
        [Request(rid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)])
    assert len(tdone) == 4 and all(r.done and len(r.out) == 4 for r in tdone)
    assert [(r.rid, r.out) for r in tdone] == [(r.rid, r.out) for r in jdone]


# --------------------------------------------------------------------------
# the MoE alone: padded groups, binding capacity, the tie order of top-k
def _moe_case(dtype: str, cf: float = 1.0):
    jcfg = dataclasses.replace(jget_reduced("granite-moe-3b-a800m"),
                               moe_capacity_factor=cf, dtype=dtype)
    cfg = dataclasses.replace(get_reduced_config("granite-moe-3b-a800m"),
                              moe_capacity_factor=cf, dtype=dtype)
    jp = jmlp.moe_specs(jcfg)
    jp = jparams.init_params(jp, jax.random.PRNGKey(7))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 100, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, _torch_tree(_leaves_np(jp)), x


@pytest.mark.parametrize("group,dtype", [(80, "float32"), (128, "float32"),
                                         (80, "bfloat16")])
def test_moe_matches_jax_with_padded_groups_and_drops(group, dtype):
    """t = 200 tokens in groups of 80 (40 zero rows pad the last) or 128
    (56): g > 64, so the capacity int(g·k/E·cf) binds and tokens drop."""
    jcfg, cfg, jp, tp, x = _moe_case(dtype)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want, jaux = jmlp.moe(jp, jx, jcfg, group_size=group)
    got, taux = tmlp.moe(tp, tx, cfg, group_size=group)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, TOL[dtype])
    assert abs(float(taux) - float(jaux)) < TOL[dtype]
    # the capacity binds: some expert of some group is offered more tokens
    # than it has slots
    cap = tmlp.capacity(group, cfg)
    assert cap == int(group * cfg.experts_per_token / cfg.num_experts
                      * cfg.moe_capacity_factor) < group
    xt = torch.nn.functional.pad(tx.reshape(200, -1).float(),
                                 (0, 0, 0, (-200) % group))
    probs = torch.softmax(xt.reshape(-1, group, cfg.d_model)
                          @ tp["router"], dim=-1)
    _, choices = tmlp.top_k(probs, cfg.experts_per_token)
    load = torch.nn.functional.one_hot(choices, cfg.num_experts).sum((1, 2))
    assert int(load.max()) > cap


def test_top_k_breaks_ties_to_the_lower_index_as_jax():
    """The zero rows that pad a group have uniform probabilities: every
    expert ties, and jax.lax.top_k takes the lower index first."""
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 3, size=(6, 40)).astype(np.float32) / 3
    probs[0] = 1 / 40
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 8)
    tv, ti = tmlp.top_k(torch.from_numpy(probs), 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti[0].tolist() == list(range(8))


# --------------------------------------------------------------------------
# RWKV-6 and attention blocks
@pytest.fixture(scope="module")
def rwkv():
    jcfg, cfg = jget_reduced("rwkv6-7b"), get_reduced_config("rwkv6-7b")
    jp = jparams.init_params(jrwkv.rwkv_specs(jcfg), jax.random.PRNGKey(5))
    x = np.random.default_rng(6).normal(size=(2, 12, cfg.d_model)) \
        .astype(np.float32)
    return jcfg, cfg, jp, _torch_tree(_leaves_np(jp)), x


def test_rwkv_mixes_match_jax_and_carry_across_a_split(rwkv):
    """The whole sequence against the JAX package, then its two halves
    through ``shift``/``s0``: the same outputs and final state."""
    jcfg, cfg, jp, tp, x = rwkv
    tx = torch.from_numpy(x)
    jy, (jlast, js) = jrwkv.rwkv_time_mix(jp, jnp.asarray(x), jcfg)
    y, (last, s) = trwkv.rwkv_time_mix(tp, tx, cfg)
    _close(y, jy, TOL["float32"])
    _close(s, js, TOL["float32"])
    _close(last, jlast, 0.0)
    jc, _ = jrwkv.rwkv_channel_mix(jp, jnp.asarray(x))
    c, _ = trwkv.rwkv_channel_mix(tp, tx, cfg)
    _close(c, jc, TOL["float32"])

    y1, (shift, s1) = trwkv.rwkv_time_mix(tp, tx[:, :5], cfg)
    y2, (_, s2) = trwkv.rwkv_time_mix(tp, tx[:, 5:], cfg, shift=shift, s0=s1)
    _close(torch.cat([y1, y2], 1), y, SPLIT_TOL)
    _close(s2, s, SPLIT_TOL)
    jy2, _ = jrwkv.rwkv_time_mix(jp, jnp.asarray(x[:, 5:]), jcfg,
                                 shift=jnp.asarray(shift.numpy()),
                                 s0=jnp.asarray(s1.numpy()))
    _close(y2, jy2, TOL["float32"])
    c1, cshift = trwkv.rwkv_channel_mix(tp, tx[:, :5], cfg)
    c2, _ = trwkv.rwkv_channel_mix(tp, tx[:, 5:], cfg,
                                      shift=cshift)
    _close(torch.cat([c1, c2], 1), c, SPLIT_TOL)
    jc2, _ = jrwkv.rwkv_channel_mix(jp, jnp.asarray(x[:, 5:]),
                                    shift=jnp.asarray(cshift.numpy()))
    _close(c2, jc2, TOL["float32"])


def test_rwkv_init_state_matches_jax(rwkv):
    jcfg, cfg, *_ = rwkv
    js = jrwkv.rwkv_init_state(3, jcfg, jnp.float32)
    ts = trwkv.rwkv_init_state(3, cfg, torch.float32)
    for a, b in zip(ts, js):
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == str(b.dtype)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-32b", "qwen2-vl-2b"])
def test_attend_full_and_decode_step_match_jax(arch):
    """qkv bias, qk norm and M-RoPE: causal, bidirectional and cross
    attention, and a global layer's decode step, on one block's weights."""
    jcfg, cfg = jget_reduced(arch), get_reduced_config(arch)
    jp = jparams.init_params(jattn.attention_specs(jcfg),
                             jax.random.PRNGKey(9))
    jp = {k: v + 0.1 if k in ("bq", "bk", "bv") else v for k, v in jp.items()}
    tp = _torch_tree(_leaves_np(jp))
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    if cfg.mrope_sections is not None:
        pos = rng.integers(0, 40, size=(3, 2, 12)).astype(np.int32)
    else:
        pos = np.arange(12)[None, :]
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for causal in (True, False):
        _close(tattn.attend_full(tp, tx, cfg, positions=torch.as_tensor(pos),
                                 causal=causal),
               jattn.attend_full(jp, jx, jcfg, positions=jnp.asarray(pos),
                                 causal=causal), TOL["float32"])
    kv = rng.normal(size=(2, 7, cfg.num_kv_heads, cfg.resolved_head_dim)) \
        .astype(np.float32)
    _close(tattn.attend_full(tp, tx, cfg, positions=None,
                             cross_kv=(torch.from_numpy(kv),) * 2),
           jattn.attend_full(jp, jx, jcfg, positions=None,
                             cross_kv=(jnp.asarray(kv),) * 2), TOL["float32"])
    hd = cfg.resolved_head_dim
    jc = jattn.KVCache.init(2, cfg.num_kv_heads, 12, hd, jnp.float32)
    tc = tattn.KVCache.init(2, cfg.num_kv_heads, 12, hd, torch.float32)
    for t in range(12):
        p = pos[..., t:t + 1] if cfg.mrope_sections is not None else None
        jy, jc = jattn.decode_step(
            jp, jnp.asarray(x[:, t:t + 1]), jc, jcfg,
            positions=None if p is None else jnp.asarray(p))
        ty, tc = tattn.decode_step(
            tp, torch.from_numpy(x[:, t:t + 1]), tc, cfg,
            positions=None if p is None else torch.as_tensor(p))
        _close(ty, jy, TOL["float32"])
    assert tc.pos == int(jc.pos) == 12
    _close(tc.k, jc.k, TOL["float32"])


# --------------------------------------------------------------------------
# elementwise functions: the same formula in f32, so 1e-6
def test_mrope_sinusoidal_and_layernorm_match_jax():
    """Positions below 64, as the reduced models see them, within 1e-6: past
    a few hundred, one ulp of the f32 angle (|angle|·2^-24, where the two
    packages' ``pow`` may differ) passes 1e-6, so whisper's full table is
    held to two ulps of its largest angle."""
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 64, size=(3, 2, 9))
    jc, js = jcommon.mrope_angles(jnp.asarray(pos), 128, 1e6, (16, 24, 24))
    tc, ts = tcommon.mrope_angles(torch.as_tensor(pos), 128, 1e6, (16, 24, 24))
    _close(tc, jc, FN_TOL)
    _close(ts, js, FN_TOL)
    with pytest.raises(ValueError, match="sections"):
        tcommon.mrope_angles(torch.as_tensor(pos), 128, 1e6, (16, 24, 23))
    for seq, dim, offset in ((32, 64, 0), (1, 64, 37), (7, 2, 3)):
        _close(tcommon.sinusoidal_positions(seq, dim, offset=offset),
               jcommon.sinusoidal_positions(seq, dim, offset=offset), FN_TOL)
    # whisper's 1500 frames: two ulps of the largest f32 angle
    _close(tcommon.sinusoidal_positions(1500, 384),
           jcommon.sinusoidal_positions(1500, 384), 1500 * 2.0 ** -22)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3 + 1
    jp = {"scale": jnp.asarray(rng.normal(size=48), jnp.float32),
          "bias": jnp.asarray(rng.normal(size=48), jnp.float32)}
    specs = tcommon.layernorm_specs(48)
    assert {k: (s.shape, s.init, s.dtype) for k, s in specs.items()} == \
        {k: (s.shape, s.init, s.dtype)
         for k, s in jcommon.layernorm_specs(48).items()}
    _close(tcommon.layernorm(_torch_tree(_leaves_np(jp)), torch.from_numpy(x)),
           jcommon.layernorm(jp, jnp.asarray(x)), FN_TOL)
