"""Parity of the PyTorch port's LM slice (RecurrentGemma: causal conv1d,
sliding-window attention, the RG-LRU and local-attention blocks, the stack,
serving) with the JAX package, on CPU.

Inputs come from a numpy seed and are handed to both packages; weights are
drawn by the JAX package and carried across with
``repro_torch.models.convert``.  The JAX kernels run as
``tests/test_kernels.py`` runs them (Pallas ``interpret`` on CPU); the port
runs its plain versions, which are what its ops run for CPU tensors.
Tolerances: kernels use ``TOL`` of ``tests/test_kernels.py`` (f32 2e-5:
summation order; bf16 3e-2, conv1d 8e-2: about one bf16 quantum at the
outputs' magnitude, rounded at other points); single elementwise functions
1e-6 (the same formula in f32); the whole model 5e-4, the bar
``tests/test_models.py`` sets for decode against forward.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import ShapeSpec as JShapeSpec  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from repro.kernels.conv1d.ops import causal_conv1d as jconv1d  # noqa: E402
from repro.kernels.conv1d.ref import conv1d_ref as jconv1d_ref  # noqa: E402
from repro.kernels.swa.ops import sliding_window_attention as jswa  # noqa: E402
from repro.kernels.swa.ref import swa_ref as jswa_ref  # noqa: E402
from repro.kernels.swa.ref import swa_ref_chunked as jswa_ref_chunked  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models.registry import build_model as jbuild_model  # noqa: E402
from repro.models.registry import input_arrays as jinput_arrays  # noqa: E402
from repro.serving.engine import BatchEngine as JBatchEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import (SHAPES, ShapeSpec, get_config,  # noqa: E402
                                 get_reduced_config, list_archs)
from repro_torch.kernels import causal_conv1d, sliding_window_attention  # noqa: E402
from repro_torch.kernels.conv1d.ref import conv1d_ref  # noqa: E402
from repro_torch.kernels.swa.ref import swa_ref, swa_ref_chunked  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.registry import build_model, input_arrays  # noqa: E402
from repro_torch.serving.engine import BatchEngine, Request  # noqa: E402
from repro_torch.serving.serve_step import make_prefill  # noqa: E402

ARCH = "recurrentgemma-2b"
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
MODEL_TOL = 5e-4
FN_TOL = 1e-6
S_MODEL = 48            # past the reduced window of 32


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, np.float32))
            for k, v in tree.items()}


# --------------------------------------------------------------------------
# kernels: the ops against the JAX package's Pallas path, and the plain
# versions against the JAX oracles (the sweeps of tests/test_kernels.py)
CONV_CASES = [
    (2, 128, 64, 4, "float32"),
    (1, 100, 48, 7, "float32"),
    (3, 256, 128, 2, "float32"),
    (1, 64, 16, 16, "float32"),
    (2, 128, 64, 4, "bfloat16"),
]
SWA_CASES = [
    (1, 4, 4, 256, 32, 64, 64, "float32"),
    (2, 8, 2, 256, 64, 128, 64, "float32"),
    (1, 2, 1, 300, 32, 100, 64, "float32"),
    (1, 4, 4, 512, 32, 512, 128, "float32"),
    (2, 6, 3, 128, 16, 1, 64, "float32"),
    (1, 4, 2, 256, 32, 96, 64, "bfloat16"),
]


def _conv_inputs(b, s, c, k, dtype):
    rng = np.random.default_rng(0)
    return [_pair(rng.normal(size=shape), dtype)
            for shape in ((b, s, c), (k, c), (c,))]


def _swa_inputs(b, hq, hkv, s, d, dtype):
    rng = np.random.default_rng(0)
    return [_pair(rng.normal(size=shape), dtype)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


@pytest.mark.parametrize("b,s,c,k,dtype", CONV_CASES)
def test_causal_conv1d_matches_pallas(b, s, c, k, dtype):
    (jx, x), (jw, w), (jb, bias) = _conv_inputs(b, s, c, k, dtype)
    want = jconv1d(jx, jw, jb, backend="pallas", block_s=64, block_c=32)
    got = causal_conv1d(x, w, bias)
    assert got.dtype == x.dtype and got.shape == x.shape
    _close(got, want, 8e-2 if dtype == "bfloat16" else TOL[dtype])


@pytest.mark.parametrize("b,s,c,k,dtype", CONV_CASES)
def test_conv1d_ref_matches_jax(b, s, c, k, dtype):
    (jx, x), (jw, w), (jb, bias) = _conv_inputs(b, s, c, k, dtype)
    _close(conv1d_ref(x, w, bias), jconv1d_ref(jx, jw, jb), TOL[dtype])
    _close(conv1d_ref(x, w), jconv1d_ref(jx, jw), TOL[dtype])


@pytest.mark.parametrize("b,hq,hkv,s,d,w,blk,dtype", SWA_CASES)
def test_sliding_window_attention_matches_pallas(b, hq, hkv, s, d, w, blk,
                                                 dtype):
    (jq, q), (jk, k), (jv, v) = _swa_inputs(b, hq, hkv, s, d, dtype)
    want = jswa(jq, jk, jv, window=w, backend="pallas", block=blk)
    got = sliding_window_attention(q, k, v, window=w)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("b,hq,hkv,s,d,w,blk,dtype", SWA_CASES)
def test_swa_ref_matches_jax(b, hq, hkv, s, d, w, blk, dtype):
    (jq, q), (jk, k), (jv, v) = _swa_inputs(b, hq, hkv, s, d, dtype)
    _close(swa_ref(q, k, v, window=w), jswa_ref(jq, jk, jv, window=w),
           TOL[dtype])


@pytest.mark.parametrize("s,w,dtype", [(256, 64, "float32"),
                                       (300, 100, "float32"),
                                       (128, 128, "float32"),
                                       (200, 48, "float32"),
                                       (200, 48, "bfloat16")])
def test_swa_ref_chunked_matches_jax(s, w, dtype):
    (jq, q), (jk, k), (jv, v) = _swa_inputs(2, 4, 2, s, 32, dtype)
    got = swa_ref_chunked(q, k, v, window=w)
    _close(got, jswa_ref_chunked(jq, jk, jv, window=w), TOL[dtype])
    _close(got, swa_ref(q, k, v, window=w), TOL[dtype])


def test_swa_ops_switch_to_chunked_like_jax():
    """S = 2100 > 2·window and > 1024: both packages take the chunked path."""
    (jq, q), (jk, k), (jv, v) = _swa_inputs(1, 2, 1, 2100, 16, "float32")
    _close(sliding_window_attention(q, k, v, window=64),
           jswa(jq, jk, jv, window=64, backend="xla"), TOL["float32"])


# --------------------------------------------------------------------------
# traps: the same formula in f32, so 1e-6
def test_gelu_is_jax_tanh_gelu():
    x = np.linspace(-8, 8, 4001, dtype=np.float32)
    jx, tx = _pair(x, "float32")
    _close(tcommon.activation("gelu")(tx), jcommon.activation("gelu")(jx),
           FN_TOL)
    _close(tcommon.activation("silu")(tx), jcommon.activation("silu")(jx),
           FN_TOL)


def test_softplus_is_jax_softplus_past_the_torch_threshold():
    x = np.concatenate([np.linspace(-30, 60, 9001, dtype=np.float32),
                        np.float32([19.99, 20.0, 20.01, 25.0])])
    jx, tx = _pair(x, "float32")
    want = jax.nn.softplus(jx)
    _close(tcommon.softplus(tx), want, FN_TOL)
    np.testing.assert_allclose(_np(tcommon.softplus(tx)), _np(want),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_scale_rounds_to_the_activation_type(dtype):
    """sqrt(2560) = 50.596 becomes 50.5 in bf16 before it scales."""
    cfg = dataclasses.replace(get_reduced_config(ARCH), d_model=2560,
                              dtype=dtype, num_layers=1)
    jcfg = dataclasses.replace(jget_reduced(ARCH), d_model=2560, dtype=dtype,
                               num_layers=1)
    rng = np.random.default_rng(0)
    table = rng.normal(size=(cfg.vocab_size, 2560)).astype(np.float32) * 0.02
    toks = rng.integers(0, cfg.vocab_size, size=(2, 5))
    jm = jbuild_model(jcfg)
    want = jm.embed_inputs({"embed": jnp.asarray(table)},
                           jnp.asarray(toks, jnp.int32))
    tm = build_model(cfg, device="cpu")
    with torch.no_grad():
        tm.embed.copy_(torch.from_numpy(table))
    got = tm.embed_inputs(torch.as_tensor(toks))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, FN_TOL)


def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    (jx, x), (js, s) = (_pair(rng.normal(size=(2, 7, 3, 32)), "float32"),
                        _pair(rng.normal(size=(32,)), "float32"))
    _close(tcommon.rmsnorm(s, x), jcommon.rmsnorm(js, jx), FN_TOL)
    pos = np.arange(50, 57)[None, :]
    jc, jsn = jcommon.rope_angles(jnp.asarray(pos), 32, 10_000.0)
    tc, tsn = tcommon.rope_angles(torch.as_tensor(pos), 32, 10_000.0)
    _close(tc, jc, FN_TOL)
    _close(tsn, jsn, FN_TOL)
    _close(tcommon.apply_rope(x, tc, tsn), jcommon.apply_rope(jx, jc, jsn),
           1e-5)
    table = rng.normal(size=(11, 32)).astype(np.float32)
    _close(tcommon.unembed(torch.from_numpy(table), x[:, :, 0], tied=True),
           jcommon.unembed(jnp.asarray(table), jx[:, :, 0], tied=True), 1e-5)


# --------------------------------------------------------------------------
# blocks on converted params
@pytest.fixture(scope="module")
def small():
    """Reduced config, block params drawn by JAX and carried across."""
    jcfg = jget_reduced(ARCH)
    cfg = get_reduced_config(ARCH)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    jp = {"rec": jparams.init_params(jrglru.rglru_specs(jcfg), keys[0]),
          "attn": jparams.init_params(jattn.attention_specs(jcfg), keys[1]),
          "mlp": jparams.init_params(jmlp.mlp_specs(jcfg), keys[2])}
    tp = _torch_tree(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, S_MODEL, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, tp, x


def test_config_matches_jax():
    assert ARCH in list_archs()
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jget_config(ARCH))
    assert dataclasses.asdict(get_reduced_config(ARCH)) == \
        dataclasses.asdict(jget_reduced(ARCH))
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}


def test_rglru_block_and_scan_match_jax(small):
    jcfg, cfg, jp, tp, x = small
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    _close(trglru.rglru_block(tp["rec"], tx, cfg),
           jrglru.rglru_block(jp["rec"], jx, jcfg), TOL["float32"])
    _close(trglru.rglru_scan(tp["rec"], tx[..., :cfg.lru_width]),
           jrglru.rglru_scan(jp["rec"], jx[..., :jcfg.lru_width]),
           TOL["float32"])


def test_rglru_decode_matches_jax(small):
    jcfg, cfg, jp, tp, x = small
    js = jrglru.rglru_init_state(2, jcfg, jnp.float32)
    ts = trglru.rglru_init_state(2, cfg, torch.float32)
    for t in range(6):
        jy, js = jrglru.rglru_decode(jp["rec"], jnp.asarray(x[:, t:t + 1]),
                                     js, jcfg)
        ty, ts = trglru.rglru_decode(tp["rec"], torch.from_numpy(x[:, t:t + 1]),
                                     ts, cfg)
        _close(ty, jy, TOL["float32"])
    _close(ts.h, js.h, TOL["float32"])
    _close(ts.conv, js.conv, TOL["float32"])


def test_attend_local_and_mlp_match_jax(small):
    jcfg, cfg, jp, tp, x = small
    pos = np.arange(S_MODEL)[None, :]
    _close(tattn.attend_local(tp["attn"], torch.from_numpy(x), cfg,
                              positions=torch.as_tensor(pos)),
           jattn.attend_local(jp["attn"], jnp.asarray(x), jcfg,
                              positions=jnp.asarray(pos)), TOL["float32"])
    _close(tmlp.mlp(tp["mlp"], torch.from_numpy(x), cfg),
           jmlp.mlp(jp["mlp"], jnp.asarray(x), jcfg), TOL["float32"])


def test_attention_decode_step_matches_jax_past_the_window(small):
    """40 tokens through a 32-slot ring buffer: the slots wrap."""
    jcfg, cfg, jp, tp, x = small
    hd = cfg.resolved_head_dim
    jc = jattn.KVCache.init(2, 1, cfg.window, hd, jnp.float32)
    tc = tattn.KVCache.init(2, 1, cfg.window, hd, torch.float32)
    for t in range(40):
        xt = x[:, t:t + 1]
        jy, jc = jattn.decode_step(jp["attn"], jnp.asarray(xt), jc, jcfg,
                                   window=jcfg.window)
        ty, tc = tattn.decode_step(tp["attn"], torch.from_numpy(xt), tc, cfg,
                                   window=cfg.window)
        _close(ty, jy, TOL["float32"])
    assert tc.pos == int(jc.pos) == 40
    _close(tc.k, jc.k, TOL["float32"])


# --------------------------------------------------------------------------
# the whole model: 8 layers, so n_full = 2 periods and a 2-layer tail
@pytest.fixture(scope="module")
def lm():
    jcfg = dataclasses.replace(jget_reduced(ARCH), num_layers=8)
    cfg = dataclasses.replace(get_reduced_config(ARCH), num_layers=8)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(from_jax_params(cfg, jax.tree.map(np.asarray, jp)))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             size=(2, S_MODEL))
    jlogits, _ = jm.forward(jp, jnp.asarray(toks, jnp.int32))
    with torch.inference_mode():
        tlogits, _ = tm(torch.as_tensor(toks))
    return jcfg, cfg, jm, jp, tm, toks, np.asarray(jlogits), tlogits


def test_param_specs_match_jax(lm):
    jcfg, cfg, jm, jp, tm, *_ = lm
    specs = tm.specs()
    assert tparams.param_count(specs) == jparams.param_count(jm.specs())
    assert set(specs) == set(dict(tm.named_parameters()))
    assert tm.n_full == 2 and tm.n_tail == 2
    assert [layer.kind for layer in tm.layers] == \
        ["rglru", "rglru", "local"] * 2 + ["rglru", "rglru"]


def test_from_jax_params_maps_scan_and_tail(lm):
    jcfg, cfg, jm, jp, tm, *_ = lm
    np.testing.assert_array_equal(
        tm.layers[5].attn["wq"].detach().numpy(),
        np.asarray(jp["scan"]["p2"]["attn"]["wq"][1]))
    np.testing.assert_array_equal(
        tm.layers[7].rec["lam"].detach().numpy(),
        np.asarray(jp["tail"]["t1"]["rec"]["lam"]))
    np.testing.assert_array_equal(tm.layers[3].ln1.detach().numpy(),
                                  np.asarray(jp["scan"]["p0"]["ln1"][1]))


def test_forward_matches_jax(lm):
    *_, jlogits, tlogits = lm
    assert tlogits.shape == jlogits.shape and tlogits.dtype == torch.float32
    _close(tlogits, jlogits, MODEL_TOL)


def test_prefill_entry_point_matches_forward(lm):
    jcfg, cfg, jm, jp, tm, toks, jlogits, tlogits = lm
    got = make_prefill(tm, cfg)({"tokens": torch.as_tensor(toks)})
    _close(got, tlogits, 0.0)


def test_decode_matches_forward_and_jax_decode(lm):
    """Token by token past the window (48 > 32): the port's decode against
    its own forward, and against the JAX package's jitted decode."""
    jcfg, cfg, jm, jp, tm, toks, jlogits, tlogits = lm
    jdecode = jax.jit(jm.decode)
    jcache = jm.init_cache(2, S_MODEL)
    tcache = tm.init_cache(2, S_MODEL)
    err_fwd = err_jax = 0.0
    with torch.inference_mode():
        for t in range(S_MODEL):
            tl, tcache = tm.decode(tcache, torch.as_tensor(toks[:, t:t + 1]))
            jl, jcache = jdecode(jp, jcache,
                                 jnp.asarray(toks[:, t:t + 1], jnp.int32))
            err_fwd = max(err_fwd, float((tl[:, 0] - tlogits[:, t]).abs().max()))
            err_jax = max(err_jax, float(np.abs(_np(tl) - np.asarray(jl)).max()))
    assert err_fwd < MODEL_TOL, err_fwd
    assert err_jax < MODEL_TOL, err_jax


def test_batch_engine_returns_the_jax_tokens(lm):
    jcfg, cfg, jm, jp, tm, *_ = lm
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=6).tolist()
               for _ in range(5)]
    jdone = JBatchEngine(jm, jcfg, jp, batch_slots=3, cache_len=64).run(
        [JRequest(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)])
    tdone = BatchEngine(tm, cfg, batch_slots=3, cache_len=64).run(
        [Request(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)])
    assert len(tdone) == 5 and all(r.done and len(r.out) == 5 for r in tdone)
    assert [(r.rid, r.out) for r in tdone] == [(r.rid, r.out) for r in jdone]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_arrays_match_jax(kind):
    cfg, jcfg = get_reduced_config(ARCH), jget_reduced(ARCH)
    got = input_arrays(cfg, ShapeSpec("smoke", 16, 2, kind), seed=4,
                       device="cpu")
    want = jinput_arrays(jcfg, JShapeSpec("smoke", 16, 2, kind), seed=4)
    assert set(got) == set(want)
    for name in got:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


def test_serve_cli_runs_on_cpu(capsys):
    assert tserve.main(["--reduced", "--device", "cpu", "--requests", "3",
                        "--slots", "2", "--prompt-len", "4",
                        "--max-new", "3"]) == 0
    assert "[serve] 3/3 requests, 9 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", list_archs())
def test_build_model_builds_every_reduced_config(arch):
    """Every registered family builds on the CPU when asked, prefills
    through ``make_prefill`` and decodes one token: finite logits of the
    right shapes."""
    cfg = get_reduced_config(arch)
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    batch = input_arrays(cfg, ShapeSpec("smoke", 24, 2, "prefill"), seed=0,
                         device="cpu")
    logits = make_prefill(model, cfg)(batch)
    assert logits.shape == (2, 24, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    with torch.inference_mode():
        step, _ = model.decode(model.init_cache(2, 4), batch["tokens"][:, :1],
                               **({"positions": torch.zeros(3, 2, 1)}
                                  if cfg.family == "vlm" else {}))
    assert step.shape == (2, 1, cfg.vocab_size)
    assert bool(torch.isfinite(step).all())
