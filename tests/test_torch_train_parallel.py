"""The trainer's parallel slice on the CPU, no jax: ``launch.train.run``
with ``--data-par``/``--model-par`` above 1 in gloo worlds that
``run_local_world`` spawns (one 4-rank and one 2-rank world for the module,
each rank running every job of its world in turn), held to the one-device
run of the same command in this process.

Tolerances, set before the runs:
- ``LOSS_RTOL`` 1e-5: each step's loss (and aux loss), relative (float32
  activations in the reduced configs; a split product sums its parts in
  another order);
- the gathered parameters after the steps (the final checkpoint, which
  rank 0 writes whole) within ``2 x`` the steps' summed learning rate of
  the one-device run's: an Adam step moves an element by up to about lr
  whatever the size of its gradient, so a last-bit difference in a
  gradient near 0 can move it by that much (``tests/test_torch_train.py``'s
  bar);
- each rank's local parameter shapes exactly ``resolve_spec``'s split
  under ``{**DEFAULT_RULES, "fsdp": [()]}``.
"""
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config, list_archs
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import DEFAULT_RULES, resolve_spec
from repro_torch.launch import train
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_local_mesh, run_local_world
from repro_torch.models.registry import build_model
from repro_torch.train.optim import OptConfig, schedule
from torch_train_cases import (BASE, STEPS, argv_of, final_params,
                               keep_until, rank_jobs)

WORLD_TIMEOUT_S = 300
LOSS_RTOL = 1e-5
RG, TL, MOE = "recurrentgemma-2b", "tinyllama-1.1b", "granite-moe-1b-a400m"
RWKV, WH, VL = "rwkv6-7b", "whisper-tiny", "qwen2-vl-2b"
# name -> (arch, data, model, extra arguments)
JOBS = {
    "rg_2x1": (RG, 2, 1, ()),
    "rg_1x2": (RG, 1, 2, ("--remat", "dots")),
    "rg_2x2": (RG, 2, 2, ()),
    "tl_2x1": (TL, 2, 1, ()),
    "tl_1x2": (TL, 1, 2, ()),
    "tl_2x2": (TL, 2, 2, ()),
    "tl_1x4": (TL, 1, 4, ()),        # 4 heads split, 2 kv heads replicated
    "tl_2x2_int8_mb2": (TL, 2, 2, ("--compression", "int8",
                                   "--microbatches", "2")),
    "tl_2x2_topk": (TL, 2, 2, ("--compression", "topk")),
    "moe_2x1": (MOE, 2, 1, ("--seq", "256")),   # 512 tokens a rank: a group
    # the MoE split over model: its 4 experts 2 and 1 a rank (EP, the
    # router gathered), under remat "dots" at (1, 2); at (2, 2) a data
    # rank's 512 tokens are a whole group; 5 experts, which 2 does not
    # divide: each expert whole with half its d_ff (FF); a vocabulary of
    # 515, which 2 does not divide: the tied embedding and the logits whole
    "moe_1x2": (MOE, 1, 2, ("--remat", "dots")),
    "moe_1x4": (MOE, 1, 4, ()),
    "moe_2x2": (MOE, 2, 2, ("--seq", "256")),
    "moe_ff_1x2": (MOE, 1, 2, ("--override", "num_experts=5")),
    "moe_vocab_1x2": (MOE, 1, 2, ("--override", "vocab_size=515")),
    # the other dense configs: qk-norm scales (replicated) inside the split
    # heads; q/k/v biases with the 2 kv heads replicated at M 4; 6 heads
    # that 4 does not divide (attention whole, the MLP split)
    "qwen3_1x2": ("qwen3-32b", 1, 2, ()),
    "qwen25_1x4": ("qwen2.5-3b", 1, 4, ()),
    "cr_1x4": ("command-r-plus-104b", 1, 4, ()),
    # rwkv6: its 4 WKV heads 2 and 1 a rank, the channel mix over d_ff
    # and d_model, under remat "dots" at (1, 2)
    "rwkv_1x2": (RWKV, 1, 2, ("--remat", "dots")),
    "rwkv_2x2": (RWKV, 2, 2, ()),
    "rwkv_1x4": (RWKV, 1, 4, ()),
    # whisper: its encoder's, decoder's and cross-attention's 4 heads 2
    # and 1 a rank (each rank makes its heads' cross K/V from the encoder
    # output), the MLPs over d_ff, the tied vocabulary split, under remat
    # "dots" at (1, 2); every model rank of a data rank takes the same
    # rows of the frames
    "wh_1x2": (WH, 1, 2, ("--remat", "dots")),
    "wh_2x2": (WH, 2, 2, ()),
    "wh_1x4": (WH, 1, 4, ()),
    # qwen2-vl: its 4 heads 2 and 1 a rank with their q biases, its 2 KV
    # heads 1 a rank at M 2 and whole at M 4 (their biases entering the
    # split region), the MLP over d_ff, the tied vocabulary split, under
    # remat "dots" at (1, 2); tokens alone, as the reference's trainer
    # feeds them (text-only M-RoPE positions)
    "vl_1x2": (VL, 1, 2, ("--remat", "dots")),
    "vl_2x2": (VL, 2, 2, ()),
    "vl_1x4": (VL, 1, 4, ()),
}
# a checkpoint at step 2 of 4, resumed on another mesh
RESUME_STEPS, RESUME_AT = 4, 2


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("train_parallel")


@pytest.fixture(scope="module")
def one(tmp):
    """The one-device runs in this process: each job's command at (1, 1),
    and a 4-step run with a checkpoint every 2 steps (resumed at (2, 2))."""
    torch.set_num_threads(2)
    out = {}
    for name, (arch, _, _, extra) in JOBS.items():
        ck = str(tmp / f"one_{name}")
        rc, losses = train.run(argv_of(arch, 1, 1, extra, ck))
        out[name] = {"rc": rc, "losses": losses, "params": final_params(ck)}
    ck = str(tmp / "one_ckpt")
    rc, losses = train.run(argv_of(TL, 1, 1, ("--ckpt-every", "2"), ck,
                                   RESUME_STEPS))
    out["ckpt"] = {"rc": rc, "losses": losses, "dir": ck}
    return out


@pytest.fixture(scope="module")
def world4(tmp, one):
    """4 ranks: the (2, 2) and (1, 4) jobs, a (2, 2) run of 4 steps with a
    checkpoint every 2, and the resume at (2, 2) of the (1, 1) run's
    checkpoint at step 2."""
    jobs = [(n, argv_of(a, d, m, e, str(tmp / f"w4_{n}")))
            for n, (a, d, m, e) in JOBS.items() if d * m == 4]
    jobs.append(("ckpt_2x2", argv_of(TL, 2, 2, ("--ckpt-every", "2"),
                                     str(tmp / "w4_ckpt"), RESUME_STEPS)))
    resume = keep_until(one["ckpt"]["dir"], str(tmp / "from_1x1"), RESUME_AT)
    jobs.append(("resume_2x2", argv_of(TL, 2, 2, ("--resume",), resume,
                                       RESUME_STEPS)))
    return run_local_world(rank_jobs, 4, jobs, timeout=WORLD_TIMEOUT_S)


@pytest.fixture(scope="module")
def world2(tmp, world4):
    """2 ranks: the (2, 1) and (1, 2) jobs, the resume at (1, 2) of the
    (2, 2) run's checkpoint at step 2, and a world of the wrong size."""
    jobs = [(n, argv_of(a, d, m, e, str(tmp / f"w2_{n}")))
            for n, (a, d, m, e) in JOBS.items() if d * m == 2]
    resume = keep_until(str(tmp / "w4_ckpt"), str(tmp / "from_2x2_a"),
                        RESUME_AT)
    jobs.append(("resume_1x2", argv_of(TL, 1, 2, ("--resume",), resume,
                                       RESUME_STEPS)))
    jobs.append(("wrong_world", argv_of(TL, 2, 2, (), str(tmp / "wrong"))))
    return run_local_world(rank_jobs, 2, jobs, timeout=WORLD_TIMEOUT_S)


@pytest.fixture(scope="module")
def worlds(world4, world2):
    return {**{k: v for r in world4[:1] for k, v in r.items()},
            **{k: v for r in world2[:1] for k, v in r.items()}}


def _rel(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def _lr_sum(steps: int) -> float:
    cfg = OptConfig(warmup_steps=20, total_steps=steps)
    return sum(float(schedule(torch.tensor(s), cfg)) for s in range(steps))


def _ranks(name, world4, world2):
    d, m = JOBS[name][1:3]
    return (world4 if d * m == 4 else world2)


@pytest.mark.parametrize("name", list(JOBS))
def test_layout_losses_match_one_device(name, one, worlds, world4, world2):
    got = worlds[name]
    assert got.get("rc") == 0, got
    want = one[name]["losses"]
    assert len(got["losses"]) == len(want) == STEPS
    assert _rel(got["losses"], want) <= LOSS_RTOL, (got["losses"], want)
    # every rank reports the global batch's loss
    for r in _ranks(name, world4, world2):
        assert r[name]["losses"] == got["losses"]


@pytest.mark.parametrize("name", list(JOBS))
def test_layout_parameters_match_one_device(name, one, tmp, worlds):
    d, m = JOBS[name][1:3]
    got = final_params(str(tmp / f"w{d * m}_{name}"))
    want = one[name]["params"]
    assert set(got) == set(want)
    bound = 2 * _lr_sum(STEPS)
    for n, w in want.items():
        assert got[n].shape == w.shape, n
        err = (got[n].float() - w.float()).abs().max().item()
        assert err <= bound, (n, err, bound)


@pytest.mark.parametrize("name", list(JOBS))
def test_local_shapes_follow_resolve_spec(name, world4, world2):
    """At M = 2 a rank holds the split leaves' half, never a replica."""
    arch, d, m, extra = JOBS[name]
    cfg = train._config(train.parse_args(argv_of(arch, d, m, extra, "")))
    specs = build_model(cfg, device="meta").specs()
    mesh = SimpleNamespace(shape={"data": d, "model": m})
    rules = {**DEFAULT_RULES, "fsdp": [()]}
    split = 0
    for r in _ranks(name, world4, world2):
        shapes = r[name]["shapes"]
        assert set(shapes) == set(specs)
        for n, spec in specs.items():
            ps = resolve_spec(spec.shape, spec.logical, mesh, rules)
            want = list(spec.shape)
            for dim, part in enumerate(ps):
                if part == "model":
                    want[dim] //= m
                    split += m > 1
                else:
                    assert part is None, (n, ps)
            assert shapes[n] == tuple(want), n
    assert (split > 0) == (m > 1)


def test_embedding_and_heads_split_at_two(world2):
    """tinyllama at (1, 2): the embedding, unembedding, wq and the MLP
    hold half their elements on each rank."""
    full = build_model(get_reduced_config(TL), device="meta").specs()
    for r in world2:
        shapes = r["tl_1x2"]["shapes"]
        assert shapes["embed"] == (256, 64)
        assert shapes["unembed"] == (64, 256)
        assert shapes["layers.0.attn.wq"] == (64, 2, 16)
        assert shapes["layers.0.attn.wk"] == (64, 1, 16)
        assert shapes["layers.0.mlp.wi_gate"] == (64, 80)
        assert shapes["layers.0.ln1"] == full["layers.0.ln1"].shape


def test_moe_layouts_at_two(world2):
    """granite-moe at (1, 2): 2 of the 4 experts and the router's columns
    a rank (EP); with 5 experts every expert whole and 32 of its 64 d_ff
    columns (FF), the router whole; with a vocabulary of 515 the tied
    embedding whole on each rank."""
    for r in world2:
        ep, ff = r["moe_1x2"]["shapes"], r["moe_ff_1x2"]["shapes"]
        assert ep["layers.0.mlp.wi_gate"] == (2, 64, 64)
        assert ep["layers.0.mlp.wo"] == (2, 64, 64)
        assert ep["layers.0.mlp.router"] == (64, 2)
        assert ff["layers.0.mlp.wi_gate"] == (5, 64, 32)
        assert ff["layers.0.mlp.wo"] == (5, 32, 64)
        assert ff["layers.0.mlp.router"] == (64, 5)
        assert r["moe_vocab_1x2"]["shapes"]["embed"] == (515, 64)


def test_checkpoint_from_2x2_resumes_at_1x2(worlds):
    want = worlds["ckpt_2x2"]["losses"][RESUME_AT:]
    got = worlds["resume_1x2"]
    assert got.get("rc") == 0, got
    assert len(got["losses"]) == RESUME_STEPS - RESUME_AT
    assert _rel(got["losses"], want) <= LOSS_RTOL


def test_checkpoint_from_2x2_resumes_at_1x1(tmp, worlds):
    resume = keep_until(str(tmp / "w4_ckpt"), str(tmp / "from_2x2_b"),
                        RESUME_AT)
    rc, losses = train.run(argv_of(TL, 1, 1, ("--resume",), resume,
                                   RESUME_STEPS))
    assert rc == 0 and len(losses) == RESUME_STEPS - RESUME_AT
    assert _rel(losses, worlds["ckpt_2x2"]["losses"][RESUME_AT:]) <= LOSS_RTOL


def test_checkpoint_from_1x1_resumes_at_2x2(one, worlds):
    got = worlds["resume_2x2"]
    assert got.get("rc") == 0, got
    assert _rel(got["losses"], one["ckpt"]["losses"][RESUME_AT:]) <= LOSS_RTOL


def test_uninterrupted_2x2_matches_one_device(one, worlds):
    assert _rel(worlds["ckpt_2x2"]["losses"], one["ckpt"]["losses"]) \
        <= LOSS_RTOL


def test_checkpoint_written_at_2x2_is_the_one_device_format(tmp, one):
    """The same manifest names, shapes and types as a one-device run's."""
    def manifest(ck, step):
        with open(os.path.join(ck, f"step_{step:08d}", "manifest.json")) as f:
            m = json.load(f)
        return [(a["name"], a["shape"], a["dtype"]) for a in m["arrays"]], \
            m["extra"]
    assert manifest(str(tmp / "w4_ckpt"), RESUME_AT) == \
        manifest(one["ckpt"]["dir"], RESUME_AT)


def test_world_of_the_wrong_size_raises(world2):
    for r in world2:
        msg = r["wrong_world"].get("exit", "")
        assert "4 ranks" in msg and "world has 2" in msg, r["wrong_world"]


def test_whisper_layouts_at_two(world2):
    """whisper at (1, 2): the encoder's, the decoder's self and cross
    attention's heads 2 a rank, the MLPs' d_ff 64, the tied embedding's
    256 rows; the norms whole."""
    for r in world2:
        shapes = r["wh_1x2"]["shapes"]
        assert shapes["embed"] == (256, 64)
        for blk in ("enc.0.attn", "dec.1.self", "dec.1.cross"):
            assert shapes[f"{blk}.wq"] == (64, 2, 16)
            assert shapes[f"{blk}.wk"] == (64, 2, 16)
            assert shapes[f"{blk}.wo"] == (2, 16, 64)
        assert shapes["enc.1.mlp.wi_up"] == (64, 64)
        assert shapes["dec.0.mlp.wo"] == (64, 64)
        assert shapes["dec.0.lnx"] == shapes["enc_norm"] == (64,)


def test_vlm_layouts_at_two(world2):
    """qwen2-vl at (1, 2): 2 heads (with bq) and 1 KV head (with bk, bv)
    a rank, the MLP's d_ff 80, the tied embedding's 256 rows; the norms
    whole."""
    for r in world2:
        shapes = r["vl_1x2"]["shapes"]
        assert shapes["embed"] == (256, 64)
        assert shapes["layers.1.attn.wq"] == (64, 2, 16)
        assert shapes["layers.1.attn.bq"] == (2, 16)
        assert shapes["layers.1.attn.wk"] == (64, 1, 16)
        assert shapes["layers.1.attn.bv"] == (1, 16)
        assert shapes["layers.1.attn.wo"] == (2, 16, 64)
        assert shapes["layers.0.mlp.wi_up"] == (64, 80)
        assert shapes["layers.0.ln1"] == shapes["final_norm"] == (64,)


@pytest.mark.parametrize("arch", list_archs())
def test_model_par_lays_out_every_family(arch):
    """No family is refused a model axis: every registered architecture,
    reduced, laid out on meta tensors at model = 2 as rank 0 of a fake
    world of 2 (``dryrun.fake_world``) by ``parameter_layout`` and
    ``shard_parameters``, holds each parameter's ``resolve_spec`` split
    under the trainer's rules, and at least one parameter split."""
    cfg = get_reduced_config(arch)
    rules = {**DEFAULT_RULES, **tp.FSDP_OFF}
    with fake_world(2):
        mesh = make_local_mesh(1, 2, device="cpu")
        model = build_model(cfg, device="meta")
        specs = model.specs()
        tp.shard_parameters(model, tp.parameter_layout(model, mesh), mesh)
        got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert set(got) == set(specs)
    for n, spec in specs.items():
        ps = resolve_spec(spec.shape, spec.logical,
                          SimpleNamespace(shape={"data": 1, "model": 2}),
                          rules)
        want = list(spec.shape)
        for dim, part in enumerate(ps):
            if part == "model":
                want[dim] //= 2
            else:
                assert part is None, (n, ps)
        want = tuple(want)
        assert got[n] == want, (n, got[n], want)
    assert got != {n: s.shape for n, s in specs.items()}


def test_moe_groups_that_a_rank_would_split_raise():
    """granite's group is min(512, 4 x 32) = 128 tokens; a data rank of 2
    holds 64 a step: its routing would differ, so the run refuses."""
    with pytest.raises(SystemExit, match="MoE groups of 128"):
        train.run(["--arch", MOE, *BASE, "--steps", "1", "--data-par", "2"])


def test_data_par_without_a_world_raises(monkeypatch):
    for k in train.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit, match="--nproc-per-node 2"):
        train.run(["--arch", TL, *BASE, "--steps", "1", "--data-par", "2"])


@pytest.mark.parametrize("heads,kv,rank,size,want", [
    (5, 1, 1, 2, ([0], 5)),            # recurrentgemma: 10 heads, MQA, M 2
    (1, 2, 3, 4, ([1], 1)),            # tinyllama reduced at M 4
    (4, 4, 1, 8, ([0], 4)),            # tinyllama: 32 heads, 4 kv, M 8
    (3, 3, 1, 2, ([1, 2, 2], 1)),      # 6 heads over 3 kv: uneven, repeat
])
def test_kv_select(heads, kv, rank, size, want):
    axis = tp.Axis("model", None, rank, size)
    q_per_kv = heads * size // kv
    assert tp.kv_select(heads, kv, q_per_kv, axis) == want


def test_one_device_run_installs_no_mesh(one):
    assert tp.ambient_mesh() is None
    assert all(r["rc"] == 0 for r in one.values())
    assert np.isfinite(one["ckpt"]["losses"]).all()
