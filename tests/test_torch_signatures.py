"""The port's public signatures against the reference's, module by module.

For every module that ``src/repro/`` and ``src/repro_torch/`` both have
(same path under the package), each public function, class method and
``__init__`` defined there is compared with ``inspect.signature`` of the
reference's: the parameters' names, kinds and order, and their defaults.
Annotations are not compared (``jax.Array`` against ``torch.Tensor``).
What differs by design is recorded in ``DIFFERENCES`` and ``MISSING``; a
new difference fails here until it is recorded or repaired, and a recorded
one that no longer holds fails too.
"""
import dataclasses
import importlib
import inspect
import os
from pathlib import Path

import pytest

pytest.importorskip("jax")

SRC = Path(__file__).resolve().parents[1] / "src"


@dataclasses.dataclass(frozen=True)
class Diff:
    """How a port signature departs from the reference's: reference
    parameters it drops, parameters of its own, and defaults it changes
    (name -> the port's default); or, with ``contract``, none of these but
    what a parameter takes or what comes back (``why`` says how)."""
    why: str
    dropped: tuple = ()
    added: tuple = ()
    defaults: tuple = ()       # ((name, port default), ...)
    contract: bool = False


PARAMS = "the nn.Module holds its parameters: no params argument"
INIT = "init fills the parameters from a torch.Generator, not a jax key"
DEVICE = "the port's tensors are made on device= (None or 'cuda': the card)"
TILES = ("Pallas tile and VMEM keywords dropped: the CUDA kernels pick their "
         "own tiles from the card's shared memory")
PLANNER = "the planner is re-derived for the card's shared memory"
GROUP = ("axis_name is the mesh axis's ProcessGroup (mesh.get_group(name)), "
         "where jax's shard_map context resolved a name")
SHARDED = ("mesh is a DeviceMesh; the callable takes and returns a DTensor "
           "of the whole grid in the reference's layout (not a jitted "
           "function of a whole array): to_local() is the shard")

DIFFERENCES = {
    "checkpoint.manager.CheckpointManager.restore": Diff(
        "a shardings leaf is a placements tuple (tree_shardings') on the "
        "DeviceMesh given as mesh=, not a NamedSharding, and comes back as "
        "this rank's slice (a local tensor), not a global array; like's "
        "leaves may be meta tensors (restored on the CPU)",
        added=("mesh",), contract=True),
    "core.simulator.simulate": Diff(DEVICE, added=("device",)),
    "core.simulator.simulate_batch": Diff(
        "the batched engine is K7 ('cuda'), run on device=",
        added=("device",), defaults=(("engine", "cuda"),)),
    "explore.search.explore": Diff(DEVICE, added=("device",)),
    "distributed.collectives.compress_decompress": Diff(
        "groups: the reference's stacked leaves; shards: the leaves held as "
        "a rank's slice, whose scale or threshold is the whole leaf's",
        added=("groups", "shards")),
    "distributed.collectives.int8_psum": Diff(GROUP, contract=True),
    "distributed.collectives.compressed_psum_tree": Diff(GROUP,
                                                         contract=True),
    "distributed.halo.halo_exchange": Diff(GROUP, contract=True),
    "distributed.halo.distributed_stencil1d": Diff(SHARDED, contract=True),
    "distributed.halo.distributed_stencil2d": Diff(SHARDED, contract=True),
    "distributed.halo.distributed_stencil3d": Diff(SHARDED, contract=True),
    "distributed.sharding.make_mesh_compat": Diff(
        DEVICE + "; a DeviceMesh over the default process group",
        added=("device",)),
    "distributed.sharding.named_sharding": Diff(
        "the DTensor placements of the spec on a DeviceMesh (Shard(dim) or "
        "Replicate() per mesh axis), not a NamedSharding", contract=True),
    "distributed.sharding.tree_shardings": Diff(
        "a dict tree of named_sharding's placements", contract=True),
    "distributed.sharding.constrain": Diff(
        "returns x: the port has no SPMD partitioner to anchor (the "
        "reference's behaviour with no mesh set)", contract=True),
    "launch.mesh.make_production_mesh": Diff(DEVICE, added=("device",)),
    "launch.mesh.make_local_mesh": Diff(DEVICE, added=("device",)),
    "train.optim.apply_updates": Diff(
        "decay and groups: the reference's stacked leaves; shards: the "
        "leaves held as a rank's slice, normed and compressed whole",
        added=("decay", "groups", "shards")),
    "kernels.conv1d.ops.causal_conv1d": Diff(
        TILES, dropped=("block_s", "block_c")),
    "kernels.swa.ops.sliding_window_attention": Diff(TILES,
                                                     dropped=("block",)),
    "kernels.stencil3d.ops.stencil3d": Diff(
        TILES + "; block=None runs DEFAULT_BLOCK through fit_block",
        dropped=("vmem_budget_bytes",), defaults=(("block", None),)),
    "kernels.stencil1d.ops.plan_1d_blocks": Diff(
        PLANNER, dropped=("bytes_per_elem", "vmem_budget"),
        added=("variant", "smem_budget", "itemsize")),
    "kernels.stencil2d.ops.plan_2d_blocks": Diff(
        PLANNER, dropped=("bytes_per_elem", "vmem_budget"),
        added=("smem_budget",)),
    "models.attention.KVCache": Diff(
        "a rank's slice of a cache split over its positions records its "
        "place: start, the first slot of the whole cache it holds, and "
        "capacity, the whole cache's slots (0: whole); both default, so "
        "KVCache(k, v, pos) builds a whole cache", added=("start",
                                                          "capacity")),
    "models.attention.KVCache.init": Diff(DEVICE, added=("device",)),
    "models.attention.attend_full": Diff(
        "frames=: the encoder's whole frame count where cross_kv is a "
        "rank's slice of the frames (decode's cross cache split over "
        "them by the rules, which records the count as cross_frames), "
        "merged over the model axis; 0 (the default): cross_kv holds "
        "every frame, of any count", added=("frames",)),
    "models.rwkv6.rwkv_channel_mix": Diff(
        "cfg gives the whole d_ff, against which a split of the value "
        "half over the model axis is read from its weights' shapes",
        added=("cfg",)),
    "models.common.sinusoidal_positions": Diff(DEVICE, added=("device",)),
    "models.rglru.rglru_init_state": Diff(DEVICE, added=("device",)),
    "models.rwkv6.rwkv_init_state": Diff(DEVICE, added=("device",)),
    "models.registry.build_model": Diff(DEVICE, added=("device",)),
    "models.registry.input_arrays": Diff(DEVICE, added=("device",)),
    "models.transformer.LM.__init__": Diff(DEVICE, added=("device",)),
    "models.transformer.LM.init": Diff(INIT, dropped=("key",),
                                       added=("generator",)),
    "models.transformer.LM.forward": Diff(PARAMS, dropped=("params",)),
    "models.transformer.LM.decode": Diff(PARAMS, dropped=("params",)),
    "models.transformer.LM.embed_inputs": Diff(PARAMS, dropped=("params",)),
    "models.encdec.EncDecLM.__init__": Diff(DEVICE, added=("device",)),
    "models.encdec.EncDecLM.init": Diff(INIT, dropped=("key",),
                                        added=("generator",)),
    "models.encdec.EncDecLM.forward": Diff(PARAMS, dropped=("params",)),
    "models.encdec.EncDecLM.decode": Diff(PARAMS, dropped=("params",)),
    "models.encdec.EncDecLM.encode": Diff(PARAMS, dropped=("params",)),
    "serving.engine.BatchEngine.__init__": Diff(PARAMS, dropped=("params",)),
    "core.roofline.TpuRooflineTerms.__init__": Diff(
        "the peaks default to the H100 SXM's datasheet: dense BF16 989e12 "
        "flop/s, HBM 3.35e12 B/s (H100_SXM.bw_gbps), NVLink 4's 900 GB/s "
        "counted one direction, 450e9 B/s (a stated constant, never "
        "measured on a one-card machine), in place of the TPU's",
        defaults=(("peak_flops_per_chip", 989e12),
                  ("hbm_bw_per_chip", 3.35e12),
                  ("link_bw_per_chip", 450e9))),
    "launch.dryrun.batch_shardings": Diff(
        "each input's DTensor placements on the DeviceMesh "
        "(named_sharding's), not a NamedSharding", contract=True),
    "launch.dryrun.cache_shardings": Diff(
        "a placements tree over the port's cache, one state a layer (a "
        "list; nothing stacked, so no path names a stacked leaf by "
        "default), the paths written as jax's keystr writes them",
        defaults=(("stacked_names", ()),)),
    "launch.dryrun.param_bytes_per_device": Diff(
        "structs: shape_tree's meta tensors; shardings: tree_shardings' "
        "placements (a dict tree), not NamedShardings", contract=True),
    "launch.dryrun.run_cell": Diff(
        "the step runs once on meta tensors as rank 0 of a fake world: "
        "nothing compiled (compile_s 0, memory_analysis unavailable, "
        "hlo_lines the aten ops dispatched, remat_duplication None), "
        "flops FlopCounterMode's plus K5/K6's own, bytes every aten op's "
        "inputs and outputs (an unfused upper bound), collectives the c10d "
        "ops dispatched; correction is taken and ignored (no layer scan: "
        "every layer counted); FSDP over data not ported (ROADMAP item "
        "5b): the step's placement is the model-axis splits, training's "
        "and serving's alike, param_bytes_per_device counts the rules' "
        "FSDP; a decode cell "
        "decodes on the rank's slice of the cache its placements give, "
        "its logits split over the vocabulary and its token their "
        "vocabulary-parallel argmax", contract=True),
    "launch.dryrun.main": Diff(
        "writes results/dryrun_torch/ (the reference: results/dryrun/); "
        "an ok cell's line also names the K5/K6 launches counted on meta",
        contract=True),
    "analysis.rooflines.main": Diff(
        "--dir defaults to results/dryrun_torch (the port's dry run's "
        "records)", contract=True),
}

# reference public names with no counterpart in the port's module
MISSING = {
    # jax shim: shard_map has no counterpart (each rank runs its shard's
    # code itself)
    "distributed.sharding": {"shard_map_compat"},
    "kernels.stencil1d.kernel": {"make_band"},         # K2 builds it on the card
    "models.params": {"init_leaf", "init_params"},     # nn.Module init
    "models.transformer": {"maybe_scan", "stack_specs"},   # one block a layer
}


def _modules(pkg: str) -> set[str]:
    root = SRC / pkg
    out = set()
    for f in root.rglob("*.py"):
        parts = f.relative_to(root).with_suffix("").parts
        parts = parts[:-1] if parts[-1] == "__init__" else parts
        if parts:
            out.add(".".join(parts))
    return out


SHARED = sorted(_modules("repro") & _modules("repro_torch"))


def _reference(module: str):
    """The reference's ``module``.  ``launch.dryrun`` sets XLA_FLAGS (512
    host devices) when imported: jax's backend starts first, with this
    process's one device, and the variable is put back after."""
    if module != "launch.dryrun":
        return importlib.import_module(f"repro.{module}")
    import jax
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(f"repro.{module}")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _public(mod) -> dict:
    """Public functions, and the public methods and ``__init__`` of public
    classes, defined in ``mod``, by qualified name."""
    out = {}
    for name, obj in vars(mod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
            continue
        if inspect.isfunction(obj):
            out[name] = obj
        elif inspect.isclass(obj):
            out[name] = None
            for mname, m in vars(obj).items():
                if mname.startswith("_") and mname != "__init__":
                    continue
                f = m.__func__ if isinstance(m, (staticmethod, classmethod)) else m
                if inspect.isfunction(f):
                    out[f"{name}.{mname}"] = f
    return out


def _default(d):
    """A default as compared: its repr, any callable as one token (a lambda
    of each package is a different object)."""
    return "<callable>" if callable(d) else repr(d)


def _params(f, skip=()) -> list[tuple]:
    return [(p.name, p.kind, _default(p.default))
            for p in inspect.signature(f).parameters.values()
            if p.name not in skip]


def test_shared_modules_are_found():
    assert len(SHARED) >= 80
    assert {"models.transformer", "serving.serve_step", "models.params",
            "kernels.swa.ops", "core.simulator"} <= set(SHARED)


@pytest.mark.parametrize("module", SHARED)
def test_signatures_match_the_reference(module):
    ref = _reference(module)
    port = importlib.import_module(f"repro_torch.{module}")
    want, got = _public(ref), _public(port)
    assert set(want) - set(got) == MISSING.get(module, set())
    for name in sorted(set(want) & set(got)):
        if want[name] is None:              # a class: its methods follow
            continue
        key = f"{module}.{name}"
        diff = DIFFERENCES.get(key, Diff(""))
        ref_names = set(inspect.signature(want[name]).parameters)
        port_names = set(inspect.signature(got[name]).parameters)
        assert set(diff.dropped) <= ref_names - port_names, key
        assert set(diff.added) <= port_names - ref_names, key
        defaults = {n: _default(d) for n, d in diff.defaults}
        ref_params = [(n, k, defaults.get(n, d))
                      for n, k, d in _params(want[name], diff.dropped)]
        assert _params(got[name], diff.added) == ref_params, key


def test_record_fields_match_the_reference():
    """Every public NamedTuple of a shared module has the reference's
    fields in its order, with its defaults, and only the fields its
    ``DIFFERENCES`` record adds, after them."""
    seen = 0
    for module in SHARED:
        ref = _reference(module)
        port = importlib.import_module(f"repro_torch.{module}")
        for name, obj in vars(ref).items():
            if (name.startswith("_") or not inspect.isclass(obj)
                    or obj.__module__ != ref.__name__
                    or not hasattr(obj, "_fields")):
                continue
            seen += 1
            got = getattr(port, name)
            added = DIFFERENCES.get(f"{module}.{name}", Diff("")).added
            assert got._fields == obj._fields + tuple(added), name
            assert {k: _default(v) for k, v in got._field_defaults.items()
                    if k not in added} == {
                k: _default(v) for k, v in obj._field_defaults.items()}, name
    assert seen >= 5


def test_every_recorded_difference_is_of_a_shared_function():
    """A record left behind by a repair fails here."""
    names = set()
    for module in SHARED:
        names |= {f"{module}.{n}" for n in _public(_reference(module))}
    assert set(DIFFERENCES) <= names
    for key, diff in DIFFERENCES.items():
        assert diff.why and (diff.dropped or diff.added or diff.defaults
                             or diff.contract), key


def test_the_repaired_signatures_behave_as_the_reference():
    """make_decode_step takes greedy=, param_count/param_bytes take
    spec_tree=, LM/EncDecLM take force_unroll by position, and
    EncDecLM.forward takes remat by position."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import params as pr
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.transformer import LM
    from repro_torch.serving.serve_step import make_decode_step
    import torch
    cfg = get_reduced_config("tinyllama-1.1b")
    model = LM(cfg, False, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    specs = model.specs()
    assert pr.param_count(spec_tree=specs) == pr.param_count(specs)
    assert pr.param_bytes(spec_tree=specs, default_dtype="float32") > 0
    step = make_decode_step(model, cfg, greedy=True)
    cache = model.init_cache(1, 8)
    nxt, logits, _ = step(cache, torch.zeros((1, 1), dtype=torch.int64), 0)
    assert nxt.shape == (1, 1) and logits.shape[-1] == cfg.vocab_size
    wcfg = get_reduced_config("whisper-tiny")
    enc = EncDecLM(wcfg, True, device="cpu")
    enc.init(torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 4), dtype=torch.int64)
    frames = torch.zeros((1, 8, wcfg.d_model))
    a, _ = enc(toks, frames, "none")
    b, _ = enc(toks, frames, remat="none")
    assert torch.equal(a, b)
