"""Multi-pod dry run (port of ``repro.launch.dryrun``).

For every (architecture x input-shape) cell and both production meshes
(single pod (data=16, model=16) = 256 ranks, multi-pod (pod=2, data=16,
model=16) = 512 ranks), run the cell's step once as rank 0 of a world of
that many ranks, in one CPU process with no card and no allocation:
  * the world is torch's ``"fake"`` process group: every collective returns
    at once and its payload stays where it is
    (``distributed.collectives.wire_device``);
  * parameters, optimizer moments, inputs and activations are meta tensors,
    each the rank's slice (``tensor_parallel.shard_parameters``; the inputs
    by ``BATCH_LOGICAL``); parameters and moments are laid out by
    ``DEFAULT_RULES`` (each ``"fsdp"`` dim over ``data``, as the
    reference's dry run places them), or ``INFERENCE_RULES`` under
    ``--infer-layout`` (no FSDP), and a rank holds exactly the record's
    ``param_bytes_per_device``;
  * K5 and K6 on meta launch nothing and count the work their launch would
    do (``kernels._build.META``).
Then record, per device:
  * flops: ``FlopCounterMode``'s aten flops plus the kernels' operations;
  * bytes: every aten op's input and output bytes (views and bare
    allocations excepted) plus the kernels' bytes: an unfused upper bound
    of XLA's "bytes accessed", which counts a fusion's operands once;
  * collective bytes, by the reference's op names and per-device convention
    (``analysis/hlo.py``), from the c10d ops the step dispatches;
  * the three roofline terms at the H100's peaks
    (``core/roofline.TpuRooflineTerms``).

What differs from the reference, by design:
  * nothing is compiled: ``compile_s`` is 0, ``lower_s`` the step's time on
    meta, ``memory_analysis`` unavailable, ``hlo_lines`` the number of aten
    ops dispatched and ``remat_duplication`` None;
  * the port has no layer scan and counts every layer as it runs:
    ``scan_correction`` is ``{"applied": False}``;
  * RWKV's WKV recurrence, a loop over the sequence, runs its first step
    alone on meta (``models/rwkv6._wkv_scan``), as XLA's cost analysis
    counts a ``lax.scan`` body once; the record then adds the other
    S - 1 steps analytically (``_wkv_analytic_flops``), as the
    reference's does, so the recurrence is counted once, not twice;
  * FSDP's collectives are placed by hand, not by GSPMD: each layer
    gathers every one of its parameters whole over ``data`` as it runs,
    in the dtype it is held in (f32), where XLA may keep a weight split
    and move activations instead (it looks tokens up in the rank's slice
    of the table, and multiplies by the rank's d_model slice of a K/V
    projection); the decoder-only stack's and whisper's decoder's layers
    run under remat, so their weights are gathered again in the backward
    pass; the tied embedding is gathered twice a step (the lookup and the
    logits); each gathered weight's gradient is reduce-scattered over
    ``data`` once a gather (in f32), and only the other leaves' gradients
    are all-reduced over the batch axes (on the multi-pod mesh the FSDP
    gradients then over ``pod`` alone);
  * the MoE places no ``expert_cap`` split of the activations: where the
    experts do not divide the model axis (granite-moe-3b-a800m's 40 over
    16), the reference's GSPMD splits the dispatched tokens' capacity; the
    port splits each expert's ``d_ff``, where the parameter rules put
    ``model``, and sums the ranks' partial outputs once a layer, after the
    combine (``models/mlp.moe``); a router split over the experts is
    gathered whole, so every rank routes as one device;
  * a decode cell's logits stay split over the vocabulary and its greedy
    token comes from ``tensor_parallel.vocab_parallel_argmax``; the KV
    cache is split as the rules place it (over its positions on both
    meshes), and the collectives are the port's hand-placed ones
    (``models/attention.decode_step``), not GSPMD's;
  * whisper's cross K/V cache is placed by the cross rule, its batch
    over ``data`` (and its frames over ``model`` where they divide):
    the reference's rule reads the path ``['cross_k']`` as the name
    ``['cross_k`` and leaves the cross K/V replicated
    (``sharding.cache_logical``).  On the production meshes its 1,500
    frames and 6 KV heads do not divide 16, so a rank holds its rows'
    whole cross K/V; the decode cell's self cache is split over its
    positions with ``wq`` whole (``attention.decode_step``'s layout (c))
    and the MLP over ``d_ff``.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \
      --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--skip-existing]
Results land in results/dryrun_torch/<arch>__<shape>__<mesh>.json.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from collections import defaultdict
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (SHAPES, ArchConfig, ShapeSpec, cells,
                                 get_config)
from repro_torch.core.roofline import TpuRooflineTerms
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import (DEFAULT_RULES, INFERENCE_RULES,
                                              cache_logical, cache_placements,
                                              mesh_context, mesh_sizes,
                                              named_sharding, tree_shardings)
from repro_torch.kernels import _build
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import params as pr
from repro_torch.models.registry import build_model, input_specs
from repro_torch.serving.serve_step import make_decode_step
from repro_torch.train.optim import OptConfig, init_opt_state
from repro_torch.train.train_step import make_train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

BATCH_LOGICAL = {
    "tokens": ("batch", None),
    "labels": ("batch", None),
    "frames": ("batch", None, None),
    "patches": ("batch", None, None),
    "positions": (None, "batch", None),
}

# c10d op -> the reference's HLO collective name (analysis/hlo.py)
_COLLECTIVE_OPS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
# allocations that touch no byte
_ALLOCATIONS = ("empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided", "empty_permuted")


def _shard(mesh, shape, logical, rules=None) -> tuple:
    return named_sharding(tuple(shape), logical, mesh, rules)


def batch_shardings(mesh, structs: dict) -> dict:
    """Each input's placements on ``mesh``: its batch dim split as
    ``BATCH_LOGICAL`` says."""
    return {k: _shard(mesh, v.shape, BATCH_LOGICAL[k])
            for k, v in structs.items()}


def cache_logical_for(name: str, ndim: int, stacked: bool) -> tuple:
    """``sharding.cache_logical``: the rule serving shares."""
    return cache_logical(name, ndim, stacked)


def cache_shardings(mesh, cache_structs, stacked_names=()) -> Any:
    """The placements of every tensor of a decode cache (same structure;
    any other leaf, a position, kept as it is), each named by its path as
    jax's ``keystr`` writes it (``sharding.cache_placements``).  The port
    keeps one cache a layer (a list), so no leaf is stacked unless its
    path names one of ``stacked_names``."""
    return cache_placements(mesh, cache_structs, stacked_names)


def param_bytes_per_device(structs, shardings, mesh) -> int:
    """Bytes of the parameters a device holds: each leaf of ``structs``
    (meta tensors, :func:`repro_torch.models.params.shape_tree`) divided
    along each dim by the mesh axes that its placements in ``shardings``
    (:func:`tree_shardings`) split it over."""
    sizes = list(mesh_sizes(mesh).values())
    total = 0
    for name, sd in structs.items():
        place = shardings[name]
        if isinstance(sd, dict):
            total += param_bytes_per_device(sd, place, mesh)
            continue
        shape = list(sd.shape)
        for size, p in zip(sizes, place):
            if isinstance(p, Shard):
                shape[p.dim] //= size
        total += math.prod(shape) * sd.element_size()
    return total


def _clone_cfg(cfg: ArchConfig, periods: int) -> ArchConfig:
    """Depth-reduced clone for the scan-cost extrapolation (§scan-correction):
    ``periods`` full pattern periods; lowered force-unrolled."""
    p = len(cfg.block_pattern)
    if cfg.family == "audio":
        return dataclasses.replace(cfg, num_layers=periods,
                                   encoder_layers=periods)
    return dataclasses.replace(cfg, num_layers=p * periods)


def _wkv_analytic_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """RWKV's WKV recurrence is a time-scan (cost-counted once); add the
    analytic (S-1)-step remainder: ~7*n^2 flops /step /head /batch /layer,
    x3 for the train backward."""
    if "rwkv" not in cfg.block_pattern or shape.kind == "decode":
        return 0.0
    n = cfg.resolved_head_dim
    steps = shape.seq_len - 1
    mult = 3.0 if shape.kind == "train" else 1.0
    return (cfg.num_layers * shape.global_batch * steps * cfg.num_heads *
            7 * n * n * mult)


@contextlib.contextmanager
def fake_world(ranks: int):
    """This process as rank 0 of a fake process group of ``ranks`` ranks,
    torn down on exit (the next cell or mesh builds its own)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run opens a fake world of its own; a "
                           "process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for a in x for t in _tensors(a)]
    return []


class StepCounter(TorchDispatchMode):
    """Counts what a step dispatches: aten ops and their bytes (inputs and
    outputs; views, which move nothing, and bare allocations left out), and
    c10d collectives by the reference's HLO names, per device: the payload
    (all-reduce, all-to-all, send and receive), the bytes received
    (all-gather), the input (reduce-scatter: the shard times the
    participants)."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.bytes = 0
        self.coll_bytes: dict[str, int] = defaultdict(int)
        self.coll_counts: dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        if func.namespace == "c10d":
            op = _COLLECTIVE_OPS.get(name, name)
            # the output lists come first; reduce-scatter counts its input
            arg = args[1] if op == "reduce-scatter" else args[0]
            self.coll_bytes[op] += _build.nbytes(*_tensors(arg))
            self.coll_counts[op] += 1
            return out
        if func.namespace != "aten":
            return out
        self.ops += 1
        ret = func._schema.returns
        alias = ret[0].alias_info if len(ret) == 1 else None
        if name in _ALLOCATIONS or (alias is not None and not alias.is_write):
            return out
        self.bytes += _build.nbytes(
            *_tensors(list(args) + list(kwargs.values())), *_tensors(out))
        return out

    def collectives(self) -> dict:
        """``analysis.hlo.collective_bytes``' record: per-device bytes."""
        return {"total_bytes": int(sum(self.coll_bytes.values())),
                "by_op": dict(self.coll_bytes),
                "counts": dict(self.coll_counts)}


def _step(cfg: ArchConfig, shape: ShapeSpec, mesh, model, remat: str):
    """The cell's step on this rank's meta slices; returns (the callable,
    model_flops)."""
    ins = input_specs(cfg, shape)
    batch = {k: tp.shard_of(v, mesh, p)
             for (k, v), p in zip(ins.items(),
                                  batch_shardings(mesh, ins).values())}
    if shape.kind == "train":
        opt = OptConfig()
        params = dict(model.named_parameters())
        state = init_opt_state(params, opt)        # f32 moments, on meta
        fn = make_train_step(model, cfg, opt, remat=remat)
        tokens = shape.global_batch * shape.seq_len
        return (lambda: fn(state, batch),
                6 * cfg.params_billion_estimate() * 1e9 * tokens)
    tokens = shape.global_batch * (shape.seq_len if shape.kind == "prefill"
                                   else 1)
    model_flops = 2 * cfg.params_billion_estimate() * 1e9 * tokens
    if shape.kind == "prefill":
        @torch.no_grad()
        def prefill():
            if cfg.family == "audio":
                return model(batch["tokens"], batch["frames"])[0]
            return model(batch["tokens"], positions=batch.get("positions"),
                         patches=batch.get("patches"))[0]
        return prefill, model_flops
    # under mesh_context: this rank's slice of the whole batch's cache, as
    # cache_shardings places it
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    step_fn = make_decode_step(model, cfg)
    return (lambda: step_fn(cache, batch["tokens"], 0)), model_flops


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             remat: str = "dots", extra_tag: str = "",
             correction: bool = True, infer_layout: bool = False,
             overrides: dict | None = None) -> dict:
    """One cell's record on one production mesh.  ``correction`` is taken
    for the reference's signature: the port counts every layer, so there
    is no scan cost to correct."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    multi = mesh_kind == "multi"
    chips = 512 if multi else 256
    rules = INFERENCE_RULES if infer_layout else DEFAULT_RULES
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        with mesh_context(mesh):
            model = build_model(cfg, device="meta")
            specs = model.specs()
            tp.shard_parameters(model, tp.parameter_layout(model, mesh,
                                                           rules), mesh)
            held = sum(p.numel() * p.element_size()
                       for p in model.parameters())
            step, model_flops = _step(cfg, shape, mesh, model, remat)
            _build.reset_meta()
            counter = StepCounter()
            t0 = time.time()
            with FlopCounterMode(display=False) as flops, counter:
                step()
            lower_s = time.time() - t0
        kernels = _build.meta_work()
        structs = pr.shape_tree(specs, cfg.param_dtype)
        pbytes = param_bytes_per_device(
            structs, tree_shardings(structs, pr.logical_tree(specs), mesh,
                                    rules), mesh)
    if held != pbytes:
        raise RuntimeError(f"a rank holds {held} B of parameters, not the "
                           f"{pbytes} B the rules place on it")

    flops_dev = float(flops.get_total_flops()
                      + sum(k["ops"] for k in kernels.values()))
    bytes_dev = float(counter.bytes
                      + sum(k["bytes"] for k in kernels.values()))
    coll = counter.collectives()
    wkv_extra = _wkv_analytic_flops(cfg, shape)   # global flops
    flops_global = flops_dev * chips + wkv_extra
    terms = TpuRooflineTerms(
        flops=flops_global, hbm_bytes=bytes_dev * chips,
        collective_bytes=coll["total_bytes"] * chips, chips=chips)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": extra_tag,
        "kind": shape.kind, "chips": chips, "ok": True,
        "lower_s": round(lower_s, 2), "compile_s": 0.0,
        "flops_per_device": flops_dev, "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll["total_bytes"],
        "collective_by_op": coll["by_op"],
        "collective_counts": coll["counts"],
        "remat_duplication": None,
        "memory_analysis": {"unavailable": "nothing is compiled: the step "
                            "ran once on meta tensors"},
        "scan_correction": {"applied": False},
        "wkv_analytic_flops": wkv_extra,
        "param_count": pr.param_count(specs),
        "param_bytes_per_device": pbytes,
        "model_flops": model_flops,
        "useful_flops_ratio": (model_flops / flops_global
                               if flops_global else None),
        "roofline": terms.as_dict(),
        "hlo_lines": counter.ops,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--tag", default="")
    ap.add_argument("--infer-layout", action="store_true",
                    help="lay parameters out by INFERENCE_RULES (split "
                         "over model alone, no FSDP gathers) in place of "
                         "DEFAULT_RULES")
    ap.add_argument("--cfg-override", action="append", default=[],
                    help="e.g. --cfg-override num_heads=16")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    todo = cells() if args.all else [(args.arch, args.shape)]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for arch, shape in todo:
        for mk in meshes:
            tag = f"__{args.tag}" if args.tag else ""
            path = os.path.join(args.out, f"{arch}__{shape}__{mk}{tag}.json")
            if args.skip_existing and os.path.exists(path):
                print(f"skip {path}")
                continue
            print(f"=== {arch} x {shape} x {mk} ===", flush=True)
            try:
                ov = {}
                for o in args.cfg_override:
                    k, v = o.split("=", 1)
                    ov[k] = int(v) if v.lstrip("-").isdigit() else v
                rec = run_cell(arch, shape, mk, remat=args.remat,
                               extra_tag=args.tag,
                               infer_layout=args.infer_layout,
                               overrides=ov or None)
            except Exception as e:
                rec = {"arch": arch, "shape": shape, "mesh": mk, "ok": False,
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            status = "OK" if rec.get("ok") else "FAIL " + rec.get("error", "")
            launches = {k: w["launches"]
                        for k, w in _build.meta_work().items()}
            print(f"    -> {status} "
                  f"(lower {rec.get('lower_s', '?')}s, "
                  f"compile {rec.get('compile_s', '?')}s)"
                  + (f" launches {json.dumps(launches)}"
                     if rec.get("ok") and launches else ""), flush=True)


if __name__ == "__main__":
    main()
