"""Wrapper of the hand-written CUDA kernel K7 in ``csrc/simbatch.cu``, which
replaces the reference's batched device loop,
``repro.core.engine.jax_engine._sweep`` (a ``jax.jit`` of ``jax.vmap`` of
``lax.while_loop(_cycle_step)``; no ``pallas_call``).

:func:`pack` lays every lane's compiled tables out unpadded and
concatenated: a 9-int record a node (:data:`NODE_FIELDS`), an ``int4`` a
edge (src, dst, pop flags, capacity clamped to ``_CAPBIG``), the in- and
out-edge lists, the filters' keep bits packed 32 to a word, the imux
patterns and the memory nodes in arbiter order, with a 16-int descriptor
a lane (:data:`LANE_FIELDS`) and its ``(epc, cap4)``.  The values are those
of the reference's padded tables; only the layout differs.  One launch
runs the batch, one block a lane, :func:`plan_threads` threads and
:func:`smem_bytes` of shared memory each; a lane whose state does not fit
the card's shared memory comes back as a ``CudaLoweringError`` value.

:func:`simbatch` launches K7 for lanes on a CUDA device and runs the plain
version (:func:`repro_torch.kernels.simbatch.ref.simbatch_plain`) only for
the CPU.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.core.engine.compile import CompiledPlan
from repro_torch.core.engine.cuda_engine import (_CAPBIG, _CNTBIG,
                                                 MAX_CYCLES,
                                                 CudaLoweringError)
from repro_torch.kernels import _build

# node kind bits and edge flags (csrc/simbatch.cu: kMem ..., kPopFirst ...)
F_MEM, F_SYNC, F_CMP, F_IMUX, F_FLT, F_OUTOPT, F_ACTIVE0 = (
    1, 2, 4, 8, 16, 32, 64)
E_POP_FIRST, E_POP_STATIC = 1, 2
NODE_FIELDS = ("kind", "limit", "sync_exp", "in_start", "in_cnt",
               "out_start", "out_cnt", "aux0", "aux1")
LANE_FIELDS = ("node_off", "edge_off", "in_off", "out_off", "keep_off",
               "pat_off", "mem_off", "nodes", "edges", "n_mem", "n_cmp",
               "threads")
LANE_WIDTH = 16            # int64 words a lane descriptor (kLaneFields)
MAX_THREADS = 1024         # kMaxThreads
ITEMS_PER_THREAD = 2       # nodes or edges a thread owns in a cycle's phase
BARRIERS_PER_CYCLE = 3
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
             + [ctypes.c_void_p] * 8)


def plan_threads(nodes: int, edges: int) -> int:
    """A lane's threads: one per ``ITEMS_PER_THREAD`` of its nodes or edges
    (whichever are more), whole warps, 32 to ``MAX_THREADS``."""
    want = -(-max(nodes, edges) // ITEMS_PER_THREAD)
    return min(MAX_THREADS, max(32, -(-want // 32) * 32))


def smem_bytes(nodes: int, edges: int, n_mem: int) -> int:
    """Shared memory of a lane (csrc/simbatch.cu: carve): int32 qlen and
    maxocc a edge and the sentinel, int32 fires and sel and uint8 active
    and flags a node and the sentinel, the memory nodes' eligibility
    words, one int32 counter."""
    used = 4 * 2 * (edges + 1) + 4 * 2 * (nodes + 1) + 2 * (nodes + 1)
    return -(-used // 4) * 4 + 4 * -(-n_mem // 32) + 4


@dataclasses.dataclass
class Packed:
    """A batch's tables as K7 reads them (host numpy)."""
    lanes: np.ndarray        # (B, LANE_WIDTH) int64
    rates: np.ndarray        # (B, 2) float64: epc, cap4
    node_info: np.ndarray    # (sum(nN + 1), 9) int32
    edge_info: np.ndarray    # (sum(nE + 1), 4) int32
    in_flat: np.ndarray
    out_flat: np.ndarray
    keep: np.ndarray         # uint32 words
    pat: np.ndarray
    mem_flat: np.ndarray
    threads: int             # the widest lane's
    smem: int                # the largest lane's


def _lane_tables(cp: CompiledPlan) -> dict:
    """One lane's unpadded tables, offsets relative to the lane."""
    nN, nE = cp.n_nodes, cp.n_edges
    info = np.zeros((nN + 1, len(NODE_FIELDS)), dtype=np.int64)
    kind = np.zeros(nN + 1, dtype=np.int64)
    kind[cp.mem_ids] |= F_MEM
    kind[cp.sync_ids] |= F_SYNC | F_OUTOPT
    kind[cp.cmp_ids] |= F_CMP | F_OUTOPT
    kind[cp.imux_ids] |= F_IMUX
    kind[cp.flt_ids] |= F_FLT
    kind[:nN][cp.active0] |= F_ACTIVE0
    info[:, 0] = kind
    info[:, 1] = _CNTBIG
    info[cp.addr_ids, 1] = np.clip(cp.addr_cnt, 0, _CNTBIG)
    info[cp.cmp_ids, 1] = 1
    info[:, 2] = _CNTBIG
    info[cp.sync_ids, 2] = np.minimum(cp.sync_exp, _CNTBIG)
    ins: list[int] = []
    for nd in cp.nodes:                    # imux: its ports, in port order
        info[nd.nid, 3] = len(ins)
        ins.extend(e.eid for e in nd.in_edges)
        info[nd.nid, 4] = len(nd.in_edges)
    info[:nN, 5] = cp.out_start[:-1]
    info[:nN, 6] = np.diff(cp.out_start)
    info[cp.flt_ids, 7] = cp.flt_koff
    info[cp.flt_ids, 8] = np.maximum(cp.flt_klen, 1)
    pats = [np.asarray(p, dtype=np.int64) for p in cp.imux_pat]
    starts = np.cumsum([0] + [len(p) for p in pats])
    info[cp.imux_ids, 7] = starts[:-1]
    info[cp.imux_ids, 8] = [len(p) for p in pats]

    edge = np.zeros((nE + 1, 4), dtype=np.int64)
    for e in cp.edges:
        edge[e.eid, :2] = (e.src.nid, e.dst.nid)
        edge[e.eid, 2] = ((E_POP_FIRST if cp.pop_first[e.eid] else 0)
                          | (E_POP_STATIC if e.dst.op != "imux" else 0))
    edge[:nE, 3] = np.minimum(cp.cap[:nE], _CAPBIG)
    keep = np.packbits(cp.keep_flat.astype(bool), bitorder="little")
    keep = np.concatenate([keep, np.zeros(-len(keep) % 4, dtype=np.uint8)])
    return dict(node_info=info, edge_info=edge,
                in_flat=np.asarray(ins, dtype=np.int64),
                out_flat=cp.out_flat, keep=keep.view("<u4"),
                pat=(np.concatenate(pats) if pats
                     else np.zeros(0, dtype=np.int64)),
                mem_flat=cp.mem_ids)


def pack(lanes: list[tuple[CompiledPlan, float]]) -> Packed:
    """Every lane's tables, concatenated, with its descriptor."""
    parts = [_lane_tables(cp) for cp, _ in lanes]
    desc = np.zeros((len(lanes), LANE_WIDTH), dtype=np.int64)
    offs = dict.fromkeys(parts[0], 0)
    for i, ((cp, _), p) in enumerate(zip(lanes, parts)):
        desc[i, :7] = [offs[k] for k in ("node_info", "edge_info", "in_flat",
                                         "out_flat", "keep", "pat",
                                         "mem_flat")]
        desc[i, 7:12] = (cp.n_nodes, cp.n_edges, len(cp.mem_ids), cp.n_cmp,
                         plan_threads(cp.n_nodes, cp.n_edges))
        for k in offs:
            offs[k] += len(p[k])
    cat = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    epc = np.asarray([epc for _, epc in lanes], dtype=np.float64)
    i32 = {k: v.astype(np.int32) for k, v in cat.items() if k != "keep"}
    return Packed(
        lanes=desc, rates=np.stack([epc, 4.0 * epc], axis=1),
        keep=cat["keep"], threads=int(desc[:, 11].max()),
        smem=max(smem_bytes(cp.n_nodes, cp.n_edges, len(cp.mem_ids))
                 for cp, _ in lanes), **i32)


@dataclasses.dataclass
class OnDevice:
    """A packed batch's tables and K7's outputs, as tensors on one card."""
    packed: Packed
    tables: dict
    out: dict


def upload(packed: Packed, device: torch.device) -> OnDevice:
    tables = {k: torch.from_numpy(np.ascontiguousarray(getattr(packed, k)))
              .to(device) for k in ("lanes", "rates", "node_info",
                                    "edge_info", "in_flat", "out_flat",
                                    "keep", "pat", "mem_flat")}
    n_nodes, n_edges = len(packed.node_info), len(packed.edge_info)
    b = len(packed.lanes)
    empty = lambda n, dt: torch.empty(n, dtype=dt, device=device)  # noqa: E731
    out = {"qlen": empty(n_edges, torch.int32),
           "maxocc": empty(n_edges, torch.int32),
           "fires": empty(n_nodes, torch.int32),
           "active": empty(n_nodes, torch.uint8),
           "credit": empty(b, torch.float64),
           "cycles": empty(b, torch.int32),
           "status": empty(b, torch.int32)}
    return OnDevice(packed, tables, out)


def launch(d: OnDevice, max_cycles: int) -> None:
    """One launch of K7 over the batch (on the current stream); the cycle
    counter is int32, so ``max_cycles`` is clamped to ``MAX_CYCLES``."""
    t, o, p = d.tables, d.out, d.packed

    def ptr(x):       # an empty table: a valid pointer the kernel never reads
        return x.data_ptr() if x.numel() else o["credit"].data_ptr()

    with torch.cuda.device(o["credit"].device):
        _build.launch(
            "simbatch", "simbatch", _ARGTYPES,
            *(ptr(t[k]) for k in ("lanes", "rates", "node_info", "edge_info",
                                  "in_flat", "out_flat", "keep", "pat",
                                  "mem_flat")),
            len(p.lanes), p.threads, p.smem,
            min(max(int(max_cycles), 0), MAX_CYCLES),
            *(o[k].data_ptr() for k in ("qlen", "maxocc", "fires", "active",
                                        "credit", "cycles", "status")),
            _build.stream_handle(o["credit"].device))


def unpack(d: OnDevice) -> list[dict]:
    """Each lane's final carry (numpy; qlen/maxocc nE + 1 long, fires/active
    nN + 1)."""
    o = {k: v.cpu().numpy() for k, v in d.out.items()}
    lanes = []
    cols = [LANE_FIELDS.index(k) for k in ("node_off", "edge_off", "nodes",
                                           "edges")]
    for i, (no, eo, nN, nE) in enumerate(d.packed.lanes[:, cols].tolist()):
        lanes.append({"qlen": o["qlen"][eo:eo + nE + 1],
                      "maxocc": o["maxocc"][eo:eo + nE + 1],
                      "fires": o["fires"][no:no + nN + 1],
                      "active": o["active"][no:no + nN + 1].astype(bool),
                      "credit": o["credit"][i], "cycles": o["cycles"][i],
                      "status": o["status"][i]})
    return lanes


def simbatch(lanes: list[tuple[CompiledPlan, float]], max_cycles: int,
             device) -> list[dict | CudaLoweringError]:
    """Every lane's cycle loop to its fixed point: one launch of K7 on a
    CUDA ``device``; the plain version on the CPU.  ``lanes``:
    ``(compiled_plan, elems_per_cycle)`` pairs.  Returns each lane's final
    carry as a dict, or a ``CudaLoweringError`` value for a lane whose
    state does not fit one block's shared memory on the card."""
    device = torch.device(device)
    if device.type == "cpu":
        from repro_torch.kernels.simbatch.ref import simbatch_plain
        return simbatch_plain(lanes, max_cycles, device)
    if device.type != "cuda":
        raise ValueError(f"simbatch runs on a CUDA device or the CPU, not "
                         f"{device}")
    if not torch.cuda.is_available():
        raise RuntimeError("engine='cuda' needs a CUDA device and "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' for the plain version")
    limit = _build.smem_per_block(device)
    out: list = [None] * len(lanes)
    fit = []
    for i, (cp, epc) in enumerate(lanes):
        need = smem_bytes(cp.n_nodes, cp.n_edges, len(cp.mem_ids))
        if need > limit:
            out[i] = CudaLoweringError(
                f"lane of {cp.n_nodes} nodes and {cp.n_edges} edges needs "
                f"{need} B of shared memory; the card allows {limit} B per "
                "block")
        else:
            fit.append(i)
    if fit:
        d = upload(pack([lanes[i] for i in fit]), device)
        launch(d, max_cycles)
        for i, lane in zip(fit, unpack(d)):
            out[i] = lane
    return out


def barrier_ms(threads: int, barriers: int, device, reps: int = 5) -> float:
    """Median CUDA-event time (ms) of the barrier-only instance: one block
    of ``threads`` passing ``barriers`` barriers (not counted as a launch
    of K7)."""
    lib = _build.library("simbatch")
    fn = lib.simbatch_barrier_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sink = torch.empty(1, dtype=torch.int32, device=device)
    times = []
    for _ in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = fn(threads, barriers, sink.data_ptr(),
                 _build.stream_handle(sink.device))
        end.record()
        if err:
            raise RuntimeError(f"simbatch barrier instance failed to launch: "
                               f"CUDA error {err}")
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times[1:]))
