"""Wrapper of the hand-written CUDA kernel K7 in ``csrc/simbatch.cu``, which
replaces the reference's batched device loop,
``repro.core.engine.jax_engine._sweep`` (a ``jax.jit`` of ``jax.vmap`` of
``lax.while_loop(_cycle_step)``; no ``pallas_call``).

:func:`pack` lays every lane's compiled tables out unpadded and
concatenated: an ``int4`` a node (:data:`NODE_FIELDS`: kind, fire limit
and two aux words), an ``int4`` a edge (src, dst, pop flags, capacity
clamped to ``_CAPBIG``), the filters' keep bits packed 32 to a word, the
imux patterns as the edges they select, the memory nodes in arbiter order
and the other nodes grouped by kind (the node owners' slots), with a
16-int descriptor a lane (:data:`LANE_FIELDS`) and its ``(epc, cap4)``.
The values are those of the reference's padded tables; only the layout
differs.  One launch runs the batch, one block a lane, with one ``ITEMS``
instance (the largest that :func:`plan` gives a lane: warp 0 arbitrates
the memory nodes, every other thread owns ``ITEMS`` node slots, every
thread ``ITEMS`` edges, in registers), each lane at its own thread count
and with :func:`smem_bytes` of shared memory; a lane whose state does not
fit the card's shared memory comes back as a ``CudaLoweringError`` value.

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
# aux0, aux1: sync (expected count, -), filter (keep-bit offset, count),
# imux (pattern offset, length)
NODE_FIELDS = ("kind", "limit", "aux0", "aux1")
LANE_FIELDS = ("node_off", "edge_off", "keep_off", "pat_off", "mem_off",
               "order_off", "nodes", "edges", "n_mem", "threads")
LANE_WIDTH = 16            # int64 words a lane descriptor (kLaneFields)
# ITEMS instance -> the most threads it runs (csrc/simbatch.cu:
# SIMBATCH_INSTANCES): as many as keep a thread's records in registers; 32
# (the widest lanes') spills to local memory.  A batch runs at the largest
# instance any of its lanes needs.
INSTANCES = {1: 1024, 4: 768, 32: 1024}
ARBITER = 32               # warp 0's threads: the memory arbiter, no nodes
BARRIERS_PER_CYCLE = 2
# the clocked instance's record of a lane (csrc/simbatch.cu: cNode ...):
# clock64() sums a phase, the loop's clocks, %globaltimer ns at start, end
PHASES = ("node", "arbiter", "bar_or", "edge", "bar_end")
CLOCK_FIELDS = PHASES + ("total", "start_ns", "end_ns")
CLOCK_WIDTH = len(CLOCK_FIELDS)   # int64 words a lane's record (kClockFields)
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
             + [ctypes.c_void_p] * 9)


def smem_bytes(nodes: int, edges: int, n_mem: int) -> int:
    """Shared memory of a lane (csrc/simbatch.cu: carve), all int32: qlen a
    edge and the sentinel, sel and a word (flags, starved, blocked) a node
    and the sentinel, node id and fires left a memory slot, the memory
    nodes' eligibility words."""
    return (4 * (edges + 1) + 8 * (nodes + 1) + 8 * n_mem
            + 4 * -(-n_mem // 32))


def lane_threads(nodes: int, edges: int, n_mem: int, items: int) -> int:
    """A lane's threads under the ``items`` instance: warp 0 (the memory
    arbiter) and one thread per ``items`` of its other nodes, or one per
    ``items`` of its edges if that is more, in whole warps."""
    def warps(n: int) -> int:          # threads for n items, whole warps
        per = -(-n // items)
        return -(-per // 32) * 32
    return max(ARBITER + warps(nodes - n_mem), warps(edges), 2 * ARBITER)


@dataclasses.dataclass(frozen=True)
class Plan:
    """A lane's launch: the ``ITEMS`` instance, threads, shared memory."""
    items: int
    threads: int
    smem: int


def plan(nodes: int, edges: int, n_mem: int) -> Plan | None:
    """The smallest instance whose threads hold the lane: one node and one
    edge a thread up to 1,024 threads (``None`` past 32 x 1,024)."""
    for items, most in sorted(INSTANCES.items()):
        t = lane_threads(nodes, edges, n_mem, items)
        if t <= most:
            return Plan(items, t, smem_bytes(nodes, edges, n_mem))
    return None


@dataclasses.dataclass
class Packed:
    """A batch's tables as K7 reads them (host numpy)."""
    lanes: np.ndarray        # (B, LANE_WIDTH) int64
    rates: np.ndarray        # (B, 2) float64: epc, cap4
    node_info: np.ndarray    # (sum(nN + 1), 4) int32
    edge_info: np.ndarray    # (sum(nE + 1), 4) int32
    keep: np.ndarray         # uint32 words
    pat: np.ndarray          # edge ids
    mem_flat: np.ndarray
    order: np.ndarray        # non-memory node ids, grouped by kind
    items: int               # the instance: ITEMS nodes and edges a thread
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
    info[cp.sync_ids, 2] = np.minimum(cp.sync_exp, _CNTBIG)
    info[cp.flt_ids, 2] = cp.flt_koff
    info[cp.flt_ids, 3] = np.maximum(cp.flt_klen, 1)
    # an imux's pattern as the in-edges it selects (the sentinel nE for a
    # port past its in-edges: never empty)
    in_edges = {nd.nid: [e.eid for e in nd.in_edges] for nd in cp.nodes}
    pats = [np.asarray([in_edges[n][p] if p < len(in_edges[n]) else nE
                        for p in np.asarray(pt).tolist()], dtype=np.int64)
            for n, pt in zip(cp.imux_ids.tolist(), cp.imux_pat)]
    starts = np.cumsum([0] + [len(p) for p in pats])
    info[cp.imux_ids, 2] = starts[:-1]
    info[cp.imux_ids, 3] = [len(p) for p in pats]

    edge = np.zeros((nE + 1, 4), dtype=np.int64)
    for e in cp.edges:
        edge[e.eid, :2] = (e.src.nid, e.dst.nid)
        edge[e.eid, 2] = ((E_POP_FIRST if cp.pop_first[e.eid] else 0)
                          | (E_POP_STATIC if e.dst.op != "imux" else 0))
    edge[:nE, 3] = np.minimum(cp.cap[:nE], _CAPBIG)
    keep = np.packbits(cp.keep_flat.astype(bool), bitorder="little")
    keep = np.concatenate([keep, np.zeros(-len(keep) % 4, dtype=np.uint8)])
    # the node owners' slots: the non-memory nodes, grouped by kind so that
    # a warp's nodes mostly take one path
    group = kind[:nN] & (F_FLT | F_SYNC | F_IMUX | F_CMP)
    order = np.argsort(group, kind="stable")
    return dict(node_info=info, edge_info=edge, keep=keep.view("<u4"),
                pat=(np.concatenate(pats) if pats
                     else np.zeros(0, dtype=np.int64)),
                mem_flat=cp.mem_ids,
                order=order[(kind[:nN] & F_MEM)[order] == 0])


def pack(lanes: list[tuple[CompiledPlan, float]],
         items: int | None = None) -> Packed:
    """Every lane's tables, concatenated, with its descriptor, for one
    launch of the ``items`` instance (by default the largest that
    :func:`plan` gives a lane; a lane that a forced instance cannot hold is
    a ``ValueError``)."""
    sizes = [(cp.n_nodes, cp.n_edges, len(cp.mem_ids)) for cp, _ in lanes]
    if items is None:
        plans = [plan(*sz) for sz in sizes]
        if None in plans:
            raise ValueError("a lane has more nodes or edges than any K7 "
                             "instance holds")
        items = max(p.items for p in plans)
    threads = [lane_threads(n, e, m, items) for n, e, m in sizes]
    if items not in INSTANCES or max(threads) > INSTANCES[items]:
        raise ValueError(f"K7's ITEMS = {items} instance cannot hold a lane "
                         f"of {max(threads)} threads (instances: "
                         f"{INSTANCES})")
    parts = [_lane_tables(cp) for cp, _ in lanes]
    desc = np.zeros((len(lanes), LANE_WIDTH), dtype=np.int64)
    offs = dict.fromkeys(parts[0], 0)
    for i, ((n, e, m), t, p) in enumerate(zip(sizes, threads, parts)):
        desc[i, :6] = [offs[k] for k in ("node_info", "edge_info", "keep",
                                         "pat", "mem_flat", "order")]
        desc[i, 6:10] = (n, e, m, t)
        for k in offs:
            offs[k] += len(p[k])
    cat = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    epc = np.asarray([epc for _, epc in lanes], dtype=np.float64)
    i32 = {k: v.astype(np.int32) for k, v in cat.items() if k != "keep"}
    return Packed(
        lanes=desc, rates=np.stack([epc, 4.0 * epc], axis=1),
        keep=cat["keep"], items=items, threads=max(threads),
        smem=max(smem_bytes(*sz) for sz in sizes), **i32)


_TABLES = ("lanes", "rates", "node_info", "edge_info", "keep", "pat",
           "mem_flat", "order")


@dataclasses.dataclass
class OnDevice:
    """A packed batch's tables and K7's outputs, as tensors on one card."""
    packed: Packed
    tables: dict
    out: dict


def upload(packed: Packed, device: torch.device) -> OnDevice:
    tables = {k: torch.from_numpy(np.ascontiguousarray(getattr(packed, k)))
              .to(device) for k in _TABLES}
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


def launch(d: OnDevice, max_cycles: int,
           clocks: torch.Tensor | None = None) -> None:
    """One launch of K7 over the batch (on the current stream); the cycle
    counter is int32, so ``max_cycles`` is clamped to ``MAX_CYCLES``.
    With ``clocks`` (int64, ``(lanes, CLOCK_WIDTH)`` on the card) the
    clocked instance runs instead and fills it (:data:`CLOCK_FIELDS`); it
    is counted as ``simbatch_clocked``, never as K7."""
    t, o, p = d.tables, d.out, d.packed
    if clocks is not None and (
            clocks.dtype != torch.int64 or not clocks.is_contiguous()
            or clocks.device != o["credit"].device
            or clocks.numel() < len(p.lanes) * CLOCK_WIDTH):
        raise ValueError(f"clocks must be a contiguous int64 tensor of "
                         f"{len(p.lanes) * CLOCK_WIDTH} values on "
                         f"{o['credit'].device}")

    def ptr(x):       # an empty table: a valid pointer the kernel never reads
        return x.data_ptr() if x.numel() else o["credit"].data_ptr()

    with torch.cuda.device(o["credit"].device):
        _build.launch(
            "simbatch" if clocks is None else "simbatch_clocked", "simbatch",
            _ARGTYPES,
            *(ptr(t[k]) for k in _TABLES),
            len(p.lanes), p.items, p.threads, p.smem,
            min(max(int(max_cycles), 0), MAX_CYCLES),
            *(o[k].data_ptr() for k in ("qlen", "maxocc", "fires", "active",
                                        "credit", "cycles", "status")),
            None if clocks is None else clocks.data_ptr(),
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
    state does not fit one block's shared memory on the card (or that has
    more nodes or edges than any instance holds)."""
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
        p = plan(cp.n_nodes, cp.n_edges, len(cp.mem_ids))
        if p is None or p.smem > limit:
            out[i] = CudaLoweringError(
                f"lane of {cp.n_nodes} nodes and {cp.n_edges} edges needs "
                f"{smem_bytes(cp.n_nodes, cp.n_edges, len(cp.mem_ids))} B "
                f"of shared memory and {max(cp.n_nodes, cp.n_edges)} items; "
                f"the card allows {limit} B per block and K7 holds "
                f"{max(k * t for k, t in INSTANCES.items())}")
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
