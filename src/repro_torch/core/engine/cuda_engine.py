"""CUDA engine: the compiled cycle loop run to its fixed point on the card,
one thread block per lane, one launch per batch.

The third backend (``simulate(..., engine="cuda")``), the counterpart of
``repro.core.engine.jax_engine``.  The vector engine lowers a DFG to
struct-of-arrays tables and runs each cycle as a handful of dense numpy
passes; this module hands those tables to K7 (``csrc/simbatch.cu``,
:mod:`repro_torch.kernels.simbatch`), a hand-written kernel that runs the
whole fixed-point loop (all ``cmp`` nodes fired, deadlock, or
``max_cycles``) of every lane of a batch in one launch, so the auto-tuner's
stage-1 ideal sweep is one device call instead of B sequential
``vector.run`` calls (``repro_torch.explore.search``, ``Budget.batch_size``).

**Timing/value decoupling.**  The firing rule is value-independent: whether
a node fires depends only on queue *lengths*, counters and the memory
credit, never on token values.  The device loop therefore carries only
small integer state — ``qlen`` per edge, ``active``/``fires`` per node,
``maxocc`` per edge, the float64 memory credit, the cycle counter and a
status code — and no ring-buffer pool at all.  Output values are produced
afterwards by a bit-exact numpy *value pass* over the DFG in topo order
(each node's whole token stream as one array op, stores written in
address-stream order), using the same float64 expressions as the other two
engines, so output grids match bitwise.

**Per-node counters collapse into ``fires``.**  Every auxiliary counter the
vector engine keeps (addr index, filter position, sync count, imux pattern
index) equals the node's fire count, so the carry holds one array and the
step *derives* filter keep bits, imux port selection and sync emission
from it each cycle.

**Two layouts of the same tables.**  :func:`lower` pads a plan to shared
dims as the reference does (node index ``N`` and edge index ``E`` are
sentinels: the sentinel node is never active, the sentinel edge reads
"never empty, never full"); the dims are the lanes' largest natural ones,
which the reference also rounds up so that jax compiles fewer shapes.  The
plain version (:mod:`repro_torch.kernels.simbatch.ref`) steps those
stacked tables, lane by lane in lockstep, as the reference's ``vmap``
does.  K7 takes each lane's own tables unpadded
(``kernels/simbatch/kernel.py:pack``: in- and out-edge lists, the filters'
keep bits packed, the imux patterns), since a padded keep matrix alone
reaches 21 MB a lane at the paper's 2D size.  The values are the same;
only the layout differs.

Not supported here (use ``engine="vector"``): network-aware mode
(``fabric=``) and telemetry sinks.  ``run`` raises ``NotImplementedError``
for those; the tuner routes stage-2 finalists through the vector engine.

Determinism: everything is integer except the memory credit, which is
float64 on the host and on the card (``elems_per_cycle`` ≈ 10.41̅6 on the
paper CGRA), so the credit walk is bit-identical to the other engines'
python-float walk: for f64 ``x >= 1``, ``x - 1.0`` is exact, hence
subtracting the fired count equals the interpreter's repeated ``-= 1.0``.

``device``: ``None`` is the card (``"cuda"``), which raises where there is
none; ``"cpu"`` runs the plain version.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.engine.common import RawStats, SimDeadlock
from repro_torch.core.engine.compile import (CompiledPlan, _keep_array,
                                             compiled_for)
from repro_torch.telemetry.probe import (ST_INACTIVE, ST_INPUT_STARVED,
                                         ST_MEM_ARB, ST_OUTPUT_BLOCKED,
                                         format_stall_summary,
                                         summary_from_state)

__all__ = ["SEMANTICS", "CudaLoweringError", "run", "run_compiled_batch"]

#: semantics version of this lowering — part of the EvalCache scope key so
#: batched-cuda measurements can never be replayed as vector ones (or vice
#: versa) across a semantics bump.  Bump on any change to the cycle step.
SEMANTICS = "cuda-batch/v1"

# status codes of the loop's carry
_RUNNING, _FINISHED, _DEADLOCKED = 0, 1, 2

_QBIG = 1 << 29          # sentinel/pad queue length: "never empty"
_CAPBIG = 1 << 30        # clamped UNBOUNDED capacity: "never full" (> _QBIG)
_CNTBIG = 1 << 30        # "never reached" fire limits / sync expectations
MAX_CYCLES = (1 << 31) - 2   # the int32 cycle counter's ceiling


class CudaLoweringError(NotImplementedError):
    """The plan uses a feature the cuda engine does not express (network
    mode, telemetry, stale tables, or a lane whose state does not fit one
    block's shared memory).  Callers that batch (the tuner) get this per
    lane as a value and fall back to the vector engine."""


# ---------------------------------------------------------------------------
# lowering: CompiledPlan -> padded numpy tables (the plain version's input)


@dataclasses.dataclass
class LoweredPlan:
    """One plan's padded array tables (numpy, host-side) plus the metadata
    the finalizer needs.  ``dims`` is the shared padded shape tuple."""
    cp: CompiledPlan
    dims: tuple
    tables: dict


def _natural_dims(cp: CompiledPlan) -> tuple:
    # (N, E, IN, OUT, M, F, KL, X, PL, P, C, INC).  IN deliberately
    # excludes cmp and imux in-degrees (both O(workers)): cmp eligibility
    # runs over its own tiny (C, INC) matrix and imux over the
    # dynamically-selected port, so the (N+1, IN) gather stays at the
    # compute-node fan-in (<= 2 for this op vocabulary).
    in_main, inc = 1, 1
    for nd in cp.nodes:
        d = len(nd.in_edges)
        if nd.op == "cmp":
            inc = max(inc, d)
        elif nd.op != "imux":
            in_main = max(in_main, d)
    return (cp.n_nodes, cp.n_edges,
            in_main, cp.out_mat.shape[1],
            max(1, len(cp.mem_ids)), max(1, len(cp.flt_ids)),
            max(1, int(cp.flt_klen.max()) if len(cp.flt_ids) else 1),
            max(1, len(cp.imux_ids)),
            max(1, max((len(p) for p in cp.imux_pat), default=1)),
            max(1, max((len(p) for p in cp.imux_port_eids), default=1)),
            max(1, len(cp.cmp_ids)), inc)


def shared_dims(cps: list[CompiledPlan]) -> tuple:
    """Elementwise max of every plan's natural dims."""
    return tuple(map(max, zip(*(_natural_dims(cp) for cp in cps))))


def lower(cp: CompiledPlan, dims: tuple | None = None) -> LoweredPlan:
    """Lower one compiled plan into padded pure-array tables (see the
    module docstring for the sentinel/padding rules)."""
    if cp.net is not None:
        raise CudaLoweringError(
            "engine='cuda' is ideal-mode only (no network-aware simulation); "
            "use engine='vector' for routed plans")
    dims = dims or shared_dims([cp])
    N, E, IN, OUT, M, F, KL, X, PL, P, C, INC = dims
    nN, nE = cp.n_nodes, cp.n_edges
    if any(a > b for a, b in zip(_natural_dims(cp), dims)):
        raise CudaLoweringError(f"plan dims {_natural_dims(cp)} exceed "
                                f"padded dims {dims}")
    i32 = np.int32

    def remap(a):                          # actual sentinel nE -> padded E
        return np.where(a == nE, E, a).astype(i32)

    # narrow in-matrix: compute-node fan-in only.  imux rows stay
    # all-sentinel (their one live port is tested via ``sel_edge``) and cmp
    # rows live in their own (C, INC) matrix; both fold back into in_ok by
    # gathers through static slot tables.
    in_mat = np.full((N + 1, IN), E, dtype=i32)
    cmp_in = np.full((C, INC), E, dtype=i32)
    cmp_slot = np.full(N + 1, C, dtype=i32)
    ci = 0
    for nd in cp.nodes:
        eids = [e.eid for e in nd.in_edges]
        if nd.op == "cmp":
            cmp_slot[nd.nid] = ci
            cmp_in[ci, :len(eids)] = remap(np.asarray(eids, dtype=i32))
            ci += 1
        elif nd.op != "imux" and eids:
            in_mat[nd.nid, :len(eids)] = remap(np.asarray(eids, dtype=i32))
    out_mat = np.full((N + 1, OUT), E, dtype=i32)
    out_mat[:nN, :cp.out_mat.shape[1]] = remap(cp.out_mat)
    capmat = np.full((N + 1, OUT), _CAPBIG, dtype=i32)
    capmat[:nN, :cp.capmat.shape[1]] = np.minimum(cp.capmat,
                                                  _CAPBIG).astype(i32)

    active0 = np.zeros(N + 1, dtype=bool)
    active0[:nN] = cp.active0
    out_opt_static = np.zeros(N + 1, dtype=bool)
    out_opt_static[cp.sync_ids] = True
    out_opt_static[cp.cmp_ids] = True
    is_mem = np.zeros(N + 1, dtype=bool)
    is_mem[cp.mem_ids] = True
    is_sync = np.zeros(N + 1, dtype=bool)
    is_sync[cp.sync_ids] = True
    is_cmp = np.zeros(N + 1, dtype=i32)
    is_cmp[cp.cmp_ids] = 1
    sync_exp = np.full(N + 1, _CNTBIG, dtype=i32)
    sync_exp[cp.sync_ids] = np.minimum(cp.sync_exp, _CNTBIG)
    limit = np.full(N + 1, _CNTBIG, dtype=i32)
    limit[cp.addr_ids] = np.clip(cp.addr_cnt, 0, _CNTBIG)
    limit[cp.cmp_ids] = 1

    esrc = np.full(E + 1, N, dtype=i32)
    edst = np.full(E + 1, N, dtype=i32)    # pads/sentinel -> never-firing N
    epop_static = np.zeros(E + 1, dtype=bool)
    for e in cp.edges:
        esrc[e.eid] = e.src.nid
        edst[e.eid] = e.dst.nid
        # every edge has exactly one consumer, so pops are per-edge tests:
        # a non-imux dst consumes all its in-edges on fire; an imux dst
        # only the per-cycle selected port (checked against sel_edge)
        epop_static[e.eid] = e.dst.op != "imux"
    pop_first = np.zeros(E + 1, dtype=bool)
    pop_first[:nE] = cp.pop_first[:nE]
    qlen0 = np.zeros(E + 1, dtype=i32)
    qlen0[nE:] = _QBIG                     # pads + sentinel: never empty

    mem_ids = np.full(M, N, dtype=i32)
    mem_ids[:len(cp.mem_ids)] = cp.mem_ids
    # static node -> bucket-slot tables (pad slot = bucket length): the
    # step extends each per-bucket result with one neutral pad entry and
    # gathers it back per node, instead of scattering into a node array
    mem_slot = np.full(N + 1, M, dtype=i32)
    mem_slot[cp.mem_ids] = np.arange(len(cp.mem_ids), dtype=i32)
    flt_slot = np.full(N + 1, F, dtype=i32)
    flt_slot[cp.flt_ids] = np.arange(len(cp.flt_ids), dtype=i32)
    imux_slot = np.full(N + 1, X, dtype=i32)
    imux_slot[cp.imux_ids] = np.arange(len(cp.imux_ids), dtype=i32)

    flt_ids = np.full(F, N, dtype=i32)
    flt_klen = np.ones(F, dtype=i32)
    keep_mat = np.zeros((F, KL), dtype=bool)
    for j, nid in enumerate(cp.flt_ids):
        flt_ids[j] = nid
        kl = max(1, int(cp.flt_klen[j]))   # 0-length keeps were padded to 1
        flt_klen[j] = kl
        off = int(cp.flt_koff[j])
        keep_mat[j, :kl] = cp.keep_flat[off:off + kl]

    imux_ids = np.full(X, N, dtype=i32)
    imux_pat = np.zeros((X, PL), dtype=i32)
    imux_plen = np.ones(X, dtype=i32)
    imux_ports = np.full((X, P), E, dtype=i32)
    for j, nid in enumerate(cp.imux_ids):
        imux_ids[j] = nid
        pat = cp.imux_pat[j]
        imux_pat[j, :len(pat)] = pat
        imux_plen[j] = len(pat)
        imux_ports[j, :len(cp.imux_port_eids[j])] = remap(
            cp.imux_port_eids[j])

    tables = dict(
        in_mat=in_mat, out_mat=out_mat, capmat=capmat, qlen0=qlen0,
        cmp_in=cmp_in, cmp_slot=cmp_slot,
        active0=active0, out_opt_static=out_opt_static, is_mem=is_mem,
        is_sync=is_sync, is_cmp=is_cmp, sync_exp=sync_exp,
        limit=limit, esrc=esrc, edst=edst, epop_static=epop_static,
        pop_first=pop_first, mem_ids=mem_ids, mem_slot=mem_slot,
        n_mem=np.int32(max(1, len(cp.mem_ids))),
        n_cmp=np.int32(cp.n_cmp),
        flt_ids=flt_ids, flt_slot=flt_slot, flt_klen=flt_klen,
        keep_mat=keep_mat,
        imux_ids=imux_ids, imux_slot=imux_slot, imux_pat=imux_pat,
        imux_plen=imux_plen, imux_ports=imux_ports)
    return LoweredPlan(cp=cp, dims=dims, tables=tables)


# ---------------------------------------------------------------------------
# host-side finalization: numpy value pass + diagnostics


def _value_pass(cp: CompiledPlan, flat_in, flat_out) -> None:
    """Bit-exact output values for a *finished* run, computed per node as
    whole token streams in topo order.  Uses the same float64 expressions
    as the scalar/vector engines (``1.0*p + coeff*q`` etc.), and writes
    stores through fancy indexing in address-stream order, so duplicate
    addresses resolve last-wins exactly like sequential store fires."""
    stream: dict[int, np.ndarray] = {}
    for nd in cp.g.topo_order():
        ins = [stream[e.src.nid] for e in nd.in_edges]
        op, p = nd.op, nd.params
        if op == "addr":
            s = np.arange(max(0, int(p["count"])), dtype=np.float64)
        elif op == "load":
            idx = np.asarray(p["indices"], dtype=np.int64)
            s = flat_in[idx[ins[0].astype(np.int64)]]
        elif op == "store":
            idx = np.asarray(p["indices"], dtype=np.int64)
            n = min(len(ins[0]), len(ins[1]))
            flat_out[idx[ins[0][:n].astype(np.int64)]] = ins[1][:n]
            s = np.ones(n, dtype=np.float64)
        elif op == "mul":
            s = float(p["coeff"]) * ins[0]
        elif op == "mac":
            n = min(len(ins[0]), len(ins[1]))
            s = 1.0 * ins[0][:n] + float(p["coeff"]) * ins[1][:n]
        elif op == "add":
            n = min(len(ins[0]), len(ins[1]))
            s = 1.0 * ins[0][:n] + 1.0 * ins[1][:n]
        elif op == "filter":
            s = ins[0][_keep_array(nd, len(ins[0]))]
        elif op == "sync":
            s = np.ones(1, dtype=np.float64)
        elif op == "cmp":
            s = np.zeros(0, dtype=np.float64)
        elif op == "imux":
            pat = np.asarray(p["pattern"], dtype=np.int64)
            T = sum(len(v) for v in ins)
            order = np.resize(pat, T) if T else pat[:0]
            s = np.empty(T, dtype=np.float64)
            for port, v in enumerate(ins):
                at = np.nonzero(order == port)[0]
                s[at[:len(v)]] = v
        else:                              # copy/mux/demux pass-throughs
            s = 1.0 * ins[0]
        stream[nd.nid] = s


def _final_state_summary(cp: CompiledPlan, qlen_full, active, fires) -> dict:
    """The vector engine's final-cycle stall classification, recomputed on
    the host from the frozen carry (nothing fired in the deadlock cycle, so
    the final state *is* that cycle's snapshot)."""
    nN = cp.n_nodes
    emat = cp.in_mat.copy()
    for j, nid in enumerate(cp.imux_ids):
        pat = cp.imux_pat[j]
        port = pat[int(fires[nid]) % len(pat)]
        emat[nid, 0] = cp.imux_port_eids[j][port]
    out_opt = np.zeros(nN, dtype=bool)
    out_opt[cp.sync_ids] = True
    out_opt[cp.cmp_ids] = True
    for j, nid in enumerate(cp.flt_ids):
        k = int(fires[nid])
        if k < int(cp.flt_klen[j]):
            keep = bool(cp.keep_flat[int(cp.flt_koff[j]) + k])
        else:                              # past the analytic horizon
            keep = bool(cp.flt_nodes[j].params["keep"](k))
        out_opt[nid] = not keep
    in_ok = (qlen_full[emat] > 0).all(axis=1)
    out_ok = (qlen_full[cp.out_mat] < cp.capmat).all(axis=1)
    elig = in_ok & (out_ok | out_opt) & active[:nN]
    state = np.full(nN, ST_INACTIVE, dtype=np.int64)
    rest = active[:nN]
    state[rest & ~in_ok] = ST_INPUT_STARVED
    state[rest & in_ok & ~elig] = ST_OUTPUT_BLOCKED
    state[rest & elig] = ST_MEM_ARB
    names, ops = [""] * nN, [""] * nN
    for nd in cp.nodes:
        names[nd.nid] = nd.name
        ops[nd.nid] = nd.op
    return summary_from_state(state, names, ops)


def _deadlock_msg(cp: CompiledPlan, qlen_full, cycles: int) -> str:
    stuck = []
    for nd in cp.nodes:
        ine = [int(qlen_full[e.eid]) for e in nd.in_edges]
        if any(ine):
            outfull = [e.capacity is not None
                       and int(qlen_full[e.eid]) >= e.capacity
                       for e in nd.out_edges]
            stuck.append(f"{nd.name}({nd.op}) in={ine} outfull={outfull}")
        if len(stuck) >= 8:
            break
    return f"deadlock at cycle {cycles}; sample blocked nodes: {stuck}"


def _finalize(cp: CompiledPlan, flat_in, flat_out, lane: dict,
              max_cycles: int) -> RawStats | SimDeadlock:
    nN, nE = cp.n_nodes, cp.n_edges
    fires = lane["fires"][:nN].astype(np.int64)
    cycles = int(lane["cycles"])
    status = int(lane["status"])
    if status != _FINISHED:
        # reconstruct the full-length qlen the diagnostics index by eid
        qlen_full = np.concatenate(
            [lane["qlen"][:nE].astype(np.int64), [1 << 60]])
        if status == _RUNNING:
            return SimDeadlock(f"exceeded max_cycles={max_cycles}",
                               cycles=cycles, timed_out=True)
        summ = _final_state_summary(cp, qlen_full, lane["active"], fires)
        return SimDeadlock(_deadlock_msg(cp, qlen_full, cycles)
                           + format_stall_summary(summ),
                           cycles=cycles, stall_summary=summ)

    _value_pass(cp, flat_in, flat_out)

    fires_by_op: dict[str, int] = {}
    for nd in cp.nodes:
        f = int(fires[nd.nid])
        if f:
            nd.fires += f
            fires_by_op[nd.op] = fires_by_op.get(nd.op, 0) + f
    maxocc = lane["maxocc"][:nE].astype(np.int64)
    for e in cp.edges:
        mo = int(maxocc[e.eid])
        if mo > e.max_occupancy:
            e.max_occupancy = mo
    loads = int(fires[cp.mem_ids[cp.is_load]].sum()) if len(cp.mem_ids) else 0
    stores = (int(fires[cp.mem_ids[~cp.is_load]].sum())
              if len(cp.mem_ids) else 0)
    flops = int((fires[cp.lin_ids] * cp.lin_fw).sum()) if len(cp.lin_ids) \
        else 0
    return RawStats(
        cycles=cycles, flops=flops, loads=loads, stores=stores,
        fires=fires_by_op,
        max_queue_total=sum(e.max_occupancy for e in cp.g.edges()))


# ---------------------------------------------------------------------------
# public entry points


def run_compiled_batch(items: list[tuple[CompiledPlan, np.ndarray, np.ndarray,
                                         float]],
                       max_cycles: int = 50_000_000, device=None
                       ) -> list[RawStats | SimDeadlock | CudaLoweringError]:
    """Simulate B compiled plans in one launch of K7 on ``device`` (the
    card by default; ``"cpu"`` runs the plain version).

    ``items``: ``(compiled_plan, flat_in, flat_out, elems_per_cycle)`` per
    lane.  Returns one entry per lane, aligned: ``RawStats`` on success
    (with ``flat_out`` filled and per-node ``fires``/``max_occupancy``
    written back), a ``SimDeadlock`` *value* (not raised) for lanes that
    deadlock or time out, or a ``CudaLoweringError`` value for lanes the
    engine rejects — one bad lane never poisons its siblings.  Lanes are
    independent blocks on the card, so none waits for a sibling and no
    lockstep grouping is needed."""
    from repro_torch.kernels.simbatch.kernel import simbatch

    max_cycles = min(int(max_cycles), MAX_CYCLES)   # int32 cycle counter
    results: list = [None] * len(items)
    good: list[tuple[int, CompiledPlan, float]] = []
    for i, (cp, _fi, _fo, epc) in enumerate(items):
        try:
            cp.require_current()           # stale tables: surface per lane
            if cp.net is not None:
                raise CudaLoweringError(
                    "engine='cuda' is ideal-mode only (no network-aware "
                    "simulation); use engine='vector' for routed plans")
            good.append((i, cp, float(epc)))
        except CudaLoweringError as e:
            results[i] = e
        except Exception as e:
            results[i] = CudaLoweringError(str(e))
    if not good:
        return results
    lanes = simbatch([(cp, epc) for _i, cp, epc in good], max_cycles,
                     "cuda" if device is None else device)
    for (i, cp, _epc), lane in zip(good, lanes):
        results[i] = (lane if isinstance(lane, Exception) else
                      _finalize(cp, items[i][1], items[i][2], lane,
                                max_cycles))
    return results


def run(plan, flat_in, flat_out, elems_per_cycle: float,
        max_cycles: int = 50_000_000, fabric=None, telemetry=None,
        device=None) -> RawStats:
    """Single-plan entry with the same signature/contract as
    ``interp.run``/``vector.run`` (a batch of one), plus ``device``.  Ideal
    mode only."""
    if fabric is not None:
        raise NotImplementedError(
            "engine='cuda' does not simulate routed fabrics; use "
            "engine='vector' for network-aware mode")
    if telemetry is not None:
        raise NotImplementedError(
            "engine='cuda' has no telemetry probes; use engine='vector' "
            "or engine='interp' with a telemetry sink")
    cp = compiled_for(plan, None)
    [res] = run_compiled_batch([(cp, flat_in, flat_out, elems_per_cycle)],
                               max_cycles=max_cycles, device=device)
    if isinstance(res, Exception):
        raise res
    return res
