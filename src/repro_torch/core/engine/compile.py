"""Compile a plan's DFG once into struct-of-arrays tables (vector backend).

The vector engine never touches ``Node``/``Edge`` objects in its cycle loop.
:func:`compile_plan` flattens the graph into dense numpy tables keyed by the
node's ``nid`` and the edge's ``eid`` (both dense — see ``DFG.finalize``):

* **op-kind buckets** — index arrays per executable kind (``addr``, memory,
  linear arithmetic, ``filter``, ``sync``, ``cmp``, ``imux``) with aligned
  parameter arrays (coefficients, flop weights, expected counts, …).
* **edge matrices + CSR** — a padded ``in_mat``/``out_mat`` (node × port) for
  one-gather eligibility snapshots, plus a CSR ``out_start``/``out_flat`` for
  broadcast expansion.  A sentinel edge (id ``n_edges``) pads ragged rows:
  it always looks non-empty for input checks and never-full for output
  checks, and its ring slot reads 0.0.
* **ring-buffer pool** — every queue lives in one preallocated float64 pool
  with per-edge ``base``/``phys`` (physical size) and runtime ``head``/``len``
  arrays; unbounded queues start small and the pool is regrown (amortized
  doubling) when one fills.
* **keep-mask arrays** — each filter's ``0^m 1^n 0^p`` pattern is evaluated
  for every stream position it will ever see, vectorized from the compiled
  ``keep_vec`` (digit windows) / ``keep_mod`` (re-interleave stride) params
  the mapper attaches; the token-count topo pass computes how many tokens
  each queue carries over a full run (also the exact per-filter horizon).
* **memory-op tables** — per-node load/store flat-index tables concatenated
  into one array with offsets, in rotating-arbiter bucket order.

Linear arithmetic is unified: ``v = A*front(in0) [+ B*front(in1)]`` covers
``mul`` (A=coeff), ``mac`` (A=1, B=coeff), ``add`` (A=B=1) and the
pass-throughs (A=1) — with the B term applied only where present, so results
stay bit-identical to the interpreter's scalar expressions.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.core.dfg import DFG, FLOPS_PER_OP, Node

if TYPE_CHECKING:  # pragma: no cover - avoids core <-> fabric import cycle
    from repro_torch.fabric.route import RoutedFabric

UNBOUNDED = 1 << 62
LIN_OPS = ("mul", "mac", "add", "copy", "mux", "demux")
SLOT_BITS = 44            # link booking key = (link id << SLOT_BITS) | slot


class StaleCompiledPlanError(RuntimeError):
    """The plan's DFG (topology or queue capacities) changed after
    ``compile_plan()``; the compiled tables no longer describe it."""


def _keep_array(nd: Node, T: int) -> np.ndarray:
    """``keep(s)`` for every stream position ``s < T``, vectorized when the
    mapper attached compiled pattern params (callable fallback otherwise)."""
    p = nd.params
    if T <= 0:
        return np.zeros(0, dtype=bool)
    s = np.arange(T, dtype=np.int64)
    kv = p.get("keep_vec")
    if kv is not None:                       # N-D digit windows (band_keep)
        windows, counts = kv["windows"], kv["counts"]
        if len(windows) == 1:
            ilo, ihi = windows[0]
            return (s >= ilo) & (s < ihi)
        ok = np.ones(T, dtype=bool)
        for cnt, (ilo, ihi) in list(zip(counts, windows))[1:][::-1]:
            s, d = np.divmod(s, cnt)
            ok &= (d >= ilo) & (d < ihi)
        olo, ohi = windows[0]
        return ok & (s >= olo) & (s < ohi)
    km = p.get("keep_mod")
    if km is not None:                       # re-interleave row stride
        return ((km["off"] + (s % km["cnt"]) * km["step"]) % km["mod"]) == 0
    keep = p["keep"]
    return np.fromiter((keep(k) for k in range(T)), dtype=bool, count=T)


def _token_counts(g: DFG) -> tuple[dict[int, int], dict[int, np.ndarray]]:
    """Tokens each node emits per out-edge over a full run (exact for the
    worker-pipeline op vocabulary), plus per-filter keep-mask arrays sized to
    the producer's emission count."""
    emit: dict[int, int] = {}
    keeps: dict[int, np.ndarray] = {}
    for nd in g.topo_order():
        ins = [emit[e.src.nid] for e in nd.in_edges]
        op = nd.op
        if op == "addr":
            t = int(nd.params["count"])
        elif op == "filter":
            arr = _keep_array(nd, ins[0] if ins else 0)
            keeps[nd.nid] = arr
            t = int(arr.sum())
        elif op == "imux":             # forwards every popped input token
            t = sum(ins)
        elif op == "sync":
            t = 1
        elif op == "cmp":
            t = 0
        else:  # load/mul/mac/add/store/copy/...: one fire per input set
            t = min(ins) if ins else 0
        emit[nd.nid] = t
    return emit, keeps


# public names for the static verifier (repro_torch.analysis.static_verify): the
# token-count topo pass *is* the shared ground truth for how many tokens
# every queue carries over a full run — the analyzer must not fork it.
token_counts = _token_counts
keep_array = _keep_array


@dataclasses.dataclass
class CompiledNetwork:
    """Static route tables for network-aware vector simulation."""
    book: list                           # nid -> [(eid, (step, …)), …]; a
                                         # step is a bare booking key when
                                         # wpc1, else a (key, wpc) pair
    loc_start: np.ndarray                # CSR over *local* out-edges only
    loc_flat: np.ndarray
    loc_py: list                         # nid -> [local eids] (sparse path)
    wpc1: bool                           # every link has words_per_cycle 1


# op-kind codes for the sparse (scalar) execute path
K_ADDR, K_LOAD, K_STORE, K_LIN, K_FLT, K_SYNC, K_CMP, K_IMUX = range(8)
_KIND_OF_OP = {"addr": K_ADDR, "load": K_LOAD, "store": K_STORE,
               "filter": K_FLT, "sync": K_SYNC, "cmp": K_CMP,
               "imux": K_IMUX, **{op: K_LIN for op in LIN_OPS}}


@dataclasses.dataclass
class CompiledPlan:
    plan: object
    g: DFG
    nodes: list[Node]
    edges: list
    n_nodes: int
    n_edges: int
    n_cmp: int
    # edge tables (all sized n_edges+1; the last row is the sentinel edge)
    cap: np.ndarray
    phys0: np.ndarray
    pop_first: np.ndarray
    # eligibility matrices + broadcast CSR
    in_mat: np.ndarray
    out_mat: np.ndarray
    capmat: np.ndarray                   # cap[out_mat], hoisted
    out_start: np.ndarray
    out_flat: np.ndarray
    # initial per-node masks
    active0: np.ndarray
    out_opt0: np.ndarray                 # out-space optional for next fire
    pos_other: np.ndarray                # static execute position (non-mem)
    # op-kind buckets + aligned tables
    addr_ids: np.ndarray
    addr_cnt: np.ndarray
    mem_ids: np.ndarray
    is_load: np.ndarray
    mem_in0: np.ndarray
    mem_in1: np.ndarray
    midx_off: np.ndarray
    midx_flat: np.ndarray
    lin_ids: np.ndarray
    lin_a: np.ndarray
    lin_b: np.ndarray
    lin_hasb: np.ndarray
    lin_in0: np.ndarray
    lin_in1: np.ndarray
    lin_fw: np.ndarray
    flt_ids: np.ndarray
    flt_in0: np.ndarray
    keep_flat: np.ndarray
    flt_koff: np.ndarray
    flt_klen: np.ndarray
    flt_nodes: list                      # for the (rare) overflow fallback
    sync_ids: np.ndarray
    sync_in0: np.ndarray
    sync_exp: np.ndarray
    cmp_ids: np.ndarray
    cmp_in: list
    imux_ids: np.ndarray
    imux_pat: list                       # per imux: np.int64 pattern array
    imux_port_eids: list                 # per imux: np.int64 port -> eid
    imux_sel0: np.ndarray
    # sparse-path dispatch tables
    kind_of: np.ndarray = None           # nid -> K_* code
    bidx: np.ndarray = None              # nid -> index into its kind bucket
    out_py: list = None                  # nid -> [out eids] (python ints)
    net: CompiledNetwork | None = None
    # staleness tracking: the DFG mutation counter and queue-capacity
    # signature observed at compile time (see compiled_for / is_current)
    dfg_version: int = -1
    cap_sig: tuple = ()

    def is_current(self) -> bool:
        """Do the compiled tables still describe the plan's DFG?  False after
        any graph mutation — including capacity rewrites applied *without*
        ``DFG.mark_mutated()`` (the capacity signature catches those)."""
        return (self.g.version == self.dfg_version
                and _cap_signature(self.edges) == self.cap_sig)

    def require_current(self) -> "CompiledPlan":
        if not self.is_current():
            raise StaleCompiledPlanError(
                f"compiled tables for DFG {self.g.name!r} are stale "
                f"(compiled at version {self.dfg_version}, graph now at "
                f"{self.g.version} or queue capacities changed); recompile "
                f"with compile_plan()/compiled_for() after mutating a plan")
        return self


def _cap_signature(edges) -> tuple:
    return tuple(e.capacity for e in edges)


def compiled_for(plan, fabric: "RoutedFabric | None" = None) -> CompiledPlan:
    """Compile-once cache: return the plan's cached :class:`CompiledPlan`
    for ``fabric``, recompiling when the DFG mutated since (new nodes/edges,
    or queue capacities rewritten by ``apply_min_capacities`` — the
    compile-then-mutate hazard).  The cache lives on the plan object, one
    entry per fabric identity (``None`` = ideal mode)."""
    cache = getattr(plan, "_compiled_cache", None)
    if cache is None:
        cache = {}
        plan._compiled_cache = cache
    key = id(fabric) if fabric is not None else None
    ent = cache.get(key)
    if ent is not None:
        cached_fabric, cp = ent
        if cached_fabric is fabric and cp.is_current():
            return cp
    cp = compile_plan(plan, fabric)
    cache[key] = (fabric, cp)
    return cp


def compile_network(g: DFG, fabric: "RoutedFabric") -> CompiledNetwork:
    from repro_torch.fabric.route import edge_key  # deferred: no import cycle
    link_id = fabric.link_index()
    wpc = fabric.words_per_cycle()
    edges = g.finalize()
    route_of: dict[int, tuple] = {}
    for e in edges:
        route_of[e.eid] = tuple(link_id[lk]
                                for lk in fabric.routes[edge_key(e)])
    book: list = [None] * len(g.nodes)
    loc_start = np.zeros(len(g.nodes) + 1, dtype=np.int64)
    loc_flat: list[int] = []
    loc_py: list = [None] * len(g.nodes)
    wpc1 = all(w == 1 for w in wpc)
    for n in g.nodes:
        # routed out-edges carry their hop sequence as precomputed booking
        # keys; the general (mixed words-per-cycle) form pairs each key with
        # the link's bandwidth, the wpc==1 fast path needs only the key.
        if wpc1:
            bk = [(e.eid, tuple(lk << SLOT_BITS for lk in route_of[e.eid]))
                  for e in n.out_edges if route_of[e.eid]]
        else:
            bk = [(e.eid, tuple((lk << SLOT_BITS, wpc[lk])
                                for lk in route_of[e.eid]))
                  for e in n.out_edges if route_of[e.eid]]
        if bk:
            book[n.nid] = bk
        loc = [e.eid for e in n.out_edges if not route_of[e.eid]]
        loc_py[n.nid] = loc
        loc_flat.extend(loc)
        loc_start[n.nid + 1] = len(loc_flat)
    return CompiledNetwork(
        book=book, loc_start=loc_start,
        loc_flat=np.asarray(loc_flat, dtype=np.int64),
        loc_py=loc_py, wpc1=wpc1)


def compile_plan(plan, fabric: "RoutedFabric | None" = None) -> CompiledPlan:
    g: DFG = plan.dfg
    nodes = g.nodes
    edges = g.finalize()
    nN, nE = len(nodes), len(edges)
    sent = nE                                  # sentinel edge id
    assert all(nodes[i].nid == i for i in range(nN)), "nids must be dense"

    n_cmp = sum(1 for n in nodes if n.op == "cmp")
    assert n_cmp, "graph has no completion (cmp) node"

    cap = np.full(nE + 1, UNBOUNDED, dtype=np.int64)
    for e in edges:
        if e.capacity is not None:
            cap[e.eid] = e.capacity
    min_caps = getattr(plan, "min_capacities", None) or {}
    hint = {e.eid: min_caps.get(id(e), 0) for e in edges}
    # presize rings to the analytic minimum occupancy plus the edge's routed
    # transit depth (hops), with headroom: a token spends `hops` cycles in
    # link buffers before it is consumable, so routed steady-state occupancy
    # exceeds the ideal-mode bound by exactly that much.  Unbounded rings
    # regrow on demand anyway, so this only trims reallocation churn.
    if fabric is not None:
        from repro_torch.fabric.route import edge_key
        hop = {e.eid: len(fabric.routes.get(edge_key(e), ()))
               for e in edges}
    else:
        hop = {e.eid: 0 for e in edges}
    phys0 = np.array(
        [min(cap[e.eid], max(16, 2 * hint[e.eid] + hop[e.eid]))
         for e in edges] + [1],
        dtype=np.int64)

    # static execute order: memory ops first (rotated at runtime), then the
    # rest in graph order — pop-before-push resolution for max_occupancy.
    mem_like = {n.nid for n in nodes if n.op in ("load", "store")}
    pos_other = np.zeros(nN, dtype=np.int64)
    k = 0
    for n in nodes:
        if n.nid not in mem_like:
            pos_other[n.nid] = k
            k += 1
    pop_first = np.zeros(nE + 1, dtype=bool)
    for e in edges:
        s_mem, d_mem = e.src.nid in mem_like, e.dst.nid in mem_like
        assert not (s_mem and d_mem), \
            "memory->memory queues would make pop order rotation-dependent"
        if d_mem and not s_mem:
            pop_first[e.eid] = True
        elif not d_mem and not s_mem:
            pop_first[e.eid] = pos_other[e.dst.nid] < pos_other[e.src.nid]

    # eligibility matrices + broadcast CSR -----------------------------------
    max_in = max((len(n.in_edges) for n in nodes), default=0) or 1
    max_out = max((len(n.out_edges) for n in nodes), default=0) or 1
    in_mat = np.full((nN, max_in), sent, dtype=np.int64)
    out_mat = np.full((nN, max_out), sent, dtype=np.int64)
    out_start = np.zeros(nN + 1, dtype=np.int64)
    out_flat: list[int] = []
    for n in nodes:
        if n.op != "imux":                  # imux eligibility is per-port
            for j, e in enumerate(n.in_edges):
                in_mat[n.nid, j] = e.eid
        for j, e in enumerate(n.out_edges):
            out_mat[n.nid, j] = e.eid
        out_flat.extend(e.eid for e in n.out_edges)
        out_start[n.nid + 1] = len(out_flat)

    emit, keeps = _token_counts(g)

    active0 = np.ones(nN, dtype=bool)
    out_opt0 = np.zeros(nN, dtype=bool)

    addr_ids, addr_cnt = [], []
    mem_ids, is_load, mem_in0, mem_in1, midx_off = [], [], [], [], []
    midx_parts: list[np.ndarray] = []
    lin_ids, lin_a, lin_b, lin_hasb, lin_in0, lin_in1, lin_fw = \
        [], [], [], [], [], [], []
    flt_ids, flt_in0, flt_koff, flt_klen, flt_nodes = [], [], [], [], []
    keep_parts: list[np.ndarray] = []
    sync_ids, sync_in0, sync_exp = [], [], []
    cmp_ids, cmp_in = [], []
    imux_ids, imux_pat, imux_port_eids, imux_sel0 = [], [], [], []
    kind_of = np.zeros(nN, dtype=np.int64)
    bidx = np.zeros(nN, dtype=np.int64)
    out_py = [[e.eid for e in n.out_edges] for n in nodes]
    koff = moff = 0
    for n in nodes:
        op = n.op
        kind_of[n.nid] = _KIND_OF_OP[op]
        if op == "addr":
            bidx[n.nid] = len(addr_ids)
            addr_ids.append(n.nid)
            addr_cnt.append(int(n.params["count"]))
            if n.params["count"] <= 0:
                active0[n.nid] = False
        elif op in ("load", "store"):
            bidx[n.nid] = len(mem_ids)
            mem_ids.append(n.nid)
            is_load.append(op == "load")
            mem_in0.append(n.in_edges[0].eid)
            mem_in1.append(n.in_edges[1].eid if op == "store" else sent)
            idx = np.asarray(n.params["indices"], dtype=np.int64)
            midx_parts.append(idx)
            midx_off.append(moff)
            moff += len(idx)
        elif op in LIN_OPS:
            bidx[n.nid] = len(lin_ids)
            lin_ids.append(n.nid)
            lin_fw.append(FLOPS_PER_OP.get(op, 0))
            if op == "mul":
                lin_a.append(float(n.params["coeff"]))
                lin_b.append(0.0)
                lin_hasb.append(False)
                lin_in0.append(n.in_edges[0].eid)
                lin_in1.append(sent)
            elif op == "mac":
                lin_a.append(1.0)
                lin_b.append(float(n.params["coeff"]))
                lin_hasb.append(True)
                lin_in0.append(n.in_edges[0].eid)
                lin_in1.append(n.in_edges[1].eid)
            elif op == "add":
                lin_a.append(1.0)
                lin_b.append(1.0)
                lin_hasb.append(True)
                lin_in0.append(n.in_edges[0].eid)
                lin_in1.append(n.in_edges[1].eid)
            else:                            # copy/mux/demux pass-through
                lin_a.append(1.0)
                lin_b.append(0.0)
                lin_hasb.append(False)
                lin_in0.append(n.in_edges[0].eid)
                lin_in1.append(sent)
        elif op == "filter":
            arr = keeps[n.nid]
            bidx[n.nid] = len(flt_ids)
            flt_ids.append(n.nid)
            flt_in0.append(n.in_edges[0].eid)
            flt_klen.append(len(arr))
            flt_nodes.append(n)
            if len(arr) == 0:                # never fires; pad for gathers
                arr = np.zeros(1, dtype=bool)
            keep_parts.append(arr)
            flt_koff.append(koff)
            koff += len(arr)
            out_opt0[n.nid] = not bool(arr[0])
        elif op == "sync":
            bidx[n.nid] = len(sync_ids)
            sync_ids.append(n.nid)
            sync_in0.append(n.in_edges[0].eid)
            sync_exp.append(int(n.params["expected"]))
            out_opt0[n.nid] = True
        elif op == "cmp":
            bidx[n.nid] = len(cmp_ids)
            cmp_ids.append(n.nid)
            cmp_in.append(np.asarray([e.eid for e in n.in_edges],
                                     dtype=np.int64))
            out_opt0[n.nid] = True
        elif op == "imux":
            bidx[n.nid] = len(imux_ids)
            imux_ids.append(n.nid)
            pat = np.asarray(n.params["pattern"], dtype=np.int64)
            ports = np.asarray([e.eid for e in n.in_edges], dtype=np.int64)
            imux_pat.append(pat)
            imux_port_eids.append(ports)
            imux_sel0.append(int(ports[pat[0]]))
        else:
            raise ValueError(f"cannot compile op {op!r} (node {n.name!r})")

    arr64 = lambda xs: np.asarray(xs, dtype=np.int64)
    cp = CompiledPlan(
        plan=plan, g=g, nodes=nodes, edges=edges, n_nodes=nN, n_edges=nE,
        n_cmp=n_cmp, cap=cap, phys0=phys0, pop_first=pop_first,
        in_mat=in_mat, out_mat=out_mat, capmat=cap[out_mat],
        out_start=out_start, out_flat=arr64(out_flat),
        active0=active0, out_opt0=out_opt0, pos_other=pos_other,
        addr_ids=arr64(addr_ids), addr_cnt=arr64(addr_cnt),
        mem_ids=arr64(mem_ids), is_load=np.asarray(is_load, dtype=bool),
        mem_in0=arr64(mem_in0), mem_in1=arr64(mem_in1),
        midx_off=arr64(midx_off),
        midx_flat=(np.concatenate(midx_parts) if midx_parts
                   else np.zeros(0, dtype=np.int64)),
        lin_ids=arr64(lin_ids), lin_a=np.asarray(lin_a, dtype=np.float64),
        lin_b=np.asarray(lin_b, dtype=np.float64),
        lin_hasb=np.asarray(lin_hasb, dtype=bool),
        lin_in0=arr64(lin_in0), lin_in1=arr64(lin_in1), lin_fw=arr64(lin_fw),
        flt_ids=arr64(flt_ids), flt_in0=arr64(flt_in0),
        keep_flat=(np.concatenate(keep_parts) if keep_parts
                   else np.zeros(0, dtype=bool)),
        flt_koff=arr64(flt_koff), flt_klen=arr64(flt_klen),
        flt_nodes=flt_nodes,
        sync_ids=arr64(sync_ids), sync_in0=arr64(sync_in0),
        sync_exp=arr64(sync_exp),
        cmp_ids=arr64(cmp_ids), cmp_in=cmp_in,
        imux_ids=arr64(imux_ids), imux_pat=imux_pat,
        imux_port_eids=imux_port_eids, imux_sel0=arr64(imux_sel0),
        kind_of=kind_of, bidx=bidx, out_py=out_py,
        net=compile_network(g, fabric) if fabric is not None else None,
        dfg_version=g.version, cap_sig=_cap_signature(edges))
    return cp
