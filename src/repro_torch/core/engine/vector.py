"""Compiled vectorized simulation backend.

Runs the exact semantics of :mod:`repro_torch.core.engine.interp` — same firing
rule, same two-phase FIFO snapshots, same rotating memory arbiter, same
network contention — but over the :class:`~repro_torch.core.engine.compile.
CompiledPlan` struct-of-arrays tables instead of ``Node``/``Edge`` objects:

* **snapshot**: one gather + ``all``-reduce over the padded in/out edge
  matrices yields every node's eligibility at once (queue lengths live in a
  flat ``qlen`` array indexed by dense edge id; queue storage in one
  ring-buffer pool).  When every queue is unbounded — the mapper's default —
  output-space checks are constant-true and skipped wholesale.
* **dense cycles** (many eligible nodes): per op-kind bucket, all eligible
  nodes fire together — fronts gathered from the ring pool, values computed
  array-wide (the unified ``A*front0 [+ B*front1]`` form is bit-identical to
  the interpreter's scalar expressions), pops/pushes applied as batched ring
  updates, broadcast expanded through the out-edge CSR.  The rotating memory
  arbiter is a rolled mask + cumsum against the fractional credit
  (decremented 1.0 at a time so the float trajectory matches exactly).
* **sparse cycles** (a handful eligible — the common shape once network
  contention spreads fires out): the same tables are executed scalar-wise
  over just the eligible nodes, in the interpreter's execute order, through
  memoryview mirrors of the ring arrays (python-int indexing, no per-access
  numpy scalar boxing).  Both paths leave identical state, so the engine
  switches freely per cycle.
* **network**: in-flight tokens sit in per-arrival-cycle buckets behind a
  heap of bucket keys, so delivery is a heap-front check per cycle and the
  next-event time is O(1) (buckets pop in arrival order and keep send order,
  preserving per-edge FIFO); link booking replaces the interpreter's linear
  full-slot walk with flat integer-keyed route-step state
  (``(link << B) | slot``) threaded by a next-free-slot chain with path
  compression, so each hop books in amortized ~O(1) while producing the
  identical slot assignments, stalls and arrivals.
* **event skip**: a cycle in which nothing fired and tokens are only riding
  the network fast-forwards to the next arrival (or memory-credit) event —
  state provably cannot change in between, so cycle counts are unaffected.

Max-occupancy bookkeeping replicates the interpreter's push-time sampling:
whether the consumer's pop lands before the producer's push inside one cycle
is a static property of the execute order (memory ops first, then graph
order), precompiled into the per-edge ``pop_first`` flag (the sparse path
simply executes in that order and samples directly).
"""
from __future__ import annotations

import heapq

import numpy as np

from repro_torch.core.engine.common import RawStats, SimDeadlock
from repro_torch.core.engine.compile import (CompiledPlan, K_ADDR, K_CMP, K_FLT,
                                             K_LIN, K_LOAD, K_STORE, K_SYNC,
                                             SLOT_BITS, UNBOUNDED, compile_plan,
                                             compiled_for)
from repro_torch.telemetry.probe import (ST_FIRED, ST_INACTIVE, ST_INPUT_STARVED,
                                         ST_MEM_ARB, ST_NET_WAIT,
                                         ST_OUTPUT_BLOCKED, format_stall_summary,
                                         summary_from_state)

_BIG = 1 << 60
_SPARSE_MAX = 96          # eligible-node count at or below which the scalar
                          # path beats the fixed cost of the bucket passes
                          # (measured crossover on program pipelines; routed
                          # contention keeps most cycles well under this)


class _Rings:
    """All queues in one float64 pool: per-edge base/phys + head/len.

    The numpy arrays are the single source of truth (the dense path updates
    them with fancy indexing); the ``*_mv`` memoryviews alias the same
    buffers for the sparse path's python-int scalar access.
    """

    def __init__(self, cap: np.ndarray, phys0: np.ndarray):
        self.cap = cap
        self.n = len(cap)                  # n_edges + 1 (sentinel last)
        self.phys = phys0.astype(np.int64).copy()
        self.head = np.zeros(self.n, dtype=np.int64)
        self.qlen = np.zeros(self.n, dtype=np.int64)
        self.qlen[-1] = _BIG               # sentinel: never empty …
        self.phys_mv = memoryview(self.phys)
        self.head_mv = memoryview(self.head)
        self.qlen_mv = memoryview(self.qlen)
        self._rebase()
        # … and the sentinel's ring slot reads 0.0 (pool stays zeroed there).

    def _rebase(self) -> None:
        self.base = np.zeros(self.n, dtype=np.int64)
        np.cumsum(self.phys[:-1], out=self.base[1:])
        self.pool = np.zeros(int(self.base[-1] + self.phys[-1]),
                             dtype=np.float64)
        self.base_mv = memoryview(self.base)
        self.pool_mv = memoryview(self.pool)

    def front(self, eids: np.ndarray) -> np.ndarray:
        return self.pool[self.base[eids] + self.head[eids]]

    def pop(self, eids: np.ndarray) -> None:
        h = self.head[eids] + 1
        ph = self.phys[eids]
        h[h == ph] = 0
        self.head[eids] = h
        self.qlen[eids] -= 1

    def push(self, eids: np.ndarray, vals: np.ndarray) -> None:
        full = self.qlen[eids] >= self.phys[eids]
        if full.any():
            self._grow(np.unique(eids[full]))
        pos = self.head[eids] + self.qlen[eids]
        ph = self.phys[eids]
        wrap = pos >= ph
        pos[wrap] -= ph[wrap]
        self.pool[self.base[eids] + pos] = vals
        self.qlen[eids] += 1

    def _grow(self, eids) -> None:
        """Amortized-doubling regrow of (logically unbounded) rings."""
        old_base, old_pool, old_phys = self.base, self.pool, self.phys.copy()
        for e in eids:
            self.phys[e] = int(min(self.cap[e], max(4 * old_phys[e], 8)))
        self._rebase()
        for e in range(self.n - 1):        # sentinel ring stays zeroed
            q = int(self.qlen[e])
            if not q:
                self.head[e] = 0
                continue
            h, p = int(self.head[e]), int(old_phys[e])
            ob, nb = int(old_base[e]), int(self.base[e])
            first = min(q, p - h)
            self.pool[nb:nb + first] = old_pool[ob + h:ob + h + first]
            if q > first:
                self.pool[nb + first:nb + q] = old_pool[ob:ob + q - first]
            self.head[e] = 0


def run(plan, flat_in, flat_out, elems_per_cycle: float,
        max_cycles: int = 50_000_000, fabric=None, telemetry=None) -> RawStats:
    """Compile ``plan`` (+ routes) and run the vectorized cycle loop;
    mutates ``flat_out`` in place.  Results match ``engine.interp`` exactly.

    Compiles are cached on the plan (``compiled_for``): re-simulating the
    same plan skips the flatten, and a plan mutated after compilation —
    ``apply_min_capacities`` after a prior run, the auto-tuner's recapacity
    path — transparently recompiles instead of using stale tables."""
    cp = compiled_for(plan, fabric)
    return _run_compiled(cp.require_current(), flat_in, flat_out,
                         elems_per_cycle, max_cycles, telemetry)


def _deadlock_msg(cp: CompiledPlan, rings: _Rings, cycles: int) -> str:
    qlen = rings.qlen
    stuck = []
    for nd in cp.nodes:
        ine = [int(qlen[e.eid]) for e in nd.in_edges]
        if any(ine):
            outfull = [e.capacity is not None
                       and int(qlen[e.eid]) >= e.capacity
                       for e in nd.out_edges]
            stuck.append(f"{nd.name}({nd.op}) in={ine} outfull={outfull}")
        if len(stuck) >= 8:
            break
    return f"deadlock at cycle {cycles}; sample blocked nodes: {stuck}"


def _expand_push(start, flat, nids, vals, rings, qstart, pop_first,
                 popped_stamp, maxocc, cycles) -> None:
    """Broadcast: expand fired nodes over their (CSR) out-edges and push."""
    deg = start[nids + 1] - start[nids]
    tot = int(deg.sum())
    if not tot:
        return
    cum = np.cumsum(deg)
    idx = np.arange(tot, dtype=np.int64) + np.repeat(start[nids] - cum + deg,
                                                     deg)
    eids = flat[idx]
    rings.push(eids, np.repeat(vals, deg))
    # interpreter-exact occupancy sampling: the push saw the consumer's pop
    # only if the consumer executes earlier in the (static) order.
    occ_c = qstart[eids] + 1 - (pop_first[eids]
                                & (popped_stamp[eids] == cycles))
    maxocc[eids] = np.maximum(maxocc[eids], occ_c)


def _run_compiled(cp: CompiledPlan, flat_in, flat_out,
                  elems_per_cycle: float, max_cycles: int,
                  tel=None) -> RawStats:
    nN, nE = cp.n_nodes, cp.n_edges
    telon = tel is not None
    rings = _Rings(cp.cap, cp.phys0)
    qlen = rings.qlen
    in_mat, out_mat, capmat = cp.in_mat, cp.out_mat, cp.capmat
    out_start, out_flat = cp.out_start, cp.out_flat
    pop_first = cp.pop_first
    # the mapper's default leaves every queue unbounded: output space is
    # then constant-true and the whole occupancy check drops out.
    all_unbounded = bool((cp.cap[:nE] == UNBOUNDED).all())
    true_arr = np.ones(nN, dtype=bool)

    active = cp.active0.copy()
    out_opt = cp.out_opt0.copy()
    fires_arr = np.zeros(nN, dtype=np.int64)
    maxocc = np.zeros(nE + 1, dtype=np.int64)
    popped_stamp = np.full(nE + 1, -1, dtype=np.int64)
    active_mv = memoryview(active)
    out_opt_mv = memoryview(out_opt)
    fires_mv = memoryview(fires_arr)
    maxocc_mv = memoryview(maxocc)

    addr_ids, addr_cnt = cp.addr_ids, cp.addr_cnt
    addr_k = np.zeros(len(addr_ids), dtype=np.int64)
    addr_k_mv = memoryview(addr_k)
    mem_ids, is_load = cp.mem_ids, cp.is_load
    mem_in0, mem_in1 = cp.mem_in0, cp.mem_in1
    midx_off, midx_flat = cp.midx_off, cp.midx_flat
    midx_mv = memoryview(midx_flat)
    flat_in_mv = memoryview(flat_in)
    flat_out_mv = memoryview(flat_out)
    n_mem = max(1, len(mem_ids))
    lin_ids, lin_a, lin_b = cp.lin_ids, cp.lin_a, cp.lin_b
    lin_hasb, lin_in0, lin_in1, lin_fw = \
        cp.lin_hasb, cp.lin_in0, cp.lin_in1, cp.lin_fw
    flt_ids, flt_in0 = cp.flt_ids, cp.flt_in0
    keep_flat, flt_koff, flt_klen = cp.keep_flat, cp.flt_koff, cp.flt_klen
    flt_k = np.zeros(len(flt_ids), dtype=np.int64)
    flt_k_mv = memoryview(flt_k)
    flt_next = (keep_flat[flt_koff].copy() if len(flt_ids)
                else np.zeros(0, dtype=bool))
    flt_next_mv = memoryview(flt_next)
    sync_ids, sync_in0, sync_exp = cp.sync_ids, cp.sync_in0, cp.sync_exp
    sync_cnt = np.zeros(len(sync_ids), dtype=np.int64)
    sync_cnt_mv = memoryview(sync_cnt)
    cmp_ids, cmp_in = cp.cmp_ids, cp.cmp_in
    imux_ids = cp.imux_ids
    n_imux = len(imux_ids)
    imux_k = np.zeros(n_imux, dtype=np.int64)
    imux_k_mv = memoryview(imux_k)
    imux_sel = cp.imux_sel0.copy()
    imux_sel_mv = memoryview(imux_sel)

    # python mirrors for the sparse (scalar) path
    kind_l = cp.kind_of.tolist()
    is_mem_l = [k in (K_LOAD, K_STORE) for k in kind_l]
    bidx_l = cp.bidx.tolist()
    out_py = cp.out_py
    addr_cnt_l = addr_cnt.tolist()
    mem_in0_l, mem_in1_l = mem_in0.tolist(), mem_in1.tolist()
    midx_off_l = midx_off.tolist()
    lin_a_l, lin_b_l = lin_a.tolist(), lin_b.tolist()
    lin_hasb_l = lin_hasb.tolist()
    lin_in0_l, lin_in1_l = lin_in0.tolist(), lin_in1.tolist()
    lin_fw_l = lin_fw.tolist()
    flt_in0_l = flt_in0.tolist()
    flt_koff_l, flt_klen_l = flt_koff.tolist(), flt_klen.tolist()
    keep_l = keep_flat.tolist()
    sync_in0_l, sync_exp_l = sync_in0.tolist(), sync_exp.tolist()
    cmp_in_l = [a.tolist() for a in cmp_in]
    imux_pat_l = [p.tolist() for p in cp.imux_pat]
    imux_ports_l = [p.tolist() for p in cp.imux_port_eids]

    net = cp.net
    if net is not None:
        book = net.book
        loc_py = net.loc_py
        loc_start, loc_flat = net.loc_start, net.loc_flat
        used: dict = {}                    # (link<<B)|slot -> words booked
        nxt_free: dict = {}                # full slot -> next candidate slot
        wpc1 = net.wpc1
        last_arr = [0] * (nE + 1)
        arrivals: dict = {}                # cycle -> [(eid, value), …] in
        arr_heap: list = []                # send order; heap of bucket keys
        tlen = np.zeros(nE + 1, dtype=np.int64)
        tlen_mv = memoryview(tlen)
        track_occ = not all_unbounded      # occ only matters for bounded
        # telemetry needs in-flight counts too (net-wait classification)
        track_tlen = track_occ or telon

    token_hops = stall_cycles = 0
    credit = 0.0
    cap4 = 4 * elems_per_cycle
    cycles = 0
    loads = stores = flops = 0
    done_pending = cp.n_cmp
    finished = False
    pos_other = cp.pos_other

    def _transit(eid: int, arr: float, v: float) -> None:
        """Queue an arrival: per-edge FIFO holds because buckets deliver in
        ascending arrival order and each bucket keeps send order."""
        lst = arrivals.get(arr)
        if lst is None:
            arrivals[arr] = [(eid, v)]
            heapq.heappush(arr_heap, arr)
        else:
            lst.append((eid, v))
        if track_tlen:
            tlen_mv[eid] += 1

    def send_routed(nid: int, v: float) -> None:
        """Book one multicast over the node's routed out-edges: identical
        slot assignment to the interpreter's linear search, but the first
        free slot >= t is found through a next-free-slot chain with path
        compression (amortized ~O(1) per hop even under heavy contention,
        where the interpreter walks every full slot).  With every link at
        words-per-cycle 1 (``wpc1``) the chain doubles as the booking table;
        the general variant below tracks per-slot word counts too."""
        nonlocal token_hops, stall_cycles
        nf_get = nxt_free.get
        bk = book[nid]
        multi = len(bk) > 1                # multicast: dedupe shared links
        booked: dict = {} if multi else None
        for eid, links in bk:
            t = cycles
            for key in links:
                if multi:
                    bs = booked.get(key)
                    if bs is not None:
                        t = bs + 1
                        continue
                s = t
                ns = nf_get(key + s)
                if ns is not None:           # hop over the known-full band
                    chain = []
                    while ns is not None:
                        chain.append(s)
                        s = ns
                        ns = nf_get(key + s)
                    for cs in chain:         # path compression
                        nxt_free[key + cs] = s
                stall_cycles += s - t
                nxt_free[key + s] = s + 1    # wpc 1: slot fills at once
                if multi:
                    booked[key] = s
                token_hops += 1
                if telon:
                    tel.link_book(key >> SLOT_BITS, s, s - t)
                t = s + 1
            la = last_arr[eid]
            arr = t if t > la else la
            last_arr[eid] = arr
            _transit(eid, arr, v)

    def send_routed_general(nid: int, v: float) -> None:
        """Mixed words-per-cycle fabric: like :func:`send_routed` but a slot
        only chains into the next-free list once its word count fills."""
        nonlocal token_hops, stall_cycles
        nf_get = nxt_free.get
        bk = book[nid]
        multi = len(bk) > 1
        booked: dict = {} if multi else None
        for eid, links in bk:
            t = cycles
            for key, capw in links:
                if multi:
                    bs = booked.get(key)
                    if bs is not None:
                        t = bs + 1
                        continue
                s = t
                ns = nf_get(key + s)
                if ns is not None:
                    chain = []
                    while ns is not None:
                        chain.append(s)
                        s = ns
                        ns = nf_get(key + s)
                    for cs in chain:
                        nxt_free[key + cs] = s
                stall_cycles += s - t
                ks = key + s
                c = used.get(ks, 0) + 1
                used[ks] = c
                if c >= capw:
                    nxt_free[ks] = s + 1
                if multi:
                    booked[key] = s
                token_hops += 1
                if telon:
                    tel.link_book(key >> SLOT_BITS, s, s - t)
                t = s + 1
            la = last_arr[eid]
            arr = t if t > la else la
            last_arr[eid] = arr
            _transit(eid, arr, v)

    def s_push(e: int, v) -> None:
        r = rings
        q = r.qlen_mv[e]
        if q >= r.phys_mv[e]:
            r._grow((e,))
            q = r.qlen_mv[e]
        pos = r.head_mv[e] + q
        ph = r.phys_mv[e]
        if pos >= ph:
            pos -= ph
        r.pool_mv[r.base_mv[e] + pos] = v
        q += 1
        r.qlen_mv[e] = q
        if q > maxocc_mv[e]:               # push-time sample, like Edge.push
            maxocc_mv[e] = q

    def s_popv(e: int):
        r = rings
        h = r.head_mv[e]
        v = r.pool_mv[r.base_mv[e] + h]
        h += 1
        r.head_mv[e] = 0 if h == r.phys_mv[e] else h
        r.qlen_mv[e] -= 1
        return v

    # sparse-path broadcast plan: local pushes + (net mode) routed booking
    if net is None:
        emit_loc = out_py
        has_routed = [False] * nN
    else:
        emit_loc = loc_py
        has_routed = [b is not None for b in book]
        if not wpc1:
            send_routed = send_routed_general

    if telon:
        prev_fires = np.zeros(nN, dtype=np.int64)
    in_ok = elig = None                    # bound per cycle; read by _classify

    def _classify(fired_mask: np.ndarray) -> np.ndarray:
        """One exclusive ``ST_*`` code per node for the cycle just executed,
        from this cycle's eligibility snapshot + the fire delta.  Mirrors the
        interpreter's scalar classification exactly (parity-gated)."""
        state = np.full(nN, ST_INACTIVE, dtype=np.int64)
        rest = active & ~fired_mask
        starv = rest & ~in_ok
        if net is not None:
            # starved, but tokens are riding the network toward an input
            intrans = tlen[in_mat].sum(axis=1) > 0
            if n_imux:
                intrans[imux_ids] = tlen[imux_sel] > 0
            state[starv & intrans] = ST_NET_WAIT
            starv &= ~intrans
        state[starv] = ST_INPUT_STARVED
        state[rest & in_ok & ~elig] = ST_OUTPUT_BLOCKED
        state[rest & elig] = ST_MEM_ARB    # lost memory-port arbitration
        state[fired_mask] = ST_FIRED
        return state

    def _final_cycle_summary() -> dict:
        names = [""] * nN
        ops = [""] * nN
        for nd in cp.nodes:
            names[nd.nid] = nd.name
            ops[nd.nid] = nd.op
        return summary_from_state(_classify(np.zeros(nN, dtype=bool)),
                                  names, ops)

    while not finished:
        if cycles >= max_cycles:
            if telon:
                tel.finish(cycles)
                summ = tel.stall_summary(window=64)
                raise SimDeadlock(f"exceeded max_cycles={max_cycles}"
                                  + format_stall_summary(summ),
                                  cycles=cycles, timed_out=True,
                                  stall_summary=summ)
            raise SimDeadlock(f"exceeded max_cycles={max_cycles}",
                              cycles=cycles, timed_out=True)
        cycles += 1
        credit = min(credit + elems_per_cycle, cap4)

        if net is not None:
            # slot searches always start at the current cycle; drop booking
            # entries for past slots periodically to keep memory flat.
            if cycles % 4096 == 0:
                mask = (1 << SLOT_BITS) - 1
                if used:
                    used = {k: v for k, v in used.items()
                            if (k & mask) >= cycles}
                if nxt_free:
                    nxt_free = {k: v for k, v in nxt_free.items()
                                if (k & mask) >= cycles}
            # deliver: arrivals land before the snapshot (buckets pop in
            # ascending arrival order; each bucket preserves send order)
            while arr_heap and arr_heap[0] <= cycles:
                for e, v in arrivals.pop(heapq.heappop(arr_heap)):
                    s_push(e, v)
                    if track_tlen:
                        tlen_mv[e] -= 1

        # phase 1: snapshot eligibility ------------------------------------
        in_ok = (qlen[in_mat] > 0).all(axis=1)
        if n_imux:
            in_ok[imux_ids] = qlen[imux_sel] > 0
        if all_unbounded:
            out_ok = true_arr
            elig = in_ok & active
        else:
            occ = qlen if net is None else qlen + tlen
            out_ok = (occ[out_mat] < capmat).all(axis=1)
            elig = in_ok & (out_ok | out_opt) & active

        cand = np.nonzero(elig)[0]
        ncand = len(cand)
        any_fired = False
        mem_waiting = False

        if not ncand:
            pass

        elif ncand <= _SPARSE_MAX:
            # ---- sparse path: scalar execute in interpreter order --------
            mems, others = [], []
            for n in cand.tolist():
                (mems if is_mem_l[n] else others).append(n)
            if mems:
                rot = cycles % n_mem
                mems.sort(key=lambda n: (bidx_l[n] - rot) % n_mem)
            for n in mems:
                if credit < 1.0:
                    mem_waiting = True
                    continue
                b = bidx_l[n]
                a = int(s_popv(mem_in0_l[b]))
                if kind_l[n] == K_LOAD:
                    v = flat_in_mv[midx_mv[midx_off_l[b] + a]]
                    loads += 1
                else:
                    val = s_popv(mem_in1_l[b])
                    flat_out_mv[midx_mv[midx_off_l[b] + a]] = val
                    stores += 1
                    v = 1.0
                credit -= 1.0
                fires_mv[n] += 1
                any_fired = True
                for e in emit_loc[n]:
                    s_push(e, v)
                if has_routed[n]:
                    send_routed(n, v)
            for n in others:
                k = kind_l[n]
                b = bidx_l[n]
                if k == K_LIN:
                    v = lin_a_l[b] * s_popv(lin_in0_l[b])
                    if lin_hasb_l[b]:
                        v = v + lin_b_l[b] * s_popv(lin_in1_l[b])
                    flops += lin_fw_l[b]
                elif k == K_FLT:
                    keep = flt_next_mv[b]
                    v = s_popv(flt_in0_l[b])
                    kk = flt_k_mv[b] + 1
                    flt_k_mv[b] = kk
                    if kk >= flt_klen_l[b]:
                        nxt = bool(cp.flt_nodes[b].params["keep"](kk))
                    else:
                        nxt = keep_l[flt_koff_l[b] + kk]
                    flt_next_mv[b] = nxt
                    out_opt_mv[n] = not nxt
                    fires_mv[n] += 1
                    any_fired = True
                    if keep:
                        for e in emit_loc[n]:
                            s_push(e, v)
                        if has_routed[n]:
                            send_routed(n, v)
                    continue
                elif k == K_ADDR:
                    kk = addr_k_mv[b]
                    v = float(kk)
                    addr_k_mv[b] = kk + 1
                    if kk + 1 >= addr_cnt_l[b]:
                        active_mv[n] = False
                elif k == K_SYNC:
                    s_popv(sync_in0_l[b])
                    c = sync_cnt_mv[b] + 1
                    sync_cnt_mv[b] = c
                    fires_mv[n] += 1
                    any_fired = True
                    if c == sync_exp_l[b] and out_ok[n]:
                        active_mv[n] = False
                        for e in emit_loc[n]:
                            s_push(e, 1.0)
                        if has_routed[n]:
                            send_routed(n, 1.0)
                    continue
                elif k == K_CMP:
                    for e in cmp_in_l[b]:
                        s_popv(e)
                    active_mv[n] = False
                    done_pending -= 1
                    if done_pending == 0:
                        finished = True
                    fires_mv[n] += 1
                    any_fired = True
                    continue
                else:                      # K_IMUX
                    v = s_popv(imux_sel_mv[b])
                    kk = imux_k_mv[b] + 1
                    imux_k_mv[b] = kk
                    pat = imux_pat_l[b]
                    imux_sel_mv[b] = imux_ports_l[b][pat[kk % len(pat)]]
                fires_mv[n] += 1
                any_fired = True
                for e in emit_loc[n]:
                    s_push(e, v)
                if has_routed[n]:
                    send_routed(n, v)

        else:
            # ---- dense path: one vectorized pass per op-kind -------------
            qstart = qlen.copy()
            pops = []
            fired = []
            push_mem_n = push_mem_v = None
            push_n, push_v = [], []

            # memory ops, rotating arbiter + fractional credit
            em = elig[mem_ids]
            em_any = em.any()
            mem_waiting = bool(em_any)
            if em_any and credit >= 1.0:
                rot = cycles % n_mem
                emr = np.concatenate((em[rot:], em[:rot])) if rot else em
                fire_r = emr & (np.cumsum(emr) <= int(credit))
                pos_r = np.nonzero(fire_r)[0]
                if rot:
                    pos_r = (pos_r + rot) % n_mem
                if len(pos_r):
                    ldm = is_load[pos_r]
                    v_mem = np.empty(len(pos_r), dtype=np.float64)
                    lp = pos_r[ldm]
                    if len(lp):
                        e0 = mem_in0[lp]
                        a = rings.front(e0).astype(np.int64)
                        v_mem[ldm] = flat_in[midx_flat[midx_off[lp] + a]]
                        pops.append(e0)
                        loads += len(lp)
                    sp = pos_r[~ldm]
                    if len(sp):
                        e0, e1 = mem_in0[sp], mem_in1[sp]
                        a = rings.front(e0).astype(np.int64)
                        flat_out[midx_flat[midx_off[sp] + a]] = rings.front(e1)
                        v_mem[~ldm] = 1.0
                        pops.append(e0)
                        pops.append(e1)
                        stores += len(sp)
                    for _ in range(len(pos_r)):   # match interp's float walk
                        credit -= 1.0
                    push_mem_n = mem_ids[pos_r]
                    push_mem_v = v_mem
                    fired.append(push_mem_n)

            # addr: index generators
            am = elig[addr_ids]
            if am.any():
                ai = np.nonzero(am)[0]
                nids = addr_ids[ai]
                push_n.append(nids)
                push_v.append(addr_k[ai].astype(np.float64))
                addr_k[ai] += 1
                done = addr_k[ai] >= addr_cnt[ai]
                if done.any():
                    active[nids[done]] = False
                fired.append(nids)

            # linear arithmetic: v = A*front0 [+ B*front1]
            lm = elig[lin_ids]
            if lm.any():
                li = np.nonzero(lm)[0]
                e0 = lin_in0[li]
                v = lin_a[li] * rings.front(e0)
                pops.append(e0)
                hb = lin_hasb[li]
                if hb.any():
                    bi = li[hb]
                    e1 = lin_in1[bi]
                    v[hb] += lin_b[bi] * rings.front(e1)
                    pops.append(e1)
                flops += int(lin_fw[li].sum())
                push_n.append(lin_ids[li])
                push_v.append(v)
                fired.append(lin_ids[li])

            # filters: pop always, forward only kept tokens
            fm = elig[flt_ids]
            if fm.any():
                fi = np.nonzero(fm)[0]
                e0 = flt_in0[fi]
                v = rings.front(e0)
                pops.append(e0)
                keep = flt_next[fi]
                if keep.any():
                    push_n.append(flt_ids[fi[keep]])
                    push_v.append(v[keep])
                flt_k[fi] += 1
                newk = flt_k[fi]
                klen = flt_klen[fi]
                over = newk >= klen
                nxt = keep_flat[flt_koff[fi] + np.minimum(newk, klen - 1)]
                if over.any():             # past the analytic horizon: ask
                    for j in np.nonzero(over)[0]:     # the original callable
                        nxt[j] = bool(cp.flt_nodes[int(fi[j])]
                                      .params["keep"](int(newk[j])))
                flt_next[fi] = nxt
                out_opt[flt_ids[fi]] = ~nxt
                fired.append(flt_ids[fi])

            # sync: count-ticks; emission rides the final tick
            sm = elig[sync_ids]
            if sm.any():
                si = np.nonzero(sm)[0]
                pops.append(sync_in0[si])
                sync_cnt[si] += 1
                emit = (sync_cnt[si] == sync_exp[si]) & out_ok[sync_ids[si]]
                if emit.any():
                    en = sync_ids[si[emit]]
                    active[en] = False
                    push_n.append(en)
                    push_v.append(np.ones(len(en), dtype=np.float64))
                fired.append(sync_ids[si])

            # cmp: completion combiners
            if done_pending:
                cm = elig[cmp_ids]
                if cm.any():
                    ci = np.nonzero(cm)[0]
                    for j in ci:
                        pops.append(cmp_in[int(j)])
                    active[cmp_ids[ci]] = False
                    done_pending -= len(ci)
                    if done_pending == 0:
                        finished = True
                    fired.append(cmp_ids[ci])

            # imux: pop the pattern-selected port
            if n_imux:
                im = elig[imux_ids]
                if im.any():
                    ii = np.nonzero(im)[0]
                    e0 = imux_sel[ii]
                    push_n.append(imux_ids[ii])
                    push_v.append(rings.front(e0))
                    pops.append(e0)
                    imux_k[ii] += 1
                    for j in ii:            # few imux nodes; ragged patterns
                        pat = cp.imux_pat[int(j)]
                        port = pat[int(imux_k[j]) % len(pat)]
                        imux_sel[j] = cp.imux_port_eids[int(j)][port]
                    fired.append(imux_ids[ii])

            # commit: pops, then pushes (snapshots were taken up front) ----
            if pops:
                pe = np.concatenate(pops)
                rings.pop(pe)
                popped_stamp[pe] = cycles
            any_fired = bool(fired)
            if any_fired:
                fires_arr[np.concatenate(fired)] += 1

            if push_mem_n is not None or push_n:
                if push_mem_n is not None:
                    nids = np.concatenate([push_mem_n] + push_n)
                    vals = np.concatenate([push_mem_v] + push_v)
                else:
                    nids = (np.concatenate(push_n) if len(push_n) > 1
                            else push_n[0])
                    vals = (np.concatenate(push_v) if len(push_v) > 1
                            else push_v[0])
                if net is None:
                    _expand_push(out_start, out_flat, nids, vals, rings,
                                 qstart, pop_first, popped_stamp, maxocc,
                                 cycles)
                else:
                    _expand_push(loc_start, loc_flat, nids, vals, rings,
                                 qstart, pop_first, popped_stamp, maxocc,
                                 cycles)
                    # booking order = interpreter execute order: memory ops
                    # in rotated order first, then the rest in graph order.
                    n_m = 0 if push_mem_n is None else len(push_mem_n)
                    if len(nids) > n_m:
                        oth = nids[n_m:]
                        order = np.argsort(pos_other[oth], kind="stable")
                        oth_n = oth[order]
                        oth_v = vals[n_m:][order]
                        if n_m:
                            nids = np.concatenate((nids[:n_m], oth_n))
                            vals = np.concatenate((vals[:n_m], oth_v))
                        else:
                            nids, vals = oth_n, oth_v
                    for nid, v in zip(nids.tolist(), vals.tolist()):
                        if book[nid] is not None:
                            send_routed(nid, v)

        if telon:
            fired_mask = fires_arr != prev_fires
            np.copyto(prev_fires, fires_arr)
            tel.observe(cycles, _classify(fired_mask))

        if not any_fired and not finished:
            if net is None or not arr_heap:
                if telon:
                    tel.finish(cycles)
                    summ = tel.stall_summary(window=64)
                else:
                    summ = _final_cycle_summary()
                raise SimDeadlock(_deadlock_msg(cp, rings, cycles)
                                  + format_stall_summary(summ),
                                  cycles=cycles, stall_summary=summ)
            # event skip: state is static until the next arrival (or the
            # memory credit crossing 1.0) — fast-forward to it.
            nxt = arr_heap[0]
            if mem_waiting and credit < 1.0 <= cap4:
                cc, n = credit, 0
                while cc < 1.0:
                    cc = min(cc + elems_per_cycle, cap4)
                    n += 1
                if cycles + n < nxt:
                    nxt = cycles + n
            k = nxt - 1 - cycles
            if k > 0:
                i = 0
                while i < k and credit < cap4:
                    credit = min(credit + elems_per_cycle, cap4)
                    i += 1
                cycles += k
                if telon:     # skipped cycles repeat the standing state
                    tel.observe_repeat(k)

    if telon:
        tel.finish(cycles)
    # write back per-node/per-edge telemetry so both backends expose the
    # same post-run state on the plan objects.
    fires: dict[str, int] = {}
    for nd in cp.nodes:
        f = int(fires_arr[nd.nid])
        if f:
            nd.fires += f
            fires[nd.op] = fires.get(nd.op, 0) + f
    for e in cp.edges:
        mo = int(maxocc[e.eid])
        if mo > e.max_occupancy:
            e.max_occupancy = mo
    return RawStats(
        cycles=cycles, flops=flops, loads=loads, stores=stores, fires=fires,
        max_queue_total=sum(e.max_occupancy for e in cp.g.edges()),
        token_hops=token_hops, stall_cycles=stall_cycles)
