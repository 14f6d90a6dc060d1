"""Plain PyTorch version of K7: the reference's ``_cycle_step`` over stacked
``(B, ...)`` tables, iterated in a Python ``while`` loop (port of
``repro.core.engine.jax_engine._cycle_step``/``_run_single``/``_sweep``).

It steps every lane of the batch in lockstep, as the reference's ``vmap``
of ``lax.while_loop`` does: a lane whose loop condition has dropped keeps
its carry while the others go on.  State is int32 (``qlen``, ``fires``,
``maxocc``, ``cycles``, ``status``), bool (``active``) and a float64 memory
credit, on whatever device the tables lie: on the CPU an eager loop of
cycles, on a card a CUDA graph of :data:`GRAPH_STEPS` cycles, replayed.
The CPU tests run it, and ``chip_smoke.py`` and the card tests run it on
the card as K7's yardstick; nothing on the main path calls it when a card
is present.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine.cuda_engine import (_DEADLOCKED, _FINISHED,
                                                 _RUNNING, lower,
                                                 shared_dims)

#: cycles a CUDA graph of the sweep holds on a card (a launch per op and
#: cycle would take some 12 minutes on the paper sweep's 431,035 cycles)
GRAPH_STEPS = 64
#: carry field names, in the order of the reference's carry tuple
CARRY = ("qlen", "active", "fires", "maxocc", "credit", "cycles", "status")
#: tables that index nodes, edges or buckets: int64 on the device, as torch
#: indexing and ``gather`` take them (their values are the int32 tables')
INDEX_TABLES = frozenset({"in_mat", "out_mat", "cmp_in", "cmp_slot", "esrc",
                          "edst", "mem_ids", "mem_slot", "flt_ids",
                          "flt_slot", "imux_ids", "imux_slot", "imux_pat",
                          "imux_ports"})


def cycle_step(t: dict, carry: tuple) -> tuple:
    """One simulator cycle over every lane's tables: the reference's
    ``_cycle_step`` with a leading batch axis (``t`` holds ``(B, ...)``
    tensors, ``epc``/``cap4``/``n_mem``/``n_cmp`` are ``(B,)``)."""
    qlen, active, fires, maxocc, credit, cycles, status = carry
    B = qlen.shape[0]
    b = torch.arange(B, device=qlen.device)[:, None]
    i32 = torch.int32

    def at(a, idx):                        # a[lane, idx[lane, ...]]
        return a[b.view(B, *([1] * (idx.dim() - 1))), idx]

    cycles = cycles + 1
    credit = torch.minimum(credit + t["epc"], t["cap4"])

    # dynamic per-cycle state derived from fire counts --------------------
    ik = at(fires, t["imux_ids"])
    sel_port = torch.gather(t["imux_pat"], 2,
                            (ik % t["imux_plen"]).long()[..., None])[..., 0]
    sel_eid = torch.gather(t["imux_ports"], 2, sel_port[..., None])[..., 0]
    sentE = torch.full((B, 1), qlen.shape[1] - 1, dtype=torch.int64,
                       device=qlen.device)
    # per-node selected in-edge; sentinel ("never empty") for non-imux
    sel_edge = at(torch.cat([sel_eid, sentE], 1), t["imux_slot"])

    fk = torch.minimum(torch.clamp(at(fires, t["flt_ids"]), min=0),
                       t["flt_klen"] - 1)
    keep_now = torch.gather(t["keep_mat"], 2, fk.long()[..., None])[..., 0]
    ones = torch.ones((B, 1), dtype=torch.bool, device=qlen.device)
    # per-node "filter drops its current token" (False for non-filters)
    flt_drop = ~at(torch.cat([keep_now, ones], 1), t["flt_slot"])
    out_opt = t["out_opt_static"] | flt_drop

    # phase 1: snapshot eligibility ---------------------------------------
    in_ok = ((at(qlen, t["in_mat"]) > 0).all(dim=2)
             & (at(qlen, sel_edge) > 0))
    cmp_ok = (at(qlen, t["cmp_in"]) > 0).all(dim=2)
    in_ok = in_ok & at(torch.cat([cmp_ok, ones], 1), t["cmp_slot"])
    out_ok = (at(qlen, t["out_mat"]) < t["capmat"]).all(dim=2)
    elig = in_ok & (out_ok | out_opt) & active

    # memory arbiter: fire iff the count of eligible memory nodes before
    # you in rotated order fits the integer credit
    M = t["mem_ids"].shape[1]
    n_mem = t["n_mem"][:, None]
    pos = torch.arange(M, dtype=i32, device=qlen.device)[None, :]
    valid = pos < n_mem
    em = at(elig, t["mem_ids"]) & valid
    rot = cycles[:, None] % n_mem
    key = torch.where(valid, (pos - rot) % n_mem,
                      torch.full_like(pos, 1 << 30))
    before = (em[:, None, :] & (key[:, None, :] < key[:, :, None])).sum(
        dim=2, dtype=i32)
    fire_mem = em & (before < torch.floor(credit).to(i32)[:, None])
    # f64 x - 1.0 is exact for x >= 1, so one subtraction of the fired
    # count is bit-identical to the interpreter's per-fire -= 1.0 walk
    credit = credit - fire_mem.sum(dim=1).to(credit.dtype)
    zeros = torch.zeros((B, 1), dtype=torch.bool, device=qlen.device)
    fired = (elig & ~t["is_mem"]) | at(torch.cat([fire_mem, zeros], 1),
                                       t["mem_slot"])

    # emission gates: filters drop unkept tokens, syncs emit only on the
    # expected-count tick with output space, cmp has no out-edges anyway
    sync_gate = torch.where(t["is_sync"],
                            (fires + 1 == t["sync_exp"]) & out_ok, True)
    emits = fired & sync_gate & ~flt_drop

    # phase 2: commit pops then pushes ------------------------------------
    eidx = torch.arange(qlen.shape[1], dtype=i32, device=qlen.device)
    dst = t["edst"]
    popped = at(fired, dst) & (t["epop_static"]
                               | (at(sel_edge, dst) == eidx[None, :]))
    pushed = at(emits, t["esrc"])
    qlen3 = qlen - popped.to(i32) + pushed.to(i32)

    # interpreter-exact occupancy sampling (see vector._expand_push): the
    # push saw this cycle's pop only where the consumer executes earlier
    occ_c = qlen + 1 - (t["pop_first"] & popped).to(i32)
    maxocc = torch.where(pushed, torch.maximum(maxocc, occ_c), maxocc)

    fires2 = fires + fired.to(i32)
    active2 = active & (fires2 < t["limit"]) & ~(emits & t["is_sync"])

    finished = (fires2 * t["is_cmp"]).sum(dim=1) >= t["n_cmp"]
    status = torch.where(finished, _FINISHED,
                         torch.where(fired.any(dim=1), _RUNNING,
                                     _DEADLOCKED)).to(i32)
    return (qlen3, active2, fires2, maxocc, credit, cycles, status)


def _live(carry: tuple, max_cycles: int) -> torch.Tensor:
    return (carry[6] == _RUNNING) & (carry[5] < max_cycles)


def _step_live(t: dict, carry: tuple, max_cycles: int) -> tuple:
    """One cycle of every lane whose loop condition holds; the others keep
    their carry, as under the reference's ``vmap`` of ``while_loop``."""
    live = _live(carry, max_cycles)
    B = live.shape[0]
    return tuple(torch.where(live.view(B, *([1] * (o.dim() - 1))), n, o)
                 for n, o in zip(cycle_step(t, carry), carry))


def sweep(t: dict, max_cycles: int) -> tuple:
    """Every lane's fixed-point loop over the stacked tables ``t`` (tensors
    on one device): lanes step in lockstep until the last one stops; a
    stopped lane's carry is frozen, as under the reference's ``vmap``.

    On a CUDA device the steps run as a CUDA graph of :data:`GRAPH_STEPS`
    cycles, replayed until every lane has stopped (a stopped lane's carry
    stays frozen through the surplus steps), with no host launch for each
    of its ops; on the CPU one cycle at a time."""
    qlen0 = t["qlen0"]
    B = qlen0.shape[0]
    dev = qlen0.device
    carry = (qlen0, t["active0"], torch.zeros_like(t["active0"],
                                                   dtype=torch.int32),
             torch.zeros_like(qlen0), torch.zeros(B, dtype=torch.float64,
                                                  device=dev),
             torch.zeros(B, dtype=torch.int32, device=dev),
             torch.full((B,), _RUNNING, dtype=torch.int32, device=dev))
    if dev.type != "cuda":
        while bool(_live(carry, max_cycles).any()):
            carry = _step_live(t, carry, max_cycles)
        return carry
    state = tuple(c.clone() for c in carry)

    def steps():
        c = state
        for _ in range(GRAPH_STEPS):
            c = _step_live(t, c, max_cycles)
        for st, new in zip(state, c):
            st.copy_(new)

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):           # warm-up before the capture
        steps()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        steps()
    for st, c in zip(state, carry):         # undo the warm-up's steps
        st.copy_(c)
    while bool(_live(state, max_cycles).any()):
        graph.replay()
    return state


def stack_tables(lows, epcs, device) -> dict:
    """The lowered plans' tables stacked along a lane axis, as tensors on
    ``device``, with the per-lane credit rate ``epc`` and its cap ``cap4``
    (``4.0 * epc`` in numpy, as the reference computes it)."""
    t = {k: np.stack([lp.tables[k] for lp in lows]) for k in lows[0].tables}
    t["epc"] = np.asarray(epcs, dtype=np.float64)
    t["cap4"] = 4.0 * t["epc"]
    return {k: torch.from_numpy(np.ascontiguousarray(
        v.astype(np.int64) if k in INDEX_TABLES else v)).to(device)
        for k, v in t.items()}


def simbatch_plain(lanes, max_cycles: int, device) -> list[dict]:
    """The plain version on ``lanes`` (``(compiled_plan, elems_per_cycle)``
    pairs): lowered to shared padded dims, stacked, swept on ``device``;
    one numpy carry dict per lane (padded lengths)."""
    cps = [cp for cp, _ in lanes]
    dims = shared_dims(cps)
    lows = [lower(cp, dims) for cp in cps]
    t = stack_tables(lows, [epc for _, epc in lanes], device)
    out = [a.cpu().numpy() for a in sweep(t, max_cycles)]
    return [{k: out[j][i] for j, k in enumerate(CARRY)}
            for i in range(len(lanes))]
