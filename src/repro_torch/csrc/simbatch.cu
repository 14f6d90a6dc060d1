// K7: the CGRA cycle engine, every lane of a batch run to its fixed point in
// one launch, for sm_90a (H100).
//
// Replaces the reference's device loop, which is no pallas_call but a
// jax.jit(jax.vmap(lax.while_loop(_cycle_step))) over lowered plans:
// repro/core/engine/jax_engine.py:_cycle_step, _run_single and _sweep.
//
// What bounds it on the H100: neither bytes nor flops.  A simulated cycle is
// a chain of dependent steps over a few thousand small integers (every
// node's eligibility reads the queue lengths the previous cycle wrote), so a
// lane is a sequence of block barriers, one cycle after another, and its
// time is its cycle count times the cost of a cycle: its barriers, the
// dependent instructions and shared-memory round trips between them, and,
// in wide lanes, the instructions the SM issues for all of its nodes and
// edges.  Lanes are independent, so a batch runs its lanes side by side on
// the SMs, one block each.
//
// The design keeps that chain short:
// - Static records live in registers.  Thread tid >= 32 owns the node
//   slots tid - 32 + i*(T - 32) and every thread the edges tid + i*T
//   (i < ITEMS, T the lane's threads) for the whole loop, and loads their
//   records once: a node's kind, fire limit and two aux words (sync: the
//   expected count; filter: keep-bit offset and count; imux: pattern offset
//   and length), an edge's ends, pop flags and capacity.  It keeps their
//   state there too: a node's fire count, active bit and its filter's
//   current keep word or its imux's selected edge; an edge's length and
//   peak occupancy.  ITEMS is a template parameter, so the arrays are
//   registers (kernels/simbatch/kernel.py:plan picks the smallest instance
//   that holds the lane: one node and one edge a thread up to 1,024
//   threads).  The slots list the non-memory nodes grouped by kind, so a
//   warp's nodes mostly take one path.  Inside the loop only shared memory,
//   a filter's next keep word and an imux's next pattern entry (read after
//   the node fires) are read.
// - Eligibility is O(1) a node.  Each node has a word in shared memory:
//   its flags for the edge phase, a starved byte (some in-edge of a
//   non-imux node is empty) and a blocked byte (some out-edge is at
//   capacity).  The edge phase sets the bytes from every edge's new length
//   each cycle; the node's owner reads the word and overwrites it with its
//   flags (every node, every cycle), so at the start of a node phase the
//   bytes are their recomputation from the queue lengths and capacities.
//   An imux reads the length of its selected edge.  No edge list is walked.
// - Two barriers a cycle.  A non-memory node fires iff it is eligible, so
//   its owner decides and commits it in one node phase.  Warp 0 owns the
//   memory nodes and no other node: meanwhile it computes their
//   eligibility, arbitrates with a ballot and popcounts (up to 32 memory
//   nodes in its lanes' registers, more in words of shared memory), and
//   commits them, with no block barrier between.
//
// Per cycle, in _cycle_step's order:
//   1. (warps 1 ..) each active non-memory node: eligibility from its word
//      (or its imux edge's length), fired = eligible, emission, fire count
//      and active bit; it publishes fired/emits (and an imux its edge).
//      (warp 0) the memory arbiter: memory node j fires iff the number of
//      eligible memory nodes before it in the order rotated by
//      cycles % n_mem is below floor(credit); the credit is
//      fmin(credit + epc, cap4), less the number fired, in float64.
//      barrier, reducing "any node fired"
//   2. (edges) qlen' = qlen - popped + pushed; maxocc takes the occupancy the
//      push saw (qlen + 1 - (pop_first & popped)) where pushed; the edge
//      sets its consumer's starved and its producer's blocked byte.  Each
//      edge has one producer and one consumer, and racing writers of a
//      byte store the same 1, so no atomics.
//      barrier, reducing "some completion (cmp) node has not fired"
// The loop runs while the status is RUNNING and cycles < max_cycles; then
// the block writes its final carry (qlen, active, fires, maxocc, credit,
// cycles, status) for the host's value pass and diagnostics.
//
// The credit is float64 throughout, added and subtracted with __dadd_rn and
// __dsub_rn (no contraction, no float32), so its walk is the other
// engines' bit for bit.
//
// A clocked instance of the same body (kClock) also records, per lane,
// clock64() summed over the cycles for each phase and %globaltimer at the
// block's start and end (scripts/k7_phases.py); the main path's instance
// carries no clock reads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRunning = 0, kFinished = 1, kDeadlocked = 2;
constexpr int kQBig = 1 << 29;       // the sentinel edge: never empty
constexpr int kMaxThreads = 1024;

// node kind bits (kernels/simbatch/kernel.py: F_*)
constexpr int kMem = 1, kSync = 2, kCmp = 4, kImux = 8, kFlt = 16,
              kOutOpt = 32, kActive0 = 64;
// edge flag bits
constexpr int kPopFirst = 1, kPopStatic = 2;
// a node's word in shared memory: byte 0 its flags for the edge phase,
// byte 1 starved, byte 2 blocked
constexpr uint32_t kFired = 1, kEmits = 2, kStarved = 1u << 8,
                   kBlocked = 1u << 16;

// lane descriptor: kernels/simbatch/kernel.py:LANE_FIELDS
enum : int {
  kNodeOff, kEdgeOff, kKeepOff, kPatOff, kMemOff, kOrderOff, kNodes, kEdges,
  kNMem, kThreads, kLaneFields = 16
};

// The clocked instance's record of a lane (kernels/simbatch/kernel.py:
// CLOCK_FIELDS): clock64() summed over the cycles for each phase, then the
// loop's total clocks and %globaltimer (ns) at the block's start and end.
// The node phase is thread 32's (a node owner), every other phase thread
// 0's (warp 0, the arbiter).
enum : int {
  cNode, cArbiter, cBarOr, cEdge, cBarEnd, kPhases,
  cTotal = kPhases, cStartNs, cEndNs, kClockFields = 8
};

// The ITEMS instances and the most threads each runs (its
// __launch_bounds__): as many as let the owned records stay in registers;
// ITEMS = 32, the widest lanes', spills to local memory.  The same table
// as kernels/simbatch/kernel.py:INSTANCES.
#define SIMBATCH_INSTANCES(X) X(1, 1024) X(4, 768) X(32, 1024)

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Per-phase clock sums of the clocked instance; compiles to nothing when
// kClock is false.
template <bool kClock>
struct Laps {
  long long acc[kPhases] = {};
  long long t = 0;
  __device__ __forceinline__ void start() {
    if (kClock) t = clock64();
  }
  __device__ __forceinline__ void lap(int phase) {
    if (kClock) {
      const long long now = clock64();
      acc[phase] += now - t;
      t = now;
    }
  }
};

// barrier 1 over nthreads threads that returns whether any passed pred != 0
__device__ __forceinline__ int bar_or(int pred, int nthreads) {
  int out;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\t"
      "setp.ne.s32 p, %1, 0;\n\t"
      "bar.red.or.pred q, 1, %2, p;\n\t"
      "selp.s32 %0, 1, 0, q;\n\t}"
      : "=r"(out)
      : "r"(pred), "r"(nthreads)
      : "memory");
  return out;
}

__device__ __forceinline__ void bar_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
}

// shared memory of a lane, all int32: qlen (nE + 1; read only for edges
// into an imux and the sentinel), sel (nN + 1: an imux's edge the cycle it
// fired), a word a node and the sentinel (flags, starved, blocked), the
// memory slots' node ids and fires left before they go inactive (n_mem
// each; an active node fires at least once, as _cycle_step checks the
// limit after a fire; used when n_mem > 32) and eligibility words.
// kernels/simbatch/kernel.py:smem_bytes computes the same size.
struct Smem {
  int* qlen; int* sel; uint32_t* nw; int* mnode; int* mleft; uint32_t* memw;
};

__device__ __forceinline__ Smem carve(unsigned char* base, int nN, int nE,
                                      int n_mem) {
  Smem s;
  s.qlen = reinterpret_cast<int*>(base);
  s.sel = s.qlen + (nE + 1);
  s.nw = reinterpret_cast<uint32_t*>(s.sel + (nN + 1));
  s.mnode = reinterpret_cast<int*>(s.nw + (nN + 1));
  s.mleft = s.mnode + n_mem;
  s.memw = reinterpret_cast<uint32_t*>(s.mleft + n_mem);
  return s;
}

__device__ __forceinline__ void set_byte(uint32_t* nw, int n, int byte) {
  reinterpret_cast<uint8_t*>(nw)[4 * n + byte] = 1;
}

template <int ITEMS, int MAX_THREADS, bool kClock>
__global__ void __launch_bounds__(MAX_THREADS)
simbatch_kernel(const int64_t* __restrict__ lanes,
                const double* __restrict__ rates,     // (epc, cap4) a lane
                const int4* __restrict__ node_info,   // kind, limit, aux0, aux1
                const int4* __restrict__ edge_info,   // src, dst, flags, cap
                const uint32_t* __restrict__ keep, const int* __restrict__ pat,
                const int* __restrict__ mem_flat,
                const int* __restrict__ order_flat, int max_cycles,
                int* __restrict__ out_qlen, int* __restrict__ out_maxocc,
                int* __restrict__ out_fires, uint8_t* __restrict__ out_active,
                double* __restrict__ out_credit, int* __restrict__ out_cycles,
                int* __restrict__ out_status, long long* __restrict__ clocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long start_ns = kClock ? global_ns() : 0;
  const int b = blockIdx.x;
  const int64_t* L = lanes + (int64_t)b * kLaneFields;
  const int T = (int)L[kThreads];
  const int tid = threadIdx.x;
  if (tid >= T) return;
  const int nN = (int)L[kNodes], nE = (int)L[kEdges], n_mem = (int)L[kNMem];
  const int n_rot = n_mem > 0 ? n_mem : 1, words = (n_mem + 31) / 32;
  const int slots = nN - n_mem, W = T - 32;    // node owners: tid 32 .. T-1
  const int4* __restrict__ nodes = node_info + L[kNodeOff];
  const int4* __restrict__ edges = edge_info + L[kEdgeOff];
  const uint32_t* __restrict__ kbits = keep + L[kKeepOff];
  const int* __restrict__ pats = pat + L[kPatOff];
  const int* __restrict__ mems = mem_flat + L[kMemOff];
  const int* __restrict__ order = order_flat + L[kOrderOff];
  const double epc = rates[2 * b], cap4 = rates[2 * b + 1];
  const Smem s = carve(smem, nN, nE, n_mem);
  const int warp = tid >> 5, lane = tid & 31;

  // -- owned records and state, in registers for the whole loop ------------
  // thread tid >= 32 owns node slots tid - 32 + i*W (order: the non-memory
  // nodes, grouped by kind, so that a warp's nodes mostly take one path);
  // every thread owns the edges tid + i*T
  int nid[ITEMS];
  int4 nd[ITEMS];        // kind (kMem: no node), limit, aux0, aux1
  int fires[ITEMS];
  int aux[ITEMS];        // a filter's keep word, an imux's selected edge
  bool act[ITEMS];
  int4 ed[ITEMS];        // src, dst, flags, cap
  int ql[ITEMS], mo[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int k = tid - 32 + i * W, e = tid + i * T;
    const bool own = tid >= 32 && k < slots;
    nid[i] = own ? order[k] : nN;
    nd[i] = own ? nodes[nid[i]] : make_int4(kMem, 0, 0, 0);
    fires[i] = 0;
    act[i] = nd[i].x & kActive0;
    aux[i] = nd[i].x & kImux ? pats[nd[i].z]
             : nd[i].x & kFlt ? (int)kbits[nd[i].z >> 5] : 0;
    ed[i] = e < nE ? edges[e] : make_int4(0, 0, 0, 0);
    ql[i] = 0;
    mo[i] = 0;
  }
  for (int e = tid; e <= nE; e += T) s.qlen[e] = e < nE ? 0 : kQBig;
  for (int n = tid; n <= nN; n += T) {
    s.sel[n] = nE;
    s.nw[n] = 0;
  }
  for (int j = tid; j < n_mem; j += T) {
    const int n = mems[j];
    const int4 r = nodes[n];
    s.mnode[j] = n;
    s.mleft[j] = r.x & kActive0 ? max(r.y, 1) : 0;
  }
  // warp 0 lane j's memory slot in registers when there are at most 32
  // (the sentinel node for lanes past n_mem)
  int m_node = nN, m_left = 0;
  if (tid < n_mem && n_mem <= 32) {
    m_node = mems[tid];
    const int4 r = nodes[m_node];
    m_left = r.x & kActive0 ? max(r.y, 1) : 0;
  }
  bar_sync(T);
  // every queue is empty at the start: the bytes from qlen = 0
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (tid + i * T >= nE) continue;
    if (ed[i].z & kPopStatic) set_byte(s.nw, ed[i].y, 1);
    if (0 >= ed[i].w) set_byte(s.nw, ed[i].x, 2);
  }
  bar_sync(T);

  int cycles = 0, status = kRunning;
  // warp 0's, the same in each lane: the rotation (cycles % n_mem), the
  // credit after the last cycle, the next cycle's before its fires
  int rot = 0;
  double credit = 0.0, credit_in = fmin(__dadd_rn(0.0, epc), cap4);
  int allowed = (int)floor(credit_in);
  Laps<kClock> laps;
  const long long clock0 = kClock ? clock64() : 0;
  laps.start();
  while (status == kRunning && cycles < max_cycles) {
    ++cycles;
    // -- 1. nodes: eligibility and commit in one phase (warps 1 ..) --------
    int any_fired = 0, pending = 0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int n = nid[i], kind = nd[i].x;
      if (kind & kMem) continue;        // no node in this slot
      const uint32_t w = s.nw[n];
      const bool imux = kind & kImux, flt = kind & kFlt, sync = kind & kSync;
      const bool in_ok = imux ? s.qlen[aux[i]] > 0 : !(w & kStarved);
      const bool out_ok = !(w & kBlocked);
      const int kk = nd[i].z + min(fires[i], nd[i].w - 1);
      const bool drop = flt && !((aux[i] >> (kk & 31)) & 1);
      const bool fired = act[i] && in_ok
                         && (out_ok || drop || (kind & kOutOpt));
      const bool emits = fired && !drop
                         && (!sync || (fires[i] + 1 == nd[i].z && out_ok));
      fires[i] += fired;
      act[i] = act[i] && fires[i] < nd[i].y && !(emits && sync);
      // publish the flags; clear starved and blocked for the edge phase
      s.nw[n] = (fired ? kFired : 0) | (emits ? kEmits : 0);
      any_fired |= fired;
      pending |= (kind & kCmp) && fires[i] == 0;
      if (fired && imux) {              // its next pattern entry
        s.sel[n] = aux[i];
        aux[i] = pats[nd[i].z + fires[i] % nd[i].w];
      }
      if (fired && flt) {               // its next keep word, if it moved
        const int k2 = nd[i].z + min(fires[i], nd[i].w - 1);
        if ((k2 >> 5) != (kk >> 5)) aux[i] = (int)kbits[k2 >> 5];
      }
    }
    if (kClock && tid == 32) laps.lap(cNode);
    // -- 1. the memory arbiter and its commits (warp 0, meanwhile) ---------
    if (warp == 0) {
      rot = rot + 1 == n_rot ? 0 : rot + 1;
      int total = 0;
      if (n_mem <= 32) {
        // one word: lane j owns memory slot j in registers
        const bool e = m_left > 0 && !(s.nw[m_node] & (kStarved | kBlocked));
        const uint32_t bits = __ballot_sync(0xffffffffu, e);
        total = __popc(bits);
        const int p_rot = __popc(bits & ((1u << rot) - 1u));
        const int p = __popc(bits & ((1u << lane) - 1u));
        const int before = lane >= rot ? p - p_rot : total - p_rot + p;
        const bool fire = e && before < allowed;
        m_left -= fire;
        s.nw[m_node] = fire ? kFired | kEmits : 0;
        any_fired |= fire;
      } else {
        // words of 32 slots in shared memory
        int p_rot = 0;
        uint32_t bits0 = 0;
        for (int w = 0; w < words; ++w) {
          const int j = w * 32 + lane;
          const bool e = j < n_mem && s.mleft[j] > 0
                         && !(s.nw[s.mnode[j]] & (kStarved | kBlocked));
          const uint32_t bits = __ballot_sync(0xffffffffu, e);
          if (w == 0) bits0 = bits;
          else if (lane == 0) s.memw[w] = bits;
          if (w == rot >> 5)
            p_rot = total + __popc(bits & ((1u << (rot & 31)) - 1u));
          total += __popc(bits);
        }
        __syncwarp();
        // eligible memory nodes before position j: after the rotation point
        // they count from it, before it they wrap
        int seen = 0;
        for (int w = 0; w < words; ++w) {
          const uint32_t bits = w == 0 ? bits0 : s.memw[w];
          const int j = w * 32 + lane;
          if (j < n_mem) {
            int fire = 0;
            if ((bits >> lane) & 1u) {
              const int p = seen + __popc(bits & ((1u << lane) - 1u));
              const int before = j >= rot ? p - p_rot : total - p_rot + p;
              fire = before < allowed;
            }
            if (fire) --s.mleft[j];
            s.nw[s.mnode[j]] = fire ? kFired | kEmits : 0;
            any_fired |= fire;
          }
          seen += __popc(bits);
        }
      }
      // the eligible nodes' ranks are 0 .. total-1: min(total, allowed) fire
      credit = __dsub_rn(credit_in, (double)min(total, max(allowed, 0)));
    }
    laps.lap(cArbiter);
    const int fired = bar_or(any_fired, T);
    laps.lap(cBarOr);
    if (warp == 0) {                  // the next cycle's credit, off its path
      credit_in = fmin(__dadd_rn(credit, epc), cap4);
      allowed = (int)floor(credit_in);
    }

    // -- 2. edges: pops then pushes, and the consumer's and producer's bytes
    const uint8_t* flags = reinterpret_cast<const uint8_t*>(s.nw);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int e = tid + i * T;
      if (e >= nE) continue;
      const int4 r = ed[i];
      const bool popped = (flags[4 * r.y] & kFired)
                          && ((r.z & kPopStatic) || s.sel[r.y] == e);
      int q = ql[i];
      if (flags[4 * r.x] & kEmits) {
        const int occ = q + 1 - ((r.z & kPopFirst) && popped);
        mo[i] = max(mo[i], occ);
        ++q;
      }
      q -= popped;
      ql[i] = q;
      if (!(r.z & kPopStatic)) s.qlen[e] = q;    // an imux reads it
      else if (q == 0) set_byte(s.nw, r.y, 1);   // starved
      if (q >= r.w) set_byte(s.nw, r.x, 2);      // blocked
    }
    laps.lap(cEdge);
    const int unfinished = bar_or(pending, T);
    laps.lap(cBarEnd);
    status = !unfinished ? kFinished : fired ? kRunning : kDeadlocked;
  }

  const int64_t eo = L[kEdgeOff], no = L[kNodeOff];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int e = tid + i * T;
    if (!(nd[i].x & kMem)) {
      out_fires[no + nid[i]] = fires[i];
      out_active[no + nid[i]] = act[i];
    }
    if (e < nE) {
      out_qlen[eo + e] = ql[i];
      out_maxocc[eo + e] = mo[i];
    }
  }
  for (int j = tid; j < n_mem; j += T) {   // the memory slots: fires, active
    const int n = s.mnode[j], left = n_mem <= 32 ? m_left : s.mleft[j];
    const int4 r = nodes[n];
    out_fires[no + n] = (r.x & kActive0 ? max(r.y, 1) : 0) - left;
    out_active[no + n] = left > 0;
  }
  if (kClock && tid == 32) clocks[(int64_t)b * kClockFields + cNode] =
      laps.acc[cNode];
  if (tid == 0) {
    out_qlen[eo + nE] = kQBig;
    out_maxocc[eo + nE] = 0;
    out_fires[no + nN] = 0;
    out_active[no + nN] = 0;
    out_credit[b] = credit;
    out_cycles[b] = cycles;
    out_status[b] = status;
    if (kClock) {
      long long* c = clocks + (int64_t)b * kClockFields;
      c[cTotal] = clock64() - clock0;
      for (int i = 0; i < kPhases; ++i)
        if (i != cNode) c[i] = laps.acc[i];
      c[cStartNs] = start_ns;
      c[cEndNs] = global_ns();
    }
  }
}

// The barrier chain alone: `barriers` named barriers over the block's
// threads, for K7's bound (kernels/simbatch/kernel.py:barrier_ms).
__global__ void __launch_bounds__(kMaxThreads)
simbatch_barrier_kernel(int barriers, int* __restrict__ sink) {
  int acc = 0;
  for (int i = 0; i < barriers; ++i) {
    bar_sync(blockDim.x);
    acc += i;
  }
  if (threadIdx.x == 0) sink[blockIdx.x] = acc;
}

template <int ITEMS, int MAX_THREADS>
int launch_items(bool clocked, int n_lanes, int threads, int smem,
                 cudaStream_t stream, const int64_t* lane_desc,
                 const double* rates, const int* node_info,
                 const int* edge_info, const uint32_t* keep, const int* pat,
                 const int* mem_flat, const int* order, int max_cycles,
                 int* out_qlen, int* out_maxocc, int* out_fires,
                 uint8_t* out_active, double* out_credit, int* out_cycles,
                 int* out_status, long long* clocks) {
  if (threads > MAX_THREADS) return (int)cudaErrorInvalidValue;
  auto* kernel = clocked ? simbatch_kernel<ITEMS, MAX_THREADS, true>
                         : simbatch_kernel<ITEMS, MAX_THREADS, false>;
  cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<n_lanes, threads, smem, stream>>>(
      lane_desc, rates, reinterpret_cast<const int4*>(node_info),
      reinterpret_cast<const int4*>(edge_info), keep, pat, mem_flat, order,
      max_cycles, out_qlen, out_maxocc, out_fires, out_active, out_credit,
      out_cycles, out_status, clocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One block per lane (`lanes` of them) of the ITEMS = `items` instance
// (SIMBATCH_INSTANCES), `threads` a block (the widest lane's, a multiple
// of 32 from 64 up to the instance's most), `smem` bytes of dynamic shared
// memory (the largest lane's).  The tables and outputs are laid out as
// kernels/simbatch/kernel.py:pack and simbatch_kernel describe; `clocks`
// non-null runs the clocked instance, which fills kClockFields int64 a
// lane.  Returns cudaGetLastError().
int simbatch_launch(const int64_t* lane_desc, const double* rates,
                    const int* node_info, const int* edge_info,
                    const uint32_t* keep, const int* pat, const int* mem_flat,
                    const int* order, int n_lanes, int items, int threads,
                    int smem, int max_cycles, int* out_qlen, int* out_maxocc,
                    int* out_fires, uint8_t* out_active, double* out_credit,
                    int* out_cycles, int* out_status, long long* clocks,
                    void* stream) {
  if (n_lanes < 1 || threads < 64 || threads % 32 || smem < 0
      || max_cycles < 0)
    return (int)cudaErrorInvalidValue;
  const bool clocked = clocks != nullptr;
  const cudaStream_t st = (cudaStream_t)stream;
#define SIMBATCH_ITEMS(I, MAX)                                               \
  case I:                                                                    \
    return launch_items<I, MAX>(clocked, n_lanes, threads, smem, st,         \
                                lane_desc, rates, node_info, edge_info,      \
                                keep, pat, mem_flat, order, max_cycles,      \
                                out_qlen, out_maxocc, out_fires, out_active, \
                                out_credit, out_cycles, out_status, clocks);
  switch (items) {
    SIMBATCH_INSTANCES(SIMBATCH_ITEMS)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SIMBATCH_ITEMS
}

// The barrier-only instance: one block of `threads` that passes `barriers`
// barriers.  Returns cudaGetLastError().
int simbatch_barrier_launch(int threads, int barriers, int* sink,
                            void* stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 || barriers < 0)
    return (int)cudaErrorInvalidValue;
  simbatch_barrier_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(barriers,
                                                                   sink);
  return (int)cudaGetLastError();
}

const char* simbatch_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
