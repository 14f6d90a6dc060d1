// K7: the CGRA cycle engine, every lane of a batch run to its fixed point in
// one launch, for sm_90a (H100).
//
// Replaces the reference's device loop, which is no pallas_call but a
// jax.jit(jax.vmap(lax.while_loop(_cycle_step))) over lowered plans:
// repro/core/engine/jax_engine.py:_cycle_step, _run_single and _sweep.
//
// What bounds it on the H100: neither bytes nor flops.  A simulated cycle is
// a chain of dependent phases over a few thousand small integers (every
// node's eligibility reads the queue lengths the previous cycle wrote), so a
// lane is a sequence of block barriers, one cycle after another, and its
// time is its cycle count times the cost of a cycle's barriers and shared
// memory round trips.  The design keeps a lane's whole state on chip and
// pays three barriers a cycle; lanes are independent, so a batch runs its
// lanes side by side on the SMs, one block each, none waiting for another.
//
// A block owns one lane.  Shared memory holds, for the whole loop, the
// lane's queue lengths and peak occupancies (one per edge, and the sentinel
// edge nE that reads "never empty"), its fire counts, active bits, per-cycle
// flags and selected imux ports (one per node), and the memory arbiter's
// eligibility words; the memory credit (float64), the cycle count and the
// status live in registers, the same in every thread.  The static tables
// (node kinds and limits, in- and out-edge lists, edges' ends and
// capacities, the filters' keep bits, the imux patterns) are read from
// global memory.  A lane's thread count is sized on the host from its nodes
// and edges (kernels/simbatch/kernel.py:plan_threads); threads past it leave
// at once, and the barriers count only the lane's threads (named barrier 1
// with a thread count), so a small lane does not wait on the widest one's.
//
// Per cycle, in _cycle_step's order:
//   1. (nodes) each active node derives its imux port (fires % plen) or its
//      filter's keep bit (clip(fires, 0, klen - 1)), and from the queue
//      lengths at the start of the cycle its in_ok, out_ok and eligibility.
//      barrier
//   2. (warp 0) the memory arbiter: memory node j fires iff the number of
//      eligible memory nodes before it in the order rotated by
//      cycles % n_mem is below floor(credit): ballots give the eligible
//      words, popcounts under a mask the counts.  The credit is
//      fmin(credit + epc, cap4), less the number fired, in float64.
//      (others) every non-memory node: fired = eligible; emits; fires and
//      active updated.  Completed cmp nodes are counted in shared memory.
//      barrier, reducing "any node fired"
//   3. (edges) qlen' = qlen - popped + pushed; maxocc takes the occupancy the
//      push saw (qlen + 1 - (pop_first & popped)) where pushed.  Each edge has
//      one producer and one consumer, so no atomics.
//      barrier
// The loop runs while the status is RUNNING and cycles < max_cycles; then
// the block writes its final carry (qlen, active, fires, maxocc, credit,
// cycles, status) for the host's value pass and diagnostics.
//
// The credit is float64 throughout, added and subtracted with __dadd_rn and
// __dsub_rn (no contraction, no float32), so its walk is the other
// engines' bit for bit.
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
// per-cycle node flags in shared memory
constexpr uint8_t kElig = 1, kFired = 2, kEmits = 4, kOutOk = 8, kDrop = 16;

// lane descriptor: kernels/simbatch/kernel.py:LANE_FIELDS
enum : int {
  kNodeOff, kEdgeOff, kInOff, kOutOff, kKeepOff, kPatOff, kMemOff,
  kNodes, kEdges, kNMem, kNCmp, kThreads, kLaneFields = 16
};
// node record: kernels/simbatch/kernel.py:NODE_FIELDS
enum : int {
  nKind, nLimit, nSyncExp, nInStart, nInCnt, nOutStart, nOutCnt, nAux0,
  nAux1, kNodeFields
};

__device__ __forceinline__ void bar_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
}

// barrier over nthreads threads that returns whether any passed pred != 0
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

// shared memory of a lane: int32 qlen, maxocc (nE + 1 each), fires, sel
// (nN + 1 each); uint8 active, flags (nN + 1 each); uint32 eligibility
// words of the memory nodes; one int32 count of completed cmp nodes.
// kernels/simbatch/kernel.py:smem_bytes computes the same size.
struct Smem {
  int* qlen; int* maxocc; int* fires; int* sel;
  uint8_t* active; uint8_t* flags; uint32_t* memw; int* cmpsum;
};

__device__ __forceinline__ Smem carve(unsigned char* base, int nN, int nE,
                                      int n_mem) {
  Smem s;
  s.qlen = reinterpret_cast<int*>(base);
  s.maxocc = s.qlen + (nE + 1);
  s.fires = s.maxocc + (nE + 1);
  s.sel = s.fires + (nN + 1);
  s.active = reinterpret_cast<uint8_t*>(s.sel + (nN + 1));
  s.flags = s.active + (nN + 1);
  const size_t used = (size_t)(s.flags + (nN + 1) - base);
  s.memw = reinterpret_cast<uint32_t*>(base + ((used + 3) & ~(size_t)3));
  s.cmpsum = reinterpret_cast<int*>(s.memw + (n_mem + 31) / 32);
  return s;
}

// One node's fire, emission and counter update (phase 2); returns fired.
__device__ __forceinline__ int commit_node(const Smem& s, int n, int kind,
                                           const int* __restrict__ ni,
                                           int fired, int& cmp_fired) {
  const uint8_t f = s.flags[n];
  const int fires = s.fires[n];
  const bool sync = kind & kSync;
  const bool gate = !sync || (fires + 1 == ni[nSyncExp] && (f & kOutOk));
  const int emits = fired && gate && !(f & kDrop);
  const int fires2 = fires + fired;
  s.fires[n] = fires2;
  s.active[n] = s.active[n] && fires2 < ni[nLimit] && !(emits && sync);
  s.flags[n] = (uint8_t)((fired ? kFired : 0) | (emits ? kEmits : 0));
  if (fired && (kind & kCmp)) ++cmp_fired;
  return fired;
}

__global__ void __launch_bounds__(kMaxThreads)
simbatch_kernel(const int64_t* __restrict__ lanes,
                const double* __restrict__ rates,     // (epc, cap4) a lane
                const int* __restrict__ node_info,
                const int4* __restrict__ edge_info,   // src, dst, flags, cap
                const int* __restrict__ in_flat, const int* __restrict__ out_flat,
                const uint32_t* __restrict__ keep, const int* __restrict__ pat,
                const int* __restrict__ mem_flat, int max_cycles,
                int* __restrict__ out_qlen, int* __restrict__ out_maxocc,
                int* __restrict__ out_fires, uint8_t* __restrict__ out_active,
                double* __restrict__ out_credit, int* __restrict__ out_cycles,
                int* __restrict__ out_status) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int64_t* L = lanes + (int64_t)b * kLaneFields;
  const int T = (int)L[kThreads];
  const int tid = threadIdx.x;
  if (tid >= T) return;
  const int nN = (int)L[kNodes], nE = (int)L[kEdges];
  const int n_mem = (int)L[kNMem], n_cmp = (int)L[kNCmp];
  const int n_rot = n_mem > 0 ? n_mem : 1;
  const int* __restrict__ nodes = node_info + L[kNodeOff] * kNodeFields;
  const int4* __restrict__ edges = edge_info + L[kEdgeOff];
  const int* __restrict__ ins = in_flat + L[kInOff];
  const int* __restrict__ outs = out_flat + L[kOutOff];
  const uint32_t* __restrict__ kbits = keep + L[kKeepOff];
  const int* __restrict__ pats = pat + L[kPatOff];
  const int* __restrict__ mems = mem_flat + L[kMemOff];
  const double epc = rates[2 * b], cap4 = rates[2 * b + 1];
  const Smem s = carve(smem, nN, nE, n_mem);

  for (int e = tid; e <= nE; e += T) {
    s.qlen[e] = e < nE ? 0 : kQBig;
    s.maxocc[e] = 0;
  }
  for (int n = tid; n <= nN; n += T) {
    s.fires[n] = 0;
    s.sel[n] = nE;
    s.flags[n] = 0;
    s.active[n] = n < nN && (nodes[n * kNodeFields + nKind] & kActive0);
  }
  if (tid == 0) *s.cmpsum = 0;
  bar_sync(T);

  const int warp = tid >> 5, lane = tid & 31;
  int cycles = 0, status = kRunning;
  double credit = 0.0;                 // warp 0's; the same in each lane
  while (status == kRunning && cycles < max_cycles) {
    // -- 1. eligibility from the queue lengths at the start of the cycle --
    for (int n = tid; n < nN; n += T) {
      uint8_t f = 0;
      if (s.active[n]) {
        const int* ni = nodes + n * kNodeFields;
        const int kind = ni[nKind];
        const int fires = s.fires[n];
        bool in_ok = true, out_ok = true, drop = false;
        if (kind & kImux) {
          const int port = pats[ni[nAux0] + fires % ni[nAux1]];
          const int sel = port < ni[nInCnt] ? ins[ni[nInStart] + port] : nE;
          s.sel[n] = sel;
          in_ok = s.qlen[sel] > 0;
        } else {
          for (int k = ni[nInStart], end = k + ni[nInCnt]; k < end; ++k)
            in_ok = in_ok && s.qlen[ins[k]] > 0;
        }
        for (int k = ni[nOutStart], end = k + ni[nOutCnt]; k < end; ++k) {
          const int e = outs[k];
          out_ok = out_ok && s.qlen[e] < edges[e].w;
        }
        if (kind & kFlt) {
          const int kk = min(max(fires, 0), ni[nAux1] - 1);
          const int bit = ni[nAux0] + kk;
          drop = !((kbits[bit >> 5] >> (bit & 31)) & 1u);
        }
        const bool elig = in_ok && (out_ok || drop || (kind & kOutOpt));
        f = (elig ? kElig : 0) | (out_ok ? kOutOk : 0) | (drop ? kDrop : 0);
      }
      s.flags[n] = f;
    }
    bar_sync(T);

    // -- 2. the memory arbiter (warp 0) and every other node's commit -----
    ++cycles;
    int any_fired = 0, cmp_fired = 0;
    if (warp == 0) {
      credit = fmin(__dadd_rn(credit, epc), cap4);
      const int allowed = (int)floor(credit);
      const int rot = cycles % n_rot;
      const int words = (n_mem + 31) / 32;
      int total = 0;
      for (int w = 0; w < words; ++w) {
        const int j = w * 32 + lane;
        const bool e = j < n_mem && (s.flags[mems[j]] & kElig);
        const uint32_t bits = __ballot_sync(0xffffffffu, e);
        if (lane == 0) s.memw[w] = bits;
        total += __popc(bits);
      }
      __syncwarp();
      // eligible memory nodes at positions < i
      auto prefix = [&](int i) {
        int c = 0;
        for (int w = 0; w < (i >> 5); ++w) c += __popc(s.memw[w]);
        if (i & 31) c += __popc(s.memw[i >> 5] & ((1u << (i & 31)) - 1u));
        return c;
      };
      const int p_rot = prefix(rot);
      for (int w = 0; w < words; ++w) {
        const int j = w * 32 + lane;
        if (j >= n_mem) continue;
        const int n = mems[j];
        int fire = 0;
        if ((s.memw[w] >> lane) & 1u) {
          const int p = prefix(j);
          const int before = j >= rot ? p - p_rot : total - p_rot + p;
          fire = before < allowed;
        }
        any_fired |= commit_node(s, n, kMem, nodes + n * kNodeFields, fire,
                                 cmp_fired);
      }
      // the eligible nodes' ranks are 0 .. total-1: min(total, allowed) fire
      credit = __dsub_rn(credit, (double)min(total, max(allowed, 0)));
    }
    for (int n = tid; n < nN; n += T) {
      const int* ni = nodes + n * kNodeFields;
      const int kind = ni[nKind];
      if (kind & kMem) continue;                // warp 0's
      any_fired |= commit_node(s, n, kind, ni, s.flags[n] & kElig, cmp_fired);
    }
    if (cmp_fired) atomicAdd(s.cmpsum, cmp_fired);
    const int fired = bar_or(any_fired, T);
    status = *s.cmpsum >= n_cmp ? kFinished
             : fired            ? kRunning
                                : kDeadlocked;

    // -- 3. pops then pushes, one thread an edge ---------------------------
    for (int e = tid; e < nE; e += T) {
      const int4 ed = edges[e];                 // src, dst, flags, cap
      const uint8_t fs = s.flags[ed.x], fd = s.flags[ed.y];
      const int popped = (fd & kFired) && ((ed.z & kPopStatic) || s.sel[ed.y] == e);
      const int q = s.qlen[e];
      if (fs & kEmits) {
        const int occ = q + 1 - ((ed.z & kPopFirst) && popped);
        if (occ > s.maxocc[e]) s.maxocc[e] = occ;
        s.qlen[e] = q - popped + 1;
      } else if (popped) {
        s.qlen[e] = q - 1;
      }
    }
    bar_sync(T);
  }

  const int64_t eo = L[kEdgeOff], no = L[kNodeOff];
  for (int e = tid; e <= nE; e += T) {
    out_qlen[eo + e] = s.qlen[e];
    out_maxocc[eo + e] = s.maxocc[e];
  }
  for (int n = tid; n <= nN; n += T) {
    out_fires[no + n] = s.fires[n];
    out_active[no + n] = s.active[n];
  }
  if (tid == 0) {
    out_credit[b] = credit;
    out_cycles[b] = cycles;
    out_status[b] = status;
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

}  // namespace

extern "C" {

// One block per lane (`lanes` of them), `threads` a block (the widest
// lane's, a multiple of 32 up to 1024), `smem` bytes of dynamic shared
// memory (the largest lane's).  The tables and outputs are laid out as
// kernels/simbatch/kernel.py:pack and simbatch_kernel describe.  Returns
// cudaGetLastError().
int simbatch_launch(const int64_t* lane_desc, const double* rates,
                    const int* node_info, const int* edge_info,
                    const int* in_flat, const int* out_flat,
                    const uint32_t* keep, const int* pat, const int* mem_flat,
                    int n_lanes, int threads, int smem, int max_cycles,
                    int* out_qlen, int* out_maxocc, int* out_fires,
                    uint8_t* out_active, double* out_credit, int* out_cycles,
                    int* out_status, void* stream) {
  if (n_lanes < 1 || threads < 32 || threads > kMaxThreads || threads % 32
      || smem < 0 || max_cycles < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute((const void*)simbatch_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return (int)e;
  simbatch_kernel<<<n_lanes, threads, smem, (cudaStream_t)stream>>>(
      lane_desc, rates, node_info, reinterpret_cast<const int4*>(edge_info),
      in_flat, out_flat, keep, pat, mem_flat, max_cycles, out_qlen,
      out_maxocc, out_fires, out_active, out_credit, out_cycles, out_status);
  return (int)cudaGetLastError();
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
