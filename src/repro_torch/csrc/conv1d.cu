// Depthwise causal conv1d with an optional fused bias, for sm_90a (H100):
// y[b,s,c] = sum_k w[k,c] * x[b, s-K+1+k, c] (+ bias[c]), zero before s = 0.
//
// Replaces the TPU kernel repro/kernels/conv1d/kernel.py:conv1d_pallas
// (_body), and the bias the JAX package's Pallas path adds after it
// (repro/kernels/conv1d/ops.py).
//
// What bounds it on the H100: device-memory bytes.  K = 4 taps are 4 FMAs
// per element for 4 bytes (f32) or 2 bytes (bf16) read and as many written,
// far below the card's flop/byte balance, so the least time is one read of
// x and one write of y at the HBM rate.  Reaching it takes many bytes in
// flight: a thread that loads one element, sums it and stores it before it
// loads the next keeps a few KB in flight per SM, where HBM's latency at
// 3.35 TB/s asks for some 20 KB.
//
// Work is indexed over flattened (batch, position) runs of `run` positions,
// so no grid dimension is bounded by the batch or the sequence.  A thread
// owns one run of one unit of channels; a vector block, `threads` units of
// one run (one 32-bit division a block, no warp across two runs):
//
// - Vector instances (K = 1..4; C * itemsize a multiple of 16; x, w and y
//   on 16-byte boundaries; kernels/conv1d/kernel.py:plan picks them on the
//   host and the launcher refuses a mismatch): the unit is one 16-byte chunk
//   of channels (8 bf16 or 4 f32), neighbouring lanes on neighbouring
//   chunks, so a warp moves 512 contiguous bytes of a row per instruction.
//   A thread keeps the K taps of its channels (read as K 16-byte chunks),
//   the K-1 previous inputs (widened as they are read) and the bias in
//   registers, and issues the 16-byte loads of AHEAD rows (a compile-time,
//   fully unrolled block) before their FMAs.  The K-1 rows before the run
//   are read at its start: zero before s = 0, never across a batch row.
//   Short runs (8 rows at the model's shape) keep many threads, and so
//   many loads, in flight; the halo they re-read mostly hits the L2.
// - The generic instance (any K <= 32, any C, any alignment): the unit is
//   one channel, 2-byte or 4-byte accesses.  Its window has KW >= K slots
//   (KW = 4, 8, 16, 32), the taps right-aligned in it; slots before the
//   first tap are skipped, not multiplied by a zero pad, so an infinite
//   input K or more positions back never becomes a NaN.
//
// Both sum in float32 with fmaf in tap order from 0 and cast once to the
// input type.  The bias, where given, is added after that cast, in float32,
// and rounded again (the Pallas path's two roundings in bf16; in f32 one
// __fadd_rn, which the compiler cannot contract into the last FMA), so the
// fused op has the bits of the kernel followed by
// (y.float() + b.float()).to(x.dtype).
//
// The backward (conv1d_bwd_launch), which training needs, has no TPU kernel
// to replace: the JAX package differentiates the forward by autodiff.  One
// pass over x and dy gives all three gradients:
//   dx[b,t,c] = sum_k w[k,c] * dy[b, t+K-1-k, c]   (dy zero past S-1),
//   dw[k,c]   = sum_{b,t} x[b, t-(K-1)+k, c] * dy[b,t,c]   (x zero before 0),
//   db[c]     = sum_{b,t} dy[b,t,c].
// Bound by bytes: x and dy read once, dx written once (18.8 us at (1, 4096,
// 2560) bf16).  A thread owns one unit of channels over one run of
// positions, as in the forward, and walks it once: at position u it reads
// x[u] and dy[u+K-1] and keeps the K newest dy rows, dy[u .. u+K-1], in a
// register window.  dx[u] is the window against the taps, summed with fmaf
// in tap order from k = 0 (w[0] * dy[u+K-1] first) and cast once: the
// forward's order on the time-reversed gradient, so dx has the bits of
// flip(conv(flip(dy), w)).  dw pairs x[u] with each dy[u+j] in the window
// (j = K-1-k; pairs past S-1 are skipped, not multiplied by a zero), db adds
// dy[u]: every (x, dy) pair of the sum lies in the run of its x, so the
// only halo is the K-1 rows of dy after the run, read by the thread itself
// and never across a batch row.  dw and db are deterministic, with no
// atomics on values: a block of 32 x R threads (32 neighbouring units of
// R consecutive runs) adds its R threads' f32 sums of each channel in slot
// order through shared memory and writes one row of a workspace (G, K + 1,
// C); conv1d_bwd_sum_kernel then adds the G rows of each column, 8 strided
// chains of rows and a fixed tree over the 8, and casts to w's and b's
// types.  The partition (runs, R, the tree) depends on the shapes alone.
// The vector and generic instances follow the forward's rules (16-byte
// chunks; one channel a thread, window slots before the first tap
// skipped).  A vector thread holds 5 x V f32 sums, K x V taps and K x V
// window values (bf16: 150-190 registers, so 8-12 warps an SM), too few
// warps to hide HBM's latency by turns alone, so it issues the loads of
// its next AHEAD rows before the FMAs of these (scripts/k5_bwd.py --sweep
// on an H100 80GB HBM3 at 700 W, bf16, (1, 4096, 2560): 0.0316 ms, against
// 0.0343 without).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// Threads per block the kernels are built for (MAX_THREADS in
// kernels/conv1d/kernel.py).  Their launch bounds also ask for one block an
// SM, which leaves ptxas free to take the registers it needs: with the
// default it held some vector instances at 48 or 64 registers and spilled.
constexpr int kMaxThreads = 256;
constexpr int kVecTaps = 4;        // VEC_TAPS there
constexpr int kMaxTaps = 32;       // MAX_TAPS there

// bias: code 0 = float32, 1 = bfloat16, -1 = none
__device__ __forceinline__ float load_bias(const void* bias, int code,
                                           int64_t c) {
  if (code == 0) return static_cast<const float*>(bias)[c];
  if (code == 1) return to_f32(static_cast<const __nv_bfloat16*>(bias)[c]);
  return 0.f;
}

// The stored value as a float that T holds exactly: the sum cast to T,
// then, with a bias, widened, the bias added in f32, and cast to T again by
// the store.
template <typename T>
__device__ __forceinline__ float finish(float acc, float bias, bool has_bias) {
  const float y = to_f32(from_f32<T>(acc));
  return has_bias ? __fadd_rn(y, bias) : y;
}

// 16 bytes of T, widened to float / packed back with round to nearest even
// (bf16 -> f32 is exact: the 16 bits move to the top of the word).
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int V = 4;
  __device__ static void widen(const uint4& r, float (&f)[V]) {
    f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float (&f)[V]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static void widen(const uint4& r, float (&f)[V]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t pack2(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return (uint32_t)__bfloat16_as_ushort(v.x)
           | ((uint32_t)__bfloat16_as_ushort(v.y) << 16);
  }
  __device__ static uint4 pack(const float (&f)[V]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                      pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
};

template <typename T, int K, int AHEAD>
__global__ void __launch_bounds__(kMaxThreads, 1)
conv1d_vec_kernel(const uint4* __restrict__ x, const uint4* __restrict__ w,
                  const void* __restrict__ bias, uint4* __restrict__ y,
                  int64_t seq, int chunks, unsigned cblocks,
                  unsigned runs_per_row, int run, int bias_code) {
  constexpr int V = Chunk<T>::V;
  constexpr int H = K > 1 ? K - 1 : 1;     // window slots (unused at K = 1)
  // block -> (run, block of chunks in the row): 32-bit division, once
  const unsigned r = blockIdx.x / cblocks;
  const int chunk = (int)(blockIdx.x - r * cblocks) * blockDim.x + threadIdx.x;
  if (chunk >= chunks) return;
  const unsigned b = r / runs_per_row;
  const int64_t s0 = (int64_t)(r - b * runs_per_row) * run;
  const int n = (int)(min(seq, s0 + run) - s0);      // rows of this run
  // the run's first row; rows are `chunks` apart, and counted in 32 bits
  const int64_t first = ((int64_t)b * seq + s0) * chunks + chunk;
  const uint4* xr = x + first;
  uint4* yr = y + first;
  const bool has_bias = bias_code >= 0;

  float wr[K][V], bv[V], win[H][V];
#pragma unroll
  for (int k = 0; k < K; ++k)
    Chunk<T>::widen(__ldg(w + k * chunks + chunk), wr[k]);
#pragma unroll
  for (int v = 0; v < V; ++v)
    bv[v] = load_bias(bias, bias_code, chunk * V + v);
#pragma unroll
  for (int i = 0; i < K - 1; ++i) {       // slot i: row s0 - (K-1) + i
    if (s0 - (K - 1) + i >= 0) {
      Chunk<T>::widen(__ldg(xr - (K - 1 - i) * chunks), win[i]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) win[i][v] = 0.f;
    }
  }
  // one block of AHEAD rows at a time: unrolling this loop too would only
  // raise the register count
#pragma unroll 1
  for (int i = 0; i < n; i += AHEAD) {
    uint4 raw[AHEAD];
#pragma unroll
    for (int j = 0; j < AHEAD; ++j)
      raw[j] = i + j < n ? __ldg(xr + j * chunks) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < AHEAD; ++j) {
      float in[V], out[V];
      Chunk<T>::widen(raw[j], in);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < K - 1; ++k) acc = fmaf(win[k][v], wr[k][v], acc);
        acc = fmaf(in[v], wr[K - 1][v], acc);
        out[v] = finish<T>(acc, bv[v], has_bias);
      }
#pragma unroll
      for (int k = 0; k + 1 < K - 1; ++k)
#pragma unroll
        for (int v = 0; v < V; ++v) win[k][v] = win[k + 1][v];
      if (K > 1) {
#pragma unroll
        for (int v = 0; v < V; ++v) win[H - 1][v] = in[v];
      }
      if (i + j < n) yr[j * chunks] = Chunk<T>::pack(out);
    }
    xr += AHEAD * chunks;
    yr += AHEAD * chunks;
  }
}

template <typename T, int KW>
__global__ void __launch_bounds__(kMaxThreads, 1)
conv1d_generic_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const void* __restrict__ bias, T* __restrict__ y,
                      int64_t seq, int64_t ch, int64_t runs_per_row, int run,
                      int64_t units, int taps, int bias_code) {
  const int64_t u = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= units) return;
  const int64_t c = u % ch, r = u / ch;
  const int64_t b = r / runs_per_row;
  const int64_t s0 = (r - b * runs_per_row) * run;
  const int64_t s1 = min(seq, s0 + run);
  const T* xb = x + b * seq * ch + c;
  T* yb = y + b * seq * ch + c;
  const int first = KW - taps;          // window slots before it have no tap
  const float bv = load_bias(bias, bias_code, c);
  const bool has_bias = bias_code >= 0;

  float wr[KW], win[KW];
#pragma unroll
  for (int i = 0; i < KW; ++i) {
    wr[i] = i >= first ? to_f32(w[(int64_t)(i - first) * ch + c]) : 0.f;
    // slot i holds position s - (KW-1) + i; before the first step s = s0
    const int64_t pos = s0 - (KW - 1) + i;
    win[i] = (i >= first && i < KW - 1 && pos >= 0) ? to_f32(xb[pos * ch]) : 0.f;
  }
  for (int64_t s = s0; s < s1; ++s) {
    win[KW - 1] = to_f32(xb[s * ch]);
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < KW; ++i)
      if (i >= first) acc = fmaf(win[i], wr[i], acc);
    yb[s * ch] = from_f32<T>(finish<T>(acc, bv, has_bias));
#pragma unroll
    for (int i = 0; i < KW - 1; ++i) win[i] = win[i + 1];
  }
}

// Shared by the backward's instances: each thread of a block (32 units x
// blockDim.y runs) has put its n sums of the block's `width` channels (its
// K taps' in tap order, then the bias's) at red[(slot * n + i) * width +
// unit channel]; adds the slots of each (i, channel) in order and writes
// them as row `g` of part (G, n, ch), channels from c0.
__device__ __forceinline__ void write_part_row(const float* red, int n,
                                               int width, int64_t c0,
                                               int64_t ch, float* part,
                                               int64_t g) {
  __syncthreads();
  const int items = n * width;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int q = tid; q < items; q += blockDim.x * blockDim.y) {
    float s = 0.f;
    for (int t = 0; t < (int)blockDim.y; ++t) s += red[t * items + q];
    const int i = q / width;
    const int64_t c = c0 + (q - i * width);
    if (c < ch) part[(g * n + i) * ch + c] = s;
  }
}

// Where a thread's run lies: run r = blockIdx's run group * blockDim.y +
// threadIdx.y of `runs` (batch * runs_per_row); false past the last.
struct RunPos {
  int64_t b, s0;
  int n;
};
__device__ __forceinline__ bool run_pos(int64_t r, int64_t runs,
                                        int64_t runs_per_row, int run,
                                        int64_t seq, RunPos& p) {
  if (r >= runs) return false;
  p.b = r / runs_per_row;
  p.s0 = (r - p.b * runs_per_row) * run;
  p.n = (int)(min(seq, p.s0 + run) - p.s0);
  return true;
}

// The vector instance: a thread one 16-byte chunk (V channels) of one run.
// g[j] holds dy[u + j] (j < K) as the thread stands at position u; the
// block's grid index is (run group, block of 32 chunks), flattened on x.
template <typename T, int K, int AHEAD>
__global__ void __launch_bounds__(kMaxThreads, 1)
conv1d_bwd_vec_kernel(const uint4* __restrict__ x, const uint4* __restrict__ dy,
                      const uint4* __restrict__ w, uint4* __restrict__ dx,
                      float* __restrict__ part, int64_t seq, int chunks,
                      unsigned cblocks, int64_t runs, int64_t runs_per_row,
                      int run) {
  constexpr int V = Chunk<T>::V;
  extern __shared__ float red[];        // [blockDim.y][K + 1][32 * V]
  const unsigned grp = blockIdx.x / cblocks;
  const int cb = (int)(blockIdx.x - grp * cblocks);
  const int chunk = cb * 32 + threadIdx.x;
  const bool want_wb = part != nullptr;
  float acc[K][V], db[V];               // acc[j]: x[u] * dy[u + j], tap K-1-j
#pragma unroll
  for (int v = 0; v < V; ++v) {
    db[v] = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j][v] = 0.f;
  }
  RunPos p;
  if (chunk < chunks && run_pos((int64_t)grp * blockDim.y + threadIdx.y, runs,
                                runs_per_row, run, seq, p)) {
    const int64_t first = (p.b * seq + p.s0) * chunks + chunk;
    const uint4* xr = x + first;
    const uint4* gr = dy + first + (int64_t)(K - 1) * chunks;  // dy[u + K-1]
    uint4* dxr = dx == nullptr ? nullptr : dx + first;
    float wr[K][V], g[K][V];
#pragma unroll
    for (int k = 0; k < K; ++k)
      Chunk<T>::widen(__ldg(w + k * chunks + chunk), wr[k]);
#pragma unroll
    for (int j = 0; j < K - 1; ++j) {     // dy[s0 + j]: zero past S-1
      if (p.s0 + j < seq) {
        Chunk<T>::widen(__ldg(dy + first + (int64_t)j * chunks), g[j + 1]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) g[j + 1][v] = 0.f;
      }
    }
    // blocks of AHEAD rows, the next block's loads issued before this one's
    // FMAs, so a thread always has rows in flight
    uint4 rx[AHEAD], rg[AHEAD];
    auto load = [&](int i, uint4 (&lx)[AHEAD], uint4 (&lg)[AHEAD]) {
      const int64_t left = seq - (p.s0 + i);
#pragma unroll
      for (int a = 0; a < AHEAD; ++a) {
        const bool in_run = i + a < p.n;
        lx[a] = in_run && want_wb ? __ldg(xr + (int64_t)(i + a) * chunks)
                                  : make_uint4(0, 0, 0, 0);
        lg[a] = in_run && a + K - 1 < left
                    ? __ldg(gr + (int64_t)(i + a) * chunks)
                    : make_uint4(0, 0, 0, 0);
      }
    };
    load(0, rx, rg);
#pragma unroll 1
    for (int i = 0; i < p.n; i += AHEAD) {
      uint4 nx[AHEAD], ng[AHEAD];
      load(i + AHEAD, nx, ng);
      const int64_t left = seq - (p.s0 + i);     // rows from u = s0 + i on
#pragma unroll
      for (int a = 0; a < AHEAD; ++a) {
        if (i + a >= p.n) continue;
#pragma unroll
        for (int j = 0; j + 1 < K; ++j)
#pragma unroll
          for (int v = 0; v < V; ++v) g[j][v] = g[j + 1][v];
        Chunk<T>::widen(rg[a], g[K - 1]);
        if (dxr != nullptr) {
          float out[V];
#pragma unroll
          for (int v = 0; v < V; ++v) {
            float s = 0.f;
#pragma unroll
            for (int k = 0; k < K; ++k) s = fmaf(g[K - 1 - k][v], wr[k][v], s);
            out[v] = to_f32(from_f32<T>(s));
          }
          dxr[(int64_t)(i + a) * chunks] = Chunk<T>::pack(out);
        }
        if (want_wb) {
          float xv[V];
          Chunk<T>::widen(rx[a], xv);
#pragma unroll
          for (int j = 0; j < K; ++j) {
            if (a + j < left) {
#pragma unroll
              for (int v = 0; v < V; ++v) acc[j][v] = fmaf(xv[v], g[j][v], acc[j][v]);
            }
          }
#pragma unroll
          for (int v = 0; v < V; ++v) db[v] += g[0][v];
        }
      }
#pragma unroll
      for (int a = 0; a < AHEAD; ++a) {
        rx[a] = nx[a];
        rg[a] = ng[a];
      }
    }
  }
  if (!want_wb) return;
  constexpr int width = 32 * V;
  float* mine = red + threadIdx.y * (K + 1) * width + threadIdx.x * V;
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int k = 0; k < K; ++k) mine[k * width + v] = acc[K - 1 - k][v];
    mine[K * width + v] = db[v];
  }
  write_part_row(red, K + 1, width, (int64_t)cb * width,
                 (int64_t)chunks * V, part, grp);
}

// The generic instance: a thread one channel of one run.  The window has
// KW >= taps slots with the newest on the right: slot i holds dy[u + i -
// first] (first = KW - taps); slots before `first` hold no tap and are
// skipped.  Tap k is slot KW-1-k for dx, and dw[k] is acc[KW-1-k].
template <typename T, int KW>
__global__ void __launch_bounds__(kMaxThreads, 1)
conv1d_bwd_generic_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          const T* __restrict__ w, T* __restrict__ dx,
                          float* __restrict__ part, int64_t seq, int64_t ch,
                          unsigned cblocks, int64_t runs,
                          int64_t runs_per_row, int run, int taps) {
  extern __shared__ float red[];        // [blockDim.y][taps + 1][32]
  const unsigned grp = blockIdx.x / cblocks;
  const int64_t cb = blockIdx.x - grp * cblocks;
  const int64_t c = cb * 32 + threadIdx.x;
  const int first = KW - taps;
  const bool want_wb = part != nullptr;
  float acc[KW], db = 0.f;
#pragma unroll
  for (int i = 0; i < KW; ++i) acc[i] = 0.f;
  RunPos p;
  if (c < ch && run_pos((int64_t)grp * blockDim.y + threadIdx.y, runs,
                        runs_per_row, run, seq, p)) {
    const T* xb = x + p.b * seq * ch + c;
    const T* gb = dy + p.b * seq * ch + c;
    T* dxb = dx == nullptr ? nullptr : dx + p.b * seq * ch + c;
    float wr[KW], g[KW];
#pragma unroll
    for (int i = 0; i < KW; ++i) {
      wr[i] = i >= first ? to_f32(w[(int64_t)(KW - 1 - i) * ch + c]) : 0.f;
      // as if at u = s0 - 1: slot i holds dy[s0 - 1 + i - first], the
      // slots after `first` (dy[s0 .. s0 + taps - 2]) the ones kept
      const int64_t pos = p.s0 - 1 + (i - first);
      g[i] = (i > first && pos < seq) ? to_f32(gb[pos * ch]) : 0.f;
    }
    for (int64_t u = p.s0; u < p.s0 + p.n; ++u) {
#pragma unroll
      for (int i = 0; i < KW - 1; ++i) g[i] = g[i + 1];
      const int64_t next = u + taps - 1;
      g[KW - 1] = next < seq ? to_f32(gb[next * ch]) : 0.f;
      if (dxb != nullptr) {
        float s = 0.f;
#pragma unroll
        for (int i = KW - 1; i >= 0; --i)
          if (i >= first) s = fmaf(g[i], wr[i], s);
        dxb[u * ch] = from_f32<T>(s);
      }
      if (want_wb) {
        const float xv = to_f32(xb[u * ch]);
        const int64_t left = seq - u;
        float g0 = 0.f;
#pragma unroll
        for (int i = 0; i < KW; ++i) {
          if (i >= first && i - first < left) acc[i] = fmaf(xv, g[i], acc[i]);
          if (i == first) g0 = g[i];
        }
        db += g0;
      }
    }
  }
  if (!want_wb) return;
  float* mine = red + threadIdx.y * (taps + 1) * 32 + threadIdx.x;
#pragma unroll
  for (int i = 0; i < KW; ++i)
    if (i >= first) mine[(KW - 1 - i) * 32] = acc[i];
  mine[taps * 32] = db;
  write_part_row(red, taps + 1, 32, cb * 32, ch, part, grp);
}

__device__ __forceinline__ void store_as(void* dst, int code, int64_t i,
                                         float v) {
  if (code == 0) static_cast<float*>(dst)[i] = v;
  else static_cast<__nv_bfloat16*>(dst)[i] = __float2bfloat16(v);
}

// dw (taps, ch) and db (ch,) from the workspace (groups, taps + 1, ch): a
// block 32 columns x 8 threads; thread (t, col) adds rows t, t + 8, t + 16,
// ... in order, four loads in flight, and the 8 chains meet in a fixed
// tree ((0+4)+(2+6))+((1+5)+(3+7)).
constexpr int kSumChains = 8;     // SUM_CHAINS in kernels/conv1d/kernel.py
__global__ void __launch_bounds__(32 * kSumChains)
conv1d_bwd_sum_kernel(const float* __restrict__ part, void* dw, void* db,
                      int w_code, int b_code, int64_t groups, int64_t ch,
                      int taps) {
  __shared__ float chain[kSumChains][32];
  const int64_t col = (int64_t)blockIdx.x * 32 + threadIdx.x;
  const int64_t cols = (int64_t)(taps + 1) * ch;
  const int t = threadIdx.y;
  float s = 0.f;
  if (col < cols) {
    const float* pc = part + col;
    int64_t r = t;
    for (; r + 3 * kSumChains < groups; r += 4 * kSumChains) {
      const float a0 = pc[r * cols], a1 = pc[(r + kSumChains) * cols],
                  a2 = pc[(r + 2 * kSumChains) * cols],
                  a3 = pc[(r + 3 * kSumChains) * cols];
      s += a0; s += a1; s += a2; s += a3;
    }
    for (; r < groups; r += kSumChains) s += pc[r * cols];
  }
  chain[t][threadIdx.x] = s;
#pragma unroll
  for (int h = kSumChains / 2; h >= 1; h /= 2) {
    __syncthreads();
    if (t < h) chain[t][threadIdx.x] += chain[t + h][threadIdx.x];
  }
  if (t != 0 || col >= cols) return;
  const float v = chain[0][threadIdx.x];
  const int64_t i = col / ch;
  if (i < taps) store_as(dw, w_code, col, v);
  else if (b_code >= 0) store_as(db, b_code, col - i * ch, v);
}

struct Args {
  const void* x;
  const void* w;
  const void* bias;
  void* y;
  int64_t batch, seq, ch;
  int taps, run, threads, ahead, bias_code;
};

template <typename T, int K, int AHEAD>
cudaError_t launch_vec(const Args& a, cudaStream_t st) {
  const int64_t chunks = a.ch / Chunk<T>::V;
  const int64_t cblocks = (chunks + a.threads - 1) / a.threads;
  const int64_t runs_per_row = (a.seq + a.run - 1) / a.run;
  const int64_t blocks = a.batch * runs_per_row * cblocks;
  if (blocks > INT32_MAX || chunks > INT32_MAX / 8)   // 8: AHEAD's largest
    return cudaErrorInvalidConfiguration;
  conv1d_vec_kernel<T, K, AHEAD><<<(unsigned)blocks, a.threads, 0, st>>>(
      (const uint4*)a.x, (const uint4*)a.w, a.bias, (uint4*)a.y, a.seq,
      (int)chunks, (unsigned)cblocks, (unsigned)runs_per_row, a.run,
      a.bias_code);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_vec_k(const Args& a, cudaStream_t st) {
  switch (a.ahead) {
    case 1: return launch_vec<T, K, 1>(a, st);
    case 2: return launch_vec<T, K, 2>(a, st);
    case 4: return launch_vec<T, K, 4>(a, st);
    case 8: return launch_vec<T, K, 8>(a, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int KW>
cudaError_t launch_generic(const Args& a, cudaStream_t st) {
  const int64_t runs_per_row = (a.seq + a.run - 1) / a.run;
  const int64_t units = a.batch * runs_per_row * a.ch;
  const int64_t blocks = (units + a.threads - 1) / a.threads;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  conv1d_generic_kernel<T, KW><<<(unsigned)blocks, a.threads, 0, st>>>(
      (const T*)a.x, (const T*)a.w, a.bias, (T*)a.y, a.seq, a.ch,
      runs_per_row, a.run, units, a.taps, a.bias_code);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, int inst, cudaStream_t st) {
  if (a.taps < 1 || a.taps > kMaxTaps || a.run < 1 || a.threads < 32
      || a.threads > kMaxThreads || a.threads % 32 || a.bias_code < -1
      || a.bias_code > 1 || (a.bias_code >= 0 && a.bias == nullptr))
    return cudaErrorInvalidValue;
  if (inst == 0) {
    if (a.taps <= 4) return launch_generic<T, 4>(a, st);
    if (a.taps <= 8) return launch_generic<T, 8>(a, st);
    if (a.taps <= 16) return launch_generic<T, 16>(a, st);
    return launch_generic<T, 32>(a, st);
  }
  // a vector instance: its taps, whole 16-byte chunks a row, aligned rows
  if (inst != a.taps || inst > kVecTaps || a.ch % Chunk<T>::V
      || (uintptr_t)a.x % 16 || (uintptr_t)a.w % 16 || (uintptr_t)a.y % 16)
    return cudaErrorInvalidValue;
  switch (inst) {
    case 1: return launch_vec_k<T, 1>(a, st);
    case 2: return launch_vec_k<T, 2>(a, st);
    case 3: return launch_vec_k<T, 3>(a, st);
    case 4: return launch_vec_k<T, 4>(a, st);
  }
  return cudaErrorInvalidValue;
}

struct BwdArgs {
  const void* x;
  const void* dy;
  const void* w;
  void* dx;
  float* part;
  int64_t batch, seq, ch, groups;
  int taps, run, threads, ahead;
};

// The run groups (blocks along the positions) of a plan: runs of `run`
// positions in each batch row, threads / 32 of them a block.
int64_t bwd_groups(const BwdArgs& a) {
  const int64_t runs = a.batch * ((a.seq + a.run - 1) / a.run);
  const int64_t rows = a.threads / 32;
  return (runs + rows - 1) / rows;
}

template <typename T, int K, int AHEAD>
cudaError_t launch_bwd_vec(const BwdArgs& a, cudaStream_t st) {
  constexpr int V = Chunk<T>::V;
  const int64_t chunks = a.ch / V;
  const int64_t cblocks = (chunks + 31) / 32;
  const int64_t runs_per_row = (a.seq + a.run - 1) / a.run;
  const int64_t blocks = a.groups * cblocks;
  if (blocks > INT32_MAX || chunks > INT32_MAX / 8)   // 8: AHEAD's largest
    return cudaErrorInvalidConfiguration;
  const dim3 block(32, a.threads / 32);
  const size_t smem = (size_t)block.y * (K + 1) * 32 * V * sizeof(float);
  conv1d_bwd_vec_kernel<T, K, AHEAD><<<(unsigned)blocks, block, smem, st>>>(
      (const uint4*)a.x, (const uint4*)a.dy, (const uint4*)a.w, (uint4*)a.dx,
      a.part, a.seq, (int)chunks, (unsigned)cblocks,
      a.batch * runs_per_row, runs_per_row, a.run);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_bwd_vec_k(const BwdArgs& a, cudaStream_t st) {
  switch (a.ahead) {
    case 1: return launch_bwd_vec<T, K, 1>(a, st);
    case 2: return launch_bwd_vec<T, K, 2>(a, st);
    case 4: return launch_bwd_vec<T, K, 4>(a, st);
    case 8: return launch_bwd_vec<T, K, 8>(a, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int KW>
cudaError_t launch_bwd_generic(const BwdArgs& a, cudaStream_t st) {
  const int64_t cblocks = (a.ch + 31) / 32;
  const int64_t runs_per_row = (a.seq + a.run - 1) / a.run;
  const int64_t blocks = a.groups * cblocks;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  const dim3 block(32, a.threads / 32);
  const size_t smem = (size_t)block.y * (a.taps + 1) * 32 * sizeof(float);
  conv1d_bwd_generic_kernel<T, KW><<<(unsigned)blocks, block, smem, st>>>(
      (const T*)a.x, (const T*)a.dy, (const T*)a.w, (T*)a.dx, a.part, a.seq,
      a.ch, (unsigned)cblocks, a.batch * runs_per_row, runs_per_row, a.run,
      a.taps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const BwdArgs& a, int inst, void* dw, void* db,
                       int b_code, cudaStream_t st) {
  if (a.taps < 1 || a.taps > kMaxTaps || a.run < 1 || a.threads < 32
      || a.threads > kMaxThreads || a.threads % 32 || b_code < -1
      || b_code > 1 || (b_code >= 0 && db == nullptr)
      || (a.dx == nullptr && a.part == nullptr)
      || ((a.part == nullptr) != (dw == nullptr))
      || (a.part != nullptr && a.groups != bwd_groups(a)))
    return cudaErrorInvalidValue;
  cudaError_t e;
  if (inst == 0) {
    if (a.taps <= 4) e = launch_bwd_generic<T, 4>(a, st);
    else if (a.taps <= 8) e = launch_bwd_generic<T, 8>(a, st);
    else if (a.taps <= 16) e = launch_bwd_generic<T, 16>(a, st);
    else e = launch_bwd_generic<T, 32>(a, st);
  } else {
    // a vector instance: its taps, whole 16-byte chunks a row, aligned rows
    if (inst != a.taps || inst > kVecTaps || a.ch % Chunk<T>::V
        || (uintptr_t)a.x % 16 || (uintptr_t)a.dy % 16 || (uintptr_t)a.w % 16
        || (uintptr_t)a.dx % 16)
      return cudaErrorInvalidValue;
    switch (inst) {
      case 1: e = launch_bwd_vec_k<T, 1>(a, st); break;
      case 2: e = launch_bwd_vec_k<T, 2>(a, st); break;
      case 3: e = launch_bwd_vec_k<T, 3>(a, st); break;
      default: e = launch_bwd_vec_k<T, 4>(a, st); break;
    }
  }
  if (e != cudaSuccess || a.part == nullptr) return e;
  const int64_t cols = (int64_t)(a.taps + 1) * a.ch;
  const int64_t blocks = (cols + 31) / 32;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  conv1d_bwd_sum_kernel<<<(unsigned)blocks, dim3(32, kSumChains), 0, st>>>(
      a.part, dw, db, sizeof(T) == 4 ? 0 : 1, b_code, a.groups, a.ch, a.taps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x, y: (batch, seq, ch) and w: (taps, ch),
// all of that type, contiguous on the device; 1 <= taps <= 32.  bias: (ch,)
// contiguous, of type bias_dtype (0 float32, 1 bfloat16), or bias_dtype -1
// and no bias.  inst: the vector instance K (1-4, = taps; ch a multiple of
// 16 bytes' worth of elements, x, w and y 16-byte aligned) or 0, the generic
// instance, as kernels/conv1d/kernel.py:plan picks it.  A thread owns run
// >= 1 positions; threads per block a multiple of 32 up to 256; ahead (1, 2,
// 4 or 8) rows in flight a vector thread, unused by the generic instance.
// Returns cudaGetLastError().
int conv1d_launch(const void* x, const void* w, const void* bias, void* y,
                  int dtype, int bias_dtype, int64_t batch, int64_t seq,
                  int64_t ch, int taps, int inst, int run, int threads,
                  int ahead, void* stream) {
  const Args a{x, w, bias, y, batch, seq, ch, taps, run, threads, ahead,
               bias_dtype};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(a, inst, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, inst, s);
  return (int)cudaErrorInvalidValue;
}

// The three gradients of the forward's input x, taps w and bias in one
// pass.  dtype: 0 = float32, 1 = bfloat16, of x, dy, w, dx and dw; x and dy
// (batch, seq, ch), w (taps, ch), contiguous on the device; 1 <= taps <= 32.
// dx: (batch, seq, ch), or null and no dx.  part: a float32 workspace of
// (groups, taps + 1, ch), groups = ceil(batch * ceil(seq / run) / (threads
// / 32)), with dw (taps, ch) of x's type and db (ch,) of type b_dtype (0
// float32, 1 bfloat16; or -1 and no db); or part and dw null and no dw or
// db.  inst: the vector instance K (1-4, = taps; ch a multiple of 16 bytes'
// worth of elements; x, dy, w and dx 16-byte aligned) or 0, the generic
// instance, as kernels/conv1d/kernel.py:plan_bwd picks it; a thread owns run
// >= 1 positions; threads a block a multiple of 32 up to 256; ahead (1, 2,
// 4 or 8) rows in flight a vector thread.  Launches two kernels on the
// stream where dw is wanted, one where not; returns cudaGetLastError().
int conv1d_bwd_launch(const void* x, const void* dy, const void* w, void* dx,
                      float* part, void* dw, void* db, int dtype, int b_dtype,
                      int64_t batch, int64_t seq, int64_t ch, int64_t groups,
                      int taps, int inst, int run, int threads, int ahead,
                      void* stream) {
  const BwdArgs a{x, dy, w, dx, part, batch, seq, ch, groups, taps, run,
                  threads, ahead};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_bwd<float>(a, inst, dw, db, b_dtype, s);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(a, inst, dw, db, b_dtype, s);
  return (int)cudaErrorInvalidValue;
}

const char* conv1d_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
