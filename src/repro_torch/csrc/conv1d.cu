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
// The backward (conv1d_bwd_wb_launch), which training needs, has no TPU
// kernel to replace: the JAX package differentiates the forward by autodiff.
// The input gradient is this same kernel on the time-reversed upstream
// gradient (dx = flip(conv(flip(dy), w)), kernels/conv1d/ops.py), so only
// the taps' and the bias's gradients are new:
//   dw[j, c] = sum_{b,t} x[b, t-(K-1)+j, c] * dy[b, t, c],  db[c] = sum dy.
// Bound by bytes (x and dy read once; 12.5 us at (1, 4096, 2560) bf16).
// Two kernels, deterministic: conv1d_bwd_partial_kernel gives a thread one
// channel and a run of positions of one batch row (neighbouring lanes on
// neighbouring channels), keeps the K-1 previous inputs in registers and
// writes the run's K + 1 f32 sums to a workspace; conv1d_bwd_reduce_kernel
// adds the runs in order, a thread a (tap or bias, channel), and casts to
// w's and b's types.
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

// One run of positions of one batch row per blockIdx.y, one channel a
// thread: part[run][i][c] = the run's sum for tap i (i < taps) or the bias
// (i = taps).  The window has KW >= taps slots, the taps right-aligned.
template <typename T, int KW>
__global__ void __launch_bounds__(kMaxThreads, 1)
conv1d_bwd_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          float* __restrict__ part, int64_t seq, int64_t ch,
                          int64_t runs_per_row, int run, int taps) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ch) return;
  const int64_t r = blockIdx.y;
  const int64_t b = r / runs_per_row;
  const int64_t s0 = (r - b * runs_per_row) * run;
  const int64_t s1 = min(seq, s0 + run);
  const T* xb = x + b * seq * ch + c;
  const T* gb = dy + b * seq * ch + c;
  const int first = KW - taps;

  float win[KW], acc[KW], db = 0.f;
#pragma unroll
  for (int i = 0; i < KW; ++i) {
    acc[i] = 0.f;
    const int64_t pos = s0 - (KW - 1) + i;
    win[i] = (i >= first && i < KW - 1 && pos >= 0) ? to_f32(xb[pos * ch]) : 0.f;
  }
  for (int64_t s = s0; s < s1; ++s) {
    win[KW - 1] = to_f32(xb[s * ch]);
    const float g = to_f32(gb[s * ch]);
#pragma unroll
    for (int i = 0; i < KW; ++i)
      if (i >= first) acc[i] = fmaf(win[i], g, acc[i]);
    db += g;
#pragma unroll
    for (int i = 0; i < KW - 1; ++i) win[i] = win[i + 1];
  }
  float* pr = part + r * (taps + 1) * ch + c;
#pragma unroll
  for (int i = 0; i < KW; ++i)
    if (i >= first) pr[(i - first) * ch] = acc[i];
  pr[taps * ch] = db;
}

__device__ __forceinline__ void store_as(void* dst, int code, int64_t i,
                                         float v) {
  if (code == 0) static_cast<float*>(dst)[i] = v;
  else static_cast<__nv_bfloat16*>(dst)[i] = __float2bfloat16(v);
}

// dw (taps, ch) and db (ch,) from the runs' sums, added in run order
__global__ void conv1d_bwd_reduce_kernel(const float* __restrict__ part,
                                         void* dw, void* db, int w_code,
                                         int b_code, int64_t ch, int taps,
                                         int64_t runs) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)(taps + 1) * ch) return;
  const int64_t i = idx / ch, c = idx - i * ch;
  if (i == taps && b_code < 0) return;
  float s = 0.f;
  for (int64_t r = 0; r < runs; ++r) s += part[(r * (taps + 1) + i) * ch + c];
  if (i < taps) store_as(dw, w_code, i * ch + c, s);
  else store_as(db, b_code, c, s);
}

template <typename T, int KW>
cudaError_t launch_bwd(const void* x, const void* dy, float* part, void* dw,
                       void* db, int w_code, int b_code, int64_t batch,
                       int64_t seq, int64_t ch, int taps, int run,
                       cudaStream_t st) {
  const int64_t runs_per_row = (seq + run - 1) / run;
  const int64_t runs = batch * runs_per_row;
  const int64_t cblocks = (ch + kMaxThreads - 1) / kMaxThreads;
  if (runs > 65535 || cblocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  conv1d_bwd_partial_kernel<T, KW>
      <<<dim3((unsigned)cblocks, (unsigned)runs), kMaxThreads, 0, st>>>(
          (const T*)x, (const T*)dy, part, seq, ch, runs_per_row, run, taps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int64_t n = (int64_t)(taps + 1) * ch;
  conv1d_bwd_reduce_kernel<<<(unsigned)((n + kMaxThreads - 1) / kMaxThreads),
                             kMaxThreads, 0, st>>>(part, dw, db, w_code,
                                                   b_code, ch, taps, runs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_t(const void* x, const void* dy, float* part, void* dw,
                         void* db, int w_code, int b_code, int64_t batch,
                         int64_t seq, int64_t ch, int taps, int run,
                         cudaStream_t st) {
  if (taps <= 4) return launch_bwd<T, 4>(x, dy, part, dw, db, w_code, b_code, batch, seq, ch, taps, run, st);
  if (taps <= 8) return launch_bwd<T, 8>(x, dy, part, dw, db, w_code, b_code, batch, seq, ch, taps, run, st);
  if (taps <= 16) return launch_bwd<T, 16>(x, dy, part, dw, db, w_code, b_code, batch, seq, ch, taps, run, st);
  return launch_bwd<T, 32>(x, dy, part, dw, db, w_code, b_code, batch, seq, ch, taps, run, st);
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

// The taps' and bias's gradients.  dtype: 0 = float32, 1 = bfloat16, of x
// and dy: (batch, seq, ch), contiguous on the device; 1 <= taps <= 32.
// part: a float32 workspace of batch * ceil(seq / run) * (taps + 1) * ch
// (at most 65,535 runs).  dw: (taps, ch) contiguous, of type w_dtype (0
// float32, 1 bfloat16); db: (ch,) contiguous of type b_dtype, or b_dtype -1
// and no db.  Launches two kernels on the stream; returns
// cudaGetLastError().
int conv1d_bwd_wb_launch(const void* x, const void* dy, float* part, void* dw,
                         void* db, int dtype, int w_dtype, int b_dtype,
                         int64_t batch, int64_t seq, int64_t ch, int taps,
                         int run, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (taps < 1 || taps > kMaxTaps || run < 1 || w_dtype < 0 || w_dtype > 1
      || b_dtype < -1 || b_dtype > 1 || (b_dtype >= 0 && db == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_bwd_t<float>(x, dy, part, dw, db, w_dtype, b_dtype, batch, seq, ch, taps, run, s);
  if (dtype == 1)
    return launch_bwd_t<__nv_bfloat16>(x, dy, part, dw, db, w_dtype, b_dtype, batch, seq, ch, taps, run, s);
  return (int)cudaErrorInvalidValue;
}

const char* conv1d_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
