// Causal sliding-window attention with GQA and an online softmax, for
// sm_90a (H100).
//
// Replaces the TPU kernel repro/kernels/swa/kernel.py:swa_pallas (_body).
//
// out[b,h,i] = softmax_j(q_i . k_j / sqrt(D)) v_j over the keys j with
// j <= i, j > i - window and j < seq; the KV head of query head h is
// h / (Hq / Hkv).  Scores, the running max m, the running sum l and the
// accumulator are float32; the output is cast to the input type at the store
// and l is floored at 1e-30 as in the TPU kernel.
//
// What bounds it on the H100: operations.  Each query meets up to `window`
// keys at 4*D flops a pair (at S = 4096, window 2048, D = 256 that is about
// 1,000 flops per byte moved), far above the card's balance.  This first
// version runs on the CUDA cores in float32, not on the tensor cores, so it
// is also held back by shared-memory loads; wgmma and TMA are later work.
//
// Design: one block of 8 warps per (b, hq, 64-query tile).  The block keeps
// its query tile in shared memory as float32, already scaled by 1/sqrt(D),
// and walks only the 32-key tiles that meet the band
// [q0 - window + 1, q0 + 63] ∩ [0, seq), one at a time: K transposed (so a
// lane reads its own key's column without bank conflicts) and V row-major,
// both as float32, zero past seq.  Warp w owns query rows 8w..8w+7.  Lane l
// scores key l against its warp's 8 rows (the query row is a broadcast
// float4 read), masks, and the warp reduces each row's max and sum with
// shuffles; the probabilities go through a per-warp 8 x 32 shared strip
// into P·V, where lane l owns output columns l, l+32, ... (NC of them,
// NC*32 >= D), so the 64 x D accumulator is split over the block's threads
// and never leaves registers.  It takes the true seq and any S, so the host
// pads nothing.  Shared memory: 4*(64*Dp + Dp*33 + 32*Dp + 8*8*32) bytes
// (Dp = D rounded up to 4): 140,288 B at D = 256, past 48 KB, so the launch
// opts in with cudaFuncSetAttribute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per tile (one per lane)
constexpr int kWarps = 8;
constexpr int kRows = kBQ / kWarps;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, 1)
swa_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o, int hq_n, int group,
           int seq, int dim, int dp, int window, float scale, int q_tiles) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // kBQ x dp
  float* kt = qs + kBQ * dp;                      // dp x (kBK + 1)
  float* vs = kt + dp * (kBK + 1);                // kBK x dp
  float* ps = vs + kBK * dp;                      // kWarps x kRows x kBK

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qt = (int)(blockIdx.x % q_tiles);
  const int64_t bh = blockIdx.x / q_tiles;
  const int hq = (int)(bh % hq_n);
  const int64_t b = bh / hq_n;
  const int hk = hq / group;
  const int hkv_n = hq_n / group;
  const int q0 = qt * kBQ;
  const T* qb = q + bh * seq * (int64_t)dim;
  const T* kb = k + (b * hkv_n + hk) * seq * (int64_t)dim;
  const T* vb = v + (b * hkv_n + hk) * seq * (int64_t)dim;
  T* ob = o + bh * seq * (int64_t)dim;

  for (int idx = tid; idx < kBQ * dp; idx += kThreads) {
    const int r = idx / dp, d = idx - r * dp;
    const int qpos = q0 + r;
    qs[idx] = (qpos < seq && d < dim) ? to_f32(qb[(int64_t)qpos * dim + d]) * scale : 0.f;
  }

  const int r0 = warp * kRows;
  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }
  float* pw = ps + warp * kRows * kBK;

  const int kv_lo = max(0, q0 - window + 1);
  const int kv_hi = min(seq, q0 + kBQ);          // exclusive
  for (int kv0 = (kv_lo / kBK) * kBK; kv0 < kv_hi; kv0 += kBK) {
    __syncthreads();                              // the last tile is consumed
    for (int idx = tid; idx < kBK * dp; idx += kThreads) {
      const int j = idx / dp, d = idx - j * dp;
      const int kpos = kv0 + j;
      const bool in = kpos < seq && d < dim;
      const int64_t g = (int64_t)kpos * dim + d;
      kt[d * (kBK + 1) + j] = in ? to_f32(kb[g]) : 0.f;
      vs[idx] = in ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    for (int d = 0; d < dp; d += 4) {
      const float k0 = kt[(d + 0) * (kBK + 1) + lane];
      const float k1 = kt[(d + 1) * (kBK + 1) + lane];
      const float k2 = kt[(d + 2) * (kBK + 1) + lane];
      const float k3 = kt[(d + 3) * (kBK + 1) + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (r0 + r) * dp + d);
        s[r] = fmaf(qv.x, k0, s[r]);
        s[r] = fmaf(qv.y, k1, s[r]);
        s[r] = fmaf(qv.z, k2, s[r]);
        s[r] = fmaf(qv.w, k3, s[r]);
      }
    }

    const int kpos = kv0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + r0 + r;
      const bool ok = kpos <= qpos && kpos > qpos - window && kpos < seq;
      const float sv = ok ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float p = ok ? expf(sv - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
      pw[r * kBK + lane] = p;
    }
    __syncwarp();

    for (int j = 0; j < kBK; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < dim ? vs[j * dp + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = pw[r * kBK + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + r0 + r;
    if (qpos >= seq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < dim) ob[(int64_t)qpos * dim + d] = from_f32<T>(acc[r][c] / den);
    }
  }
}

template <typename T, int NC>
cudaError_t launch_nc(const void* q, const void* k, const void* v, void* o,
                      int64_t batch, int hq, int hkv, int seq, int dim,
                      int window, float scale, size_t smem, cudaStream_t stream) {
  const int q_tiles = (seq + kBQ - 1) / kBQ;
  const int64_t blocks = batch * hq * (int64_t)q_tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  const int dp = (dim + 3) & ~3;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)swa_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  swa_kernel<T, NC><<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, hq, hq / hkv, seq, dim, dp,
      window, scale, q_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int64_t batch, int hq, int hkv, int seq, int dim, int window,
                   float scale, size_t smem, cudaStream_t stream) {
  if (hkv < 1 || hq % hkv != 0 || window < 1 || dim < 1)
    return cudaErrorInvalidValue;
  if (dim <= 32) return launch_nc<T, 1>(q, k, v, o, batch, hq, hkv, seq, dim, window, scale, smem, stream);
  if (dim <= 64) return launch_nc<T, 2>(q, k, v, o, batch, hq, hkv, seq, dim, window, scale, smem, stream);
  if (dim <= 128) return launch_nc<T, 4>(q, k, v, o, batch, hq, hkv, seq, dim, window, scale, smem, stream);
  if (dim <= 256) return launch_nc<T, 8>(q, k, v, o, batch, hq, hkv, seq, dim, window, scale, smem, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q, o: (batch, hq, seq, dim); k, v:
// (batch, hkv, seq, dim); all of that type, contiguous on the device;
// hq % hkv == 0, 1 <= dim <= 256, window >= 1.  smem: dynamic shared memory,
// as kernels/swa/kernel.py:smem_bytes gives it.  Returns cudaGetLastError().
int swa_launch(const void* q, const void* k, const void* v, void* o, int dtype,
               int64_t batch, int hq, int hkv, int seq, int dim, int window,
               float scale, size_t smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, o, batch, hq, hkv, seq, dim, window, scale, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, batch, hq, hkv, seq, dim, window, scale, smem, s);
  return (int)cudaErrorInvalidValue;
}

const char* swa_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
