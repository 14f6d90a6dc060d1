// Backward of causal sliding-window attention with GQA, for sm_90a (H100):
// FlashAttention-2's backward in two launches, on the CUDA cores.
//
// No TPU kernel to replace: the JAX package defines no backward (it takes
// the gradient of the forward by autodiff).  The forward is K6
// (csrc/swa.cu, repro/kernels/swa/kernel.py:swa_pallas); this file is its
// gradient, which training RecurrentGemma runs on the card.
//
// With scale = 1/sqrt(D), S_ij = scale q_i.k_j over the band j <= i,
// j > i - window, j < seq, P_ij = exp(S_ij - LSE_i), O_i = sum_j P_ij v_j:
//   D_i   = dO_i . O_i
//   dP_ij = dO_i . v_j,  dS_ij = P_ij (dP_ij - D_i)
//   dQ_i  = scale sum_j dS_ij k_j
//   dK_j  = scale sum_i dS_ij q_i,  dV_j = sum_i P_ij dO_i
// where a KV head's sums run over every query head of its group.
//
// - swa_bwd_dq_kernel: one block of 8 warps per (b, hq, 64-query tile);
//   warp w owns rows 8w..8w+7, lane l scores key l of a 32-key tile.
//   Pass 1 walks the band's key tiles for each row's max and sum (the LSE;
//   the forward keeps none, so it is recomputed with one more Q.K^T) and
//   computes D from dO and the forward's stored O; both go to device memory
//   in f32 for the second kernel.  Pass 2 walks the band again: P, dP, dS
//   a lane per key, and dQ accumulated in registers with lanes across D
//   (each dS broadcast by a shuffle).
// - swa_bwd_dkdv_kernel: one block of 8 warps per (b, hkv, 32-key tile);
//   warp w owns keys 4w..4w+3 and keeps their dK and dV rows in registers
//   (lanes across D).  It loops over the group's query heads and over the
//   32-query tiles whose band reaches the key tile, lane l scoring query l,
//   and accumulates with no atomics; each block writes its own rows.
//
// Inputs are float32 or bfloat16, read through (batch, head, position)
// strides with unit stride along D, widened to f32 in shared memory; every
// sum is f32 in a fixed order, and the gradients are cast to the input
// type at the store.  Masking by the true sequence length and the window
// means nothing is padded on the host.
//
// What bounds it on the H100: operations.  The whole backward needs five
// products over the band's (query, key) pairs (S, dP, dQ, dK, dV; 2D flops
// each), 1.6e11 flops at (1, 10, 4096, 256) with window 2048; these kernels
// run eight (S twice and dP twice more, for the split) as f32 FMAs on the
// CUDA cores, where bf16 inputs could use the tensor cores.  That is the
// simple first design: its time stands beside the bound in PERF.md.
//
// Shared memory, Dp = D rounded up to 4, rows read by a lane padded to
// Dp + 4 floats (a 16-byte load per lane without bank conflicts when Dp is
// a multiple of 32): dq 4 * (2*64*Dp + 2*32*(Dp+4)) bytes, 197,632 B at
// D = 256; dkdv 4 * (2*32*Dp + 2*32*(Dp+4) + 64), 132,352 B.  Both past
// 48 KB, so the launches opt in with cudaFuncSetAttribute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 64;                  // dq: query rows per block
constexpr int kRows = kBQ / kWarps;      // dq: rows per warp
constexpr int kBK = 32;                  // dq: keys per tile, one a lane
constexpr int kKeys = 32;                // dkdv: keys per block
constexpr int kKeysPerWarp = kKeys / kWarps;
constexpr int kQT = 32;                  // dkdv: queries per tile, one a lane

// element strides along (batch, head, position) of q, k, v, o, dO, dq, dk, dv
struct Strides {
  int64_t q[3], k[3], v[3], o[3], g[3], dq[3], dk[3], dv[3];
};

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

// rows [row0, row0 + rows) of a (position, D) slab into shared memory as
// f32 times `mul`, `ld` floats a row; zero past seq and past dim
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          int64_t row_stride, int row0,
                                          int rows, int seq, int dim, int dp,
                                          float mul) {
  for (int idx = threadIdx.x; idx < rows * dp; idx += kThreads) {
    const int r = idx / dp, d = idx - r * dp;
    const int pos = row0 + r;
    dst[r * ld + d] = (pos < seq && d < dim)
        ? to_f32(src[(int64_t)pos * row_stride + d]) * mul : 0.f;
  }
}

// s[r] = rows[r] . lane_row over dp (dp a multiple of 4): `rows` are read by
// the whole warp at once (broadcast), `lane_row` is the lane's own row
template <int R>
__device__ __forceinline__ void dots(const float* rows, int row_ld,
                                     const float* lane_row, int dp,
                                     float (&s)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = 0.f;
  for (int d = 0; d < dp; d += 4) {
    const float4 b = *reinterpret_cast<const float4*>(lane_row + d);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(rows + r * row_ld + d);
      s[r] = fmaf(a.x, b.x, s[r]);
      s[r] = fmaf(a.y, b.y, s[r]);
      s[r] = fmaf(a.z, b.z, s[r]);
      s[r] = fmaf(a.w, b.w, s[r]);
    }
  }
}

__device__ __forceinline__ bool in_band(int qpos, int kpos, int seq,
                                        int window) {
  return qpos < seq && kpos <= qpos && kpos > qpos - window;
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, 1)
swa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ o,
                  const T* __restrict__ g, T* __restrict__ dq,
                  float* __restrict__ lse, float* __restrict__ delta,
                  Strides st, int hq_n, int group, int seq, int dim, int dp,
                  int window, float scale, int q_tiles) {
  extern __shared__ float4 smem4[];
  const int ldk = dp + 4;
  float* qs = reinterpret_cast<float*>(smem4);   // kBQ x dp, times scale
  float* gs = qs + kBQ * dp;                      // kBQ x dp, dO
  float* ks = gs + kBQ * dp;                      // kBK x ldk
  float* vs = ks + kBK * ldk;                     // kBK x ldk

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qt = (int)(blockIdx.x % q_tiles);
  const int64_t bh = blockIdx.x / q_tiles;
  const int hq = (int)(bh % hq_n);
  const int64_t b = bh / hq_n;
  const int hk = hq / group;
  const int q0 = qt * kBQ;
  const T* qb = q + b * st.q[0] + hq * st.q[1];
  const T* kb = k + b * st.k[0] + hk * st.k[1];
  const T* vb = v + b * st.v[0] + hk * st.v[1];
  const T* ob = o + b * st.o[0] + hq * st.o[1];
  const T* gb = g + b * st.g[0] + hq * st.g[1];
  T* dqb = dq + b * st.dq[0] + hq * st.dq[1];

  load_rows(qs, dp, qb, st.q[2], q0, kBQ, seq, dim, dp, scale);
  load_rows(gs, dp, gb, st.g[2], q0, kBQ, seq, dim, dp, 1.f);
  __syncthreads();

  const int r0 = warp * kRows;
  const float* qw = qs + r0 * dp;
  const float* gw = gs + r0 * dp;
  float dlt[kRows], lrow[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + r0 + r;
    float s = 0.f;
    if (qpos < seq) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < dim) s = fmaf(gw[r * dp + d], to_f32(ob[qpos * st.o[2] + d]), s);
      }
    }
    dlt[r] = warp_sum(s);
  }

  const int kv_lo = max(0, q0 - window + 1);
  const int kv_hi = min(seq, q0 + kBQ);          // exclusive
  const int kv_first = (kv_lo / kBK) * kBK;

  // pass 1: each row's max and sum over the band
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  for (int kv0 = kv_first; kv0 < kv_hi; kv0 += kBK) {
    __syncthreads();                              // the last tile is consumed
    load_rows(ks, ldk, kb, st.k[2], kv0, kBK, seq, dim, dp, 1.f);
    __syncthreads();
    float s[kRows];
    dots(qw, dp, ks + lane * ldk, dp, s);
    const int kpos = kv0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool ok = in_band(q0 + r0 + r, kpos, seq, window);
      const float sv = ok ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float p = ok ? expf(sv - m_new) : 0.f;
      l[r] = l[r] * expf(m[r] - m_new) + warp_sum(p);
      m[r] = m_new;
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    lrow[r] = l[r] > 0.f ? m[r] + logf(l[r]) : 0.f;
    const int qpos = q0 + r0 + r;
    if (lane == 0 && qpos < seq) {
      lse[bh * seq + qpos] = lrow[r];
      delta[bh * seq + qpos] = dlt[r];
    }
  }

  // pass 2: dQ
  float acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  for (int kv0 = kv_first; kv0 < kv_hi; kv0 += kBK) {
    __syncthreads();
    load_rows(ks, ldk, kb, st.k[2], kv0, kBK, seq, dim, dp, 1.f);
    load_rows(vs, ldk, vb, st.v[2], kv0, kBK, seq, dim, dp, 1.f);
    __syncthreads();
    float s[kRows], dpv[kRows], ds[kRows];
    dots(qw, dp, ks + lane * ldk, dp, s);
    dots(gw, dp, vs + lane * ldk, dp, dpv);
    const int kpos = kv0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool ok = in_band(q0 + r0 + r, kpos, seq, window);
      const float p = ok ? expf(s[r] - lrow[r]) : 0.f;
      ds[r] = p * (dpv[r] - dlt[r]);
    }
    for (int j = 0; j < kBK; ++j) {
      float kv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        kv[c] = d < dp ? ks[j * ldk + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float dsj = __shfl_sync(0xffffffffu, ds[r], j);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(dsj, kv[c], acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + r0 + r;
    if (qpos >= seq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < dim) dqb[qpos * st.dq[2] + d] = from_f32<T>(acc[r][c] * scale);
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, 1)
swa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, Strides st, int hq_n, int hkv_n,
                    int group, int seq, int dim, int dp, int window,
                    float scale, int k_tiles) {
  extern __shared__ float4 smem4[];
  const int ldq = dp + 4;
  float* ks = reinterpret_cast<float*>(smem4);   // kKeys x dp
  float* vs = ks + kKeys * dp;                    // kKeys x dp
  float* qs = vs + kKeys * dp;                    // kQT x ldq, times scale
  float* gs = qs + kQT * ldq;                     // kQT x ldq, dO
  float* ls = gs + kQT * ldq;                     // kQT: LSE
  float* ds_ = ls + kQT;                          // kQT: D

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kt = (int)(blockIdx.x % k_tiles);
  const int64_t bh = blockIdx.x / k_tiles;
  const int hk = (int)(bh % hkv_n);
  const int64_t b = bh / hkv_n;
  const int k0 = kt * kKeys;
  const T* kb = k + b * st.k[0] + hk * st.k[1];
  const T* vb = v + b * st.v[0] + hk * st.v[1];

  load_rows(ks, dp, kb, st.k[2], k0, kKeys, seq, dim, dp, 1.f);
  load_rows(vs, dp, vb, st.v[2], k0, kKeys, seq, dim, dp, 1.f);

  const int j0 = warp * kKeysPerWarp;
  const float* kw = ks + j0 * dp;
  const float* vw = vs + j0 * dp;
  float dka[kKeysPerWarp][NC], dva[kKeysPerWarp][NC];
#pragma unroll
  for (int j = 0; j < kKeysPerWarp; ++j)
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[j][c] = dva[j][c] = 0.f;

  // queries whose band reaches keys [k0, k0 + kKeys): [k0, k0 + kKeys - 1 + window)
  const int q_hi = (int)min((int64_t)seq, (int64_t)k0 + kKeys - 1 + window);
  for (int h = 0; h < group; ++h) {
    const int64_t bhq = b * hq_n + (int64_t)hk * group + h;
    const T* qb = q + b * st.q[0] + ((int64_t)hk * group + h) * st.q[1];
    const T* gb = g + b * st.g[0] + ((int64_t)hk * group + h) * st.g[1];
    for (int qq0 = k0; qq0 < q_hi; qq0 += kQT) {
      __syncthreads();                            // the last tile is consumed
      load_rows(qs, ldq, qb, st.q[2], qq0, kQT, seq, dim, dp, scale);
      load_rows(gs, ldq, gb, st.g[2], qq0, kQT, seq, dim, dp, 1.f);
      if (tid < kQT) {
        const int qpos = qq0 + tid;
        ls[tid] = qpos < seq ? lse[bhq * seq + qpos] : 0.f;
        ds_[tid] = qpos < seq ? delta[bhq * seq + qpos] : 0.f;
      }
      __syncthreads();
      float s[kKeysPerWarp], dpv[kKeysPerWarp], p[kKeysPerWarp],
          dsc[kKeysPerWarp];
      dots(kw, dp, qs + lane * ldq, dp, s);
      dots(vw, dp, gs + lane * ldq, dp, dpv);
      const int qpos = qq0 + lane;
#pragma unroll
      for (int j = 0; j < kKeysPerWarp; ++j) {
        const int kpos = k0 + j0 + j;
        const bool ok = kpos < seq && in_band(qpos, kpos, seq, window);
        p[j] = ok ? expf(s[j] - ls[lane]) : 0.f;
        dsc[j] = p[j] * (dpv[j] - ds_[lane]);
      }
      for (int i = 0; i < kQT; ++i) {
        float gv[NC], qv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = lane + 32 * c;
          gv[c] = d < dp ? gs[i * ldq + d] : 0.f;
          qv[c] = d < dp ? qs[i * ldq + d] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kKeysPerWarp; ++j) {
          const float pi = __shfl_sync(0xffffffffu, p[j], i);
          const float dsi = __shfl_sync(0xffffffffu, dsc[j], i);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dva[j][c] = fmaf(pi, gv[c], dva[j][c]);
            dka[j][c] = fmaf(dsi, qv[c], dka[j][c]);
          }
        }
      }
    }
  }
  T* dkb = dk + b * st.dk[0] + hk * st.dk[1];
  T* dvb = dv + b * st.dv[0] + hk * st.dv[1];
#pragma unroll
  for (int j = 0; j < kKeysPerWarp; ++j) {
    const int kpos = k0 + j0 + j;
    if (kpos >= seq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < dim) {
        dkb[kpos * st.dk[2] + d] = from_f32<T>(dka[j][c]);
        dvb[kpos * st.dv[2] + d] = from_f32<T>(dva[j][c]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *g;
  void *dq, *dk, *dv;
  float *lse, *delta;
  Strides st;
  int64_t batch;
  int hq, hkv, seq, dim, window;
  float scale;
  size_t smem;
};

template <typename T, int NC>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  const int q_tiles = (a.seq + kBQ - 1) / kBQ;
  const int64_t blocks = a.batch * a.hq * (int64_t)q_tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)swa_bwd_dq_kernel<T, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (e != cudaSuccess) return e;
  swa_bwd_dq_kernel<T, NC><<<(unsigned)blocks, kThreads, a.smem, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.o,
      (const T*)a.g, (T*)a.dq, a.lse, a.delta, a.st, a.hq, a.hq / a.hkv,
      a.seq, a.dim, (a.dim + 3) & ~3, a.window, a.scale, q_tiles);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_dkdv(const Args& a, cudaStream_t stream) {
  const int k_tiles = (a.seq + kKeys - 1) / kKeys;
  const int64_t blocks = a.batch * a.hkv * (int64_t)k_tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)swa_bwd_dkdv_kernel<T, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (e != cudaSuccess) return e;
  swa_bwd_dkdv_kernel<T, NC><<<(unsigned)blocks, kThreads, a.smem, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.g, a.lse,
      a.delta, (T*)a.dk, (T*)a.dv, a.st, a.hq, a.hkv, a.hq / a.hkv, a.seq,
      a.dim, (a.dim + 3) & ~3, a.window, a.scale, k_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, bool dkdv, cudaStream_t s) {
  if (a.dim <= 32) return dkdv ? launch_dkdv<T, 1>(a, s) : launch_dq<T, 1>(a, s);
  if (a.dim <= 64) return dkdv ? launch_dkdv<T, 2>(a, s) : launch_dq<T, 2>(a, s);
  if (a.dim <= 128) return dkdv ? launch_dkdv<T, 4>(a, s) : launch_dq<T, 4>(a, s);
  return dkdv ? launch_dkdv<T, 8>(a, s) : launch_dq<T, 8>(a, s);
}

int launch(const void* q, const void* k, const void* v, const void* o,
           const void* g, void* dq, void* dk, void* dv, float* lse,
           float* delta, int dtype, const int64_t* strides, int64_t batch,
           int hq, int hkv, int seq, int dim, int window, float scale,
           size_t smem, bool dkdv, void* stream) {
  if (hkv < 1 || hq % hkv != 0 || window < 1 || dim < 1 || dim > 256
      || seq < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, g, dq, dk, dv, lse, delta, {}, batch, hq, hkv, seq,
         dim, window, scale, smem};
  int64_t* dst[8] = {a.st.q, a.st.k, a.st.v, a.st.o, a.st.g, a.st.dq,
                     a.st.dk, a.st.dv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)dispatch<float>(a, dkdv, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, dkdv, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q, o, dO (g), dq: (batch, hq, seq,
// dim); k, v, dk, dv: (batch, hkv, seq, dim); all of that type on the
// device, unit stride along dim; strides: 24 int64, the (batch, head,
// position) element strides of q, k, v, o, g, dq, dk, dv in that order.
// lse, delta: (batch, hq, seq) float32, contiguous: swa_bwd_dq writes them,
// swa_bwd_dkdv reads them, so dq launches first on the same stream.
// hq % hkv == 0, 1 <= dim <= 256, window >= 1.  smem: dynamic shared
// memory, as kernels/swa/kernel.py:bwd_smem_bytes gives it for each.
// Returns cudaGetLastError().
int swa_bwd_dq_launch(const void* q, const void* k, const void* v,
                      const void* o, const void* g, void* dq, float* lse,
                      float* delta, int dtype, const int64_t* strides,
                      int64_t batch, int hq, int hkv, int seq, int dim,
                      int window, float scale, size_t smem, void* stream) {
  return launch(q, k, v, o, g, dq, nullptr, nullptr, lse, delta, dtype,
                strides, batch, hq, hkv, seq, dim, window, scale, smem, false,
                stream);
}

int swa_bwd_dkdv_launch(const void* q, const void* k, const void* v,
                        const void* g, void* dk, void* dv, const float* lse,
                        const float* delta, int dtype, const int64_t* strides,
                        int64_t batch, int hq, int hkv, int seq, int dim,
                        int window, float scale, size_t smem, void* stream) {
  return launch(q, k, v, nullptr, g, nullptr, dk, dv, (float*)lse,
                (float*)delta, dtype, strides, batch, hq, hkv, seq, dim,
                window, scale, smem, true, stream);
}

const char* swa_bwd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
