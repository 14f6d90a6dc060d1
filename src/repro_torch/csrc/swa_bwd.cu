// Backward of causal sliding-window attention with GQA, for sm_90a (H100):
// FlashAttention-2's backward in two launches, bf16 on the tensor cores.
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
// What bounds it on the H100: operations.  The whole backward needs five
// products over the band's (query, key) pairs (S, dP, dQ, dK, dV; 2D flops
// each): 1.6e11 flops at (1, 10, 4096, 256) with window 2048, 0.163 ms at
// the bf16 tensor-core peak.  The LSE the forward does not keep costs one
// more Q.K^T, and splitting dQ from dK/dV without atomics S and dP once
// more: eight products.
//
// bfloat16 runs them on the tensor cores with wgmma (helpers shared with
// the forward in wgmma.cuh; tiles in the 128-byte swizzle, D zero-filled to
// Dp = 64, 128 or 256, loaded by cp.async, or element by element where an
// operand is not 16-byte aligned):
// - swa_bwd_dq_wgmma_kernel: one block of two warpgroups per (b, hq,
//   128-query tile), warpgroup w owning rows 64w..64w+63, shaped like the
//   forward.  Q and dO stay in shared memory; K tiles of 64 keys come
//   through a two-stage ring, V through one buffer refilled as soon as dP
//   has read it.  D comes from dO and O in the prologue.  Pass 1: S = Q K^T
//   (SS m64n64k16) and an online max and sum give each row's LSE.  Pass 2:
//   S and dP = dO V^T (SS), P and dS in f32 registers, dS rounded to bf16
//   in registers (the accumulator layout is the A-operand layout) and
//   dQ += dS K (RS m64nDpk16, K read MN-major).  dQ (64 x Dp f32, 128
//   registers a thread at Dp = 256) stays in registers; LSE and D go to
//   device memory in f32.
// - swa_bwd_dkdv_wgmma_kernel: keys are the rows.  One block of two
//   warpgroups per (b, hkv, 64-key tile, part of the group's query heads);
//   its K and V tiles stay in shared memory, a two-stage ring brings 64-query
//   Q and dO tiles with their LSE and D.  Warpgroup 0 computes S^T = K Q^T,
//   P^T and dV += P^T dO; warpgroup 1 dP^T = V dO^T, dS^T = P^T (dP^T - D)
//   and dK += dS^T Q (Q and dO read MN-major), P^T handed across in shared
//   memory (f32, each thread's own fragment) under named barrier 1: four
//   products, and one 64 x Dp f32 accumulator a warpgroup, as two would not
//   fit one's registers at Dp = 256.  The group's query heads are split
//   into `parts` (a rule on the shapes alone: as many as keep the blocks
//   within the H100's 132 SMs), because one KV head at S = 4096 has only 64
//   key tiles; each part writes its f32 partial dK and dV.
// - swa_bwd_fold_kernel: sums the parts in a fixed order and casts to bf16.
// Only the tiles that meet the band are visited and only those on its edge
// or at seq's end are masked.  Every sum runs in a fixed order, with no
// atomics: the same inputs give the same bits.
//
// float32 keeps CUDA-core kernels (its 1e-5 bar rules out bf16 and TF32
// products; the training step runs bf16):
// - swa_bwd_dq_kernel: one block of 8 warps per (b, hq, 64-query tile);
//   warp w owns rows 8w..8w+7, lane l scores key l of a 32-key tile.
//   Pass 1 walks the band's key tiles for each row's max and sum (the LSE)
//   and computes D; pass 2 walks the band again: P, dP, dS a lane per key,
//   and dQ accumulated in registers with lanes across D (each dS broadcast
//   by a shuffle).
// - swa_bwd_dkdv_kernel: one block of 8 warps per (b, hkv, 32-key tile);
//   warp w owns keys 4w..4w+3 and keeps their dK and dV rows in registers
//   (lanes across D).  It loops over the group's query heads and over the
//   32-query tiles whose band reaches the key tile, lane l scoring query l.
// Inputs are widened to f32 in shared memory, every sum is f32 in a fixed
// order, and the gradients are cast at the store.
//
// Shared memory (kernels/swa/kernel.py:bwd_smem_bytes, checked here at the
// launch): bf16 dq 2 * Dp * (2*128 + 3*64) + 4*128 + 1024 bytes (230,912 B
// at Dp = 256), dkdv 2 * Dp * 6*64 + 4*4*64 + 4*64*64 + 1024 (215,040 B);
// f32 (Dp = D rounded up to 4, rows a lane reads padded to Dp + 4) dq
// 4 * (2*64*Dp + 2*32*(Dp+4)), dkdv 4 * (2*32*Dp + 2*32*(Dp+4) + 64).  All
// past 48 KB, so the launches opt in with cudaFuncSetAttribute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "wgmma.cuh"

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

// ---------------------------------------------------------------------------
// bfloat16: warpgroup products (wgmma) on the tensor cores
// ---------------------------------------------------------------------------
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWgThreads = 256;          // two warpgroups
constexpr int kDqRows = 128;             // dq: query rows per block, 64 a warpgroup
constexpr int kTile = 64;                // dq: keys a tile; dkdv: keys a block, queries a tile

template <int DP>
constexpr size_t dq_smem() {
  return 2 * DP * (2 * kDqRows + 3 * kTile) + 4 * kDqRows + 1024;
}
template <int DP>
constexpr size_t dkdv_smem() {
  return 2 * DP * 6 * kTile + 4 * 4 * kTile + 4 * kTile * kTile + 1024;
}

// 4 bytes global -> shared; src_bytes 0 writes a zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

// a K-major descriptor of a ROWS-row tile advanced by ki steps of 16
// columns (32 bytes within an atom, ROWS * 128 bytes an atom; the address
// field is the low 14 bits, in 16-byte units), and an MN-major one by kk
// steps of 16 rows (2048 bytes): dkdv's descriptors as a base and an
// immediate offset, which measured faster there than desc_kmajor and
// desc_mnmajor (and slower in dq, whose registers are fuller)
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint64_t base, int ki) {
  return base + (uint64_t)(((ki >> 2) * ROWS * 128 + (ki & 3) * 32) >> 4);
}
__device__ __forceinline__ uint64_t desc_mn(uint64_t base, int kk) {
  return base + (uint64_t)(kk * 128);
}

__device__ __forceinline__ char* align1024(void* p) {
  const uint32_t pad = (1024u - (smem_addr(p) & 1023u)) & 1023u;
  return reinterpret_cast<char*>(p) + pad;
}

template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
swa_bwd_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ g, bf16* __restrict__ dq,
                        float* __restrict__ lse, float* __restrict__ delta,
                        Strides st, int hkv_n, int group, int seq, int dim,
                        int window, float scale, int q_tiles, int vec) {
  extern __shared__ uint4 smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(align1024(smem_raw));   // kDqRows x DP
  bf16* gs = qs + kDqRows * DP;                              // dO, kDqRows x DP
  bf16* ring = gs + kDqRows * DP;                            // 2 K stages, kTile x DP
  bf16* vs = ring + 2 * kTile * DP;                          // V, kTile x DP
  float* dsm = reinterpret_cast<float*>(vs + kTile * DP);    // kDqRows: D

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const int gi = (int)(blockIdx.x % group);
  const int rest = (int)(blockIdx.x / group);
  const int qt = q_tiles - 1 - rest % q_tiles;     // longest bands first
  const int bkv = rest / q_tiles;
  const int hk = bkv % hkv_n, b = bkv / hkv_n;
  const int hq = hk * group + gi;
  const int64_t bh = (int64_t)b * hkv_n * group + hq;
  const bf16* qb = q + b * st.q[0] + hq * st.q[1];
  const bf16* kb = k + b * st.k[0] + hk * st.k[1];
  const bf16* vb = v + b * st.v[0] + hk * st.v[1];
  const bf16* ob = o + b * st.o[0] + hq * st.o[1];
  const bf16* gb = g + b * st.g[0] + hq * st.g[1];
  bf16* dqb = dq + b * st.dq[0] + hq * st.dq[1];

  const int q0 = qt * kDqRows;
  const int kv_lo = max(0, q0 - window + 1);
  const int kv_hi = min(seq, q0 + kDqRows);        // exclusive
  const int t0 = kv_lo / kTile * kTile;
  const int n = (kv_hi - t0 + kTile - 1) / kTile;  // key tiles; a pass each

  load_blk<DP, kDqRows, kWgThreads>(qs, qb, st.q[2], q0, seq, dim, vec, tid);
  load_blk<DP, kDqRows, kWgThreads>(gs, gb, st.g[2], q0, seq, dim, vec, tid);
  load_blk<DP, kTile, kWgThreads>(ring, kb, st.k[2], t0, seq, dim, vec, tid);
  cp_async_commit();

  // D = rowsum(dO * O), a warp a row, from device memory
  for (int r = warp; r < kDqRows; r += kWgThreads / 32) {
    const int pos = q0 + r;
    float s = 0.f;
    if (pos < seq)
      for (int d = lane; d < dim; d += 32)
        s = fmaf(__bfloat162float(gb[pos * st.g[2] + d]),
                 __bfloat162float(ob[pos * st.o[2] + d]), s);
    s = warp_sum(s);
    if (lane == 0) {
      dsm[r] = s;
      if (pos < seq) delta[bh * seq + pos] = s;
    }
  }

  const int wr = wg * 64 + (warp & 3) * 16;        // the warp's first row
  const int qrow0 = q0 + wr + (lane >> 2), qrow1 = qrow0 + 8;
  const int kcol = (lane & 3) * 2;
  const int r_lo = q0 + wg * 64, r_hi = r_lo + 63; // the warpgroup's rows
  const float scale_log2 = scale * kLog2e;
  // pass 1: running max and sum (log2 units); pass 2: LSE and D of the rows
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float lse0 = 0.f, lse1 = 0.f, dl0 = 0.f, dl1 = 0.f;
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  for (int u = 0; u < 2 * n; ++u) {
    const bool pass2 = u >= n;
    const int t = pass2 ? u - n : u;
    const int kv0 = t0 + t * kTile;
    cp_async_wait_group<0>();
    fence_async_shared();
    __syncthreads();                               // K(u) (and V) landed; stage u+1 free
    if (u + 1 < 2 * n) {
      const int tn = u + 1 < n ? u + 1 : u + 1 - n;
      load_blk<DP, kTile, kWgThreads>(ring + ((u + 1) & 1) * kTile * DP, kb, st.k[2],
                                      t0 + tn * kTile, seq, dim, vec, tid);
      if (u + 1 == n)
        load_blk<DP, kTile, kWgThreads>(vs, vb, st.v[2], t0, seq, dim, vec, tid);
      cp_async_commit();
    }
    if (u == n) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      lse0 = l0 > 0.f ? m0 + log2f(l0) : 0.f;
      lse1 = l1 > 0.f ? m1 + log2f(l1) : 0.f;
      if ((lane & 3) == 0) {
        if (qrow0 < seq) lse[bh * seq + qrow0] = lse0 * kLn2;
        if (qrow1 < seq) lse[bh * seq + qrow1] = lse1 * kLn2;
      }
      dl0 = dsm[wr + (lane >> 2)];
      dl1 = dsm[wr + (lane >> 2) + 8];
    }
    const bf16* ks = ring + (u & 1) * kTile * DP;
    // no key of the tile meets the warpgroup's rows: nothing to add
    const bool skip = kv0 > r_hi || kv0 + kTile - 1 <= r_lo - window;
    const bool edge = !(kv0 + kTile - 1 <= r_lo && kv0 > r_hi - window
                        && kv0 + kTile <= seq);
    float s[32];
    if (!pass2) {
      if (!skip) {
#pragma unroll
        for (int j = 0; j < 32; ++j) s[j] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int ki = 0; ki < DP / 16; ++ki)
          wgmma_ss_n64(s, desc_kmajor<kDqRows>(qs, wg * 64, ki), desc_kmajor<kTile>(ks, 0, ki));
        wgmma_commit();
        wgmma_wait0();
#pragma unroll
        for (int j = 0; j < 32; ++j) reg_fence(s[j]);
        uint32_t ok = 0xffffffffu;
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * j + e] * scale_log2;
            if (edge) {
              const int kpos = kv0 + j * 8 + kcol + (e & 1);
              const int qpos = e < 2 ? qrow0 : qrow1;
              if (!(kpos <= qpos && kpos > qpos - window && kpos < seq)) {
                ok &= ~(1u << (j * 4 + e));
                x = kNegInf;
              }
            }
            s[4 * j + e] = x;
            if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
          }
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float alpha0 = fast_exp2(m0 - mx0), alpha1 = fast_exp2(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float p = (ok >> j) & 1u ? fast_exp2(s[j] - ((j & 2) ? mx1 : mx0)) : 0.f;
          if (j & 2) sum1 += p; else sum0 += p;
        }
        l0 = l0 * alpha0 + sum0;
        l1 = l1 * alpha1 + sum1;
      }
      continue;
    }

    float dp[32];
    if (!skip) {
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ki = 0; ki < DP / 16; ++ki)
        wgmma_ss_n64(s, desc_kmajor<kDqRows>(qs, wg * 64, ki), desc_kmajor<kTile>(ks, 0, ki));
#pragma unroll
      for (int ki = 0; ki < DP / 16; ++ki)
        wgmma_ss_n64(dp, desc_kmajor<kDqRows>(gs, wg * 64, ki), desc_kmajor<kTile>(vs, 0, ki));
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        reg_fence(s[j]);
        reg_fence(dp[j]);
      }
    }
    __syncthreads();                               // V(t) is read: refill it
    if (t + 1 < n) {
      load_blk<DP, kTile, kWgThreads>(vs, vb, st.v[2], kv0 + kTile, seq, dim, vec, tid);
      cp_async_commit();
    }
    if (skip) continue;
    // P = 2^(S log2e - LSE) on the band, dS = P (dP - D), in place of dP
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool ok = true;
        if (edge) {
          const int kpos = kv0 + j * 8 + kcol + (e & 1);
          const int qpos = e < 2 ? qrow0 : qrow1;
          ok = kpos <= qpos && kpos > qpos - window && kpos < seq;
        }
        const float p = ok ? fast_exp2(s[4 * j + e] * scale_log2 - (e < 2 ? lse0 : lse1)) : 0.f;
        dp[4 * j + e] = p * (dp[4 * j + e] - (e < 2 ? dl0 : dl1));
      }
    }
    // dQ += dS K, dS rounded to bf16 in registers (16 keys per product)
    uint32_t pa[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      pa[kk][0] = pack_bf16(dp[8 * kk], dp[8 * kk + 1]);
      pa[kk][1] = pack_bf16(dp[8 * kk + 2], dp[8 * kk + 3]);
      pa[kk][2] = pack_bf16(dp[8 * kk + 4], dp[8 * kk + 5]);
      pa[kk][3] = pack_bf16(dp[8 * kk + 6], dp[8 * kk + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_pv<DP>(acc, pa[kk], desc_mnmajor<kTile>(ks, kk));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) reg_fence(pa[kk][e]);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) reg_fence(acc[i]);
  }

#pragma unroll
  for (int nn = 0; nn < DP / 8; ++nn) {
    const int d = nn * 8 + kcol;
    if (d >= dim) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qpos = half ? qrow1 : qrow0;
      if (qpos >= seq) continue;
      const float y0 = acc[4 * nn + 2 * half] * scale, y1 = acc[4 * nn + 2 * half + 1] * scale;
      bf16* dst = dqb + qpos * st.dq[2] + d;
      if (vec) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(y0, y1);
      } else {
        dst[0] = __float2bfloat16(y0);
        if (d + 1 < dim) dst[1] = __float2bfloat16(y1);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
swa_bwd_dkdv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ g,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ part, Strides st, int hkv_n,
                          int group, int seq, int dim, int window, float scale,
                          int k_tiles, int parts, int vec) {
  extern __shared__ uint4 smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(align1024(smem_raw));   // kTile x DP
  bf16* vs = ks + kTile * DP;                                // kTile x DP
  bf16* ring = vs + kTile * DP;                              // 2 x (Q, dO), kTile x DP each
  float* lsm = reinterpret_cast<float*>(ring + 4 * kTile * DP);  // 2 x kTile: LSE
  float* dsm = lsm + 2 * kTile;                              // 2 x kTile: D
  float* psm = dsm + 2 * kTile;                              // 32 x 128: P^T fragments

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wt = tid & 127;
  const int pi = (int)(blockIdx.x % parts);
  const int rest = (int)(blockIdx.x / parts);
  const int kt = rest % k_tiles;                   // longest bands first
  const int bkv = rest / k_tiles;
  const int hk = bkv % hkv_n, b = bkv / hkv_n;
  const int h_lo = pi * group / parts, h_hi = (pi + 1) * group / parts;
  const int k0 = kt * kTile;
  // queries whose band reaches keys [k0, k0 + kTile): [k0, k0 + kTile - 1 + window)
  const int q_hi = min(seq, k0 + kTile - 1 + window);
  const int nq = (q_hi - k0 + kTile - 1) / kTile;
  const int n = (h_hi - h_lo) * nq;

  auto load_stage = [&](int u) {
    const int hq = hk * group + h_lo + u / nq;
    const int q0 = k0 + (u % nq) * kTile;
    const int64_t bhq = (int64_t)b * hkv_n * group + hq;
    bf16* dst = ring + (u & 1) * 2 * kTile * DP;
    load_blk<DP, kTile, kWgThreads>(dst, q + b * st.q[0] + hq * st.q[1], st.q[2], q0,
                                    seq, dim, vec, tid);
    load_blk<DP, kTile, kWgThreads>(dst + kTile * DP, g + b * st.g[0] + hq * st.g[1],
                                    st.g[2], q0, seq, dim, vec, tid);
    if (tid < 2 * kTile) {
      const int i = tid & (kTile - 1);
      const float* src = tid < kTile ? lse : delta;
      float* sm = (tid < kTile ? lsm : dsm) + (u & 1) * kTile + i;
      const bool in = q0 + i < seq;
      cp_async4(smem_addr(sm), in ? src + bhq * seq + q0 + i : src, in ? 4 : 0);
    }
  };
  load_blk<DP, kTile, kWgThreads>(ks, k + b * st.k[0] + hk * st.k[1], st.k[2], k0, seq,
                                  dim, vec, tid);
  load_blk<DP, kTile, kWgThreads>(vs, v + b * st.v[0] + hk * st.v[1], st.v[2], k0, seq,
                                  dim, vec, tid);
  load_stage(0);
  cp_async_commit();

  const int krow0 = k0 + (warp & 3) * 16 + (lane >> 2), krow1 = krow0 + 8;
  const int qcol = (lane & 3) * 2;
  const float scale_log2 = scale * kLog2e;
  float acc[DP / 2];                               // warpgroup 0: dV; 1: dK / scale
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  for (int u = 0; u < n; ++u) {
    cp_async_wait_group<0>();
    fence_async_shared();
    __syncthreads();                               // stage u landed; stage u+1 and psm free
    if (u + 1 < n) {
      load_stage(u + 1);
      cp_async_commit();
    }
    const int q0 = k0 + (u % nq) * kTile;
    const bf16* qs = ring + (u & 1) * 2 * kTile * DP;
    const bf16* gs = qs + kTile * DP;
    const float* lsu = lsm + (u & 1) * kTile;
    const float* dsu = dsm + (u & 1) * kTile;
    const bool edge = !(k0 + kTile - 1 <= q0 && k0 > q0 + kTile - 1 - window
                        && q0 + kTile <= seq);

    // warpgroup 0: S^T = K Q^T; warpgroup 1: dP^T = V dO^T (64 keys x 64 queries)
    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    const uint64_t dsc_a = desc_kmajor<kTile>(wg == 0 ? ks : vs, 0, 0);
    const uint64_t dsc_b = desc_kmajor<kTile>(wg == 0 ? qs : gs, 0, 0);
    wgmma_fence();
#pragma unroll
    for (int ki = 0; ki < DP / 16; ++ki)
      wgmma_ss_n64(s, desc_k<kTile>(dsc_a, ki), desc_k<kTile>(dsc_b, ki));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int j = 0; j < 32; ++j) reg_fence(s[j]);

    if (wg == 0) {
      // P^T = 2^(S^T log2e - LSE_col) on the band, handed to warpgroup 1
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + qcol + (e & 1);
          bool ok = true;
          if (edge) {
            const int qpos = q0 + col;
            const int kpos = e < 2 ? krow0 : krow1;
            ok = kpos <= qpos && kpos > qpos - window && qpos < seq;
          }
          const float p = ok ? fast_exp2(s[4 * j + e] * scale_log2 - lsu[col] * kLog2e) : 0.f;
          s[4 * j + e] = p;
          psm[(4 * j + e) * 128 + wt] = p;
        }
      }
      asm volatile("bar.arrive 1, 256;\n" ::: "memory");
    } else {
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      // dS^T = P^T (dP^T - D_col)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + qcol + (e & 1);
          s[4 * j + e] = psm[(4 * j + e) * 128 + wt] * (s[4 * j + e] - dsu[col]);
        }
      }
    }
    // dV += P^T dO (warpgroup 0), dK += dS^T Q (warpgroup 1), the left
    // operand rounded to bf16 in registers (16 queries per product)
    uint32_t pa[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    const uint64_t dsc_rhs = desc_mnmajor<kTile>(wg == 0 ? gs : qs, 0);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_pv<DP>(acc, pa[kk], desc_mn(dsc_rhs, kk));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) reg_fence(pa[kk][e]);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) reg_fence(acc[i]);
  }

  // this part's f32 partial: plane 0 dK, plane 1 dV, each (B, Hkv, S, dim)
  const int64_t plane = (int64_t)(gridDim.x / (parts * k_tiles)) * seq * dim;
  const float mul = wg == 0 ? 1.f : scale;
  float* dst = part + ((int64_t)(wg == 0 ? 1 : 0) * parts + pi) * plane
               + (int64_t)bkv * seq * dim;
#pragma unroll
  for (int nn = 0; nn < DP / 8; ++nn) {
    const int d = nn * 8 + qcol;
    if (d >= dim) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kpos = half ? krow1 : krow0;
      if (kpos >= seq) continue;
      const float y0 = acc[4 * nn + 2 * half] * mul, y1 = acc[4 * nn + 2 * half + 1] * mul;
      float* p = dst + (int64_t)kpos * dim + d;
      if (vec) {
        *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
      } else {
        p[0] = y0;
        if (d + 1 < dim) p[1] = y1;
      }
    }
  }
}

// dk, dv = bf16(sum over the parts, in order, of the f32 partials); a
// block a row of (B, Hkv, S) at a time, threads along D
__global__ void __launch_bounds__(256)
swa_bwd_fold_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, Strides st, int parts, int hkv_n,
                    int seq, int dim, int64_t rows) {
  const int64_t plane = rows * dim;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const int pos = (int)(row % seq);
    const int64_t bh = row / seq;
    const int h = (int)(bh % hkv_n);
    const int64_t b = bh / hkv_n;
    const float* src = part + row * dim;
    bf16* dkr = dk + b * st.dk[0] + h * st.dk[1] + pos * st.dk[2];
    bf16* dvr = dv + b * st.dv[0] + h * st.dv[1] + pos * st.dv[2];
    for (int d = threadIdx.x; d < dim; d += blockDim.x) {
      float a = src[d], c = src[parts * plane + d];
      for (int p = 1; p < parts; ++p) {
        a += src[p * plane + d];
        c += src[(parts + p) * plane + d];
      }
      dkr[d] = __float2bfloat16(a);
      dvr[d] = __float2bfloat16(c);
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *g;
  void *dq, *dk, *dv;
  float *lse, *delta, *part;
  Strides st;
  int64_t batch;
  int hq, hkv, seq, dim, window, parts;
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

cudaError_t dispatch_f32(const Args& a, bool dkdv, cudaStream_t s) {
  if (a.dim <= 32) return dkdv ? launch_dkdv<float, 1>(a, s) : launch_dq<float, 1>(a, s);
  if (a.dim <= 64) return dkdv ? launch_dkdv<float, 2>(a, s) : launch_dq<float, 2>(a, s);
  if (a.dim <= 128) return dkdv ? launch_dkdv<float, 4>(a, s) : launch_dq<float, 4>(a, s);
  return dkdv ? launch_dkdv<float, 8>(a, s) : launch_dq<float, 8>(a, s);
}

// 16-byte cp.async and paired stores: D a multiple of 8, every row and
// pointer 16-byte aligned (dq: q, k, v, dO, o, dq; dkdv: q, k, v, dO and
// the partial sums, contiguous)
bool vec_ok(const Args& a, bool dkdv) {
  if (a.dim % 8) return false;
  const void* ptrs[6] = {a.q, a.k, a.v, a.g, a.o, a.dq};
  const int64_t* st[6] = {a.st.q, a.st.k, a.st.v, a.st.g, a.st.o, a.st.dq};
  if (dkdv) ptrs[4] = a.part;
  for (int t = 0; t < (dkdv ? 5 : 6); ++t)
    if ((uintptr_t)ptrs[t] % 16) return false;
  for (int t = 0; t < (dkdv ? 4 : 6); ++t)
    for (int i = 0; i < 3; ++i)
      if (st[t][i] % 8) return false;
  return true;
}

template <int DP>
cudaError_t launch_dq_wgmma(const Args& a, cudaStream_t stream) {
  if (a.smem != dq_smem<DP>()) return cudaErrorInvalidValue;
  const int q_tiles = (a.seq + kDqRows - 1) / kDqRows;
  const int64_t blocks = a.batch * a.hq * (int64_t)q_tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)swa_bwd_dq_wgmma_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (e != cudaSuccess) return e;
  swa_bwd_dq_wgmma_kernel<DP><<<(unsigned)blocks, kWgThreads, a.smem, stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (const bf16*)a.o,
      (const bf16*)a.g, (bf16*)a.dq, a.lse, a.delta, a.st, a.hkv, a.hq / a.hkv,
      a.seq, a.dim, a.window, a.scale, q_tiles, (int)vec_ok(a, false));
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkdv_wgmma(const Args& a, cudaStream_t stream) {
  const int group = a.hq / a.hkv;
  if (a.smem != dkdv_smem<DP>() || a.parts < 1 || a.parts > group || !a.part)
    return cudaErrorInvalidValue;
  const int k_tiles = (a.seq + kTile - 1) / kTile;
  const int64_t blocks = a.batch * a.hkv * (int64_t)k_tiles * a.parts;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)swa_bwd_dkdv_wgmma_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (e != cudaSuccess) return e;
  swa_bwd_dkdv_wgmma_kernel<DP><<<(unsigned)blocks, kWgThreads, a.smem, stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (const bf16*)a.g,
      a.lse, a.delta, a.part, a.st, a.hkv, group, a.seq, a.dim, a.window,
      a.scale, k_tiles, a.parts, (int)vec_ok(a, true));
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const Args& a, bool dkdv, cudaStream_t s) {
  if (a.dim <= 64) return dkdv ? launch_dkdv_wgmma<64>(a, s) : launch_dq_wgmma<64>(a, s);
  if (a.dim <= 128) return dkdv ? launch_dkdv_wgmma<128>(a, s) : launch_dq_wgmma<128>(a, s);
  return dkdv ? launch_dkdv_wgmma<256>(a, s) : launch_dq_wgmma<256>(a, s);
}

int launch(Args a, int dtype, const int64_t* strides, bool dkdv, void* stream) {
  if (a.hkv < 1 || a.hq % a.hkv != 0 || a.window < 1 || a.dim < 1
      || a.dim > 256 || a.seq < 1 || a.batch < 1)
    return (int)cudaErrorInvalidValue;
  int64_t* dst[8] = {a.st.q, a.st.k, a.st.v, a.st.o, a.st.g, a.st.dq,
                     a.st.dk, a.st.dv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)dispatch_f32(a, dkdv, s);
  if (dtype == 1) return (int)dispatch_bf16(a, dkdv, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  q, o,
// dO (g), dq: (batch, hq, seq, dim); k, v, dk, dv: (batch, hkv, seq, dim);
// all of that type on the device, unit stride along dim; strides: 24
// int64, the (batch, head, position) element strides of q, k, v, o, g, dq,
// dk, dv in that order.  lse, delta: (batch, hq, seq) float32, contiguous:
// swa_bwd_dq writes them, swa_bwd_dkdv reads them, so dq launches first on
// the same stream.  hq % hkv == 0, 1 <= dim <= 256, window >= 1.  smem:
// dynamic shared memory, as kernels/swa/kernel.py:bwd_smem_bytes gives it
// for each (bf16: refused unless it is the kernel's layout).  Returns
// cudaGetLastError().
int swa_bwd_dq_launch(const void* q, const void* k, const void* v,
                      const void* o, const void* g, void* dq, float* lse,
                      float* delta, int dtype, const int64_t* strides,
                      int64_t batch, int hq, int hkv, int seq, int dim,
                      int window, float scale, size_t smem, void* stream) {
  Args a{q, k, v, o, g, dq, nullptr, nullptr, lse, delta, nullptr, {}, batch,
         hq, hkv, seq, dim, window, 1, scale, smem};
  return launch(a, dtype, strides, false, stream);
}

// float32 writes dk and dv; bfloat16 writes each part's f32 partial sums
// into `partial`, (2, parts, batch, hkv, seq, dim) contiguous (dK, then
// dV), 1 <= parts <= hq / hkv, and leaves dk and dv to swa_bwd_fold.
int swa_bwd_dkdv_launch(const void* q, const void* k, const void* v,
                        const void* g, void* dk, void* dv, const float* lse,
                        const float* delta, int dtype, const int64_t* strides,
                        int64_t batch, int hq, int hkv, int seq, int dim,
                        int window, float scale, float* partial, int parts,
                        size_t smem, void* stream) {
  Args a{q, k, v, nullptr, g, nullptr, dk, dv, (float*)lse, (float*)delta,
         partial, {}, batch, hq, hkv, seq, dim, window, parts, scale, smem};
  return launch(a, dtype, strides, true, stream);
}

// dk, dv (bfloat16, through their (batch, head, position) strides, 6 int64)
// = the sum over the parts, in order, of swa_bwd_dkdv's partials.
int swa_bwd_fold_launch(const float* partial, void* dk, void* dv,
                        const int64_t* strides, int64_t batch, int hkv,
                        int seq, int dim, int parts, void* stream) {
  if (batch < 1 || hkv < 1 || seq < 1 || dim < 1 || parts < 1)
    return (int)cudaErrorInvalidValue;
  Strides st{};
  for (int i = 0; i < 3; ++i) {
    st.dk[i] = strides[i];
    st.dv[i] = strides[3 + i];
  }
  const int64_t rows = batch * hkv * (int64_t)seq;
  const int64_t blocks = std::min<int64_t>(rows, 132 * 8);
  swa_bwd_fold_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      partial, (bf16*)dk, (bf16*)dv, st, parts, hkv, seq, dim, rows);
  return (int)cudaGetLastError();
}

const char* swa_bwd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
