// Causal sliding-window attention with GQA and an online softmax, for
// sm_90a (H100).
//
// Replaces the TPU kernel repro/kernels/swa/kernel.py:swa_pallas (_body).
//
// out[b,h,i] = softmax_j(q_i . k_j / sqrt(D)) v_j over the keys j with
// j <= i, j > i - window and j < seq; the KV head of query head h is
// h / (Hq / Hkv).  Scores, the running max m, the running sum l and the
// accumulator are float32; masked scores are -1e30 and their probabilities
// 0, l is floored at 1e-30, and the output is cast to the input type at the
// store, as in the TPU kernel.  q, k, v and o are read and written through
// per-dimension (batch, head, position) strides with unit stride along D, so
// the model hands over its (B, S, H, D) projections without a copy.
//
// What bounds it on the H100: operations.  Each query meets up to `window`
// keys at 4*D flops a pair (at S = 4096, window 2048, D = 256 that is about
// 1,000 flops per byte moved), far above the card's balance.
//
// bfloat16 runs on the tensor cores (swa_wgmma_kernel), FlashAttention-2
// style with Hopper's warpgroup products (helpers shared with the backward
// in wgmma.cuh).  One block of two warpgroups per
// (b, hq, 128-query tile); warpgroup w owns query rows 64w..64w+63.  Q
// (128 x Dp) and a two-stage ring of 64-key K and V tiles live in shared
// memory as bfloat16 in the 128-byte swizzle that wgmma reads without bank
// conflicts (Dp = 64, 128 or 256, D zero-filled up to it); cp.async fills
// the next K/V stage while the warpgroups compute on this one.  Per key
// tile a warpgroup computes its 64 x 64 scores with wgmma m64n64k16 (Q and
// K from shared memory, f32 accumulators), scales them in f32, masks only
// where the tile meets the band's edge or the sequence end, updates m and
// l, rounds P to bf16 in registers (the accumulator layout of S is the
// register A-operand layout of P.V) and adds P.V with wgmma m64nDpk16 (V
// from shared memory, MN-major).  The 64 x Dp f32 accumulator stays in
// registers (128 a thread at D = 256).  Only the key tiles that meet the
// band [q0 - window + 1, q0 + 127] ∩ [0, seq) are visited and the true seq
// is masked, so nothing is padded on the host.  Shared memory:
// 2 * (128 + 4*64) * Dp bytes + 1024 for alignment, 197,632 B at D = 256,
// past 48 KB, so the launch opts in with cudaFuncSetAttribute.  Blocks are
// ordered so that the query heads of one KV head run side by side (K/V
// reuse in L2) and the longest bands start first.
//
// float32 keeps a CUDA-core kernel (swa_f32_kernel): the f32 limit of 2e-5
// rules out TF32 and bf16 products.  One block of 8 warps per (b, hq,
// 64-query tile) keeps its query tile scaled in shared memory and walks
// 32-key tiles (K transposed with a padded stride, V row-major); lane l
// scores key l against its warp's 8 rows and owns output columns l, l+32,
// ... of P.V in registers.  Shared memory 4*(64*Dp + Dp*33 + 32*Dp + 8*8*32)
// bytes (Dp = D rounded up to 4), 140,288 B at D = 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// element strides of q, k, v, o along (batch, head, position)
struct Strides {
  int64_t q[3], k[3], v[3], o[3];
};

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per tile (one per lane)
constexpr int kWarps = 8;
constexpr int kRows = kBQ / kWarps;
constexpr int kThreads = kWarps * 32;

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

template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
swa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, Strides st,
               int hq_n, int group, int seq, int dim, int dp, int window,
               float scale, int q_tiles) {
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
  const int q0 = qt * kBQ;
  const float* qb = q + b * st.q[0] + hq * st.q[1];
  const float* kb = k + b * st.k[0] + hk * st.k[1];
  const float* vb = v + b * st.v[0] + hk * st.v[1];
  float* ob = o + b * st.o[0] + hq * st.o[1];

  for (int idx = tid; idx < kBQ * dp; idx += kThreads) {
    const int r = idx / dp, d = idx - r * dp;
    const int qpos = q0 + r;
    qs[idx] = (qpos < seq && d < dim) ? qb[qpos * st.q[2] + d] * scale : 0.f;
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
      kt[d * (kBK + 1) + j] = in ? kb[kpos * st.k[2] + d] : 0.f;
      vs[idx] = in ? vb[kpos * st.v[2] + d] : 0.f;
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
      if (d < dim) ob[qpos * st.o[2] + d] = acc[r][c] / den;
    }
  }
}

template <int NC>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       const Strides& st, int64_t batch, int hq, int hkv,
                       int seq, int dim, int window, float scale, size_t smem,
                       cudaStream_t stream) {
  const int q_tiles = (seq + kBQ - 1) / kBQ;
  const int64_t blocks = batch * hq * (int64_t)q_tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  const int dp = (dim + 3) & ~3;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)swa_f32_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  swa_f32_kernel<NC><<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, st, hq,
      hq / hkv, seq, dim, dp, window, scale, q_tiles);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: warpgroup products (wgmma) on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kWgThreads = 256;       // two warpgroups, 64 query rows each
constexpr int kWQ = 128;              // query rows per block
constexpr int kWK = 64;               // keys per tile

template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
swa_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, Strides st,
                 int hkv_n, int group, int seq, int dim, int window,
                 float scale_log2, int q_tiles, int vec) {
  extern __shared__ uint4 smem_raw[];
  // the swizzle pattern repeats every 1024 bytes of address: align to it
  const uint32_t pad = (1024u - (smem_addr(smem_raw) & 1023u)) & 1023u;
  bf16* qs = reinterpret_cast<bf16*>(reinterpret_cast<char*>(smem_raw) + pad);  // kWQ x DP
  bf16* ring = qs + kWQ * DP;                      // 2 x (K, V), kWK x DP each

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const int g = (int)(blockIdx.x % group);
  const int rest = (int)(blockIdx.x / group);
  const int qt = q_tiles - 1 - rest % q_tiles;     // longest bands first
  const int bkv = rest / q_tiles;
  const int hk = bkv % hkv_n, b = bkv / hkv_n;
  const int hq = hk * group + g;
  const bf16* qb = q + b * st.q[0] + hq * st.q[1];
  const bf16* kb = k + b * st.k[0] + hk * st.k[1];
  const bf16* vb = v + b * st.v[0] + hk * st.v[1];
  bf16* ob = o + b * st.o[0] + hq * st.o[1];

  const int q0 = qt * kWQ;
  const int kv_lo = max(0, q0 - window + 1);
  const int kv_hi = min(seq, q0 + kWQ);            // exclusive
  const int t0 = kv_lo / kWK * kWK;
  const int n_tiles = (kv_hi - t0 + kWK - 1) / kWK;

  load_blk<DP, kWQ, kWgThreads>(qs, qb, st.q[2], q0, seq, dim, vec, tid);
  load_blk<DP, kWK, kWgThreads>(ring, kb, st.k[2], t0, seq, dim, vec, tid);
  load_blk<DP, kWK, kWgThreads>(ring + kWK * DP, vb, st.v[2], t0, seq, dim, vec, tid);
  cp_async_commit();

  const int wr = wg * 64 + (warp & 3) * 16;        // the warp's first row
  const int qrow0 = q0 + wr + (lane >> 2), qrow1 = qrow0 + 8;
  const int kcol = (lane & 3) * 2;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[DP / 2];
#pragma unroll
  for (int n = 0; n < DP / 2; ++n) acc[n] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t0 + t * kWK;
    if (t + 1 < n_tiles) {
      bf16* nk = ring + ((t + 1) & 1) * 2 * kWK * DP;
      load_blk<DP, kWK, kWgThreads>(nk, kb, st.k[2], kv0 + kWK, seq, dim, vec, tid);
      load_blk<DP, kWK, kWgThreads>(nk + kWK * DP, vb, st.v[2], kv0 + kWK, seq, dim, vec, tid);
      cp_async_commit();
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    fence_async_shared();
    __syncthreads();
    const bf16* ks = ring + (t & 1) * 2 * kWK * DP;
    const bf16* vs = ks + kWK * DP;

    // S = Q K^T: 64 rows x 64 keys per warpgroup, 16 of d per product
    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ki = 0; ki < DP / 16; ++ki)
      wgmma_ss_n64(s, desc_kmajor<kWQ>(qs, wg * 64, ki), desc_kmajor<kWK>(ks, 0, ki));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int j = 0; j < 32; ++j) reg_fence(s[j]);

    const bool edge = !(kv0 + kWK - 1 <= q0 && kv0 > q0 + kWQ - 1 - window
                        && kv0 + kWK <= seq);
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
      s[j] = p;
      if (j & 2) sum1 += p; else sum0 += p;
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int n = 0; n < DP / 2; n += 4) {
      acc[n] *= alpha0;
      acc[n + 1] *= alpha0;
      acc[n + 2] *= alpha1;
      acc[n + 3] *= alpha1;
    }

    // O += P V, P rounded to bf16 in registers (16 keys per product)
    uint32_t pa[kWK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kWK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWK / 16; ++kk)
      wgmma_pv<DP>(acc, pa[kk], desc_mnmajor<kWK>(vs, kk));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int kk = 0; kk < kWK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) reg_fence(pa[kk][e]);
#pragma unroll
    for (int n = 0; n < DP / 2; ++n) reg_fence(acc[n]);
    __syncthreads();                               // this stage is refilled next
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int d = n * 8 + kcol;
    if (d >= dim) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qpos = half ? qrow1 : qrow0;
      if (qpos >= seq) continue;
      const float den = half ? den1 : den0;
      const float y0 = acc[4 * n + 2 * half] / den, y1 = acc[4 * n + 2 * half + 1] / den;
      bf16* dst = ob + qpos * st.o[2] + d;
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
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         const Strides& st, int64_t batch, int hq, int hkv,
                         int seq, int dim, int window, float scale, int vec,
                         size_t smem, cudaStream_t stream) {
  const int q_tiles = (seq + kWQ - 1) / kWQ;
  const int64_t blocks = batch * hq * (int64_t)q_tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)swa_wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  swa_wgmma_kernel<DP><<<(unsigned)blocks, kWgThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, st, hkv,
      hq / hkv, seq, dim, window, scale * kLog2e, q_tiles, vec);
  return cudaGetLastError();
}
}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  q, o:
// (batch, hq, seq, dim); k, v: (batch, hkv, seq, dim); all of that type on
// the device, unit stride along dim; strides: 12 int64, the (batch, head,
// position) element strides of q, k, v and o in that order.  hq % hkv == 0,
// 1 <= dim <= 256, window >= 1.  vec (bf16 only): dim % 8 == 0 and every
// pointer and row 16-byte aligned.  smem: dynamic shared memory, as
// kernels/swa/kernel.py:smem_bytes gives it.  Returns cudaGetLastError().
int swa_launch(const void* q, const void* k, const void* v, void* o, int dtype,
               const int64_t* strides, int64_t batch, int hq, int hkv, int seq,
               int dim, int window, float scale, int vec, size_t smem,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (hkv < 1 || hq % hkv != 0 || window < 1 || dim < 1 || dim > 256)
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  if (dtype == 0) {
    if (dim <= 32) return launch_f32<1>(q, k, v, o, st, batch, hq, hkv, seq, dim, window, scale, smem, s);
    if (dim <= 64) return launch_f32<2>(q, k, v, o, st, batch, hq, hkv, seq, dim, window, scale, smem, s);
    if (dim <= 128) return launch_f32<4>(q, k, v, o, st, batch, hq, hkv, seq, dim, window, scale, smem, s);
    return launch_f32<8>(q, k, v, o, st, batch, hq, hkv, seq, dim, window, scale, smem, s);
  }
  if (dtype == 1) {
    if (dim <= 64) return launch_wgmma<64>(q, k, v, o, st, batch, hq, hkv, seq, dim, window, scale, vec, smem, s);
    if (dim <= 128) return launch_wgmma<128>(q, k, v, o, st, batch, hq, hkv, seq, dim, window, scale, vec, smem, s);
    return launch_wgmma<256>(q, k, v, o, st, batch, hq, hkv, seq, dim, window, scale, vec, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* swa_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
