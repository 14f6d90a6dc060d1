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
// float32 runs on the tensor cores too (swa_f32_kernel), on mma.sync
// m16n8k8 in 3xTF32 with the helpers of the f32 backward (tf32.cuh): each
// operand split into a TF32 hi and the rest as it is read, three products
// summed in f32, which keeps the f32 limit of 2e-5 that one TF32 product
// misses, and long sums in short chunks added by FADD, as the tensor cores
// truncate.  One block of 8 warps per (b, hq, 64-query tile) on 32-key
// tiles; Q (64 x Dp) and a two-stage ring of K and V tiles are f32 in
// shared memory in the swizzle that serves ldmatrix along rows and element
// reads down columns (Dp = 64, 128 or 256, D zero-filled), filled by
// cp.async while the warps compute on the other stage.  Warps w and w + 4
// share query rows 16 (w % 4)..+15: each computes S for its 16 keys of the
// tile, scales it in f32 by scale log2e and masks it only where its keys
// meet the band's edge or seq; the pair takes each row's running max from
// both halves through shared memory (named barrier 1 + w % 4), so both
// hold the same bits of m, alpha and P; each keeps the partial sum l of its
// own keys (added once at the end); each turns its P into split A
// fragments, hands them to the other, and adds P V over the tile's 32 keys
// into its half of the output's columns (64 registers a thread at
// Dp = 256), rescaled by alpha first.  Shared memory
// 4 * (Dp * (64 + 4*32) + 8*512 + 8*16) bytes, 213,504 B at Dp = 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "tf32.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// element strides of q, k, v, o along (batch, head, position)
struct Strides {
  int64_t q[3], k[3], v[3], o[3];
};

// ---------------------------------------------------------------------------
// float32: 3xTF32 products (mma.sync m16n8k8) on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kFRows = 64;               // query rows a block, 16 a warp pair
constexpr int kFKeys = 32;               // keys a tile, 16 a warp

template <int DP>
constexpr size_t f32_smem() {
  return 4 * (size_t)DP * (kFRows + 4 * kFKeys) + 4 * (8 * kXch + 8 * 16);
}

template <int DP>
__global__ void __launch_bounds__(kFThreads, 1)
swa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, Strides st,
               int hkv_n, int group, int seq, int dim, int window,
               float scale_log2, int q_tiles, int vec) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);                 // kFRows x DP
  float* ring = qs + kFRows * DP;                              // 2 x (K, V), kFKeys x DP each
  uint32_t* xch = reinterpret_cast<uint32_t*>(ring + 4 * kFKeys * DP);   // 8 x kXch: P
  float* mxs = reinterpret_cast<float*>(xch + 8 * kXch);      // 8 warps x 16 rows: max, then sum
  auto stage = [&](int t) { return ring + (t & 1) * 2 * kFKeys * DP; };   // K, then V

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gl = lane >> 2, ql = lane & 3;
  const int wr = warp & 3, wh = warp >> 2;   // rows 16 wr..; keys 16 wh.. of a tile
  const int gi = (int)(blockIdx.x % group);
  const int rest = (int)(blockIdx.x / group);
  const int qt = q_tiles - 1 - rest % q_tiles;     // longest bands first
  const int bkv = rest / q_tiles;
  const int hk = bkv % hkv_n, b = bkv / hkv_n;
  const int hq = hk * group + gi;
  const float* qb = q + b * st.q[0] + hq * st.q[1];
  const float* kb = k + b * st.k[0] + hk * st.k[1];
  const float* vb = v + b * st.v[0] + hk * st.v[1];
  float* ob = o + b * st.o[0] + hq * st.o[1];

  const int q0 = qt * kFRows;
  const int kv_lo = max(0, q0 - window + 1);
  const int kv_hi = min(seq, q0 + kFRows);         // exclusive
  const int t0 = kv_lo / kFKeys * kFKeys;
  const int n = (kv_hi - t0 + kFKeys - 1) / kFKeys;

  load_tile<DP, kFRows>(qs, qb, st.q[2], q0, seq, dim, vec, tid);
  load_tile<DP, kFKeys>(stage(0), kb, st.k[2], t0, seq, dim, vec, tid);
  load_tile<DP, kFKeys>(stage(0) + kFKeys * DP, vb, st.v[2], t0, seq, dim, vec, tid);
  cp_async_commit();

  const FragCols fc(lane);
  const int r0 = 16 * wr;                          // the warp's first row in the block
  const int qrow0 = q0 + r0 + gl, qrow1 = qrow0 + 8;
  const int row_lo = q0 + r0;
  auto skip_half = [&](int kv0, int h) { return keys16_skip(kv0 + 16 * h, row_lo, seq, window); };
  auto edge_half = [&](int kv0, int h) { return keys16_edge(kv0 + 16 * h, row_lo, seq, window); };

  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;   // rows g, g + 8; log2 units
  float acc[DP / 16][4];                           // O l, columns wh DP/2 ..
#pragma unroll
  for (int i = 0; i < DP / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int t = 0; t < n; ++t) {
    cp_async_wait_group<0>();
    __syncthreads();                               // tile t landed; tile t - 1 is read
    if (t + 1 < n) {
      float* nx = stage(t + 1);
      const int kn = t0 + (t + 1) * kFKeys;
      load_tile<DP, kFKeys>(nx, kb, st.k[2], kn, seq, dim, vec, tid);
      load_tile<DP, kFKeys>(nx + kFKeys * DP, vb, st.v[2], kn, seq, dim, vec, tid);
      cp_async_commit();
    }
    const int kv0 = t0 + t * kFKeys;
    const bool skip0 = skip_half(kv0, 0), skip1 = skip_half(kv0, 1);
    if (skip0 && skip1) continue;                  // the pair's rows meet no key of the tile
    const float* ks = stage(t);
    const float* vs = ks + kFKeys * DP;

    // S = Q K^T for the warp's 16 keys, in log2 units, masked to -1e30
    float s[2][4];
    float mx0 = kNegInf, mx1 = kNegInf;
    if (wh ? skip1 : skip0) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = kNegInf;
    } else {
      product16<DP>(s, qs, r0, ks, 16 * wh, fc);
      const bool edge = edge_half(kv0, wh);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * scale_log2;
          if (edge && !in_band(e < 2 ? qrow0 : qrow1, kv0 + 16 * wh + 8 * nt + 2 * ql + (e & 1),
                               seq, window))
            x = kNegInf;
          s[nt][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
    }
    // the running max over both halves: the pair's warps take the same bits
    if (ql == 0) {
      mxs[warp * 16 + gl] = mx0;
      mxs[warp * 16 + gl + 8] = mx1;
    }
    bar_sync(1 + wr, 64);
    const float* pm = mxs + (warp ^ 4) * 16;
    const float mn0 = fmaxf(m0, fmaxf(mx0, pm[gl])), mn1 = fmaxf(m1, fmaxf(mx1, pm[gl + 8]));
    const float alpha0 = fast_exp2(m0 - mn0), alpha1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // P = 2^(S - m) on the band: the A fragments of the tile's k-steps
    // 2 wh and 2 wh + 1, handed to warp ^ 4 too
    float sum0 = 0.f, sum1 = 0.f;
    Frag own[2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv = s[nt][e];
        x[e] = sv == kNegInf ? 0.f : fast_exp2(sv - (e < 2 ? mn0 : mn1));
        if (e < 2) sum0 += x[e]; else sum1 += x[e];
      }
      acc_to_a(x, own[nt]);
      xch_put(xch + warp * kXch, nt, lane, own[nt]);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int i = 0; i < DP / 16; ++i) {
      acc[i][0] *= alpha0;
      acc[i][1] *= alpha0;
      acc[i][2] *= alpha1;
      acc[i][3] *= alpha1;
    }
    bar_sync(1 + wr, 64);
    // O += P V, the warp's half of D, over each half of the tile's keys
    // (16, two k-steps of 8) in a chunk of its own
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h ? skip1 : skip0) continue;
      Frag fa[2];
      if (h == wh) {
        fa[0] = own[0];
        fa[1] = own[1];
      } else {
        xch_get(xch + (warp ^ 4) * kXch, 0, lane, fa[0]);
        xch_get(xch + (warp ^ 4) * kXch, 1, lane, fa[1]);
      }
      add_product16<DP>(acc, fa, vs, 16 * h, wh * (DP / 2), fc, ql);
    }
  }

  // l over both halves of the keys: the pair's partial sums share m, and
  // both warps add them in an order that gives the same bits
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (ql == 0) {                                   // the pair has read the maxima
    mxs[warp * 16 + gl] = l0;
    mxs[warp * 16 + gl + 8] = l1;
  }
  bar_sync(1 + wr, 64);
  const float* pl = mxs + (warp ^ 4) * 16;
  const float den0 = fmaxf(l0 + pl[gl], 1e-30f), den1 = fmaxf(l1 + pl[gl + 8], 1e-30f);
#pragma unroll
  for (int nt = 0; nt < DP / 16; ++nt) {
    const int d = wh * (DP / 2) + nt * 8 + 2 * ql;
    if (d >= dim) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = h ? qrow1 : qrow0;
      if (qpos >= seq) continue;
      const float den = h ? den1 : den0;
      const float y0 = acc[nt][2 * h] / den, y1 = acc[nt][2 * h + 1] / den;
      float* dst = ob + qpos * st.o[2] + d;
      if (vec) {
        *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
      } else {
        dst[0] = y0;
        if (d + 1 < dim) dst[1] = y1;
      }
    }
  }
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       const Strides& st, int64_t batch, int hq, int hkv,
                       int seq, int dim, int window, float scale, int vec,
                       size_t smem, cudaStream_t stream) {
  if (smem != f32_smem<DP>()) return cudaErrorInvalidValue;
  const int q_tiles = (seq + kFRows - 1) / kFRows;
  const int64_t blocks = batch * hq * (int64_t)q_tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)swa_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  swa_f32_kernel<DP><<<(unsigned)blocks, kFThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, st, hkv,
      hq / hkv, seq, dim, window, scale * kLog2e, q_tiles, vec);
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

// dtype: 0 = float32 (mma.sync in 3xTF32), 1 = bfloat16 (wgmma).  q, o:
// (batch, hq, seq, dim); k, v: (batch, hkv, seq, dim); all of that type on
// the device, unit stride along dim; strides: 12 int64, the (batch, head,
// position) element strides of q, k, v and o in that order.  hq % hkv == 0,
// 1 <= dim <= 256, window >= 1.  vec: dim a multiple of 16 bytes (8 bf16, 4
// f32) and every pointer and row 16-byte aligned.  smem: dynamic shared
// memory, as kernels/swa/kernel.py:smem_bytes gives it (f32: refused unless
// it is the kernel's layout).  Returns cudaGetLastError().
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
    if (dim <= 64) return launch_f32<64>(q, k, v, o, st, batch, hq, hkv, seq, dim, window, scale, vec, smem, s);
    if (dim <= 128) return launch_f32<128>(q, k, v, o, st, batch, hq, hkv, seq, dim, window, scale, vec, smem, s);
    return launch_f32<256>(q, k, v, o, st, batch, hq, hkv, seq, dim, window, scale, vec, smem, s);
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
