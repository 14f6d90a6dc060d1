// Backward of causal sliding-window attention with GQA, for sm_90a (H100):
// FlashAttention-2's backward in two launches and a fold, on the tensor
// cores in both types.
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
// more: eight products.  In f32 each product is three TF32 ones (3xTF32,
// below): 0.977 ms for the five at the TF32 peak, against 2.40 for them in
// f32 FMAs on the CUDA cores.
//
// Both types share the shape of the work:
// - swa_bwd_dq: one block per (b, hq, query tile).  Pass 1 walks the band's
//   key tiles for each row's max and sum (the LSE), pass 2 walks them again
//   for S, dP = dO V^T, P, dS = P (dP - D) in f32 registers and dQ += dS K.
//   Q and dO stay in shared memory; D = rowsum(dO * O) comes from device
//   memory in the prologue; LSE and D go to device memory in f32.
// - swa_bwd_dkdv: keys are the rows.  One block per (b, hkv, 64-key tile,
//   part of the group's query heads); its K and V tiles stay in shared
//   memory and a two-stage ring brings the query tiles of the heads of its
//   part with their LSE and D.  Two groups of four warps: group 0 computes
//   S^T = K Q^T, P^T and dV += P^T dO, group 1 dP^T = V dO^T, dS^T = P^T
//   (dP^T - D) and dK += dS^T Q, P^T handed across in shared memory (f32,
//   each thread's own fragment) under named barrier 1: four products, and
//   one 64 x Dp f32 accumulator a group, as two would not fit a thread's
//   registers at Dp = 256.  The group's query heads are split into `parts`
//   (a rule on the shapes alone: as many as keep the blocks within the
//   H100's 132 SMs), because one KV head at S = 4096 has only 64 key tiles;
//   each part writes its f32 partial dK and dV.
// - swa_bwd_fold: sums the parts in a fixed order and casts to the type.
// Only the tiles that meet the band are visited and only those on its edge
// or at seq's end are masked.  Every sum runs in a fixed order, with no
// atomics: the same inputs give the same bits.
//
// bfloat16 (wgmma, helpers shared with the forward in wgmma.cuh; tiles in
// the 128-byte swizzle, D zero-filled to Dp = 64, 128 or 256, loaded by
// cp.async, or element by element where an operand is not 16-byte aligned):
// swa_bwd_dq_wgmma_kernel runs two warpgroups on 128 query rows, 64 each:
// K tiles of 64 keys come through a two-stage ring, V through one buffer
// refilled as soon as dP has read it; S and dP are SS m64n64k16 products,
// dS is rounded to bf16 in registers (the accumulator layout is the
// A-operand layout) and dQ += dS K is RS m64nDpk16, K read MN-major, dQ
// (128 registers a thread at Dp = 256) in registers.
// swa_bwd_dkdv_wgmma_kernel's groups are its two warpgroups, on 64-query
// tiles, P^T and dS^T rounded to bf16 in registers, Q and dO read MN-major.
//
// float32 (mma.sync m16n8k8 in 3xTF32, mma_tf32 in common.cuh, as K2's,
// the fragment helpers shared with the f32 forward in tf32.cuh:
// each f32 operand split as hi + lo, hi TF32, and a product summing lo*hi,
// hi*lo and hi*hi in f32, which keeps the 1e-5 bar that one TF32 product
// misses; long sums in chunks, as the tensor cores truncate, mma3_apart).
// Not wgmma: its TF32 form reads shared-memory operands K-major only, where
// dQ = dS K, dV = P^T dO and dK = dS^T Q read K, dO and Q down their
// columns.  mma.sync's fragments are loaded by hand,
// so one tile serves both orientations:
// - tiles are f32 in shared memory, D zero-filled to Dp = 64, 128 or 256,
//   with no padding; within each 32-column chunk row r's columns are XORed
//   with 8 ((r >> 1) & 3) + 4 (r & 1) (swz), which puts both fragment
//   reads on 32 banks;
// - an accumulator is the A operand of the next product without a
//   shuffle: its columns (2q, 2q + 1) of an n-tile become depth slots
//   (q, q + 4), and the B operand reads its rows in the same permuted order
//   (rows k0 + 2q, k0 + 2q + 1), which leaves the sum unchanged;
// - operands are split into hi and lo as they are read (split), the
//   A operands and the B operands read along their rows by ldmatrix;
// - swa_bwd_dkdv splits the group's (head, query tile) steps into more
//   parts than bf16 (kernel.py:bwd_parts, 6 at the model's shape): its key
//   tiles' bands differ in length, and more, shorter blocks even out the
//   SMs' shares.
// swa_bwd_dq_f32_kernel: one block of 8 warps per (b, hq, 64-query tile) on
// 32-key tiles.  Warps w and w + 4 share rows 16 (w % 4)..+15: each
// computes S and dP for its 16 keys of the tile, hands its dS fragments to
// the other through shared memory (named barrier 1 + w % 4) and adds dS K
// over the tile's 32 keys into its half of dQ's columns (64 registers a
// thread at Dp = 256).  The LSE's (max, sum) of the two halves are merged
// after pass 1.  K and V have a buffer each: pass 2 computes dP first, so V
// is refilled while S and dQ run and K while the next dP runs; pass 1 uses
// both buffers as a ring of K tiles.
// swa_bwd_dkdv_f32_kernel: the groups are warps 0-3 and 4-7, 16 keys a
// warp, on 16-query tiles (a 32-query stage would not fit twice at
// Dp = 256).
//
// Shared memory (kernels/swa/kernel.py:bwd_smem_bytes, checked here at the
// launch): bf16 dq 2 * Dp * (2*128 + 3*64) + 4*128 + 1024 bytes (230,912 B
// at Dp = 256), dkdv 2 * Dp * 6*64 + 4*4*64 + 4*64*64 + 1024 (215,040 B);
// f32 dq 4 * Dp * (2*64 + 2*32) + 4 * (8*512 + 64 + 8*16*2) (214,272 B),
// dkdv 4 * Dp * (2*64 + 2*2*16) + 4 * (2*2*16 + 4*8*32) (200,960 B).  All
// past 48 KB, so the launches opt in with cudaFuncSetAttribute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "tf32.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// element strides along (batch, head, position) of q, k, v, o, dO, dq, dk, dv
struct Strides {
  int64_t q[3], k[3], v[3], o[3], g[3], dq[3], dk[3], dv[3];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// ---------------------------------------------------------------------------
// float32: 3xTF32 products (mma.sync m16n8k8) on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kFRows = 64;               // dq: query rows a block, 16 a warp pair
constexpr int kFKeys = 32;               // dq: keys a tile, 16 a warp
constexpr int kFQT = 16;                 // dkdv: queries a tile (keys a block: kTile)

template <int DP>
constexpr size_t f32_dq_smem() {
  return 4 * (size_t)DP * (2 * kFRows + 2 * kFKeys) + 4 * (8 * kXch + kFRows + 8 * 16 * 2);
}
template <int DP>
constexpr size_t f32_dkdv_smem() {
  return 4 * (size_t)DP * (2 * kTile + 4 * kFQT) + 4 * (4 * kFQT + 4 * 8 * 32);
}

template <int DP>
__global__ void __launch_bounds__(kFThreads, 1)
swa_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ o,
                      const float* __restrict__ g, float* __restrict__ dq,
                      float* __restrict__ lse, float* __restrict__ delta,
                      Strides st, int hkv_n, int group, int seq, int dim,
                      int window, float scale, int q_tiles, int vec) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);                // kFRows x DP
  float* gs = qs + kFRows * DP;                               // dO, kFRows x DP
  float* kv = gs + kFRows * DP;                               // 2 key tiles, kFKeys x DP
  uint32_t* xch = reinterpret_cast<uint32_t*>(kv + 2 * kFKeys * DP);   // 8 x kXch
  float* dsm = reinterpret_cast<float*>(xch + 8 * kXch);     // kFRows: D
  float* mls = dsm + kFRows;                                  // 8 warps x 16 rows x (max, sum)
  auto buf = [&](int i) { return kv + i * kFKeys * DP; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gl = lane >> 2, ql = lane & 3;
  const int wr = warp & 3, wh = warp >> 2;   // rows 16 wr..; keys 16 wh.. of a tile
  const int gi = (int)(blockIdx.x % group);
  const int rest = (int)(blockIdx.x / group);
  const int qt = q_tiles - 1 - rest % q_tiles;     // longest bands first
  const int bkv = rest / q_tiles;
  const int hk = bkv % hkv_n, b = bkv / hkv_n;
  const int hq = hk * group + gi;
  const int64_t bh = (int64_t)b * hkv_n * group + hq;
  const float* qb = q + b * st.q[0] + hq * st.q[1];
  const float* kb = k + b * st.k[0] + hk * st.k[1];
  const float* vb = v + b * st.v[0] + hk * st.v[1];
  const float* ob = o + b * st.o[0] + hq * st.o[1];
  const float* gb = g + b * st.g[0] + hq * st.g[1];
  float* dqb = dq + b * st.dq[0] + hq * st.dq[1];

  const int q0 = qt * kFRows;
  const int kv_lo = max(0, q0 - window + 1);
  const int kv_hi = min(seq, q0 + kFRows);         // exclusive
  const int t0 = kv_lo / kFKeys * kFKeys;
  const int n = (kv_hi - t0 + kFKeys - 1) / kFKeys;   // key tiles; a pass each

  load_tile<DP, kFRows>(qs, qb, st.q[2], q0, seq, dim, vec, tid);
  load_tile<DP, kFRows>(gs, gb, st.g[2], q0, seq, dim, vec, tid);
  load_tile<DP, kFKeys>(buf(0), kb, st.k[2], t0, seq, dim, vec, tid);
  cp_async_commit();

  // D = rowsum(dO * O), a warp a row, from device memory
  for (int r = warp; r < kFRows; r += kFThreads / 32) {
    const int pos = q0 + r;
    float s = 0.f;
    if (pos < seq)
      for (int d = lane; d < dim; d += 32) s = fmaf(gb[pos * st.g[2] + d], ob[pos * st.o[2] + d], s);
    s = warp_sum(s);
    if (lane == 0) {
      dsm[r] = s;
      if (pos < seq) delta[bh * seq + pos] = s;
    }
  }

  const FragCols fc(lane);
  const int r0 = 16 * wr;                          // the warp's first row in the block
  const int qrow0 = q0 + r0 + gl, qrow1 = qrow0 + 8;
  const int row_lo = q0 + r0;
  const float scale_log2 = scale * kLog2e;
  auto skip_half = [&](int kv0, int h) { return keys16_skip(kv0 + 16 * h, row_lo, seq, window); };
  auto edge_half = [&](int kv0, int h) { return keys16_edge(kv0 + 16 * h, row_lo, seq, window); };
  // s = the warp's 16 rows of `a` times its 16 key rows of `bt`, over D
  // in 32-column chunks (mma3_apart)
  auto product = [&](float (&s)[2][4], const float* a, const float* bt) {
    product16<DP>(s, a, r0, bt, 16 * wh, fc);
  };

  // pass 1: running max and sum (log2 units) of each row over the warp's
  // keys; both buffers are a ring of K tiles, and the last step brings V(0)
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  for (int u = 0; u < n; ++u) {
    cp_async_wait_group<0>();
    __syncthreads();                               // K(u) landed; the other buffer is free
    const bool more = u + 1 < n;
    load_tile<DP, kFKeys>(buf((u + 1) & 1), more ? kb : vb, more ? st.k[2] : st.v[2],
                          more ? t0 + (u + 1) * kFKeys : t0, seq, dim, vec, tid);
    cp_async_commit();
    const int kv0 = t0 + u * kFKeys;
    if (skip_half(kv0, wh)) continue;
    float s[2][4];
    product(s, qs, buf(u & 1));
    const bool edge = edge_half(kv0, wh);
    float mx0 = m0, mx1 = m1;
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
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[nt][e];
        const float p = x == kNegInf ? 0.f : fast_exp2(x - (e < 2 ? mx0 : mx1));
        if (e < 2) sum0 += p; else sum1 += p;
      }
    l0 = l0 * fast_exp2(m0 - mx0) + sum0;
    l1 = l1 * fast_exp2(m1 - mx1) + sum1;
    m0 = mx0;
    m1 = mx1;
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (ql == 0) {
    float* ml = mls + (warp * 16 + gl) * 2;
    ml[0] = m0;
    ml[1] = l0;
    ml[16] = m1;
    ml[17] = l1;
  }
  __syncthreads();                                 // the last K tile is read; (max, sum) written
  float* const kbuf = buf((n - 1) & 1);
  float* const vbuf = buf(n & 1);                  // V(0) is on its way there
  load_tile<DP, kFKeys>(kbuf, kb, st.k[2], t0, seq, dim, vec, tid);
  cp_async_commit();
  // each row's LSE over both halves of the keys (log2 units), and its D
  float lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float* a = mls + (warp * 16 + gl + 8 * i) * 2;
    const float* c = mls + ((warp ^ 4) * 16 + gl + 8 * i) * 2;
    const float m = fmaxf(a[0], c[0]);
    const float l = a[1] * fast_exp2(a[0] - m) + c[1] * fast_exp2(c[0] - m);
    lse2[i] = l > 0.f ? m + log2f(l) : 0.f;
  }
  if (wh == 0 && ql == 0) {
    if (qrow0 < seq) lse[bh * seq + qrow0] = lse2[0] * kLn2;
    if (qrow1 < seq) lse[bh * seq + qrow1] = lse2[1] * kLn2;
  }
  const float dl[2] = {dsm[r0 + gl], dsm[r0 + gl + 8]};

  // pass 2: dP = dO V^T first, so V refills while S and dQ run, and K
  // while the next dP runs
  float acc[DP / 16][4];                           // dQ / scale, columns wh DP/2 ..
#pragma unroll
  for (int i = 0; i < DP / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  cp_async_wait_group<1>();
  __syncthreads();                                 // V(0) landed
  for (int t = 0; t < n; ++t) {
    const int kv0 = t0 + t * kFKeys;
    const bool skip0 = skip_half(kv0, 0), skip1 = skip_half(kv0, 1);
    const bool skip = wh ? skip1 : skip0;
    float dp[2][4], s[2][4];
    if (!skip) product(dp, gs, vbuf);
    cp_async_wait_group<0>();
    __syncthreads();                               // K(t) landed; V(t) is read
    if (t + 1 < n) {
      load_tile<DP, kFKeys>(vbuf, vb, st.v[2], kv0 + kFKeys, seq, dim, vec, tid);
      cp_async_commit();
    }
    if (!skip) product(s, qs, kbuf);
    // dS = P (dP - D), P = 2^(S scale log2e - LSE) on the band: the A
    // fragments of dQ's k-steps 2 wh and 2 wh + 1, handed to warp ^ 4 too
    const bool edge = edge_half(kv0, wh);
    Frag own[2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const bool ok = !skip && (!edge || in_band(h ? qrow1 : qrow0,
                                                   kv0 + 16 * wh + 8 * nt + 2 * ql + (e & 1),
                                                   seq, window));
        x[e] = ok ? fast_exp2(s[nt][e] * scale_log2 - lse2[h]) * (dp[nt][e] - dl[h]) : 0.f;
      }
      acc_to_a(x, own[nt]);
      xch_put(xch + warp * kXch, nt, lane, own[nt]);
    }
    bar_sync(1 + wr, 64);
    // dQ += dS K, the warp's half of D, over each half of the tile's keys
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
      add_product16<DP>(acc, fa, kbuf, 16 * h, wh * (DP / 2), fc, ql);
    }
    if (t + 1 < n) cp_async_wait_group<0>();
    __syncthreads();                               // K(t) and the fragments are read; V(t+1) landed
    if (t + 1 < n) {
      load_tile<DP, kFKeys>(kbuf, kb, st.k[2], kv0 + kFKeys, seq, dim, vec, tid);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int nt = 0; nt < DP / 16; ++nt) {
    const int d = wh * (DP / 2) + nt * 8 + 2 * ql;
    if (d >= dim) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = h ? qrow1 : qrow0;
      if (qpos >= seq) continue;
      const float y0 = acc[nt][2 * h] * scale, y1 = acc[nt][2 * h + 1] * scale;
      float* dst = dqb + qpos * st.dq[2] + d;
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
__global__ void __launch_bounds__(kFThreads, 1)
swa_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ g,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ part, Strides st, int hkv_n, int group,
                        int seq, int dim, int window, float scale, int k_tiles,
                        int parts, int vec) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // kTile x DP
  float* vs = ks + kTile * DP;                    // kTile x DP
  float* ring = vs + kTile * DP;                  // 2 x (Q, dO), kFQT x DP each
  float* lsm = ring + 4 * kFQT * DP;              // 2 x kFQT: LSE
  float* dsm = lsm + 2 * kFQT;                    // 2 x kFQT: D
  float* psm = dsm + 2 * kFQT;                    // 4 warps x 8 x 32: P^T fragments

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gl = lane >> 2, ql = lane & 3;
  const int grp = warp >> 2;                      // 0: S^T, P^T, dV; 1: dP^T, dS^T, dK
  const int pi = (int)(blockIdx.x % parts);
  const int rest = (int)(blockIdx.x / parts);
  const int kt = rest % k_tiles;                  // longest bands first
  const int bkv = rest / k_tiles;
  const int hk = bkv % hkv_n, b = bkv / hkv_n;
  const int k0 = kt * kTile;
  // queries whose band reaches keys [k0, k0 + kTile): [k0, k0 + kTile - 1 + window)
  const int q_hi = min(seq, k0 + kTile - 1 + window);
  const int nq = (q_hi - k0 + kFQT - 1) / kFQT;
  // the part's share of the group's (head, query tile) steps, in order
  const int u_lo = (int)((int64_t)pi * group * nq / parts);
  const int n = (int)((int64_t)(pi + 1) * group * nq / parts) - u_lo;

  auto load_stage = [&](int u) {
    const int hq = hk * group + (u_lo + u) / nq;
    const int q0 = k0 + (u_lo + u) % nq * kFQT;
    const int64_t bhq = (int64_t)b * hkv_n * group + hq;
    float* dst = ring + (u & 1) * 2 * kFQT * DP;
    load_tile<DP, kFQT>(dst, q + b * st.q[0] + hq * st.q[1], st.q[2], q0, seq, dim, vec, tid);
    load_tile<DP, kFQT>(dst + kFQT * DP, g + b * st.g[0] + hq * st.g[1], st.g[2], q0, seq,
                        dim, vec, tid);
    if (tid < 2 * kFQT) {
      const int i = tid & (kFQT - 1);
      const float* src = tid < kFQT ? lse : delta;
      float* sm = (tid < kFQT ? lsm : dsm) + (u & 1) * kFQT + i;
      const bool in = q0 + i < seq;
      cp_async4(smem_addr(sm), in ? src + bhq * seq + q0 + i : src, in ? 4 : 0);
    }
  };
  load_tile<DP, kTile>(ks, k + b * st.k[0] + hk * st.k[1], st.k[2], k0, seq, dim, vec, tid);
  load_tile<DP, kTile>(vs, v + b * st.v[0] + hk * st.v[1], st.v[2], k0, seq, dim, vec, tid);
  load_stage(0);
  cp_async_commit();

  const FragCols fc(lane);
  const int r0 = 16 * (warp & 3);                 // the warp's first key in the block
  const int krow0 = k0 + r0 + gl, krow1 = krow0 + 8;
  const int key_lo = k0 + r0;
  const float scale_log2 = scale * kLog2e;
  const float* at = grp == 0 ? ks : vs;           // S^T's or dP^T's left operand
  float* pw = psm + (warp & 3) * 256 + lane;      // P^T of the warp's keys
  float acc[DP / 8][4];                           // group 0: dV; 1: dK / scale
#pragma unroll
  for (int i = 0; i < DP / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int u = 0; u < n; ++u) {
    cp_async_wait_group<0>();
    __syncthreads();                              // stage u landed; stage u+1 and psm free
    if (u + 1 < n) {
      load_stage(u + 1);
      cp_async_commit();
    }
    const int q0 = k0 + (u_lo + u) % nq * kFQT;
    const float* qs = ring + (u & 1) * 2 * kFQT * DP;
    const float* gs = qs + kFQT * DP;
    const float* lsu = lsm + (u & 1) * kFQT;
    const float* dsu = dsm + (u & 1) * kFQT;
    // the warp's 16 keys against the tile's 16 queries: none in the band
    // (skip), or some pair outside it (edge)
    const bool skip = key_lo > q0 + kFQT - 1 || key_lo + 15 <= q0 - window || q0 >= seq;
    const bool edge = !(key_lo + 15 <= q0 && key_lo > q0 + kFQT - 1 - window
                        && q0 + kFQT <= seq);

    // S^T = K Q^T (group 0) or dP^T = V dO^T (group 1), over D in
    // 32-column chunks (mma3_apart)
    float s[2][4] = {};
    if (!skip) product16<DP>(s, at, r0, grp == 0 ? qs : gs, 0, fc);
    if (grp == 0) {
      // P^T = 2^(S^T scale log2e - LSE_col) on the band, handed to group 1
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * nt + 2 * ql + (e & 1);
          const bool ok = !skip && (!edge || in_band(q0 + col, e < 2 ? krow0 : krow1, seq,
                                                     window));
          const float p = ok ? fast_exp2(s[nt][e] * scale_log2 - lsu[col] * kLog2e) : 0.f;
          s[nt][e] = p;
          pw[(4 * nt + e) * 32] = p;
        }
      bar_arrive(1, 256);
    } else {
      bar_sync(1, 256);
      // dS^T = P^T (dP^T - D_col)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * nt + 2 * ql + (e & 1);
          s[nt][e] = pw[(4 * nt + e) * 32] * (s[nt][e] - dsu[col]);
        }
    }
    if (skip) continue;
    // dV += P^T dO (group 0), dK += dS^T Q (group 1), over the tile's 16
    // queries in a chunk of their own
    const float* bt = grp == 0 ? gs : qs;
    Frag fa[2];
    acc_to_a(s[0], fa[0]);
    acc_to_a(s[1], fa[1]);
    add_product16<DP>(acc, fa, bt, 0, 0, fc, ql);
  }

  // this part's f32 partial: plane 0 dK, plane 1 dV, each (B, Hkv, S, dim)
  const int64_t plane = (int64_t)(gridDim.x / (parts * k_tiles)) * seq * dim;
  const float mul = grp == 0 ? 1.f : scale;
  float* dst = part + ((int64_t)(grp == 0 ? 1 : 0) * parts + pi) * plane
               + (int64_t)bkv * seq * dim;
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt) {
    const int d = nt * 8 + 2 * ql;
    if (d >= dim) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kpos = h ? krow1 : krow0;
      if (kpos >= seq) continue;
      const float y0 = acc[nt][2 * h] * mul, y1 = acc[nt][2 * h + 1] * mul;
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

// dk, dv = T(sum over the parts, in order, of the f32 partials); a block a
// row of (B, Hkv, S) at a time, threads along D
template <typename T>
__global__ void __launch_bounds__(256)
swa_bwd_fold_kernel(const float* __restrict__ part, T* __restrict__ dk,
                    T* __restrict__ dv, Strides st, int parts, int hkv_n,
                    int seq, int dim, int64_t rows) {
  const int64_t plane = rows * dim;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const int pos = (int)(row % seq);
    const int64_t bh = row / seq;
    const int h = (int)(bh % hkv_n);
    const int64_t b = bh / hkv_n;
    const float* src = part + row * dim;
    T* dkr = dk + b * st.dk[0] + h * st.dk[1] + pos * st.dk[2];
    T* dvr = dv + b * st.dv[0] + h * st.dv[1] + pos * st.dv[2];
    for (int d = threadIdx.x; d < dim; d += blockDim.x) {
      float a = src[d], c = src[parts * plane + d];
      for (int p = 1; p < parts; ++p) {
        a += src[p * plane + d];
        c += src[(parts + p) * plane + d];
      }
      dkr[d] = from_f32<T>(a);
      dvr[d] = from_f32<T>(c);
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *g;
  void* dq;
  float *lse, *delta, *part;
  Strides st;
  int64_t batch;
  int hq, hkv, seq, dim, window, parts;
  float scale;
  size_t smem;
};

// 16-byte cp.async and paired stores: D a multiple of 16 bytes, every row
// and pointer 16-byte aligned (dq: q, k, v, dO, o, dq; dkdv: q, k, v, dO
// and the partial sums, contiguous)
bool vec_ok(const Args& a, bool dkdv, int itemsize) {
  const int per16 = 16 / itemsize;
  if (a.dim % per16) return false;
  const void* ptrs[6] = {a.q, a.k, a.v, a.g, a.o, a.dq};
  const int64_t* st[6] = {a.st.q, a.st.k, a.st.v, a.st.g, a.st.o, a.st.dq};
  if (dkdv) ptrs[4] = a.part;
  for (int t = 0; t < (dkdv ? 5 : 6); ++t)
    if ((uintptr_t)ptrs[t] % 16) return false;
  for (int t = 0; t < (dkdv ? 4 : 6); ++t)
    for (int i = 0; i < 3; ++i)
      if (st[t][i] % per16) return false;
  return true;
}

template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  return cudaFuncSetAttribute((const void*)kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DP>
cudaError_t launch_dq_wgmma(const Args& a, cudaStream_t stream) {
  if (a.smem != dq_smem<DP>()) return cudaErrorInvalidValue;
  const int q_tiles = (a.seq + kDqRows - 1) / kDqRows;
  const int64_t blocks = a.batch * a.hq * (int64_t)q_tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  cudaError_t e = opt_in(swa_bwd_dq_wgmma_kernel<DP>, a.smem);
  if (e != cudaSuccess) return e;
  swa_bwd_dq_wgmma_kernel<DP><<<(unsigned)blocks, kWgThreads, a.smem, stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (const bf16*)a.o,
      (const bf16*)a.g, (bf16*)a.dq, a.lse, a.delta, a.st, a.hkv, a.hq / a.hkv,
      a.seq, a.dim, a.window, a.scale, q_tiles, (int)vec_ok(a, false, 2));
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq_f32(const Args& a, cudaStream_t stream) {
  if (a.smem != f32_dq_smem<DP>()) return cudaErrorInvalidValue;
  const int q_tiles = (a.seq + kFRows - 1) / kFRows;
  const int64_t blocks = a.batch * a.hq * (int64_t)q_tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  cudaError_t e = opt_in(swa_bwd_dq_f32_kernel<DP>, a.smem);
  if (e != cudaSuccess) return e;
  swa_bwd_dq_f32_kernel<DP><<<(unsigned)blocks, kFThreads, a.smem, stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (const float*)a.o,
      (const float*)a.g, (float*)a.dq, a.lse, a.delta, a.st, a.hkv, a.hq / a.hkv,
      a.seq, a.dim, a.window, a.scale, q_tiles, (int)vec_ok(a, false, 4));
  return cudaGetLastError();
}

// blocks of both dkdv kernels: (b, hkv, 64-key tile, part), parts fastest
bool dkdv_grid(const Args& a, int& k_tiles, int64_t& blocks) {
  const int group = a.hq / a.hkv;
  if (a.parts < 1 || a.parts > group || !a.part) return false;
  k_tiles = (a.seq + kTile - 1) / kTile;
  blocks = a.batch * a.hkv * (int64_t)k_tiles * a.parts;
  return blocks <= INT32_MAX;
}

template <int DP>
cudaError_t launch_dkdv_wgmma(const Args& a, cudaStream_t stream) {
  int k_tiles;
  int64_t blocks;
  if (a.smem != dkdv_smem<DP>() || !dkdv_grid(a, k_tiles, blocks)) return cudaErrorInvalidValue;
  cudaError_t e = opt_in(swa_bwd_dkdv_wgmma_kernel<DP>, a.smem);
  if (e != cudaSuccess) return e;
  swa_bwd_dkdv_wgmma_kernel<DP><<<(unsigned)blocks, kWgThreads, a.smem, stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (const bf16*)a.g,
      a.lse, a.delta, a.part, a.st, a.hkv, a.hq / a.hkv, a.seq, a.dim, a.window,
      a.scale, k_tiles, a.parts, (int)vec_ok(a, true, 2));
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkdv_f32(const Args& a, cudaStream_t stream) {
  int k_tiles;
  int64_t blocks;
  if (a.smem != f32_dkdv_smem<DP>() || !dkdv_grid(a, k_tiles, blocks))
    return cudaErrorInvalidValue;
  cudaError_t e = opt_in(swa_bwd_dkdv_f32_kernel<DP>, a.smem);
  if (e != cudaSuccess) return e;
  swa_bwd_dkdv_f32_kernel<DP><<<(unsigned)blocks, kFThreads, a.smem, stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (const float*)a.g,
      a.lse, a.delta, a.part, a.st, a.hkv, a.hq / a.hkv, a.seq, a.dim, a.window,
      a.scale, k_tiles, a.parts, (int)vec_ok(a, true, 4));
  return cudaGetLastError();
}

template <int DP>
cudaError_t dispatch_dp(const Args& a, int dtype, bool dkdv, cudaStream_t s) {
  if (dtype == 0) return dkdv ? launch_dkdv_f32<DP>(a, s) : launch_dq_f32<DP>(a, s);
  return dkdv ? launch_dkdv_wgmma<DP>(a, s) : launch_dq_wgmma<DP>(a, s);
}

int launch(Args a, int dtype, const int64_t* strides, bool dkdv, void* stream) {
  if (a.hkv < 1 || a.hq % a.hkv != 0 || a.window < 1 || a.dim < 1
      || a.dim > 256 || a.seq < 1 || a.batch < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  int64_t* dst[8] = {a.st.q, a.st.k, a.st.v, a.st.o, a.st.g, a.st.dq,
                     a.st.dk, a.st.dv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  cudaStream_t s = (cudaStream_t)stream;
  // D zero-filled to Dp = 64, 128 or 256
  if (a.dim <= 64) return (int)dispatch_dp<64>(a, dtype, dkdv, s);
  if (a.dim <= 128) return (int)dispatch_dp<128>(a, dtype, dkdv, s);
  return (int)dispatch_dp<256>(a, dtype, dkdv, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (mma.sync in 3xTF32), 1 = bfloat16 (wgmma).  q, o,
// dO (g), dq: (batch, hq, seq, dim); k, v: (batch, hkv, seq, dim); all of
// that type on the device, unit stride along dim; strides: 24 int64, the
// (batch, head, position) element strides of q, k, v, o, g, dq, dk, dv in
// that order (dk's and dv's are not read here).  lse, delta: (batch, hq,
// seq) float32, contiguous: swa_bwd_dq writes them, swa_bwd_dkdv reads
// them, so dq launches first on the same stream.  hq % hkv == 0, 1 <= dim
// <= 256, window >= 1.  smem: dynamic shared memory, as
// kernels/swa/kernel.py:bwd_smem_bytes gives it for each (refused unless
// it is the kernel's layout).  Returns cudaGetLastError().
int swa_bwd_dq_launch(const void* q, const void* k, const void* v,
                      const void* o, const void* g, void* dq, float* lse,
                      float* delta, int dtype, const int64_t* strides,
                      int64_t batch, int hq, int hkv, int seq, int dim,
                      int window, float scale, size_t smem, void* stream) {
  Args a{q, k, v, o, g, dq, lse, delta, nullptr, {}, batch,
         hq, hkv, seq, dim, window, 1, scale, smem};
  return launch(a, dtype, strides, false, stream);
}

// Writes each part's f32 partial sums into `partial`, (2, parts, batch,
// hkv, seq, dim) contiguous (dK, then dV), 1 <= parts <= hq / hkv, and
// leaves dk and dv to swa_bwd_fold.
int swa_bwd_dkdv_launch(const void* q, const void* k, const void* v,
                        const void* g, const float* lse, const float* delta,
                        int dtype, const int64_t* strides, int64_t batch,
                        int hq, int hkv, int seq, int dim, int window,
                        float scale, float* partial, int parts, size_t smem,
                        void* stream) {
  Args a{q, k, v, nullptr, g, nullptr, (float*)lse, (float*)delta, partial, {},
         batch, hq, hkv, seq, dim, window, parts, scale, smem};
  return launch(a, dtype, strides, true, stream);
}

// dk, dv (dtype as above, through their (batch, head, position) strides, 6
// int64) = the sum over the parts, in order, of swa_bwd_dkdv's partials.
int swa_bwd_fold_launch(const float* partial, void* dk, void* dv, int dtype,
                        const int64_t* strides, int64_t batch, int hkv,
                        int seq, int dim, int parts, void* stream) {
  if (batch < 1 || hkv < 1 || seq < 1 || dim < 1 || parts < 1
      || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Strides st{};
  for (int i = 0; i < 3; ++i) {
    st.dk[i] = strides[i];
    st.dv[i] = strides[3 + i];
  }
  const int64_t rows = batch * hkv * (int64_t)seq;
  const unsigned blocks = (unsigned)std::min<int64_t>(rows, 132 * 8);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    swa_bwd_fold_kernel<float><<<blocks, 256, 0, s>>>(
        partial, (float*)dk, (float*)dv, st, parts, hkv, seq, dim, rows);
  else
    swa_bwd_fold_kernel<bf16><<<blocks, 256, 0, s>>>(
        partial, (bf16*)dk, (bf16*)dv, st, parts, hkv, seq, dim, rows);
  return (int)cudaGetLastError();
}

const char* swa_bwd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
