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
// style with Hopper's warpgroup products.  One block of two warpgroups per
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
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// 2^x, x <= 0 here (scores minus their running max)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&p);
}

constexpr int kWgThreads = 256;       // two warpgroups, 64 query rows each
constexpr int kWQ = 128;              // query rows per block
constexpr int kWK = 64;               // keys per tile

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep a register's value where the asynchronous product reads or writes it
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
// cp.async writes (generic proxy) before wgmma reads (async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory descriptor of a wgmma operand in the 128-byte swizzle
// (layout type 1): start address, lbo and sbo in 16-byte units.  K-major
// (Q, K): sbo = 1024 B between 8-row groups, lbo unused (16 B).  MN-major
// (V): lbo = bytes between 64-column atoms, sbo = 1024 B between 8-row
// groups along K.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
         | ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// D (64 x 64, f32) += A (64 x 16, shared) * B (16 x 64, shared), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, f32) += A (64 x 16, bf16 registers) * B (16 x 256, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&acc)[DP / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DP == 64) wgmma_rs_n64(acc, a, db);
  else if constexpr (DP == 128) wgmma_rs_n128(acc, a, db);
  else wgmma_rs_n256(acc, a, db);
}

// Element offset of (r, c) in a tile of ROWS x DP bf16, as wgmma reads it
// in the 128-byte swizzle: 64-column atoms, each ROWS rows of 128 bytes,
// with the 16-byte chunks of row r XOR-ed with r % 8, so the 8 rows of a
// core matrix fall in distinct bank groups.  Atoms start 1024-byte aligned.
template <int ROWS>
__device__ __forceinline__ int tile_off(int r, int c) {
  return (c >> 6) * ROWS * 64 + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

// rows row0..row0+ROWS-1 of a (seq, dim) slice into a tile of DP columns
// laid out by tile_off, zero past seq and past dim (all DP columns are read).
template <int DP, int ROWS>
__device__ __forceinline__ void load_blk(bf16* dst, const bf16* src, int64_t ld_g,
                                         int row0, int seq, int dim, bool vec,
                                         int tid) {
  if (vec) {
    constexpr int cpr = DP / 8;
    for (int idx = tid; idx < ROWS * cpr; idx += kWgThreads) {
      const int r = idx / cpr, d = (idx % cpr) * 8;
      const int pos = row0 + r;
      const bool in = pos < seq && d < dim;
      cp_async16(smem_addr(dst + tile_off<ROWS>(r, d)),
                 in ? src + pos * ld_g + d : src, in ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int idx = tid; idx < ROWS * DP; idx += kWgThreads) {
      const int r = idx / DP, d = idx % DP;
      const int pos = row0 + r;
      dst[tile_off<ROWS>(r, d)] = (pos < seq && d < dim) ? src[pos * ld_g + d] : zero;
    }
  }
}

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

  load_blk<DP, kWQ>(qs, qb, st.q[2], q0, seq, dim, vec, tid);
  load_blk<DP, kWK>(ring, kb, st.k[2], t0, seq, dim, vec, tid);
  load_blk<DP, kWK>(ring + kWK * DP, vb, st.v[2], t0, seq, dim, vec, tid);
  cp_async_commit();

  // core-matrix strides: 128 B along a row, DP * 16 B between 8-row blocks
  // descriptors: K-major Q and K (16 of d per product: 32 bytes within an
  // atom), MN-major V (16 keys per product: 16 rows of 128 bytes)
  auto desc_qk = [](const bf16* base, int rows, int r0, int ki) {
    return smem_desc(base + (ki >> 2) * rows * 64 + r0 * 64 + (ki & 3) * 16, 16, 1024);
  };
  auto desc_v = [](const bf16* base, int kk) {
    return smem_desc(base + kk * 16 * 64, kWK * 128, 1024);
  };

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
      load_blk<DP, kWK>(nk, kb, st.k[2], kv0 + kWK, seq, dim, vec, tid);
      load_blk<DP, kWK>(nk + kWK * DP, vb, st.v[2], kv0 + kWK, seq, dim, vec, tid);
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
      wgmma_ss_n64(s, desc_qk(qs, kWQ, wg * 64, ki), desc_qk(ks, kWK, 0, ki));
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
      wgmma_pv<DP>(acc, pa[kk], desc_v(vs, kk));
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
