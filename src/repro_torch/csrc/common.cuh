// Helpers shared by the kernels in this directory; each .cu includes this
// file, and kernels/_build.py hashes it with every source.
//
// Loads and stores convert between the storage type and float32 only here:
// float passes through, bfloat16 goes through __bfloat162float and
// __float2bfloat16 (round to nearest even), as jnp's astype does.  The
// kernels accumulate in float32 and cast once at the store.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ void fma4(float4& acc, float c, const float4& v) {
  acc.x = fmaf(c, v.x, acc.x);
  acc.y = fmaf(c, v.y, acc.y);
  acc.z = fmaf(c, v.z, acc.z);
  acc.w = fmaf(c, v.w, acc.w);
}

// cp.async: 16 bytes global -> shared without a register round trip
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// src_bytes < 16 zero-fills the rest (0: all)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}
// 4 bytes global -> shared; src_bytes 0 writes a zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// all but the newest N committed groups of this thread have landed
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// d += a . b on the tensor cores (16 x 8 x 8, TF32 in, f32 out).  Fragments
// (g = lane / 4, q = lane % 4): a = rows (g, g+8) x columns (q, q+4) as
// (g,q), (g+8,q), (g,q+4), (g+8,q+4); b = (k q, n g), (k q+4, n g); d =
// (g,2q), (g,2q+1), (g+8,2q), (g+8,2q+1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
