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
