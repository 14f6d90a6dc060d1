// Helpers shared by the kernels in this directory; each .cu includes this
// file, and kernels/_build.py hashes it with every source.
//
// Loads and stores convert between the storage type and float32 only here:
// float passes through, bfloat16 goes through __bfloat162float and
// __float2bfloat16 (round to nearest even), as jnp's astype does.  The
// kernels accumulate in float32 and cast once at the store.
#pragma once

#include <cuda_bf16.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
