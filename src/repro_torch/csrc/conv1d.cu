// Depthwise causal conv1d, y[b,s,c] = sum_k w[k,c] * x[b, s-K+1+k, c], zero
// before s = 0, for sm_90a (H100).
//
// Replaces the TPU kernel repro/kernels/conv1d/kernel.py:conv1d_pallas
// (_body).
//
// What bounds it on the H100: device-memory bytes.  K = 4 taps are 4 FMAs
// per element for 4 bytes (f32) or 2 bytes (bf16) read and as many written,
// far below the card's flop/byte balance, so the least time is one read of
// x and one write of y at the HBM rate.
//
// Design: one thread per channel, channels coalesced across the warp.  A
// thread walks kSeqTile sequence positions of its channel, keeping the K
// taps and the K-1 previous inputs in registers (a register window of KW >= K
// slots, shifted by one each step, taps right-aligned in it), so each input
// is read from device memory once per tile plus a K-1 row halo that the
// thread reads itself from the previous tile's rows (zero before s = 0).
// This replaces the TPU kernel's prev/cur block pair and the host padding.
// It sums in float32 in tap order and casts to the input type at the store;
// the bias is added outside.  K > 32 is refused by the launcher.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSeqTile = 64;   // SEQ_TILE in kernels/conv1d/kernel.py

template <typename T, int KW>
__global__ void __launch_bounds__(kThreads)
conv1d_kernel(const T* __restrict__ x, const T* __restrict__ w,
              T* __restrict__ y, int64_t seq, int64_t ch, int taps) {
  const int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (c >= ch) return;
  const int64_t s0 = (int64_t)blockIdx.y * kSeqTile;
  const int64_t s1 = min(seq, s0 + kSeqTile);
  const int64_t b = blockIdx.z;
  const T* xb = x + b * seq * ch + c;
  T* yb = y + b * seq * ch + c;
  const int first = KW - taps;          // window slots before it have no tap

  float wr[KW], win[KW];
#pragma unroll
  for (int i = 0; i < KW; ++i) {
    wr[i] = i >= first ? to_f32(w[(int64_t)(i - first) * ch + c]) : 0.f;
    // slot i holds position s - (KW-1) + i; before the first step s = s0
    const int64_t pos = s0 - (KW - 1) + i;
    win[i] = (i >= first && i < KW - 1 && pos >= 0) ? to_f32(xb[pos * ch]) : 0.f;
  }
  for (int64_t s = s0; s < s1; ++s) {
    win[KW - 1] = to_f32(xb[s * ch]);
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < KW; ++i)
      if (i >= first) acc = fmaf(win[i], wr[i], acc);
    yb[s * ch] = from_f32<T>(acc);
#pragma unroll
    for (int i = 0; i < KW - 1; ++i) win[i] = win[i + 1];
  }
}

template <typename T, int KW>
cudaError_t launch_kw(const void* x, const void* w, void* y, int64_t batch,
                      int64_t seq, int64_t ch, int taps, cudaStream_t stream) {
  const int64_t gx = (ch + kThreads - 1) / kThreads;
  const int64_t gy = (seq + kSeqTile - 1) / kSeqTile;
  if (gx > INT32_MAX || gy > 65535 || batch > 65535)
    return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)batch);
  conv1d_kernel<T, KW><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)w, (T*)y, seq, ch, taps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int64_t batch,
                   int64_t seq, int64_t ch, int taps, cudaStream_t stream) {
  if (taps < 1) return cudaErrorInvalidValue;
  if (taps <= 4) return launch_kw<T, 4>(x, w, y, batch, seq, ch, taps, stream);
  if (taps <= 8) return launch_kw<T, 8>(x, w, y, batch, seq, ch, taps, stream);
  if (taps <= 16) return launch_kw<T, 16>(x, w, y, batch, seq, ch, taps, stream);
  if (taps <= 32) return launch_kw<T, 32>(x, w, y, batch, seq, ch, taps, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x, y: (batch, seq, ch) and w: (taps, ch),
// all of that type, contiguous on the device; 1 <= taps <= 32.
// Returns cudaGetLastError().
int conv1d_launch(const void* x, const void* w, void* y, int dtype,
                  int64_t batch, int64_t seq, int64_t ch, int taps,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, w, y, batch, seq, ch, taps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, y, batch, seq, ch, taps, s);
  return (int)cudaErrorInvalidValue;
}

const char* conv1d_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
