// Batched 1D star stencil with T fused sweeps, for sm_90a (H100).
//
// Replaces the TPU kernel repro/kernels/stencil1d/kernel.py:stencil1d_pallas,
// both variants: "vpu" (_vpu_body, a shift-FMA ladder) as stencil1d_vpu, and
// "mxu" (_mxu_body, each sweep as ext @ W_band) as stencil1d_mxu.
//
// What bounds it on the H100: device-memory bytes.  A launch reads the
// (B, N) grid once and writes it once; the 2r+1 taps and T sweeps are served
// from shared memory, so at r=8, T=1 a point costs 17 FMAs for 8 bytes of
// HBM traffic (f32), far below the card's 20 flop/byte balance.  The mxu
// variant trades that for FP32 flops: every 32-wide output tile is a dense
// (rows x 32+2r) @ (32+2r x 32) product, (32+2r)/(2r+1) times the ladder's
// FMAs, still under the balance at r=8.
//
// Design: one thread block per (block_b rows, block_n columns) output tile.
// It loads block_n + 2rT columns per row into shared memory as f32, zero
// outside [0, n) (the TPU kernel's clamped edge views and masks, and the
// host-side padding, are not needed), runs the T sweeps ping-ponging between
// two shared buffers, and writes block_n columns once, zeroing within rT of
// either end of the row and casting to the output type at the store.  Loads
// and stores are coalesced along the row.  Taps are summed k = 0..2r,
// skipping zero coefficients, as the JAX body does.  The mxu band is
// Toeplitz, so one (32+2r) x 32 sub-block W[j][i] = c[j-i] serves every tile;
// it lives in shared memory and each warp computes one 32-column tile for up
// to kRowsPerWarp rows, in IEEE FP32 FMA (no TF32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTn = 32;           // mxu output tile width (one warp)
constexpr int kRowsPerWarp = 4;   // mxu rows sharing one band value

__host__ __device__ inline int pad4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ int rows_left(int64_t batch, int64_t row0, int block_b) {
  const int64_t left = batch - row0;
  return left < block_b ? (int)left : block_b;
}

// Load rows [row0, row0+rows) x columns [col0-halo, col0-halo+w0) as f32,
// zero outside [0, n), into buf with row stride `stride`.
template <typename T>
__device__ void load_tile(const T* __restrict__ x, float* buf, int64_t n,
                          int64_t row0, int rows, int64_t col0, int halo,
                          int w0, int stride) {
  for (int idx = threadIdx.x; idx < rows * w0; idx += blockDim.x) {
    const int rr = idx / w0, j = idx - rr * w0;
    const int64_t g = col0 - halo + j;
    buf[rr * stride + j] = (g >= 0 && g < n) ? to_f32(x[(row0 + rr) * n + g]) : 0.f;
  }
}

// Write block_n columns of each row, zero within `halo` of either end.
template <typename T>
__device__ void store_tile(T* __restrict__ y, const float* buf, int64_t n,
                           int64_t row0, int rows, int64_t col0, int halo,
                           int block_n, int stride) {
  for (int idx = threadIdx.x; idx < rows * block_n; idx += blockDim.x) {
    const int rr = idx / block_n, j = idx - rr * block_n;
    const int64_t g = col0 + j;
    if (g < n) {
      const float v = (g >= halo && g < n - halo) ? buf[rr * stride + j] : 0.f;
      y[(row0 + rr) * n + g] = from_f32<T>(v);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil1d_vpu_kernel(const T* __restrict__ x, T* __restrict__ y,
                     const float* __restrict__ coeffs, int64_t batch, int64_t n,
                     int r, int steps, int block_b, int block_n, int64_t tiles_n) {
  extern __shared__ float smem[];
  const int ntaps = 2 * r + 1, halo = r * steps, w0 = block_n + 2 * halo;
  float* c = smem;
  float* in = smem + pad4(ntaps);
  float* out = in + block_b * w0;
  const int64_t row0 = (blockIdx.x / tiles_n) * block_b;
  const int64_t col0 = (blockIdx.x % tiles_n) * block_n;
  const int rows = rows_left(batch, row0, block_b);

  for (int k = threadIdx.x; k < ntaps; k += blockDim.x) c[k] = coeffs[k];
  load_tile(x, in, n, row0, rows, col0, halo, w0, w0);
  __syncthreads();
  int w = w0;
  for (int s = 0; s < steps; ++s) {
    w -= 2 * r;
    for (int idx = threadIdx.x; idx < rows * w; idx += blockDim.x) {
      const int rr = idx / w, j = idx - rr * w;
      const float* src = in + rr * w0 + j;
      float acc = 0.f;
      for (int k = 0; k < ntaps; ++k) {
        const float ck = c[k];
        if (ck != 0.f) acc = fmaf(ck, src[k], acc);
      }
      out[rr * w0 + j] = acc;
    }
    __syncthreads();
    float* t = in; in = out; out = t;
  }
  store_tile(y, in, n, row0, rows, col0, halo, block_n, w0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil1d_mxu_kernel(const T* __restrict__ x, T* __restrict__ y,
                     const float* __restrict__ coeffs, int64_t batch, int64_t n,
                     int r, int steps, int block_b, int block_n, int64_t tiles_n) {
  extern __shared__ float smem[];
  const int kdim = kTn + 2 * r, halo = r * steps, w0 = block_n + 2 * halo;
  // Row stride w0 + kTn: the last, partial tile of a sweep reads and writes
  // up to kTn - 1 columns past the valid width; they are zeroed first and
  // only ever meet zero band entries.
  const int stride = w0 + kTn;
  float* band = smem;                       // [kdim][kTn], W[j][i] = c[j - i]
  float* in = band + kdim * kTn;
  float* out = in + block_b * stride;
  const int64_t row0 = (blockIdx.x / tiles_n) * block_b;
  const int64_t col0 = (blockIdx.x % tiles_n) * block_n;
  const int rows = rows_left(batch, row0, block_b);

  for (int idx = threadIdx.x; idx < kdim * kTn; idx += blockDim.x) {
    const int d = idx / kTn - idx % kTn;
    band[idx] = (d >= 0 && d <= 2 * r) ? coeffs[d] : 0.f;
  }
  for (int idx = threadIdx.x; idx < 2 * block_b * stride; idx += blockDim.x) in[idx] = 0.f;
  __syncthreads();
  load_tile(x, in, n, row0, rows, col0, halo, w0, stride);
  __syncthreads();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const int groups = (rows + kRowsPerWarp - 1) / kRowsPerWarp;
  int w = w0;
  for (int s = 0; s < steps; ++s) {
    w -= 2 * r;
    const int tiles = (w + kTn - 1) / kTn;
    for (int item = warp; item < groups * tiles; item += nwarps) {
      const int r0 = (item / tiles) * kRowsPerWarp;
      const int c0 = (item % tiles) * kTn;
      float acc[kRowsPerWarp];
#pragma unroll
      for (int m = 0; m < kRowsPerWarp; ++m) acc[m] = 0.f;
      for (int j = 0; j < kdim; ++j) {
        const float b = band[j * kTn + lane];
#pragma unroll
        for (int m = 0; m < kRowsPerWarp; ++m)
          if (r0 + m < rows) acc[m] = fmaf(in[(r0 + m) * stride + c0 + j], b, acc[m]);
      }
#pragma unroll
      for (int m = 0; m < kRowsPerWarp; ++m)
        if (r0 + m < rows) out[(r0 + m) * stride + c0 + lane] = acc[m];
    }
    __syncthreads();
    float* t = in; in = out; out = t;
  }
  store_tile(y, in, n, row0, rows, col0, halo, block_n, stride);
}

template <typename T>
cudaError_t launch(bool mxu, const void* x, void* y, const void* coeffs,
                   int64_t batch, int64_t n, int r, int steps, int block_b,
                   int block_n, size_t smem, cudaStream_t stream) {
  const int64_t tiles_n = (n + block_n - 1) / block_n;
  const int64_t tiles = tiles_n * ((batch + block_b - 1) / block_b);
  if (tiles > INT32_MAX) return cudaErrorInvalidConfiguration;
  auto kernel = mxu ? stencil1d_mxu_kernel<T> : stencil1d_vpu_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)tiles, kThreads, smem, stream>>>(
      (const T*)x, (T*)y, (const float*)coeffs, batch, n, r, steps, block_b,
      block_n, tiles_n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x, y: (batch, n) contiguous on the
// device; coeffs: 2r+1 float32 on the device; smem: dynamic shared memory of
// one tile, as kernels/stencil1d/kernel.py:smem_bytes lays it out.
// Returns cudaGetLastError().
int stencil1d_launch(int mxu, const void* x, void* y, const void* coeffs,
                     int dtype, int64_t batch, int64_t n, int r, int steps,
                     int block_b, int block_n, size_t smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(mxu, x, y, coeffs, batch, n, r, steps, block_b, block_n, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(mxu, x, y, coeffs, batch, n, r, steps, block_b, block_n, smem, s);
  return (int)cudaErrorInvalidValue;
}

const char* stencil1d_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
