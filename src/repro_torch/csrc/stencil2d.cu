// Batched 2D star stencil (y chain, then x chain) with T fused sweeps, for
// sm_90a (H100).
//
// Replaces the TPU kernel repro/kernels/stencil2d/kernel.py:stencil2d_pallas
// (_body, _sweep2d).
//
// What bounds it on the H100: device-memory bytes.  A launch reads the
// (B, ny, nx) grids once and writes them once; the 2ry+2rx+1 taps and the T
// sweeps run out of shared memory (the paper's 49-pt seismic stencil is 48
// FMAs per point per sweep for 8 bytes of HBM traffic in f32, below the
// card's 20 flop/byte balance at T=1).
//
// Design: the classic shared-memory tile with halo.  One thread block per
// (grid, by x bx output tile) loads the full (by + 2ryT) x (bx + 2rxT)
// rectangle, corners included because the support of fused star sweeps is a
// diamond, as f32 with zeros outside the grid (this replaces the TPU
// kernel's nine clamped neighbour views and its masks, and the host-side
// padding).  It runs T sweeps ping-ponging between two shared buffers, each
// sweep shrinking the region by (ry, rx) per side, summing y taps then x taps
// (k ascending, zero coefficients skipped) as the JAX body does, and writes
// the by x bx tile once, zeroing within (ryT, rxT) of the grid's faces and
// casting at the store.  The second buffer holds only a sweep's output, so it
// is 2ry rows shorter.  The tile is planned on the host against the card's
// opt-in shared memory per block (up to 227 KB); a tile that cannot fit is
// refused there, never shrunk silently.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline int pad4(int v) { return (v + 3) & ~3; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil2d_kernel(const T* __restrict__ x, T* __restrict__ y,
                 const float* __restrict__ coeffs, int ny, int nx, int ry,
                 int rx, int steps, int by, int bx, int tiles_y, int tiles_x) {
  extern __shared__ float smem[];
  const int ncy = 2 * ry + 1, ncx = 2 * rx + 1;
  const int hy = ry * steps, hx = rx * steps;
  const int h0 = by + 2 * hy, w0 = bx + 2 * hx;   // row stride of both buffers
  float* cy = smem;
  float* cx = cy + ncy;
  float* in = smem + pad4(ncy + ncx);
  float* out = in + h0 * w0;

  const int64_t tile = blockIdx.x;
  const int tx = (int)(tile % tiles_x);
  const int ty = (int)((tile / tiles_x) % tiles_y);
  const int64_t b = tile / ((int64_t)tiles_x * tiles_y);
  const int y0 = ty * by, x0 = tx * bx;
  const int64_t plane = (int64_t)ny * nx;
  const T* xb = x + b * plane;
  T* yb = y + b * plane;

  for (int k = threadIdx.x; k < ncy + ncx; k += blockDim.x) cy[k] = coeffs[k];
  for (int idx = threadIdx.x; idx < h0 * w0; idx += blockDim.x) {
    const int i = idx / w0, j = idx - i * w0;
    const int gy = y0 - hy + i, gx = x0 - hx + j;
    in[idx] = (gy >= 0 && gy < ny && gx >= 0 && gx < nx)
                  ? to_f32(xb[(int64_t)gy * nx + gx]) : 0.f;
  }
  __syncthreads();

  int h = h0, w = w0;
  for (int s = 0; s < steps; ++s) {
    h -= 2 * ry;
    w -= 2 * rx;
    for (int idx = threadIdx.x; idx < h * w; idx += blockDim.x) {
      const int i = idx / w, j = idx - i * w;
      float acc = 0.f;
      for (int a = 0; a < ncy; ++a) {
        const float c = cy[a];
        if (c != 0.f) acc = fmaf(c, in[(i + a) * w0 + j + rx], acc);
      }
      const float* row = in + (i + ry) * w0 + j;
      for (int k = 0; k < ncx; ++k) {
        const float c = cx[k];
        if (c != 0.f) acc = fmaf(c, row[k], acc);
      }
      out[i * w0 + j] = acc;
    }
    __syncthreads();
    float* t = in; in = out; out = t;
  }

  for (int idx = threadIdx.x; idx < by * bx; idx += blockDim.x) {
    const int i = idx / bx, j = idx - i * bx;
    const int gy = y0 + i, gx = x0 + j;
    if (gy < ny && gx < nx) {
      const bool valid = gy >= hy && gy < ny - hy && gx >= hx && gx < nx - hx;
      yb[(int64_t)gy * nx + gx] = from_f32<T>(valid ? in[i * w0 + j] : 0.f);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, const void* coeffs, int64_t batch,
                   int ny, int nx, int ry, int rx, int steps, int by, int bx,
                   size_t smem, cudaStream_t stream) {
  const int tiles_y = (ny + by - 1) / by, tiles_x = (nx + bx - 1) / bx;
  const int64_t tiles = batch * tiles_y * tiles_x;
  if (tiles > INT32_MAX) return cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)stencil2d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  stencil2d_kernel<T><<<(unsigned)tiles, kThreads, smem, stream>>>(
      (const T*)x, (T*)y, (const float*)coeffs, ny, nx, ry, rx, steps, by, bx,
      tiles_y, tiles_x);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x, y: (batch, ny, nx) contiguous on the
// device; coeffs: cy (2ry+1) then cx (2rx+1), float32 on the device.
// smem: dynamic shared memory of one tile, as
// kernels/stencil2d/kernel.py:smem_bytes lays it out.
// Returns cudaGetLastError().
int stencil2d_launch(const void* x, void* y, const void* coeffs, int dtype,
                     int64_t batch, int ny, int nx, int ry, int rx, int steps,
                     int by, int bx, size_t smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, y, coeffs, batch, ny, nx, ry, rx, steps, by, bx, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, coeffs, batch, ny, nx, ry, rx, steps, by, bx, smem, s);
  return (int)cudaErrorInvalidValue;
}

const char* stencil2d_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
