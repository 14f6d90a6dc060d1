// Batched 3D star stencil, one sweep per launch, for sm_90a (H100).
//
// Replaces the TPU kernel repro/kernels/stencil3d/kernel.py:stencil3d_pallas
// (_body).  As there, T > 1 is T launches (repro_torch/kernels/stencil3d/
// ops.py); the rim re-mask between sweeps is this kernel's store: launch t
// zeroes within (rz*t, ry*t, rx*t) of the faces, and the store casts to the
// grid's type.
//
// What bounds it on the H100: device-memory bytes.  A launch reads the
// (B, nz, ny, nx) grids once and writes them once; with r=2 a point costs 13
// FMAs for 8 bytes of HBM traffic (f32), below the card's 20 flop/byte
// balance.
//
// Design: a 2.5D z-march, the GPU form of the paper's line buffering.  One
// thread block owns a by x bx column tile over bz consecutive planes.  It
// keeps a ring of the 2rz+1 planes around the current z in shared memory,
// each with its (ry, rx) halo, so every element is read from device memory
// once per tile (plus the xy halo and 2rz planes at the chunk's ends).  Each
// step loads one new plane (zeros outside the grid, which replaces the TPU
// kernel's clamped face views and masks and the host-side padding) and
// writes one output plane, summing z taps, then y taps, then x taps (k
// ascending, zero coefficients skipped), each axis's centre coefficient
// included, in f32, as the JAX body does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline int pad4(int v) { return (v + 3) & ~3; }

struct Geometry {
  int nz, ny, nx;        // grid
  int rz, ry, rx;        // radii
  int mz, my, mx;        // rim zeroed at the store
  int bz, by, bx;        // tile: z chunk depth, column tile
  int tiles_z, tiles_y, tiles_x;
};

template <typename T>
__device__ void load_plane(const T* __restrict__ xb, float* dst, int z, int y0,
                           int x0, const Geometry& g) {
  const int h = g.by + 2 * g.ry, w = g.bx + 2 * g.rx;
  const bool zin = z >= 0 && z < g.nz;
  for (int idx = threadIdx.x; idx < h * w; idx += blockDim.x) {
    const int i = idx / w, j = idx - i * w;
    const int gy = y0 - g.ry + i, gx = x0 - g.rx + j;
    dst[idx] = (zin && gy >= 0 && gy < g.ny && gx >= 0 && gx < g.nx)
                   ? to_f32(xb[((int64_t)z * g.ny + gy) * g.nx + gx]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil3d_kernel(const T* __restrict__ x, T* __restrict__ y,
                 const float* __restrict__ coeffs, Geometry g) {
  extern __shared__ float smem[];
  const int ncz = 2 * g.rz + 1, ncy = 2 * g.ry + 1, ncx = 2 * g.rx + 1;
  const int h = g.by + 2 * g.ry, w = g.bx + 2 * g.rx, plane = h * w;
  float* cz = smem;
  float* cy = cz + ncz;
  float* cx = cy + ncy;
  float* ring = smem + pad4(ncz + ncy + ncx);   // ncz planes of h x w

  const int64_t tile = blockIdx.x;
  const int tx = (int)(tile % g.tiles_x);
  const int ty = (int)((tile / g.tiles_x) % g.tiles_y);
  const int tz = (int)((tile / ((int64_t)g.tiles_x * g.tiles_y)) % g.tiles_z);
  const int64_t b = tile / ((int64_t)g.tiles_x * g.tiles_y * g.tiles_z);
  const int z0 = tz * g.bz, y0 = ty * g.by, x0 = tx * g.bx;
  const int z1 = min(z0 + g.bz, g.nz);
  const int64_t vol = (int64_t)g.nz * g.ny * g.nx;
  const T* xb = x + b * vol;
  T* yb = y + b * vol;

  for (int k = threadIdx.x; k < ncz + ncy + ncx; k += blockDim.x) cz[k] = coeffs[k];
  // Plane z lives in slot (z - z0 + rz) % ncz.
  for (int q = 0; q < 2 * g.rz; ++q) load_plane(xb, ring + q * plane, z0 - g.rz + q, y0, x0, g);

  for (int z = z0; z < z1; ++z) {
    load_plane(xb, ring + ((z - z0 + 2 * g.rz) % ncz) * plane, z + g.rz, y0, x0, g);
    __syncthreads();
    const float* centre = ring + ((z - z0 + g.rz) % ncz) * plane;
    const bool zvalid = z >= g.mz && z < g.nz - g.mz;
    for (int idx = threadIdx.x; idx < g.by * g.bx; idx += blockDim.x) {
      const int i = idx / g.bx, j = idx - i * g.bx;
      const int gy = y0 + i, gx = x0 + j;
      if (gy >= g.ny || gx >= g.nx) continue;
      const int at = (i + g.ry) * w + j + g.rx;
      float acc = 0.f;
      for (int k = 0; k < ncz; ++k) {
        const float c = cz[k];
        if (c != 0.f) acc = fmaf(c, ring[((z - z0 + k) % ncz) * plane + at], acc);
      }
      for (int k = 0; k < ncy; ++k) {
        const float c = cy[k];
        if (c != 0.f) acc = fmaf(c, centre[(i + k) * w + j + g.rx], acc);
      }
      for (int k = 0; k < ncx; ++k) {
        const float c = cx[k];
        if (c != 0.f) acc = fmaf(c, centre[(i + g.ry) * w + j + k], acc);
      }
      const bool valid = zvalid && gy >= g.my && gy < g.ny - g.my &&
                         gx >= g.mx && gx < g.nx - g.mx;
      yb[((int64_t)z * g.ny + gy) * g.nx + gx] = from_f32<T>(valid ? acc : 0.f);
    }
    __syncthreads();   // the next step overwrites the oldest slot
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, const void* coeffs, int64_t batch,
                   const Geometry& g, size_t smem, cudaStream_t stream) {
  const int64_t tiles = batch * g.tiles_z * g.tiles_y * g.tiles_x;
  if (tiles > INT32_MAX) return cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)stencil3d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  stencil3d_kernel<T><<<(unsigned)tiles, kThreads, smem, stream>>>(
      (const T*)x, (T*)y, (const float*)coeffs, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x, y: (batch, nz, ny, nx) contiguous on
// the device; coeffs: cz, cy, cx (2r+1 each), float32 on the device; the
// output rim (mz, my, mx) is zeroed; smem: dynamic shared memory of one
// tile, as kernels/stencil3d/kernel.py:smem_bytes lays it out.
// Returns cudaGetLastError().
int stencil3d_launch(const void* x, void* y, const void* coeffs, int dtype,
                     int64_t batch, int nz, int ny, int nx, int rz, int ry,
                     int rx, int mz, int my, int mx, int bz, int by, int bx,
                     size_t smem, void* stream) {
  const Geometry g{nz, ny, nx, rz, ry, rx, mz, my, mx, bz, by, bx,
                   (nz + bz - 1) / bz, (ny + by - 1) / by, (nx + bx - 1) / bx};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, y, coeffs, batch, g, smem, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, coeffs, batch, g, smem, s);
  return (int)cudaErrorInvalidValue;
}

const char* stencil3d_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
