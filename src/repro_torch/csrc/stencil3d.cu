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
// balance.  So the inner loop has to keep up with HBM: few shared loads, no
// integer work and no coefficient loads per FMA, and loads that overlap the
// arithmetic.
//
// Design: a register-queue z-march (Micikevicius's 3D stencil, the GPU form
// of the paper's line buffering).  One block of (bx/4) x (by/4) threads owns
// a by x bx column tile over a chunk of bz planes; each thread owns a 4 x 4
// micro-tile of columns (4 along x, 4 along y).  The haloed planes
// (by + 2ry) x (bx + 2px) (px: rx rounded up to one 16-byte chunk) arrive
// in shared memory through a ring of slots filled by cp.async in 16-byte
// chunks, kAhead planes ahead of the one the march needs next, with zeros
// outside the grid (replacing the TPU kernel's clamped face views, masks and
// host-side padding); a chunk cut by the grid's last column, or any chunk
// when rows are not 16-byte aligned, goes element by element.  bf16 lands
// raw and is widened to f32 in registers as it is read.  One __syncthreads
// per plane: after it, the next load goes into the slot the previous step
// has finished with.
//
// The compile-time instances (rz, ry, rx) = (1, 1, 1) and (2, 2, 2) run the
// star pattern of taps (every tap non-zero but the y and x centres, as
// star_3d and heat_3d have it; the host checks the pattern and names the
// instance), so they sum a fixed set of taps with no test.  They keep,
// for each of a thread's 16 columns, the 2R+1 z-values in registers: each
// step reads the newest plane's own columns from shared memory into the
// front of the queue and shifts the queue by one in a fully unrolled move,
// so the ring holds only the planes that are still to be centres (R + 1 +
// kAhead slots).  The y taps read the centre plane's 2R halo rows from
// shared memory (the rows inside the micro-tile are in the queue already);
// the x taps come from a 12-wide register window (two float4 reads a row).
// Every other radius or pattern of taps runs the generic instance, whose
// ring holds all 2rz+1 planes of the z taps (2rz + 1 + kAhead slots) and
// which walks the host-compacted non-zero taps with shared loads.  Sums are
// the JAX body's: z taps, then y taps, then x taps, k ascending, zero
// coefficients skipped, fmaf in f32.  The taps come as a kernel-argument
// struct, so every lane reads them as a constant-bank broadcast.  Whether a
// tile touches the rim is decided once per block; interior tiles store
// without the mask.  No integer division or modulo runs in any loop: ring
// slots rotate with a compare.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kMX = 4, kMY = 4;     // micro-tile: columns x rows a thread owns
constexpr int kMaxThreads = 256;    // by * bx / 16 threads at most
constexpr int kAhead = 2;           // planes in flight beyond the one needed next
constexpr int kMaxTaps = 64;        // taps per axis: radius <= 31

// The taps of the three axes: compacted (offset a in 0..2r, coefficient) in
// ascending order, and dense by offset for the compile-time instances.
// kernels/stencil3d/kernel.py:pack_taps lays out the same fields.
struct Taps {
  int nz, ny, nx;
  int oz[kMaxTaps], oy[kMaxTaps], ox[kMaxTaps];
  float cz[kMaxTaps], cy[kMaxTaps], cx[kMaxTaps];
  float dz[kMaxTaps], dy[kMaxTaps], dx[kMaxTaps];
};

struct Geometry {
  int nz, ny, nx;           // grid
  int rz, ry, rx;           // radii
  int mz, my, mx;           // rim zeroed at the store
  int bz, by, bx;           // tile: z chunk depth, column tile
  int tiles_z, tiles_y, tiles_x;
  int px, h, w;             // x halo in shared memory; haloed plane rows x cols
  int vec;                  // rows and pointers 16-byte aligned
};

// 4 consecutive elements of a shared row as f32 (f32: 16-byte aligned;
// bf16: 8-byte aligned, widened here)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// 4 consecutive outputs; p aligned to 4 elements
__device__ __forceinline__ void store4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float4& v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Start loading plane z of the haloed tile into `slot` (global columns
// x0 - px .. x0 + bx + px - 1, rows y0 - ry .. y0 + by + ry - 1), zeros
// outside the grid.  x0 and px are multiples of the chunk, so every chunk is
// wholly inside or outside the grid unless the grid's last column cuts it.
template <typename T>
__device__ __forceinline__ void issue_plane(const T* __restrict__ xb, T* slot, int z,
                                            int y0, int x0, const Geometry& g) {
  constexpr int E = 16 / sizeof(T);
  const int nch = g.w / E;
  const bool zin = z >= 0 && z < g.nz;
  for (int i = threadIdx.y; i < g.h; i += blockDim.y) {
    const int gy = y0 - g.ry + i;
    const bool row_in = zin && gy >= 0 && gy < g.ny;
    const T* src = xb + (row_in ? ((int64_t)z * g.ny + gy) * g.nx : 0);
    T* dst = slot + i * g.w;
    for (int c = threadIdx.x; c < nch; c += blockDim.x) {
      const int gx = x0 - g.px + E * c;
      const bool in_grid = row_in && gx >= 0 && gx + E <= g.nx;
      if (g.vec && (in_grid || !row_in || gx < 0 || gx >= g.nx)) {
        cp_async16(smem_addr(dst + E * c), in_grid ? src + gx : xb, in_grid ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e)
          dst[E * c + e] = (row_in && gx + e >= 0 && gx + e < g.nx) ? src[gx + e]
                                                                  : from_f32<T>(0.f);
      }
    }
  }
}

// 4 columns of row gy of plane z straight from global memory (zeros outside)
template <typename T>
__device__ __forceinline__ float4 own_global(const T* __restrict__ xb, int z, int gy,
                                             int gx, const Geometry& g) {
  float v[kMX];
  const bool in = z >= 0 && z < g.nz && gy < g.ny;
  const T* p = xb + ((int64_t)(in ? z : 0) * g.ny + (in ? gy : 0)) * g.nx + gx;
#pragma unroll
  for (int e = 0; e < kMX; ++e) v[e] = in && gx + e < g.nx ? to_f32(p[e]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// One row of a thread's 4 outputs to global memory, masked unless the tile
// is interior, 4-wide where aligned and whole.
template <typename T>
__device__ __forceinline__ void store_row(T* __restrict__ yb, float4 acc, int z, int gy,
                                          int gx, bool interior, bool zvalid,
                                          const Geometry& g) {
  if (gy >= g.ny || gx >= g.nx) return;
  if (!interior) {
    const bool row_ok = zvalid && gy >= g.my && gy < g.ny - g.my;
    acc.x = row_ok && gx >= g.mx && gx < g.nx - g.mx ? acc.x : 0.f;
    acc.y = row_ok && gx + 1 >= g.mx && gx + 1 < g.nx - g.mx ? acc.y : 0.f;
    acc.z = row_ok && gx + 2 >= g.mx && gx + 2 < g.nx - g.mx ? acc.z : 0.f;
    acc.w = row_ok && gx + 3 >= g.mx && gx + 3 < g.nx - g.mx ? acc.w : 0.f;
  }
  T* dst = yb + ((int64_t)z * g.ny + gy) * g.nx + gx;
  if (g.vec && gx + kMX <= g.nx) {
    store4(dst, acc);
  } else {
    const float v[kMX] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int e = 0; e < kMX; ++e)
      if (gx + e < g.nx) dst[e] = from_f32<T>(v[e]);
  }
}

// R > 0: the instance rz = ry = rx = R for the star pattern of taps, with
// the z queue in registers; R == 0: any radii and taps, every tap from
// shared memory.
template <typename T, int R>
__global__ void __launch_bounds__(kMaxThreads, 2)
stencil3d_kernel(const T* __restrict__ x, T* __restrict__ y,
                 const __grid_constant__ Taps tp, const Geometry g) {
  extern __shared__ uint4 smem4[];
  constexpr bool kQueue = R > 0;
  T* ring = reinterpret_cast<T*>(smem4);
  const int plane = g.h * g.w;
  const int rz = kQueue ? R : g.rz;
  const int nslots = (kQueue ? R : 2 * g.rz) + 1 + kAhead;

  const int64_t tile = blockIdx.x;      // x tiles fastest, then y, z, batch
  const int tx = (int)(tile % g.tiles_x);
  const int ty = (int)((tile / g.tiles_x) % g.tiles_y);
  const int tz = (int)((tile / ((int64_t)g.tiles_x * g.tiles_y)) % g.tiles_z);
  const int64_t b = tile / ((int64_t)g.tiles_x * g.tiles_y * g.tiles_z);
  const int z0 = tz * g.bz, y0 = ty * g.by, x0 = tx * g.bx;
  const int z1 = min(z0 + g.bz, g.nz);
  const int64_t vol = (int64_t)g.nz * g.ny * g.nx;
  const T* xb = x + b * vol;
  T* yb = y + b * vol;

  const int j = kMX * threadIdx.x, i = kMY * threadIdx.y;   // in the tile
  const int gx = x0 + j, gy0 = y0 + i;
  const int own = (g.ry + i) * g.w + g.px + j;   // shared offset of own (0, 0)
  const bool interior = z0 >= g.mz && z1 <= g.nz - g.mz && y0 >= g.my &&
                        y0 + g.by <= g.ny - g.my && x0 >= g.mx &&
                        x0 + g.bx <= g.nx - g.mx;

  // Prologue: slot s holds plane zlo + s (mod nslots); the ring starts with
  // every plane up to z0 + rz + kAhead - 1 in flight (z0 + rz is needed
  // first), as far as the chunk needs them (up to z1 - 1 + rz), so that no
  // load is pending when the block exits.  Each slot commits a group, empty
  // or not, so the waits below count the same groups.
  const int zlo = z0 - (kQueue ? 0 : rz);
  for (int s = 0; s < nslots - 1; ++s) {
    if (zlo + s < z1 + rz) issue_plane(xb, ring + s * plane, zlo + s, y0, x0, g);
    cp_async_commit();
  }
  float4 q[kQueue ? 2 * R + 1 : 1][kMY];   // q[k][o]: plane z - R + k, row o
  if constexpr (kQueue) {
#pragma unroll
    for (int k = 0; k < R; ++k)
#pragma unroll
      for (int o = 0; o < kMY; ++o) q[k][o] = own_global(xb, z0 - R + k, gy0 + o, gx, g);
  }
  cp_async_wait_group<kAhead - 1>();
  __syncthreads();
  if constexpr (kQueue) {
#pragma unroll
    for (int k = 0; k < R; ++k)
#pragma unroll
      for (int o = 0; o < kMY; ++o) q[R + k][o] = ld4(ring + k * plane + own + o * g.w);
  }

  int sb = 0;   // slot of plane z (instances) or of plane z - rz (generic)
  for (int z = z0; z < z1; ++z) {
    if (z > z0) {
      cp_async_wait_group<kAhead - 1>();   // plane z + rz has landed
      __syncthreads();         // ... for every thread; the last step is done
    }
    // the next plane goes into the slot the last step finished with
    if (z + kAhead < z1)
      issue_plane(xb, ring + (sb == 0 ? nslots - 1 : sb - 1) * plane,
                  z + rz + kAhead, y0, x0, g);
    cp_async_commit();
    const bool zvalid = z >= g.mz && z < g.nz - g.mz;

    if constexpr (kQueue) {
      const T* centre = ring + sb * plane + own;
      const T* front = ring + (sb + R >= nslots ? sb + R - nslots : sb + R) * plane + own;
#pragma unroll
      for (int o = 0; o < kMY; ++o) q[2 * R][o] = ld4(front + o * g.w);
#pragma unroll
      for (int o = 0; o < kMY; ++o) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int k = 0; k <= 2 * R; ++k) fma4(acc, tp.dz[k], q[k][o]);
#pragma unroll
        for (int k = 0; k <= 2 * R; ++k) {
          const int r = o - R + k;   // row in the micro-tile
          if (k != R)
            fma4(acc, tp.dy[k], r >= 0 && r < kMY ? q[R][r] : ld4(centre + r * g.w));
        }
        const float4 lo = ld4(centre + o * g.w - kMX), mid = q[R][o],
                     hi = ld4(centre + o * g.w + kMX);
        const float win[3 * kMX] = {lo.x, lo.y, lo.z, lo.w, mid.x, mid.y,
                                    mid.z, mid.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int k = 0; k <= 2 * R; ++k) {
          const float c = tp.dx[k];
          if (k != R) {
            acc.x = fmaf(c, win[kMX - R + k], acc.x);
            acc.y = fmaf(c, win[kMX - R + k + 1], acc.y);
            acc.z = fmaf(c, win[kMX - R + k + 2], acc.z);
            acc.w = fmaf(c, win[kMX - R + k + 3], acc.w);
          }
        }
        store_row(yb, acc, z, gy0 + o, gx, interior, zvalid, g);
      }
#pragma unroll
      for (int k = 0; k < 2 * R; ++k)
#pragma unroll
        for (int o = 0; o < kMY; ++o) q[k][o] = q[k + 1][o];
    } else {
      const int sc = sb + rz >= nslots ? sb + rz - nslots : sb + rz;
      const T* centre = ring + sc * plane + own;
      for (int o = 0; o < kMY; ++o) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int t = 0; t < tp.nz; ++t) {
          const int s = sb + tp.oz[t] >= nslots ? sb + tp.oz[t] - nslots : sb + tp.oz[t];
          fma4(acc, tp.cz[t], ld4(ring + s * plane + own + o * g.w));
        }
        for (int t = 0; t < tp.ny; ++t)
          fma4(acc, tp.cy[t], ld4(centre + (o - g.ry + tp.oy[t]) * g.w));
        const T* row = centre + o * g.w - g.rx;
        for (int t = 0; t < tp.nx; ++t) {
          const float c = tp.cx[t];
          const T* p = row + tp.ox[t];
          acc.x = fmaf(c, to_f32(p[0]), acc.x);
          acc.y = fmaf(c, to_f32(p[1]), acc.y);
          acc.z = fmaf(c, to_f32(p[2]), acc.z);
          acc.w = fmaf(c, to_f32(p[3]), acc.w);
        }
        store_row(yb, acc, z, gy0 + o, gx, interior, zvalid, g);
      }
    }
    sb = sb + 1 == nslots ? 0 : sb + 1;
  }
}

template <typename T, int R>
cudaError_t launch_r(const void* x, void* y, const Taps& tp, int64_t batch,
                     const Geometry& g, size_t smem, cudaStream_t stream) {
  const int64_t tiles = batch * g.tiles_z * g.tiles_y * g.tiles_x;
  if (tiles > INT32_MAX) return cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)stencil3d_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  stencil3d_kernel<T, R><<<(unsigned)tiles, dim3(g.bx / kMX, g.by / kMY), smem, stream>>>(
      (const T*)x, (T*)y, tp, g);
  return cudaGetLastError();
}

// Every tap of radius r non-zero but the y and x centres, which are zero:
// the pattern the instances sum without tests.
bool star_pattern(const Taps& tp, int r) {
  for (int k = 0; k <= 2 * r; ++k)
    if (tp.dz[k] == 0.f || (tp.dy[k] == 0.f) != (k == r) || (tp.dx[k] == 0.f) != (k == r))
      return false;
  return true;
}

template <typename T>
cudaError_t launch(const void* x, void* y, const Taps& tp, int64_t batch, int inst,
                   const Geometry& g, size_t smem, cudaStream_t stream) {
  if (inst == 1) return launch_r<T, 1>(x, y, tp, batch, g, smem, stream);
  if (inst == 2) return launch_r<T, 2>(x, y, tp, batch, g, smem, stream);
  return launch_r<T, 0>(x, y, tp, batch, g, smem, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x, y: (batch, nz, ny, nx) contiguous on
// the device.  taps: a host buffer laid out as struct Taps (the kernel gets a
// copy as its argument).  inst: the instance, 1 or 2 (rz = ry = rx = inst,
// taps in the star pattern) or 0 (generic), as
// kernels/stencil3d/kernel.py:instance picks it.  The output rim (mz, my,
// mx) is zeroed.  bz >= 1; by a multiple of 4 and bx of 8, by * bx <= 4096.
// vec: nx is a multiple of 16 bytes' worth of elements and x, y are 16-byte
// aligned.  smem: dynamic shared memory of one tile, as
// kernels/stencil3d/kernel.py:smem_bytes lays it out.  Returns
// cudaGetLastError().
int stencil3d_launch(const void* x, void* y, const void* taps, int dtype,
                     int64_t batch, int inst, int nz, int ny, int nx, int rz,
                     int ry, int rx, int mz, int my, int mx, int bz, int by,
                     int bx, int vec, size_t smem, void* stream) {
  Taps tp;
  memcpy(&tp, taps, sizeof(Taps));
  if (bz < 1 || by < kMY || by % kMY || bx < 8 || bx % 8
      || by / kMY * (bx / kMX) > kMaxThreads || 2 * rz + 1 > kMaxTaps
      || 2 * ry + 1 > kMaxTaps || 2 * rx + 1 > kMaxTaps || tp.nz < 0
      || tp.nz > 2 * rz + 1 || tp.ny < 0 || tp.ny > 2 * ry + 1 || tp.nx < 0
      || tp.nx > 2 * rx + 1 || (dtype != 0 && dtype != 1)
      || (inst != 0 && (inst > 2 || rz != inst || ry != inst || rx != inst
                        || !star_pattern(tp, inst))))
    return (int)cudaErrorInvalidValue;
  const int chunk = dtype == 0 ? 4 : 8;   // elements in 16 bytes
  const int px = (rx + chunk - 1) / chunk * chunk;
  const Geometry g{nz, ny, nx, rz, ry, rx, mz, my, mx, bz, by, bx,
                   (nz + bz - 1) / bz, (ny + by - 1) / by, (nx + bx - 1) / bx,
                   px, by + 2 * ry, bx + 2 * px, vec};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, y, tp, batch, inst, g, smem, s);
  return launch<__nv_bfloat16>(x, y, tp, batch, inst, g, smem, s);
}

// sizeof(struct Taps): kernels/stencil3d/kernel.py refuses a library whose
// struct is not the buffer it packs.
int stencil3d_taps_bytes() { return (int)sizeof(Taps); }

const char* stencil3d_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
