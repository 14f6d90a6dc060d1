// Batched 2D star stencil (y chain, then x chain) with T fused sweeps, for
// sm_90a (H100).
//
// Replaces the TPU kernel repro/kernels/stencil2d/kernel.py:stencil2d_pallas
// (_body, _sweep2d).
//
// What bounds it on the H100: device-memory bytes.  A launch reads the
// (B, ny, nx) grids once and writes them once; the 2ry+2rx+1 taps and the T
// sweeps run out of shared memory and registers (the paper's 49-pt seismic
// stencil is 48 FMAs per point per sweep for 8 bytes of HBM traffic in f32,
// below the card's 20 flop/byte balance at T=1).  So the inner loop has to
// keep up with HBM: few shared loads and no integer work per FMA.
//
// Design: one block of 32 x 8 threads per (grid, by x bx output tile) loads
// the full haloed rectangle (by + 2ryT) x (bx + 2rxT), corners included
// because the support of fused star sweeps is a diamond, as f32 with zeros
// outside the grid: 16-byte chunks of 8 elements, on rows aligned so that
// the chunks line up with the grid's own 16-byte rows, all issued by
// cp.async before any is waited for (bf16 lands raw in the upper half of
// each row and is widened in place).  Each thread then computes 8 x 4
// micro-tiles of outputs:
// the y chain streams the 8 + 2r input rows of its four columns through one
// float4 register, each row feeding every output it reaches; the x chain
// loads each row's 4 + 2r' window (r' = r rounded up to 4) as float4s into
// registers.  At r = 12 that is 88 shared float4 loads for 32 outputs and
// 1,568 FMAs.  The sum is the JAX body's: y taps then x taps, k ascending,
// zero coefficients skipped, fmaf in f32.  The radii 1, 2, 3 and 12 (ry ==
// rx) are compile-time instances, whose taps are the dense coefficients by
// offset with a warp-uniform skip of a zero tap over the four outputs it
// would feed; every other radius walks the compacted list of non-zero taps
// (built on the host in ascending order) with shared loads.  The taps come as
// a kernel-argument struct, so every lane reads them as a constant-bank
// broadcast.  The last sweep writes from registers straight to global
// memory (4-wide stores), zeroing within (ryT, rxT) of the grid's faces and
// casting at the store; at T = 1 there is no second buffer.  For T > 1 the
// earlier sweeps ping-pong between two shared buffers, each sweep computed
// with the same micro-tiles over its shrinking region rounded out to whole
// micro-tiles; an 8-column margin on each side and 8 rows below absorb the
// rounding (what lands there feeds only cells outside the next region).
// No integer division runs in any inner loop: threads are indexed in 2D.
// The tile is planned on the host against the card's opt-in shared memory
// per block (up to 227 KB); a tile that cannot fit is refused there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kTX = 32, kTY = 8;          // threads per block: kTX x kTY
constexpr int kMY = 8, kMX = 4;           // micro-tile: rows x columns
constexpr int kMaxTaps = 128;             // non-zero taps per axis
constexpr int kWidenRows = 8;             // rows a warp widens from bf16 at once

// The taps of both chains: compacted (offset a in 0..2r, coefficient) in
// ascending order, and dense by offset for the compile-time radii.
// kernels/stencil2d/kernel.py:pack_taps lays out the same fields.
struct Taps {
  int ny, nx;
  int oy[kMaxTaps], ox[kMaxTaps];
  float cy[kMaxTaps], cx[kMaxTaps];
  float dy[kMaxTaps], dx[kMaxTaps];
};

__host__ __device__ inline int pad8(int v) { return (v + 7) & ~7; }

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void bf16x8_to_f32(const uint4& a, float (&v)[8]) {
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[2 * e] = __uint_as_float(w[e] << 16);
    v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

// 4 consecutive outputs; p aligned to 4 elements
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// One 8 x 4 micro-tile at shared row i, column j (j % 4 == 0) of `in`, row
// stride w0: compile-time radius R on both axes.
template <int R>
__device__ __forceinline__ void micro_fixed(const float* in, int w0, int i, int j,
                                            const Taps& tp, float4 (&acc)[kMY]) {
  constexpr int P = (R + 3) & ~3;
#pragma unroll
  for (int o = 0; o < kMY; ++o) acc[o] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* col = in + (i - R) * w0 + j;
#pragma unroll
  for (int rr = 0; rr < kMY + 2 * R; ++rr) {
    const float4 v = lds4(col + rr * w0);
#pragma unroll
    for (int o = 0; o < kMY; ++o) {
      const int a = rr - o;
      if (a >= 0 && a <= 2 * R) {
        const float c = tp.dy[a];
        if (c != 0.f) fma4(acc[o], c, v);
      }
    }
  }
#pragma unroll
  for (int o = 0; o < kMY; ++o) {
    float w[kMX + 2 * P];
    const float* row = in + (i + o) * w0 + j - P;
#pragma unroll
    for (int m = 0; m < (kMX + 2 * P) / 4; ++m) {
      const float4 v = lds4(row + 4 * m);
      w[4 * m] = v.x; w[4 * m + 1] = v.y; w[4 * m + 2] = v.z; w[4 * m + 3] = v.w;
    }
#pragma unroll
    for (int b = 0; b <= 2 * R; ++b) {
      const float c = tp.dx[b];
      if (c != 0.f) {
        acc[o].x = fmaf(c, w[b - R + P], acc[o].x);
        acc[o].y = fmaf(c, w[b - R + P + 1], acc[o].y);
        acc[o].z = fmaf(c, w[b - R + P + 2], acc[o].z);
        acc[o].w = fmaf(c, w[b - R + P + 3], acc[o].w);
      }
    }
  }
}

// The same micro-tile for any radii, over the compacted non-zero taps.
__device__ __forceinline__ void micro_any(const float* in, int w0, int i, int j,
                                          int ry, int rx, const Taps& tp,
                                          float4 (&acc)[kMY]) {
#pragma unroll
  for (int o = 0; o < kMY; ++o) acc[o] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = 0; t < tp.ny; ++t) {
    const float c = tp.cy[t];
    const float* col = in + (i - ry + tp.oy[t]) * w0 + j;
#pragma unroll
    for (int o = 0; o < kMY; ++o) fma4(acc[o], c, lds4(col + o * w0));
  }
#pragma unroll
  for (int o = 0; o < kMY; ++o) {
    const float* row = in + (i + o) * w0 + j - rx;
    for (int t = 0; t < tp.nx; ++t) {
      const float c = tp.cx[t];
      const float* p = row + tp.ox[t];
      acc[o].x = fmaf(c, p[0], acc[o].x);
      acc[o].y = fmaf(c, p[1], acc[o].y);
      acc[o].z = fmaf(c, p[2], acc[o].z);
      acc[o].w = fmaf(c, p[3], acc[o].w);
    }
  }
}

// R > 0: the compile-time instance; R == 0: any radii
template <typename T, int R>
__global__ void __launch_bounds__(kTX * kTY, 2)
stencil2d_kernel(const T* __restrict__ x, T* __restrict__ y, const Taps tp,
                 int ny, int nx, int ry, int rx, int steps, int by, int bx,
                 int tiles_y, int tiles_x, int vec) {
  extern __shared__ float4 smem4[];
  const int hy = ry * steps, hx = rx * steps;
  const int mx = steps > 1 ? 8 : 0;           // column margin on each side
  const int px = pad8(hx);
  const int cb = mx + px;                     // shared column of output column 0
  const int w0 = 2 * cb + bx;                 // row stride of both buffers
  const int h0 = by + 2 * hy;                 // rows that hold data
  const int hb = h0 + (steps > 1 ? kMY : 0);  // rows of one buffer
  float* in = reinterpret_cast<float*>(smem4);
  float* out = in + hb * w0;                  // only when steps > 1

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t tile = blockIdx.x;
  const int txi = (int)(tile % tiles_x);
  const int tyi = (int)((tile / tiles_x) % tiles_y);
  const int64_t b = tile / ((int64_t)tiles_x * tiles_y);
  const int y0 = tyi * by, x0 = txi * bx;
  const int64_t plane = (int64_t)ny * nx;
  const T* xb = x + b * plane;
  T* yb = y + b * plane;

  // the haloed rectangle, global columns x0 - px .. x0 + bx + px - 1, in
  // chunks of 8 (x0 and px are multiples of 8): every chunk wholly inside
  // or outside the grid by cp.async (zero-filled outside), all in flight at
  // once; f32 lands in place, bf16 raw in the upper half of its row and is
  // widened below.  A chunk cut by the grid's last column (or any chunk
  // when !vec) goes element by element.
  const int nch = (bx + 2 * px) >> 3;
  for (int i = ty; i < h0; i += kTY) {
    const int gy = y0 - hy + i;
    const bool row_in = gy >= 0 && gy < ny;
    const T* src = xb + (row_in ? (int64_t)gy * nx : 0);
    for (int c = tx; c < nch; c += kTX) {
      const int gx = x0 - px + 8 * c;
      const bool in_grid = row_in && gx >= 0 && gx + 8 <= nx;
      const bool whole = vec && (in_grid || !row_in || gx < 0 || gx >= nx);
      if constexpr (sizeof(T) == 4) {
        float* dst = in + i * w0 + mx + 8 * c;
        if (whole) {
          cp_async16(smem_addr(dst), in_grid ? src + gx : xb, in_grid ? 16 : 0);
          cp_async16(smem_addr(dst + 4), in_grid ? src + gx + 4 : xb, in_grid ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            dst[e] = (row_in && gx + e >= 0 && gx + e < nx) ? to_f32(src[gx + e]) : 0.f;
        }
      } else {
        T* dst = reinterpret_cast<T*>(in + i * w0 + w0 / 2) + mx + 8 * c;
        if (whole) {
          cp_async16(smem_addr(dst), in_grid ? src + gx : xb, in_grid ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            dst[e] = (row_in && gx + e >= 0 && gx + e < nx) ? src[gx + e] : from_f32<T>(0.f);
        }
      }
    }
  }
  cp_async_wait_all();
  if constexpr (sizeof(T) == 2) {
    // bf16 -> f32 in place.  Each lane widens the chunks it copied itself
    // (its own cp.async wait makes them visible).  The f32 chunk c overlaps
    // only staged chunks c' <= c of its own row, so a warp reads the staged
    // chunks of kWidenRows rows (32 a row at a time, in increasing c)
    // before it writes any of them.
    for (int c0 = 0; c0 < nch; c0 += kTX) {
      const int c = c0 + tx;
      for (int i0 = ty; i0 < h0; i0 += kTY * kWidenRows) {
        uint4 raw[kWidenRows];
#pragma unroll
        for (int rb = 0; rb < kWidenRows; ++rb) {
          const int i = i0 + rb * kTY;
          if (i < h0 && c < nch)
            raw[rb] = *reinterpret_cast<const uint4*>(
                reinterpret_cast<const T*>(in + i * w0 + w0 / 2) + mx + 8 * c);
        }
        __syncwarp();
#pragma unroll
        for (int rb = 0; rb < kWidenRows; ++rb) {
          const int i = i0 + rb * kTY;
          if (i >= h0 || c >= nch) continue;
          float v[8];
          bf16x8_to_f32(raw[rb], v);
          float* dst = in + i * w0 + mx + 8 * c;
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  for (int s = 1; s <= steps; ++s) {
    const bool last = s == steps;
    const int r_lo = ry * s, r_hi = h0 - ry * s;
    const int c_lo = (cb - hx + rx * s) & ~3, c_hi = cb + bx + hx - rx * s;
    const int nmy = (r_hi - r_lo + kMY - 1) / kMY;   // once per sweep
    const int nmx = (c_hi - c_lo + kMX - 1) / kMX;
    for (int my = ty; my < nmy; my += kTY) {
      for (int mxi = tx; mxi < nmx; mxi += kTX) {
        const int i = r_lo + kMY * my, j = c_lo + kMX * mxi;
        const int gy0 = y0 + i - hy, gx = x0 + j - cb;
        if (last && (gy0 >= ny || gx >= nx)) continue;   // past the grid's end
        float4 acc[kMY];
        if constexpr (R > 0) micro_fixed<R>(in, w0, i, j, tp, acc);
        else micro_any(in, w0, i, j, ry, rx, tp, acc);
        if (!last) {
#pragma unroll
          for (int o = 0; o < kMY; ++o)
            *reinterpret_cast<float4*>(out + (i + o) * w0 + j) = acc[o];
          continue;
        }
        const bool col_ok[kMX] = {gx >= hx && gx < nx - hx,
                                  gx + 1 >= hx && gx + 1 < nx - hx,
                                  gx + 2 >= hx && gx + 2 < nx - hx,
                                  gx + 3 >= hx && gx + 3 < nx - hx};
#pragma unroll
        for (int o = 0; o < kMY; ++o) {
          const int gy = gy0 + o;
          if (gy >= ny) break;
          const bool row_ok = gy >= hy && gy < ny - hy;
          const float r[kMX] = {acc[o].x, acc[o].y, acc[o].z, acc[o].w};
          float vals[kMX];
#pragma unroll
          for (int e = 0; e < kMX; ++e) vals[e] = row_ok && col_ok[e] ? r[e] : 0.f;
          T* dst = yb + (int64_t)gy * nx + gx;
          if (vec && gx + kMX <= nx) {
            store4(dst, vals);
          } else {
#pragma unroll
            for (int e = 0; e < kMX; ++e)
              if (gx + e < nx) dst[e] = from_f32<T>(vals[e]);
          }
        }
      }
    }
    if (!last) {
      __syncthreads();
      float* t = in; in = out; out = t;
    }
  }
}

template <typename T, int R>
cudaError_t launch_r(const void* x, void* y, const Taps& tp, int64_t batch,
                     int ny, int nx, int ry, int rx, int steps, int by, int bx,
                     int vec, size_t smem, cudaStream_t stream) {
  const int tiles_y = (ny + by - 1) / by, tiles_x = (nx + bx - 1) / bx;
  const int64_t tiles = batch * tiles_y * tiles_x;
  if (tiles > INT32_MAX) return cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)stencil2d_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  stencil2d_kernel<T, R><<<(unsigned)tiles, dim3(kTX, kTY), smem, stream>>>(
      (const T*)x, (T*)y, tp, ny, nx, ry, rx, steps, by, bx, tiles_y, tiles_x, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, void* y, const Taps& tp, int64_t batch,
                   int ny, int nx, int ry, int rx, int steps, int by, int bx,
                   int vec, size_t smem, cudaStream_t stream) {
  if (ry == rx) {
    switch (ry) {
      case 1: return launch_r<T, 1>(x, y, tp, batch, ny, nx, ry, rx, steps, by, bx, vec, smem, stream);
      case 2: return launch_r<T, 2>(x, y, tp, batch, ny, nx, ry, rx, steps, by, bx, vec, smem, stream);
      case 3: return launch_r<T, 3>(x, y, tp, batch, ny, nx, ry, rx, steps, by, bx, vec, smem, stream);
      case 12: return launch_r<T, 12>(x, y, tp, batch, ny, nx, ry, rx, steps, by, bx, vec, smem, stream);
      default: break;
    }
  }
  return launch_r<T, 0>(x, y, tp, batch, ny, nx, ry, rx, steps, by, bx, vec, smem, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x, y: (batch, ny, nx) contiguous on the
// device.  taps: a host buffer laid out as struct Taps (the kernel gets a
// copy as its argument).  by, bx: multiples of 8.  vec: nx is a multiple of
// 16 bytes' worth of elements and x, y are 16-byte aligned.  smem: dynamic
// shared memory of one tile, as kernels/stencil2d/kernel.py:smem_bytes lays
// it out.  Returns cudaGetLastError().
int stencil2d_launch(const void* x, void* y, const void* taps, int dtype,
                     int64_t batch, int ny, int nx, int ry, int rx, int steps,
                     int by, int bx, int vec, size_t smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Taps tp;
  memcpy(&tp, taps, sizeof(Taps));
  if (by < kMY || by % 8 || bx < 8 || bx % 8 || tp.ny < 0 || tp.ny > kMaxTaps
      || tp.nx < 0 || tp.nx > kMaxTaps || 2 * ry + 1 > kMaxTaps
      || 2 * rx + 1 > kMaxTaps || steps < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, y, tp, batch, ny, nx, ry, rx, steps, by, bx, vec, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, tp, batch, ny, nx, ry, rx, steps, by, bx, vec, smem, s);
  return (int)cudaErrorInvalidValue;
}

// sizeof(struct Taps): kernels/stencil2d/kernel.py refuses a library whose
// struct is not the buffer it packs.
int stencil2d_taps_bytes() { return (int)sizeof(Taps); }

const char* stencil2d_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
