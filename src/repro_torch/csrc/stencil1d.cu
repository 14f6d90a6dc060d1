// Batched 1D star stencil with T fused sweeps, for sm_90a (H100).
//
// Replaces the TPU kernel repro/kernels/stencil1d/kernel.py:stencil1d_pallas,
// both variants: "vpu" (_vpu_body, a shift-FMA ladder) as stencil1d_vpu, and
// "mxu" (_mxu_body, each sweep as ext @ W_band) as stencil1d_mxu.
//
// What bounds it on the H100: device-memory bytes.  A launch reads the
// (B, N) grid once and writes it once; the 2r+1 taps and T sweeps are served
// from shared memory, so at r=8, T=1 a point costs 17 FMAs for 8 bytes of
// HBM traffic (f32), far below the card's 20 flop/byte balance.
//
// vpu: one thread block per (block_b rows, block_n columns) output tile.  It
// loads block_n + 2rT columns per row into shared memory as f32, zero
// outside [0, n) (the TPU kernel's clamped edge views and masks, and the
// host-side padding, are not needed), runs the T sweeps ping-ponging between
// two shared buffers, and writes block_n columns once, zeroing within rT of
// either end of the row and casting to the output type at the store.  Taps
// are summed k = 0..2r, skipping zero coefficients, as the JAX body does.
//
// mxu: the band product on the tensor cores, in 3xTF32.  A warp computes
// D[16 rows][8 columns] = X[16][K] . W[K][8] with
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, K = ceil8(8 + 2r), the band
// W[j][i] = c[j - i] for 0 <= j - i <= 2r and 0 elsewhere.  TF32 alone keeps
// about 3 decimal digits, so each operand is split into two TF32 parts
// (v = hi + lo, both by cvt.rna) and D = x_hi W_hi + (x_hi W_lo + x_lo W_hi):
// each kind of small product goes to an accumulator of its own (which also
// keeps the mma chains short), and their sum is added to the large one at
// the end; x_lo W_lo (2^-22 relative) is dropped.  bf16 is exact in
// TF32, so a bf16 grid's first sweep needs only the two products with x_hi.
// Like the TPU's _mxu_body, the product runs through the band's zeros, so a
// non-finite input reaches its tile's neighbours (the ladder skips zero taps).
//
// W is Toeplitz and the same for every tile, so the compile-time instances
// (NK = K/8 k-steps: 2 for r <= 4, 3 for r = 5..8, the paper's 17-pt among
// them) build its B fragments, hi and lo, once per thread into registers.
// A warp walks a run of 8-column tiles along its 16 rows; tile i0 + 8's
// k-step s is tile i0's k-step s + 1, so the split A fragments sit in a
// register window of NK k-steps and each tile loads and splits one new
// k-step (4 shared loads a thread).  Every other radius runs the generic
// instance, which reads every k-step's A fragment and the split band from
// shared memory.
//
// Loads: a tile (block_b rows, block_n + 2rT columns) arrives in shared
// memory in the grid's type by cp.async 16-byte chunks (zero-filled outside
// the row and past the batch; element by element where rows are not 16-byte
// aligned); bf16 is widened as a fragment is read.  Loads overlap the
// arithmetic through a ring of two tiles: a block is persistent (as many as
// fit the card) and walks tiles blockIdx.x, blockIdx.x + gridDim.x, ...;
// while it sums one tile the next one is in flight, and once it has summed
// a tile it starts loading the tile after next into the freed buffer.  Two
// blocks share an SM at the planned 16 x 512 tile in f32, four in bf16.
// Row strides are 16 bytes past a multiple of 128, so the fragment reads are
// free of bank conflicts.
//
// Stores: the D fragment gives a thread 2 adjacent columns of 2 rows.  The
// last sweep writes them, masked to the r*T rim and cast once, into an
// output tile in shared memory, which goes out in 16-byte chunks along the
// rows (a fragment written straight to global memory touches 16 rows in one
// store).  Fused sweeps (T > 1) write each
// sweep's f32 result to one of two shared buffers, which the next sweep
// reads as its A operand with all three products.  Rows of a tile past
// block_b (an mma takes 16) are zero and not stored.  No integer division or
// modulo runs in any loop.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

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

// ---- mxu: the band product on the tensor cores -----------------------------

constexpr int kMxuThreads = 128;
constexpr int kMxuWarps = kMxuThreads / 32;   // a power of two: a shift splits tiles

// One block's shared memory: the split band (generic instance), two raw
// tiles in the grid's type (the one being summed and the next one in
// flight), the output tile in the grid's type, and for T > 1 two f32 sweep
// buffers.  kernels/stencil1d/kernel.py:smem_bytes computes the same size.
struct MxuLayout {
  int rows;      // block_b rounded up to 16, an mma's rows
  int nk;        // k-steps of 8: K = 8 nk = ceil8(8 + 2r)
  int ph;        // the halo r*T rounded up to one 16-byte chunk
  int lw;        // columns loaded a row: global col0 - ph .. col0 - ph + lw - 1
  int sraw;      // raw row stride, elements of T
  int sout;      // output row stride, elements of T
  int sf;        // f32 buffer row stride, floats
  int coef;      // floats of each split band array (generic instance)
  size_t raw_bytes, out_bytes, bytes;
};

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

MxuLayout mxu_layout(int itemsize, int r, int steps, int block_b, int block_n) {
  MxuLayout L;
  L.rows = round_up(block_b, 16);
  L.nk = (8 + 2 * r + 7) / 8;
  L.ph = round_up(r * steps, 16 / itemsize);
  L.lw = round_up(2 * L.ph + block_n + 16, 16);
  // Row strides in 4-byte words, 4 past a multiple of 32 where a warp reads
  // or writes 4 bytes a lane at rows g = 0..7, 8 past where it writes 8.
  const int raw_words = round_up(L.lw * itemsize / 4, 32) + 4;
  const int out_words = round_up(round_up(block_n, 8) * itemsize / 4, 32)
                        + (itemsize == 4 ? 8 : 4);
  L.sraw = raw_words * 4 / itemsize;
  L.sout = out_words * 4 / itemsize;
  L.sf = round_up(L.lw, 32) + 4;
  L.coef = 8 * L.nk + 8;
  L.raw_bytes = (size_t)L.rows * raw_words * 4;
  L.out_bytes = (size_t)L.rows * out_words * 4;
  L.bytes = 4 * (size_t)(2 * L.coef) + 2 * L.raw_bytes + L.out_bytes
            + (steps > 1 ? 2 * (size_t)L.rows * L.sf * 4 : 0);
  return L;
}

struct MxuArgs {
  int64_t batch, n, tiles_n, tiles;
  int64_t step_rows, step_cols;   // gridDim.x tiles as whole rows of tiles + the rest
  int r, steps, block_b, block_n;
  int vec;    // 16-byte chunks: n and block_n multiples of one, x and y aligned
  MxuLayout L;
};

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(v));
  return u;
}

// v = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// d += a . b on the tensor cores (16 x 8 x 8, TF32 in, f32 out)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step's A fragment, split: p points at row g, column q of the k-step;
// a0..a3 are (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4).  kExact: the
// values are exact in TF32 (bf16), lo is not used.
struct AFrag {
  uint32_t hi[4], lo[4];
};

template <bool kExact, typename S>
__device__ __forceinline__ void load_a(const S* p, int stride8, AFrag& f) {
  const float v[4] = {to_f32(p[0]), to_f32(p[stride8]), to_f32(p[4]),
                      to_f32(p[stride8 + 4])};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (kExact) f.hi[i] = __float_as_uint(v[i]);
    else split_tf32(v[i], f.hi[i], f.lo[i]);
  }
}

// A tile's sums: the large products in d, each kind of small one apart
struct Acc {
  float d[4], e[4], l[4];
};

template <bool kExact>
__device__ __forceinline__ void mma_3x(Acc& c, const AFrag& f, uint32_t bh0, uint32_t bh1,
                                       uint32_t bl0, uint32_t bl1) {
  if constexpr (!kExact) mma_tf32(c.l, f.lo, bh0, bh1);
  mma_tf32(c.e, f.hi, bl0, bl1);
  mma_tf32(c.d, f.hi, bh0, bh1);
}

// Where a sweep writes: a shared f32 buffer (the next sweep's input), or for
// the last sweep the output tile, masked to the r*T rim and cast.
template <bool kLast, typename O>
struct Sink {
  O* buf;
  int stride;
  int64_t n, col0, halo;
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The tile whose output columns start at j0, rows r0..r0 + 15
template <bool kExact, bool kLast, typename O>
__device__ __forceinline__ void sink_tile(const Sink<kLast, O>& o, const Acc& c, int r0,
                                          int j0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int j = j0 + 2 * q;
  const int64_t gc = o.col0 + j;
  const bool m0 = kLast && (gc < o.halo || gc >= o.n - o.halo);
  const bool m1 = kLast && (gc + 1 < o.halo || gc + 1 >= o.n - o.halo);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = 2 * h + i;
      v[i] = c.d[k] + (kExact ? c.e[k] : c.e[k] + c.l[k]);
    }
    store2(o.buf + (r0 + g + 8 * h) * o.stride + j, m0 ? 0.f : v[0], m1 ? 0.f : v[1]);
  }
}

// One sweep of the compile-time instance: w output columns of rows
// 0..rows-1 from src (output column j reads src columns soff + j ..
// soff + j + 2r).  Each warp walks its run of 8-column tiles in every group
// of 16 rows, with the A fragments of NK k-steps in a register window whose
// slots rotate at compile time (the tile loop is unrolled NK times).
template <int NK, bool kExact, bool kLast, typename S, typename O>
__device__ void sweep_fixed(const S* src, int sstride, int soff, int w, int rows,
                            const uint32_t (&bh)[NK][2], const uint32_t (&bl)[NK][2],
                            const Sink<kLast, O>& o) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = (w + 7) >> 3;
  const int run = (tiles + kMxuWarps - 1) / kMxuWarps;    // a shift
  const int t0 = warp * run, t1 = min(t0 + run, tiles);
  if (t0 >= t1) return;
  for (int r0 = 0; r0 < rows; r0 += 16) {
    const S* sp = src + (r0 + (lane >> 2)) * sstride + soff + (lane & 3) + 8 * t0;
    AFrag win[NK];
#pragma unroll
    for (int s = 0; s < NK - 1; ++s) load_a<kExact>(sp + 8 * s, 8 * sstride, win[s]);
    for (int t = t0; t < t1; t += NK) {
#pragma unroll
      for (int p = 0; p < NK; ++p) {
        if (t + p < t1) {
          load_a<kExact>(sp + 8 * (t + p - t0 + NK - 1), 8 * sstride,
                         win[(p + NK - 1) % NK]);
          Acc c = {};
#pragma unroll
          for (int s = 0; s < NK; ++s)
            mma_3x<kExact>(c, win[(p + s) % NK], bh[s][0], bh[s][1], bl[s][0], bl[s][1]);
          sink_tile<kExact>(o, c, r0, 8 * (t + p));
        }
      }
    }
  }
}

// One sweep of the generic instance: every k-step's A fragment and the split
// band (chi, clo: W[8s + k][i] at index 8s + k - i + 8) from shared memory.
template <bool kExact, bool kLast, typename S, typename O>
__device__ void sweep_generic(const S* src, int sstride, int soff, int w, int rows,
                              int nk, const float* chi, const float* clo,
                              const Sink<kLast, O>& o) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int tiles = (w + 7) >> 3;
  const int run = (tiles + kMxuWarps - 1) / kMxuWarps;
  const int t0 = warp * run, t1 = min(t0 + run, tiles);
  for (int r0 = 0; r0 < rows; r0 += 16) {
    const S* sp = src + (r0 + g) * sstride + soff + q;
    for (int t = t0; t < t1; ++t) {
      Acc c = {};
      for (int s = 0; s < nk; ++s) {
        AFrag f;
        load_a<kExact>(sp + 8 * (t + s), 8 * sstride, f);
        const int ib = 8 * s + q - g + 8;
        mma_3x<kExact>(c, f, __float_as_uint(chi[ib]), __float_as_uint(chi[ib + 4]),
                       __float_as_uint(clo[ib]), __float_as_uint(clo[ib + 4]));
      }
      sink_tile<kExact>(o, c, r0, 8 * t);
    }
  }
}

template <int NK, bool kExact, bool kLast, typename S, typename O>
__device__ __forceinline__ void sweep(const S* src, int sstride, int soff, int w,
                                      int rows, const uint32_t (&bh)[NK > 0 ? NK : 1][2],
                                      const uint32_t (&bl)[NK > 0 ? NK : 1][2],
                                      const float* chi, const float* clo, int nk,
                                      const Sink<kLast, O>& o) {
  if constexpr (NK > 0)
    sweep_fixed<NK, kExact>(src, sstride, soff, w, rows, bh, bl, o);
  else
    sweep_generic<kExact>(src, sstride, soff, w, rows, nk, chi, clo, o);
}

// Start loading a raw tile: rows row0 .. row0 + L.rows - 1, global columns
// col0 - ph .. col0 - ph + lw - 1, zeros outside the row and past `rows`.
// With vec every 16-byte chunk is wholly inside or outside the row and goes
// by cp.async; else element by element.
template <typename T>
__device__ void load_raw(const T* __restrict__ x, T* raw, const MxuArgs& a,
                         int64_t row0, int rows, int64_t col0) {
  constexpr int E = 16 / sizeof(T);
  const int nch = a.L.lw / E;
  const int64_t g0 = col0 - a.L.ph;
  int rr = 0, c = threadIdx.x;          // chunk i = rr * nch + c
  while (c >= nch) { c -= nch; ++rr; }
  for (int i = threadIdx.x; i < a.L.rows * nch; i += kMxuThreads) {
    const int64_t gc = g0 + E * c;
    T* dst = raw + rr * a.L.sraw + E * c;
    const bool row_in = rr < rows;
    const T* src = x + (row0 + (row_in ? rr : 0)) * a.n + gc;
    if (a.vec) {
      const bool in = row_in && gc >= 0 && gc < a.n;
      cp_async16(smem_addr(dst), in ? src : x, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        dst[e] = (row_in && gc + e >= 0 && gc + e < a.n) ? src[e] : from_f32<T>(0.f);
    }
    c += kMxuThreads;
    while (c >= nch) { c -= nch; ++rr; }
  }
}

// Write the output tile's rows 0..rows-1, columns 0..block_n-1 that lie in
// the row: 16-byte chunks along the rows where vec, else element by element.
template <typename T>
__device__ void store_out(T* __restrict__ y, const T* out, const MxuArgs& a,
                          int64_t row0, int rows, int64_t col0) {
  constexpr int E = 16 / sizeof(T), kLogE = sizeof(T) == 4 ? 2 : 3;
  const int cols = a.n - col0 < a.block_n ? (int)(a.n - col0) : a.block_n;
  const int nch = a.vec ? cols >> kLogE : cols;   // vec: cols is a multiple of E
  int rr = 0, c = threadIdx.x;
  while (c >= nch) { c -= nch; ++rr; }
  for (int i = threadIdx.x; i < rows * nch; i += kMxuThreads) {
    T* dst = y + (row0 + rr) * a.n + col0;
    const T* src = out + rr * a.L.sout;
    if (a.vec)
      *reinterpret_cast<uint4*>(dst + E * c) = *reinterpret_cast<const uint4*>(src + E * c);
    else
      dst[c] = src[c];
    c += kMxuThreads;
    while (c >= nch) { c -= nch; ++rr; }
  }
}

// NK > 0: the compile-time instance with NK k-steps; NK == 0: generic.  A
// block walks the tiles blockIdx.x, blockIdx.x + gridDim.x, ...: while it
// sums one tile, the next one's loads are in flight into the other raw
// buffer; once it has summed a tile, it starts loading the tile after next
// into that buffer and then stores the output tile.
template <typename T, int NK>
__global__ void __launch_bounds__(kMxuThreads, 4)
stencil1d_mxu_kernel(const T* __restrict__ x, T* __restrict__ y,
                     const float* __restrict__ coeffs, const MxuArgs a) {
  extern __shared__ uint4 smem4[];
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int NB = NK > 0 ? NK : 1;
  const MxuLayout& L = a.L;
  float* chi = reinterpret_cast<float*>(smem4);
  float* clo = chi + L.coef;
  char* base = reinterpret_cast<char*>(clo + L.coef);
  T* raw0 = reinterpret_cast<T*>(base);
  T* raw1 = reinterpret_cast<T*>(base + L.raw_bytes);
  T* out = reinterpret_cast<T*>(base + 2 * L.raw_bytes);
  float* f0 = reinterpret_cast<float*>(base + 2 * L.raw_bytes + L.out_bytes);
  float* f1 = f0 + L.rows * L.sf;

  int64_t tile = blockIdx.x;
  if (tile >= a.tiles) return;
  int64_t rt = tile / a.tiles_n, ct = tile - rt * a.tiles_n;   // the tile summed
  int64_t lt = tile, lrt = rt, lct = ct;                        // the next one loaded
  // Start loading tile lt into buf (nothing past the last tile) as one
  // cp.async group, and step lt on by the grid.
  auto issue = [&](T* buf) {
    if (lt < a.tiles)
      load_raw(x, buf, a, lrt * a.block_b, rows_left(a.batch, lrt * a.block_b, a.block_b),
               lct * a.block_n);
    cp_async_commit();
    lt += gridDim.x;
    lrt += a.step_rows;
    lct += a.step_cols;
    if (lct >= a.tiles_n) { lct -= a.tiles_n; ++lrt; }
  };
  issue(raw0);
  issue(raw1);

  const int r = a.r, halo = r * a.steps;
  if (a.steps > 1) {   // columns the sweeps read past those they write stay 0
    for (int i = threadIdx.x; i < 2 * L.rows * L.sf; i += kMxuThreads) f0[i] = 0.f;
  }
  uint32_t bh[NB][2], bl[NB][2];
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  if constexpr (NK > 0) {
#pragma unroll
    for (int s = 0; s < NK; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 8 * s + q + 4 * h - g;       // W[8s + q + 4h][g] = c[k]
        split_tf32(k >= 0 && k <= 2 * r ? coeffs[k] : 0.f, bh[s][h], bl[s][h]);
      }
  } else {
    for (int i = threadIdx.x; i < L.coef; i += kMxuThreads) {
      const int k = i - 8;
      uint32_t hi, lo;
      split_tf32(k >= 0 && k <= 2 * r ? coeffs[k] : 0.f, hi, lo);
      chi[i] = __uint_as_float(hi);
      clo[i] = __uint_as_float(lo);
    }
  }

  const int soff = L.ph - halo;
  for (; tile < a.tiles; tile += gridDim.x) {
    const int64_t row0 = rt * a.block_b, col0 = ct * a.block_n;
    const int rows = rows_left(a.batch, row0, a.block_b);
    cp_async_wait_group<1>();   // all but the newest group: this tile has landed
    __syncthreads();

    const Sink<true, T> last{out, L.sout, a.n, col0, halo};
    int w = a.block_n + 2 * halo - 2 * r;          // sweep 1's output columns
    if (a.steps == 1) {
      sweep<NK, kBf16>(raw0, L.sraw, soff, w, rows, bh, bl, chi, clo, L.nk, last);
    } else {
      Sink<false, float> buf{f0, L.sf, a.n, col0, halo};
      sweep<NK, kBf16>(raw0, L.sraw, soff, w, rows, bh, bl, chi, clo, L.nk, buf);
      __syncthreads();
      for (int s = 2; s < a.steps; ++s) {
        w -= 2 * r;
        const float* in = buf.buf;
        buf.buf = in == f0 ? f1 : f0;
        sweep<NK, false>(in, L.sf, 0, w, rows, bh, bl, chi, clo, L.nk, buf);
        __syncthreads();
      }
      w -= 2 * r;
      sweep<NK, false>(buf.buf, L.sf, 0, w, rows, bh, bl, chi, clo, L.nk, last);
    }
    __syncthreads();
    issue(raw0);   // the tile after next, into the buffer just summed
    store_out(y, out, a, row0, rows, col0);
    T* t = raw0;   // the tile in flight is summed next
    raw0 = raw1;
    raw1 = t;
    rt += a.step_rows;
    ct += a.step_cols;
    if (ct >= a.tiles_n) { ct -= a.tiles_n; ++rt; }
  }
}

template <typename T, int NK>
cudaError_t launch_mxu_nk(const void* x, void* y, const void* coeffs, MxuArgs a,
                          size_t smem, cudaStream_t stream) {
  const void* kernel = (const void*)stencil1d_mxu_kernel<T, NK>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMxuThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t blocks = std::min<int64_t>(a.tiles, (int64_t)sms * per_sm);
  a.step_rows = blocks / a.tiles_n;
  a.step_cols = blocks - a.step_rows * a.tiles_n;
  stencil1d_mxu_kernel<T, NK><<<(unsigned)blocks, kMxuThreads, smem, stream>>>(
      (const T*)x, (T*)y, (const float*)coeffs, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mxu(const void* x, void* y, const void* coeffs, int64_t batch,
                       int64_t n, int r, int steps, int block_b, int block_n,
                       size_t smem, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  MxuArgs a;
  a.batch = batch;
  a.n = n;
  a.tiles_n = (n + block_n - 1) / block_n;
  a.tiles = a.tiles_n * ((batch + block_b - 1) / block_b);
  a.r = r;
  a.steps = steps;
  a.block_b = block_b;
  a.block_n = block_n;
  a.vec = n % E == 0 && block_n % E == 0 && (uintptr_t)x % 16 == 0
          && (uintptr_t)y % 16 == 0;
  a.L = mxu_layout(sizeof(T), r, steps, block_b, block_n);
  if (smem != a.L.bytes) return cudaErrorInvalidValue;   // the host's layout differs
  if (a.L.nk == 2) return launch_mxu_nk<T, 2>(x, y, coeffs, a, smem, stream);
  if (a.L.nk == 3) return launch_mxu_nk<T, 3>(x, y, coeffs, a, smem, stream);
  return launch_mxu_nk<T, 0>(x, y, coeffs, a, smem, stream);
}

template <typename T>
cudaError_t launch(bool mxu, const void* x, void* y, const void* coeffs,
                   int64_t batch, int64_t n, int r, int steps, int block_b,
                   int block_n, size_t smem, cudaStream_t stream) {
  if (mxu)
    return launch_mxu<T>(x, y, coeffs, batch, n, r, steps, block_b, block_n, smem, stream);
  const int64_t tiles_n = (n + block_n - 1) / block_n;
  const int64_t tiles = tiles_n * ((batch + block_b - 1) / block_b);
  if (tiles > INT32_MAX) return cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)stencil1d_vpu_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  stencil1d_vpu_kernel<T><<<(unsigned)tiles, kThreads, smem, stream>>>(
      (const T*)x, (T*)y, (const float*)coeffs, batch, n, r, steps, block_b,
      block_n, tiles_n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x, y: (batch, n) contiguous on the
// device; coeffs: 2r+1 float32 on the device; smem: dynamic shared memory of
// one tile, as kernels/stencil1d/kernel.py:smem_bytes lays it out (mxu
// refuses any other size).  Returns cudaGetLastError().
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
