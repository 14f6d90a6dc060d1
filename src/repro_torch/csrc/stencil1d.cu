// Batched 1D star stencil with T fused sweeps, for sm_90a (H100).
//
// Replaces the TPU kernel repro/kernels/stencil1d/kernel.py:stencil1d_pallas,
// both variants: "vpu" (_vpu_body, a shift-FMA ladder) as stencil1d_vpu, and
// "mxu" (_mxu_body, each sweep as ext @ W_band) as stencil1d_mxu.
//
// What bounds it on the H100: device-memory bytes.  A launch reads the
// (B, N) grid once and writes it once; the 2r+1 taps and T sweeps are served
// from shared memory and registers, so at r=8, T=1 a point costs 17 FMAs for
// 8 bytes of HBM traffic (f32), below the card's 20 flop/byte balance.
//
// The memory pipeline, shared by both variants (walk_tiles): a block is
// persistent (as many as fit the card) and walks the (block_b rows, block_n
// columns) output tiles blockIdx.x, blockIdx.x + gridDim.x, ...  A tile's
// input (block_n + 2rT columns a row) arrives in shared memory in the grid's
// type by cp.async 16-byte chunks (zero-filled outside the row and past the
// batch; element by element where rows are not 16-byte aligned) through a
// ring of two tiles: while a block sums one tile the next one is in flight,
// and once it has summed a tile it starts loading the tile after next into
// the freed buffer.  bf16 is widened as it is read.  The last sweep writes,
// masked to the r*T rim and cast once, an output tile in shared memory that
// goes out in 16-byte chunks along the rows.  Fused sweeps (T > 1) write
// each sweep's f32 result to one of two shared buffers, which the next sweep
// reads.  No integer division or modulo runs in any loop.
//
// vpu: the ladder from registers.  In the compile-time instance (r = 8 with
// every tap non-zero: the paper's 17-pt) a thread owns a run of outputs, one
// 16-byte chunk of its source's row (4 outputs from f32, 8 from bf16): it
// reads the run's window of run + 2r inputs in 16-byte loads, widens it to
// f32 in registers and sums the 17 taps there, with no shared load, test or
// coefficient load per tap; the taps sit in registers, loaded once per
// thread.  Consecutive lanes own consecutive runs, so the eight lanes of a
// 16-byte shared access phase read 128 contiguous bytes: no bank conflict,
// where runs of 32 bytes (8 f32) would collide two ways.  r*T is a multiple
// of a chunk at r = 8, so the windows are aligned.  Every other radius or
// tap pattern runs the generic instance, over the non-zero taps compacted on
// the host to (offset, value) pairs: a lane makes 8 outputs 32 columns
// apart, one shared load and one FMA a tap and output.  Zero taps are
// skipped, as the JAX body skips them, so an infinite input never reaches an
// output through a zero tap.
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
// shared memory.  Tile rows round up to an mma's 16 (zeros, not stored).
// Two blocks share an SM at the planned 16 x 512 tile in f32, four in bf16.
// Raw row strides are 16 bytes past a multiple of 128, so the fragment reads
// are free of bank conflicts.  The D fragment gives a thread 2 adjacent
// columns of 2 rows, which it writes to the output tile (a fragment written
// straight to global memory touches 16 rows in one store).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ int rows_left(int64_t batch, int64_t row0, int block_b) {
  const int64_t left = batch - row0;
  return left < block_b ? (int)left : block_b;
}

// ---- the memory pipeline of both variants ----------------------------------

// One block's shared memory: a head (vpu: the compacted taps; mxu: the split
// band of the generic instance), two raw tiles in the grid's type (the one
// being summed and the next one in flight), the output tile in the grid's
// type, and for T > 1 two f32 sweep buffers.
// kernels/stencil1d/kernel.py:smem_bytes computes the same size.
struct TileLayout {
  int rows;      // tile rows in shared memory (mxu: block_b rounded up to 16)
  int ph;        // the halo r*T rounded up to one 16-byte chunk
  int lw;        // columns loaded a row: global col0 - ph .. col0 - ph + lw - 1
  int sraw;      // raw row stride, elements of T
  int sout;      // output row stride, elements of T
  int sf;        // f32 buffer row stride, floats
  int head;      // bytes before the raw tiles, a multiple of 16
  size_t raw_bytes, out_bytes, bytes;
};

TileLayout tile_layout(int itemsize, int steps, int rows, int ph, int lw, int block_n,
                       int head) {
  TileLayout L;
  L.rows = rows;
  L.ph = ph;
  L.lw = lw;
  L.head = head;
  // Row strides in 4-byte words, 4 past a multiple of 32 where mxu's warp
  // reads or writes 4 bytes a lane at rows g = 0..7, 8 past where it writes 8.
  const int raw_words = round_up(lw * itemsize / 4, 32) + 4;
  const int out_words = round_up(round_up(block_n, 8) * itemsize / 4, 32)
                        + (itemsize == 4 ? 8 : 4);
  L.sraw = raw_words * 4 / itemsize;
  L.sout = out_words * 4 / itemsize;
  L.sf = round_up(lw, 32) + 4;
  L.raw_bytes = (size_t)rows * raw_words * 4;
  L.out_bytes = (size_t)rows * out_words * 4;
  L.bytes = head + 2 * L.raw_bytes + L.out_bytes
            + (steps > 1 ? 2 * (size_t)rows * L.sf * 4 : 0);
  return L;
}

int chunk_halo(int itemsize, int r, int steps) {
  return round_up(r * steps, 16 / itemsize);
}

__host__ __device__ inline int mxu_nk(int r) { return (8 + 2 * r + 7) / 8; }  // K = 8 nk

// mxu: rows rounded up to 16, lw = ceil16(2 ph + block_n + 16) (the k-steps
// of the last 8-column tile read past block_n + 2 ph), and the split band.
TileLayout mxu_layout(int itemsize, int r, int steps, int block_b, int block_n) {
  const int ph = chunk_halo(itemsize, r, steps);
  const int coef = 8 * mxu_nk(r) + 8;   // floats of each split band array
  return tile_layout(itemsize, steps, round_up(block_b, 16), ph,
                     round_up(2 * ph + block_n + 16, 16), block_n, 2 * coef * 4);
}

// vpu: block_b rows, the columns a tile needs rounded up to a chunk, and
// 2r+1 (offset, value) pairs of taps.
TileLayout vpu_layout(int itemsize, int r, int steps, int block_b, int block_n) {
  const int ph = chunk_halo(itemsize, r, steps);
  return tile_layout(itemsize, steps, block_b, ph,
                     round_up(ph + block_n + r * steps, 16 / itemsize), block_n,
                     round_up(8 * (2 * r + 1), 16));
}

struct TileArgs {
  int64_t batch, n, tiles_n, tiles;
  int64_t step_rows, step_cols;   // gridDim.x tiles as whole rows of tiles + the rest
  int r, steps, block_b, block_n;
  int vec;    // 16-byte chunks: n and block_n multiples of one, x and y aligned
  TileLayout L;
};

template <typename T>
TileArgs tile_args(const void* x, const void* y, int64_t batch, int64_t n, int r, int steps,
                   int block_b, int block_n, const TileLayout& L) {
  constexpr int E = 16 / sizeof(T);
  TileArgs a;
  a.batch = batch;
  a.n = n;
  a.tiles_n = (n + block_n - 1) / block_n;
  a.tiles = a.tiles_n * ((batch + block_b - 1) / block_b);
  a.step_rows = a.step_cols = 0;
  a.r = r;
  a.steps = steps;
  a.block_b = block_b;
  a.block_n = block_n;
  a.vec = n % E == 0 && block_n % E == 0 && (uintptr_t)x % 16 == 0
          && (uintptr_t)y % 16 == 0;
  a.L = L;
  return a;
}

// Start loading a raw tile: rows row0 .. row0 + L.rows - 1, global columns
// col0 - ph .. col0 - ph + lw - 1, zeros outside the row and past `rows`.
// With vec every 16-byte chunk is wholly inside or outside the row and goes
// by cp.async; else element by element.
template <int kThreads, typename T>
__device__ void load_raw(const T* __restrict__ x, T* raw, const TileArgs& a,
                         int64_t row0, int rows, int64_t col0) {
  constexpr int E = 16 / sizeof(T);
  const int nch = a.L.lw / E;
  const int64_t g0 = col0 - a.L.ph;
  int rr = 0, c = threadIdx.x;          // chunk i = rr * nch + c
  while (c >= nch) { c -= nch; ++rr; }
  for (int i = threadIdx.x; i < a.L.rows * nch; i += kThreads) {
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
    c += kThreads;
    while (c >= nch) { c -= nch; ++rr; }
  }
}

// Write the output tile's rows 0..rows-1, columns 0..block_n-1 that lie in
// the row: 16-byte chunks along the rows where vec, else element by element.
template <int kThreads, typename T>
__device__ void store_out(T* __restrict__ y, const T* out, const TileArgs& a,
                          int64_t row0, int rows, int64_t col0) {
  constexpr int E = 16 / sizeof(T), kLogE = sizeof(T) == 4 ? 2 : 3;
  const int cols = a.n - col0 < a.block_n ? (int)(a.n - col0) : a.block_n;
  const int nch = a.vec ? cols >> kLogE : cols;   // vec: cols is a multiple of E
  int rr = 0, c = threadIdx.x;
  while (c >= nch) { c -= nch; ++rr; }
  for (int i = threadIdx.x; i < rows * nch; i += kThreads) {
    T* dst = y + (row0 + rr) * a.n + col0;
    const T* src = out + rr * a.L.sout;
    if (a.vec)
      *reinterpret_cast<uint4*>(dst + E * c) = *reinterpret_cast<const uint4*>(src + E * c);
    else
      dst[c] = src[c];
    c += kThreads;
    while (c >= nch) { c -= nch; ++rr; }
  }
}

// The tile walk.  prologue() runs once the first two tiles' loads are in
// flight; then each tile, once its loads have landed, is summed by
// sum(raw, out, rows, col0) (raw: its input tile; out: the output tile to
// fill), after which the tile after next starts loading into the freed
// buffer and the output tile goes out.
template <int kThreads, typename T, typename Prologue, typename Sum>
__device__ __forceinline__ void walk_tiles(const T* __restrict__ x, T* __restrict__ y,
                                           const TileArgs& a, char* smem,
                                           Prologue&& prologue, Sum&& sum) {
  const TileLayout& L = a.L;
  T* raw0 = reinterpret_cast<T*>(smem + L.head);
  T* raw1 = reinterpret_cast<T*>(smem + L.head + L.raw_bytes);
  T* out = reinterpret_cast<T*>(smem + L.head + 2 * L.raw_bytes);

  int64_t tile = blockIdx.x;
  if (tile >= a.tiles) return;
  int64_t rt = tile / a.tiles_n, ct = tile - rt * a.tiles_n;   // the tile summed
  int64_t lt = tile, lrt = rt, lct = ct;                        // the next one loaded
  // Start loading tile lt into buf (nothing past the last tile) as one
  // cp.async group, and step lt on by the grid.
  auto issue = [&](T* buf) {
    if (lt < a.tiles)
      load_raw<kThreads>(x, buf, a, lrt * a.block_b,
                         rows_left(a.batch, lrt * a.block_b, a.block_b), lct * a.block_n);
    cp_async_commit();
    lt += gridDim.x;
    lrt += a.step_rows;
    lct += a.step_cols;
    if (lct >= a.tiles_n) { lct -= a.tiles_n; ++lrt; }
  };
  issue(raw0);
  issue(raw1);
  prologue();

  for (; tile < a.tiles; tile += gridDim.x) {
    const int64_t row0 = rt * a.block_b, col0 = ct * a.block_n;
    const int rows = rows_left(a.batch, row0, a.block_b);
    cp_async_wait_group<1>();   // all but the newest group: this tile has landed
    __syncthreads();
    sum(static_cast<const T*>(raw0), out, rows, col0);
    __syncthreads();
    issue(raw0);   // the tile after next, into the buffer just summed
    store_out<kThreads>(y, out, a, row0, rows, col0);
    T* t = raw0;   // the tile in flight is summed next
    raw0 = raw1;
    raw1 = t;
    rt += a.step_rows;
    ct += a.step_cols;
    if (ct >= a.tiles_n) { ct -= a.tiles_n; ++rt; }
  }
}

// Launch a persistent kernel: as many blocks as fit the card at once (no
// more than the tiles), each walking every gridDim.x-th tile.
template <typename... P, typename... A>
cudaError_t launch_persistent(void (*kernel)(P...), int threads, TileArgs a, size_t smem,
                              cudaStream_t stream, A... args) {
  const void* k = (const void*)kernel;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t blocks = std::min<int64_t>(a.tiles, (int64_t)sms * per_sm);
  a.step_rows = blocks / a.tiles_n;
  a.step_cols = blocks - a.step_rows * a.tiles_n;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(args..., a);
  return cudaGetLastError();
}

// Where a sweep writes: a shared f32 buffer (the next sweep's input), or for
// the last sweep the output tile, masked to the r*T rim and cast.
template <bool kLast, typename O>
struct Sink {
  O* buf;
  int stride;
  int64_t n, col0, halo;
};

// ---- vpu: the shift-FMA ladder from registers ------------------------------

constexpr int kVpuThreads = 256;
constexpr int kVpuWarps = kVpuThreads / 32;
constexpr int kVpuRadius = 8;   // the compile-time instance: the paper's 17-pt
// Its halo r*T is a multiple of a 16-byte chunk (4 f32, 8 bf16) at every T,
// so its runs' windows start on a chunk.
static_assert(kVpuRadius % 8 == 0, "the compile-time instance needs aligned windows");
constexpr int kGroup = 8;       // generic: outputs a lane makes at once, 32 apart
static_assert(32 * kGroup == 256, "vpu_sweep_generic walks 256-column blocks");

// A 16-byte chunk of shared memory to E floats
__device__ __forceinline__ void load_chunk(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float* v) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // a bf16 is the high half of its f32
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// A run's E outputs to p (16-byte aligned for f32, 8 or 16 for bf16)
__device__ __forceinline__ void store_run(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_run(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store_run(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}
__device__ __forceinline__ void store_run(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                            pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

// Output column j of the tile lies within r*T of either end of the row
template <bool kLast, typename O>
__device__ __forceinline__ bool in_rim(const Sink<kLast, O>& o, int64_t j) {
  const int64_t gc = o.col0 + j;
  return kLast && (gc < o.halo || gc >= o.n - o.halo);
}

// One sweep of the compile-time instance: w output columns of rows
// 0..rows-1 from src (output column j reads src columns j .. j + 2R).  A run
// is E = 16 / sizeof(S) outputs; a thread takes runs tid, tid + kVpuThreads,
// ... of the rows in order.  Runs past w compute columns that no one reads
// and the store does not write.
template <int R, typename S, bool kLast, typename O>
__device__ void vpu_sweep_fixed(const S* src, int sstride, int w, int rows,
                                const float (&c)[2 * R + 1], const Sink<kLast, O>& o) {
  constexpr int E = 16 / sizeof(S), kLogE = E == 4 ? 2 : 3;
  constexpr int NCH = (2 * R + 2 * E - 1) / E;   // chunks of a window of E + 2R
  const int nr = (w + E - 1) >> kLogE;           // runs a row
  int rr = 0, q = threadIdx.x;
  while (q >= nr) { q -= nr; ++rr; }
  while (rr < rows) {
    const S* p = src + rr * sstride + E * q;
    float v[NCH * E];
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) load_chunk(p + E * ch, v + E * ch);
    float acc[E];
#pragma unroll
    for (int i = 0; i < E; ++i) acc[i] = c[0] * v[i];
#pragma unroll
    for (int k = 1; k <= 2 * R; ++k)
#pragma unroll
      for (int i = 0; i < E; ++i) acc[i] = fmaf(c[k], v[i + k], acc[i]);
    const int j = E * q;
    if (kLast && (in_rim(o, j) || in_rim(o, j + E - 1))) {
#pragma unroll
      for (int i = 0; i < E; ++i)
        if (in_rim(o, j + i)) acc[i] = 0.f;
    }
    store_run(o.buf + rr * o.stride + j, acc);
    q += kVpuThreads;
    while (q >= nr) { q -= nr; ++rr; }
  }
}

// One sweep of the generic instance over the m non-zero taps (offset,
// value bits) in shared memory: output column j reads src column soff + j +
// offset.  A warp takes the 256-column blocks of the rows in turn; a lane
// makes the block's columns lane, lane + 32, ..., lane + 224 (in a row's
// last block, columns past w read column w - 1 and are not written).
template <typename S, bool kLast, typename O>
__device__ void vpu_sweep_generic(const S* src, int sstride, int soff, int w, int rows,
                                  const int2* taps, int m, const Sink<kLast, O>& o) {
  const int lane = threadIdx.x & 31;
  const int nb = (w + 255) >> 8;   // 256-column blocks a row
  int rr = 0, b = threadIdx.x >> 5;
  while (b >= nb) { b -= nb; ++rr; }
  while (rr < rows) {
    const int j0 = (b << 8) + lane;
    const S* p = src + rr * sstride + soff;
    float acc[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) acc[i] = 0.f;
    if ((b << 8) + 256 <= w) {   // a whole block: one address a tap
      for (int k = 0; k < m; ++k) {
        const int2 t = taps[k];
        const float ck = __int_as_float(t.y);
        const S* pk = p + j0 + t.x;
#pragma unroll
        for (int i = 0; i < kGroup; ++i) acc[i] = fmaf(ck, to_f32(pk[32 * i]), acc[i]);
      }
    } else {
      int col[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) col[i] = min(j0 + 32 * i, w - 1);
      for (int k = 0; k < m; ++k) {
        const int2 t = taps[k];
        const float ck = __int_as_float(t.y);
#pragma unroll
        for (int i = 0; i < kGroup; ++i) acc[i] = fmaf(ck, to_f32(p[col[i] + t.x]), acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int j = j0 + 32 * i;
      if (j < w) o.buf[rr * o.stride + j] = from_f32<O>(in_rim(o, j) ? 0.f : acc[i]);
    }
    b += kVpuWarps;
    while (b >= nb) { b -= nb; ++rr; }
  }
}

template <int R, typename S, bool kLast, typename O>
__device__ __forceinline__ void vpu_sweep(const S* src, int sstride, int soff, int w,
                                          int rows, const float (&c)[R > 0 ? 2 * R + 1 : 1],
                                          const int2* taps, int m, const Sink<kLast, O>& o) {
  if constexpr (R > 0)
    vpu_sweep_fixed<R>(src, sstride, w, rows, c, o);
  else
    vpu_sweep_generic(src, sstride, soff, w, rows, taps, m, o);
}

// R > 0: the compile-time instance of radius R (all 2R+1 taps non-zero, so
// taps[k] is tap k); R == 0: generic.  taps: m (offset, value bits) pairs.
template <typename T, int R>
__global__ void __launch_bounds__(kVpuThreads, 2)
stencil1d_vpu_kernel(const T* __restrict__ x, T* __restrict__ y,
                     const int2* __restrict__ taps, int m, const TileArgs a) {
  extern __shared__ uint4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const TileLayout& L = a.L;
  int2* stap = reinterpret_cast<int2*>(smem);
  float* f0 = reinterpret_cast<float*>(smem + L.head + 2 * L.raw_bytes + L.out_bytes);
  float* f1 = f0 + L.rows * L.sf;
  const int r = a.r, halo = r * a.steps, soff = L.ph - halo;
  float c[R > 0 ? 2 * R + 1 : 1];

  walk_tiles<kVpuThreads>(x, y, a, smem, [&] {
    if constexpr (R > 0) {
#pragma unroll
      for (int k = 0; k <= 2 * R; ++k) c[k] = __int_as_float(taps[k].y);
    } else {
      for (int k = threadIdx.x; k < m; k += kVpuThreads) stap[k] = taps[k];
    }
  }, [&](const T* raw, T* out, int rows, int64_t col0) {
    const Sink<true, T> last{out, L.sout, a.n, col0, halo};
    int w = a.block_n + 2 * halo - 2 * r;          // sweep 1's output columns
    if (a.steps == 1) {
      vpu_sweep<R>(raw, L.sraw, soff, w, rows, c, stap, m, last);
      return;
    }
    Sink<false, float> buf{f0, L.sf, a.n, col0, halo};
    vpu_sweep<R>(raw, L.sraw, soff, w, rows, c, stap, m, buf);
    __syncthreads();
    for (int s = 2; s < a.steps; ++s) {
      w -= 2 * r;
      const float* in = buf.buf;
      buf.buf = in == f0 ? f1 : f0;
      vpu_sweep<R>(in, L.sf, 0, w, rows, c, stap, m, buf);
      __syncthreads();
    }
    w -= 2 * r;
    vpu_sweep<R>(static_cast<const float*>(buf.buf), L.sf, 0, w, rows, c, stap, m, last);
  });
}

// ---- mxu: the band product on the tensor cores -----------------------------

constexpr int kMxuThreads = 128;
constexpr int kMxuWarps = kMxuThreads / 32;   // a power of two: a shift splits tiles

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

// NK > 0: the compile-time instance with NK k-steps; NK == 0: generic.
template <typename T, int NK>
__global__ void __launch_bounds__(kMxuThreads, 4)
stencil1d_mxu_kernel(const T* __restrict__ x, T* __restrict__ y,
                     const float* __restrict__ coeffs, const TileArgs a) {
  extern __shared__ uint4 smem4[];
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int NB = NK > 0 ? NK : 1;
  char* smem = reinterpret_cast<char*>(smem4);
  const TileLayout& L = a.L;
  const int nk = mxu_nk(a.r), coef = 8 * nk + 8;
  float* chi = reinterpret_cast<float*>(smem);
  float* clo = chi + coef;
  float* f0 = reinterpret_cast<float*>(smem + L.head + 2 * L.raw_bytes + L.out_bytes);
  float* f1 = f0 + L.rows * L.sf;

  const int r = a.r, halo = r * a.steps;
  uint32_t bh[NB][2], bl[NB][2];
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int soff = L.ph - halo;
  walk_tiles<kMxuThreads>(x, y, a, smem, [&] {
    if (a.steps > 1) {   // columns the sweeps read past those they write stay 0
      for (int i = threadIdx.x; i < 2 * L.rows * L.sf; i += kMxuThreads) f0[i] = 0.f;
    }
    if constexpr (NK > 0) {
#pragma unroll
      for (int s = 0; s < NK; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 8 * s + q + 4 * h - g;       // W[8s + q + 4h][g] = c[k]
          split_tf32(k >= 0 && k <= 2 * r ? coeffs[k] : 0.f, bh[s][h], bl[s][h]);
        }
    } else {
      for (int i = threadIdx.x; i < coef; i += kMxuThreads) {
        const int k = i - 8;
        uint32_t hi, lo;
        split_tf32(k >= 0 && k <= 2 * r ? coeffs[k] : 0.f, hi, lo);
        chi[i] = __uint_as_float(hi);
        clo[i] = __uint_as_float(lo);
      }
    }
  }, [&](const T* raw, T* out, int rows, int64_t col0) {
    const Sink<true, T> last{out, L.sout, a.n, col0, halo};
    int w = a.block_n + 2 * halo - 2 * r;          // sweep 1's output columns
    if (a.steps == 1) {
      sweep<NK, kBf16>(raw, L.sraw, soff, w, rows, bh, bl, chi, clo, nk, last);
    } else {
      Sink<false, float> buf{f0, L.sf, a.n, col0, halo};
      sweep<NK, kBf16>(raw, L.sraw, soff, w, rows, bh, bl, chi, clo, nk, buf);
      __syncthreads();
      for (int s = 2; s < a.steps; ++s) {
        w -= 2 * r;
        const float* in = buf.buf;
        buf.buf = in == f0 ? f1 : f0;
        sweep<NK, false>(in, L.sf, 0, w, rows, bh, bl, chi, clo, nk, buf);
        __syncthreads();
      }
      w -= 2 * r;
      sweep<NK, false>(buf.buf, L.sf, 0, w, rows, bh, bl, chi, clo, nk, last);
    }
  });
}

// ---- launchers --------------------------------------------------------------

template <typename T>
cudaError_t launch_mxu(const void* x, void* y, const void* coeffs, int64_t batch,
                       int64_t n, int r, int steps, int block_b, int block_n,
                       size_t smem, cudaStream_t stream) {
  const TileArgs a = tile_args<T>(x, y, batch, n, r, steps, block_b, block_n,
                                  mxu_layout(sizeof(T), r, steps, block_b, block_n));
  if (smem != a.L.bytes) return cudaErrorInvalidValue;   // the host's layout differs
  const T* xt = (const T*)x;
  T* yt = (T*)y;
  const float* c = (const float*)coeffs;
  switch (mxu_nk(r)) {
    case 2: return launch_persistent(stencil1d_mxu_kernel<T, 2>, kMxuThreads, a, smem, stream, xt, yt, c);
    case 3: return launch_persistent(stencil1d_mxu_kernel<T, 3>, kMxuThreads, a, smem, stream, xt, yt, c);
    default: return launch_persistent(stencil1d_mxu_kernel<T, 0>, kMxuThreads, a, smem, stream, xt, yt, c);
  }
}

template <typename T>
cudaError_t launch_vpu(int inst, const void* x, void* y, const void* taps, int m,
                       int64_t batch, int64_t n, int r, int steps, int block_b,
                       int block_n, size_t smem, cudaStream_t stream) {
  const TileArgs a = tile_args<T>(x, y, batch, n, r, steps, block_b, block_n,
                                  vpu_layout(sizeof(T), r, steps, block_b, block_n));
  if (smem != a.L.bytes) return cudaErrorInvalidValue;   // the host's layout differs
  const T* xt = (const T*)x;
  T* yt = (T*)y;
  const int2* tp = (const int2*)taps;
  if (inst == kVpuRadius)
    return launch_persistent(stencil1d_vpu_kernel<T, kVpuRadius>, kVpuThreads, a, smem, stream,
                             xt, yt, tp, m);
  return launch_persistent(stencil1d_vpu_kernel<T, 0>, kVpuThreads, a, smem, stream, xt, yt,
                           tp, m);
}

}  // namespace

extern "C" {

// mxu: 1 runs K2 (coeffs: the 2r+1 taps, float32, ntaps = 2r+1; inst 0), 0
// runs K1 (coeffs: the ntaps non-zero taps as (int32 offset, float32 value)
// pairs in ascending order; inst: 8 for the compile-time instance, r = 8
// with all 17 taps non-zero, else 0 for the generic one, as
// kernels/stencil1d/kernel.py:instance picks it).  dtype: 0 = float32,
// 1 = bfloat16.  x, y: (batch, n) contiguous on the device; coeffs on the
// device.  smem: dynamic shared memory of one block, as
// kernels/stencil1d/kernel.py:smem_bytes lays it out.  Any other size, or an
// instance that does not fit the taps, is refused (cudaErrorInvalidValue).
// Returns cudaGetLastError().
int stencil1d_launch(int mxu, int inst, const void* x, void* y, const void* coeffs,
                     int ntaps, int dtype, int64_t batch, int64_t n, int r, int steps,
                     int block_b, int block_n, size_t smem, void* stream) {
  const bool bad_taps =
      mxu ? inst != 0 || ntaps != 2 * r + 1
          : ntaps < 0 || ntaps > 2 * r + 1
                || (inst != 0 && (inst != kVpuRadius || r != inst || ntaps != 2 * r + 1));
  if (r < 0 || steps < 1 || block_b < 1 || block_n < 1 || bad_taps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return mxu ? launch_mxu<float>(x, y, coeffs, batch, n, r, steps, block_b, block_n, smem, s)
               : launch_vpu<float>(inst, x, y, coeffs, ntaps, batch, n, r, steps, block_b,
                                   block_n, smem, s);
  if (dtype == 1)
    return mxu ? launch_mxu<__nv_bfloat16>(x, y, coeffs, batch, n, r, steps, block_b,
                                           block_n, smem, s)
               : launch_vpu<__nv_bfloat16>(inst, x, y, coeffs, ntaps, batch, n, r, steps,
                                           block_b, block_n, smem, s);
  return (int)cudaErrorInvalidValue;
}

const char* stencil1d_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
