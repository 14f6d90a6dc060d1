// 3xTF32 products (mma.sync m16n8k8) on f32 tiles in shared memory, for
// sm_90a: the helpers K6's f32 forward (swa.cu) and its f32 backward
// (swa_bwd.cu) share.  Each .cu that uses them includes this file;
// kernels/_build.py hashes every csrc/*.cuh with every source.
//
// Tiles are f32, D zero-filled to DP = 64, 128 or 256 columns, XOR-swizzled
// within each 32-column chunk (swz) so that one tile serves fragment reads
// along its rows (ldmatrix: load_a, load_b_rows) and down its columns
// (load_b_cols), filled by cp.async (load_tile).  Each operand is split as
// it is read into a TF32 hi and the rest (split), and a product sums
// lo*hi, hi*lo and hi*hi in f32 (mma3, mma3_apart; mma_tf32 in
// common.cuh), which keeps the f32 bar that one TF32 product misses.  An
// accumulator is the A operand of the next product without a shuffle
// (acc_to_a).  Warps that share rows hand fragments across in shared
// memory under named barriers (bar_sync, bar_arrive).
#pragma once

#include <stdint.h>

#include "common.cuh"

constexpr int kFThreads = 256;           // 8 warps: a block of each f32 kernel
constexpr int kXch = 2 * 8 * 32;         // u32s of a warp's split A fragments: 2 k-steps, hi, lo

// Column c of row r of a swizzled f32 tile: XORed with 8 ((r >> 1) & 3) +
// 4 (r & 1) within its 32-column chunk, so lanes (g, q) = (lane / 4, lane %
// 4) reading rows g, columns q (+ 4), or rows 2q (+ 1), column g, hit 32
// banks; cp.async's 16-byte chunks stay whole.
__device__ __forceinline__ int swz(int r, int c) {
  return c ^ ((((r >> 1) & 3) << 3) | ((r & 1) << 2));
}

// The lane's rows and swizzled columns, within a 32-column chunk, of the
// fragment reads: ldmatrix of an A operand (16 rows x 8 columns: four 8 x
// 4 blocks, rows then columns) or of two n-tiles of a B operand read along
// its rows (16 rows x 8: blocks columns first); rows 2q + i, column 8j + g
// of a B operand read down its columns.
struct FragCols {
  int a_row, a_col[4];   // A: row a_row, columns a_col[j] = 8j + 4 (lane / 16)
  int b_row, b_col[4];   // B along rows: columns 8j + 4 (lane / 8 % 2)
  int col[4][2];         // B down columns
  __device__ __forceinline__ explicit FragCols(int lane) {
    const int g = lane >> 2, q = lane & 3;
    a_row = (lane & 7) + 8 * ((lane >> 3) & 1);
    b_row = (lane & 7) + 8 * (lane >> 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a_col[j] = swz(lane, 8 * j + 4 * (lane >> 4));
      b_col[j] = swz(lane, 8 * j + 4 * ((lane >> 3) & 1));
#pragma unroll
      for (int i = 0; i < 2; ++i) col[j][i] = swz(2 * q + i, 8 * j + g);
    }
  }
};

// ldmatrix of f32 tiles: four blocks of 8 rows x 4 f32 (8 x 8 16-bit
// values); lane t gives the address of row t % 8 of block t / 8 and gets
// from block i the f32 at row t / 4, column t % 4 in r[i], which is the
// layout of mma.sync's TF32 fragments
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

struct Frag {
  uint32_t hi[4], lo[4];
};

// v = hi + lo, the TF32 parts of an f32 operand: hi is v rounded to TF32
// (to nearest, ties away from zero, as cvt.rna, in two integer operations,
// which run faster here than cvt.rna.tf32.f32), lo = v - hi exactly,
// passed as f32: the tensor cores read a TF32 operand's top 19 bits, and
// lo's lower bits weigh under 2^-22 of v.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// The fragment reads below take a column as c32 + 8j: c32 a multiple of 32,
// j = 0..3 known at compile time; r0, n0 and k0 are multiples of 8.
// A operand: rows r0 + g, r0 + g + 8, columns c32 + 8j + q, c32 + 8j + q + 4
// of a DP-wide tile, split
template <int DP>
__device__ __forceinline__ void load_a(const float* t, int r0, int c32, int j,
                                       const FragCols& fc, Frag& f) {
  uint32_t v[4];
  ldsm_x4(v, t + (r0 + fc.a_row) * DP + c32 + fc.a_col[j]);
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(v[i]), f.hi[i], f.lo[i]);
}

// B operands of two n-tiles read along a tile's rows: n = rows n0 + g and
// n0 + 8 + g, depth = columns c32 + 8j + q, c32 + 8j + q + 4; split
template <int DP>
__device__ __forceinline__ void load_b_rows(const float* t, int n0, int c32, int j,
                                            const FragCols& fc, uint32_t (&hi)[2][2],
                                            uint32_t (&lo)[2][2]) {
  uint32_t v[4];
  ldsm_x4(v, t + (n0 + fc.b_row) * DP + c32 + fc.b_col[j]);
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(v[i]), hi[i >> 1][i & 1], lo[i >> 1][i & 1]);
}

// B operand read down a tile's columns, depth permuted as acc_to_a leaves
// it: depth slots q, q + 4 = rows k0 + 2q, k0 + 2q + 1 (k0 % 8 == 0); n =
// column c32 + 8j + g
template <int DP>
__device__ __forceinline__ void load_b_cols(const float* t, int k0, int c32, int j,
                                            const FragCols& fc, int q, uint32_t (&hi)[2],
                                            uint32_t (&lo)[2]) {
  const float* p = t + (k0 + 2 * q) * DP + c32;
  split(p[fc.col[j][0]], hi[0], lo[0]);
  split(p[DP + fc.col[j][1]], hi[1], lo[1]);
}

// An 8-column n-tile of an accumulator (rows g, g + 8; columns 2q, 2q + 1)
// as the A operand of a product over those columns: depth slot q holds
// column 2q and slot q + 4 column 2q + 1
__device__ __forceinline__ void acc_to_a(const float (&x)[4], Frag& f) {
  split(x[0], f.hi[0], f.lo[0]);
  split(x[2], f.hi[1], f.lo[1]);
  split(x[1], f.hi[2], f.lo[2]);
  split(x[3], f.hi[3], f.lo[3]);
}

// c += a . b in 3xTF32, the small products first
__device__ __forceinline__ void mma3(float (&c)[4], const Frag& a, const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(c, a.lo, bh[0], bh[1]);
  mma_tf32(c, a.hi, bl[0], bl[1]);
  mma_tf32(c, a.hi, bh[0], bh[1]);
}

// The tensor cores round their sum toward zero at every product, so one
// accumulator carried through thousands of products drifts past the f32
// bar.  Long sums therefore run in short chunks, each product of a chunk
// into accumulators zeroed for it, added to the f32 total by FADD (round to
// nearest); over D, the hi*hi products and the small ones take accumulators
// of their own, which also gives the tensor cores independent chains.
__device__ __forceinline__ void mma3_apart(float (&big)[4], float (&small)[4], const Frag& a,
                                           const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  mma_tf32(small, a.lo, bh[0], bh[1]);
  mma_tf32(small, a.hi, bl[0], bl[1]);
  mma_tf32(big, a.hi, bh[0], bh[1]);
}

// s = rows r0..r0+15 of `a` times rows n0..n0+15 of `bt` (two n-tiles of
// 8), both DP-wide tiles, over D in 32-column chunks (mma3_apart), each
// chunk added to s by FADD
template <int DP>
__device__ __forceinline__ void product16(float (&s)[2][4], const float* a, int r0,
                                          const float* bt, int n0, const FragCols& fc) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll 2
  for (int c32 = 0; c32 < DP; c32 += 32) {
    float big[2][4] = {}, small[2][4] = {};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      Frag fa;
      uint32_t bh[2][2], bl[2][2];
      load_a<DP>(a, r0, c32, j, fc, fa);
      load_b_rows<DP>(bt, n0, c32, j, fc, bh, bl);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) mma3_apart(big[nt], small[nt], fa, bh[nt], bl[nt]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] += big[nt][e] + small[nt][e];
  }
}

// acc (NT n-tiles: columns col0 .. col0 + 8 NT of a DP-wide tile t) += fa
// (two k-steps of A fragments, acc_to_a's depth order) times rows k0 ..
// k0 + 15 of t, read down its columns; the 16 rows' products in a chunk of
// their own, added to acc by FADD
template <int DP, int NT>
__device__ __forceinline__ void add_product16(float (&acc)[NT][4], const Frag (&fa)[2],
                                              const float* t, int k0, int col0,
                                              const FragCols& fc, int q) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float c[4] = {};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t bh[2], bl[2];
      load_b_cols<DP>(t, k0 + 8 * i, col0 + 32 * (nt >> 2), nt & 3, fc, q, bh, bl);
      mma3(c, fa[i], bh, bl);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] += c[e];
  }
}

// rows [row0, row0 + ROWS) of a (position, D) f32 slab into a DP-wide
// swizzled tile by cp.async, zero past seq and past dim: 16-byte chunks
// where vec (D % 4 == 0, rows 16-byte aligned), else 4 bytes each
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int64_t ld, int row0,
                                          int seq, int dim, bool vec, int tid) {
  if (vec) {
    constexpr int cpr = DP / 4;
    for (int idx = tid; idx < ROWS * cpr; idx += kFThreads) {
      const int r = idx / cpr, c = (idx % cpr) * 4;
      const int pos = row0 + r;
      const bool in = pos < seq && c < dim;
      cp_async16(smem_addr(dst + r * DP + swz(r, c)), in ? src + pos * ld + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < ROWS * DP; idx += kFThreads) {
      const int r = idx / DP, c = idx % DP;
      const int pos = row0 + r;
      const bool in = pos < seq && c < dim;
      cp_async4(smem_addr(dst + r * DP + swz(r, c)), in ? src + pos * ld + c : src, in ? 4 : 0);
    }
  }
}

// A warp's split A fragment of k-step i into its kXch slots of the
// exchange (xch_put), or a partner's out of its slots (xch_get): lane-major,
// hi then lo, so both run on 32 banks
__device__ __forceinline__ void xch_put(uint32_t* slots, int i, int lane, const Frag& f) {
  uint32_t* p = slots + i * 256 + lane;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    p[e * 32] = f.hi[e];
    p[(4 + e) * 32] = f.lo[e];
  }
}
__device__ __forceinline__ void xch_get(const uint32_t* slots, int i, int lane, Frag& f) {
  const uint32_t* p = slots + i * 256 + lane;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f.hi[e] = p[e * 32];
    f.lo[e] = p[(4 + e) * 32];
  }
}

// named barrier `id` over `n` threads: arrive and wait, or arrive only
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ bool in_band(int qpos, int kpos, int seq, int window) {
  return kpos <= qpos && kpos > qpos - window && qpos < seq && kpos < seq;
}

// 16 keys from lo against 16 query rows from row_lo: no pair in the band
// or below seq (keys16_skip), or some pair outside them (keys16_edge)
__device__ __forceinline__ bool keys16_skip(int lo, int row_lo, int seq, int window) {
  return lo > row_lo + 15 || lo + 15 <= row_lo - window || lo >= seq;
}
__device__ __forceinline__ bool keys16_edge(int lo, int row_lo, int seq, int window) {
  return !(lo + 15 <= row_lo && lo > row_lo + 15 - window && lo + 16 <= seq);
}
