// f32 tensor-core building blocks of the flash forward's f32 path
// (flash_fwd_tf32.cuh: K1 and K1'): mma.sync m16n8k8 on tf32 operands with
// f32 accumulators, the 3xTF32 split that keeps f32 accuracy, and the loads
// of (rows, d) f32 tiles into shared memory, by cp.async or through
// registers.
//
// 3xTF32.  A tf32 operand keeps 10 of f32's 23 mantissa bits.  Every f32
// operand x is split into hi = tf32(x) (cvt.rna: round to nearest, ties away
// from zero) and lo = tf32(x - hi) (x - hi is exact in f32), so hi + lo is x
// to about 2^-22 relative.  A product a b is taken as lo_a hi_b + hi_a lo_b +
// hi_a hi_b, the small terms first, with f32 sums; the term left out,
// lo_a lo_b, is about 2^-22 of the product.  This is the card's counterpart
// of the TPU kernel's Precision.HIGHEST, a multi-pass f32 product on bf16
// units.  ops/flash_attention.py::tf32_round and forward_tf32 emulate it.
//
// Layouts (mma.m16n8k8 with .tf32 operands), with g = lane / 4, t = lane % 4:
//   A (16 x 8, row major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//   B (8 x 8, column major): b0 (t, g), b1 (t + 4, g);
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// ldmatrix moves 16-bit elements, so the f32 operands come from shared memory
// by plain 32-bit loads.  Shared tiles are row major with row stride
// stride<D>() = D + 4 words, 4 times an odd number: the 8 rows g of a B
// fragment read as K[g][t] fall in 8 distinct groups of 4 banks, and so do
// the rows 2t, 2t + 1 of the permuted V reads (flash_fwd_tf32.cuh), so both
// are free of bank conflicts (tests/test_torch_port_flash_tf32.py models the
// addresses).  d is padded with zeros to D, a multiple of 16.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"

namespace tf32 {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // the block's own tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// shared-memory row stride in words: D + 4, 4 times an odd number for D a
// multiple of 16, and rows stay 16-byte aligned for cp.async
template <int D>
__host__ __device__ constexpr int stride() { return D + 4; }

// x = hi + lo to about 2^-22: hi = tf32(x), lo = tf32(x - hi).  hi's low 13
// bits are cleared before the subtraction (the tf32 register layout is the
// implementation's), so x - hi is the exact remainder of the value the
// tensor core takes
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  hi &= 0xffffe000u;
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// c += a b: m16n8k8, tf32 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: lo_a hi_b, then hi_a lo_b, then hi_a hi_b
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                     const uint32_t (&b_lo)[2]) {
  mma(c, a_lo, b_hi[0], b_hi[1]);
  mma(c, a_hi, b_lo[0], b_lo[1]);
  mma(c, a_hi, b_hi[0], b_hi[1]);
}

// rows x D tile of src (row stride d) into dst (row stride stride<D>())
// through registers; rows past `limit` and columns past d are 0
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int row0, int rows,
                                      int limit, int d) {
  constexpr int S = stride<D>();
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    dst[r * S + c] = row0 + r < limit && c < d ? src[(size_t)(row0 + r) * d + c] : 0.f;
  }
}

// rows [row0, row0 + rows) of src into a ring slot: cp.async in 16-byte
// copies when every row start is 16-byte aligned (zero_pad cleared columns
// d..D once), else through registers
template <int D>
__device__ __forceinline__ void load(float* dst, const float* src, int row0, int rows,
                                     int limit, int d, bool async) {
  if (async)
    copy_rows<kThreads>(dst, stride<D>() * 4, src, d * 4, row0, rows, limit, 16);
  else
    stage<D>(dst, src, row0, rows, limit, d);
}

// columns d..D of `rows` rows: cp.async never writes them
template <int D>
__device__ __forceinline__ void zero_pad(float* buf, int rows, int d) {
  constexpr int S = stride<D>();
  if (d < D)
    for (int i = threadIdx.x; i < rows * (D - d); i += kThreads)
      buf[(i / (D - d)) * S + d + i % (D - d)] = 0.f;
}

// every row start of a (rows, d) f32 array at p is 16-byte aligned
inline bool rows_aligned(const void* p, int d) { return copy_width(p, 4LL * d) == 16; }

// The K/V ring's depth: K1 takes kStages, its kv-resident variant K1'
// (BUCTD_FLASH_KVRES) kKvresStages, as the bf16 kernels do
constexpr int kStages = 2;
constexpr int kKvresStages = 3;

}  // namespace tf32
