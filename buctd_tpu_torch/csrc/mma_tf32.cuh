// f32 tensor-core building blocks of the f32 paths (flash_fwd_tf32.cuh: K1
// and K1'; flash_bwd_tf32.cuh: K2 and K2'; fused_block_tf32.cuh: K5):
// mma.sync m16n8k8 on tf32 operands with f32 accumulators and the 3xTF32
// split that keeps f32 accuracy.  The (rows, d) tile loads are
// cp_async.cuh's, shared with the bf16 kernels.
//
// 3xTF32.  A tf32 operand keeps 10 of f32's 23 mantissa bits.  Every f32
// operand x is split into hi = tf32(x) (cvt.rna: round to nearest, ties away
// from zero) and lo = tf32(x - hi) (x - hi is exact in f32), so hi + lo is x
// to about 2^-22 relative.  A product a b is taken as lo_a hi_b + hi_a lo_b +
// hi_a hi_b, the small terms first, with f32 sums; the term left out,
// lo_a lo_b, is about 2^-22 of the product.  This is the card's counterpart
// of the TPU kernel's Precision.HIGHEST, a multi-pass f32 product on bf16
// units.  ops/tf32.py emulates it for the checks.
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

// tf32(x) of bit pattern b, rounded as cvt.rna.tf32.f32 rounds every x that
// is no NaN (to nearest, ties away from zero) but by integer arithmetic:
// half the range of the 13 dropped bits added to the sign-magnitude bits,
// then the 13 bits cleared.  A NaN's bits may carry into the sign bit or
// the exponent (0x7fffffff gives -0.0): split lets lo carry the NaN.
__device__ __forceinline__ uint32_t rna(uint32_t b) { return (b + 0x1000u) & 0xffffe000u; }

// x = hi + lo to about 2^-22: hi = tf32(x), lo = tf32(x - hi), by rna in an
// add and an and where cvt.rna took more issue: f32 K5 ran 13.05 -> 10.73 ms
// over the four W48 branches on an H100 (tools/bench_block_variants.py
// --dtype float32, variant cvtsplit).  x - hi is the exact remainder of the
// value the tensor core takes; it is NaN where x is NaN or infinite, and
// lo = rest * 0 + tf32(rest) is then NaN too (and tf32(rest) itself
// elsewhere), so lo_a hi_b makes a product with a NaN operand NaN, as f32
// does, and one with an infinite operand NaN where f32 may give inf: never
// finite.  One fma where a compare and a select on each half cost f32 K5
// 28% (variant nanfree, the split without it).  ops/tf32.py::tf32_split is
// the same arithmetic, held against cvt.rna's definition by
// tests/test_torch_port_flash_tf32.py.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna(__float_as_uint(x));
  const float rest = x - __uint_as_float(hi);
  lo = __float_as_uint(__fmaf_rn(rest, 0.f, __uint_as_float(rna(__float_as_uint(rest)))));
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

// An m16n8 accumulator tile c (rows g, g + 8; columns 2t, 2t + 1) split as
// the A fragment of a product over its 8 columns, without a shuffle, in the
// permuted order: A column t takes column 2t, column t + 4 column 2t + 1.
// The product's B operand is read in the same order, B[2t][g], B[2t + 1][g].
__device__ __forceinline__ void c_to_a(const float (&c)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// x * mul rounded to f32 (never contracted into a later subtraction), as
// stage_tile's op: q' = q * scale * log2 e before its split
struct MulRn {
  float mul;
  __device__ __forceinline__ float operator()(float x) const { return __fmul_rn(x, mul); }
};

// A landed (rows, D) tile of row stride S split once for the block: hi =
// tf32(x * mul) in place, lo = tf32(x * mul - hi) at `lo` (every warp reads
// every fragment of it, so a split in registers would repeat in each warp)
template <int kThreads, int D, int S>
__device__ __forceinline__ void split_tile(float* x, float* lo, int rows, float mul) {
  for (int i = threadIdx.x; i < rows * (D / 4); i += kThreads) {
    const int at = (i / (D / 4)) * S + (i % (D / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(x + at);
    uint32_t h[4], l[4];
    split(__fmul_rn(v.x, mul), h[0], l[0]);
    split(__fmul_rn(v.y, mul), h[1], l[1]);
    split(__fmul_rn(v.z, mul), h[2], l[2]);
    split(__fmul_rn(v.w, mul), h[3], l[3]);
    *reinterpret_cast<uint4*>(x + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The lane's A fragments of the 16 rows row0.. of a (limit, d) f32 operand
// in device memory, times mul, split: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4) of each of the KD 8-column steps; rows past limit and
// columns past d are 0
template <int KD>
__device__ __forceinline__ void a_frags(uint32_t (&hi)[KD][4], uint32_t (&lo)[KD][4],
                                        const float* src, int row0, int limit, int d,
                                        float mul) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + gid + 8 * (e & 1), c = kk * 8 + tig + 4 * (e >> 1);
      split(r < limit && c < d ? __fmul_rn(src[(size_t)r * d + c], mul) : 0.f, hi[kk][e],
            lo[kk][e]);
    }
}

// The same from a 16-row f32 tile in shared memory (row stride S, 4 times an
// odd number: the 8 rows g fall in distinct groups of 4 banks), columns
// k0..k0 + 7 only, split as it is read
template <int S>
__device__ __forceinline__ void a_frag(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* tile,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  const float* p = tile + (lane >> 2) * S + k0 + (lane & 3);
  split(p[0], hi[0], lo[0]);
  split(p[8 * S], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * S + 4], hi[3], lo[3]);
}

// The looped operand's ring depth: K1 and K2 take kStages, their
// kv-resident variants K1' and K2' (BUCTD_FLASH_KVRES) kKvresStages, as the
// bf16 kernels do
constexpr int kStages = 2;
constexpr int kKvresStages = 3;

}  // namespace tf32
