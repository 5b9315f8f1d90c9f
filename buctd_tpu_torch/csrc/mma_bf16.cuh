// bf16 tensor-core building blocks shared by the flash kernels' bf16 paths
// (flash_fwd_tc.cuh: K1 and K1'; flash_bwd_tc.cuh: K2 and K2'): mma.sync
// m16n8k16 with f32 accumulators, ldmatrix fragment loads from shared memory,
// and the repacking of accumulators as the next product's A operand.  The
// (rows, d) tile loads are cp_async.cuh's, shared with the f32 kernels.
//
// Layouts.  A block has kWarps warps; each owns 16 rows of the block's own
// kRows-row tile.  In an m16n8 accumulator tile a lane holds rows gid and
// gid + 8 (gid = lane / 4) and columns 2 tig, 2 tig + 1 (tig = lane % 4).
// Shared tiles are row-major with row stride stride<D>() = D + 8 elements:
// an odd number of 16-byte units, so the 8 rows an ldmatrix 8x8 matrix reads
// fall in 8 distinct bank groups.  d is padded with zeros to D, a multiple of
// 16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // the block's own tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// shared-memory row stride in elements: D + 8, an odd number of 16-byte units
template <int D>
__host__ __device__ constexpr int stride() { return D + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lanes 8i .. 8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b: m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulators of N n8 tiles (a lane holds rows gid, gid + 8 and columns
// 8 j + 2 tig, +1 of tile j) rounded to bf16 as the A fragments of N / 2 k16
// steps: the m16n8 layout of tiles 2 k and 2 k + 1 is the m16k16 A layout.
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 2][4], const float (&c)[N][4]) {
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    a[k][0] = pack(c[2 * k][0], c[2 * k][1]);
    a[k][1] = pack(c[2 * k][2], c[2 * k][3]);
    a[k][2] = pack(c[2 * k + 1][0], c[2 * k + 1][1]);
    a[k][3] = pack(c[2 * k + 1][2], c[2 * k + 1][3]);
  }
}

// A lane's ldmatrix address in a 16 x 16 tile of a row-major shared array with
// row stride S, for the three ways the kernels read one:
//   a_off:   rows m, columns k, as the A operand (ldsm -> a0..a3);
//   b_nk:    rows n, columns k (B transposed in memory): ldsm -> b0, b1 of
//            the n-tile of rows 0-7, then b0, b1 of rows 8-15;
//   b_kn:    rows k, columns n (B in memory): ldsm_t -> the same.
template <int S>
__device__ __forceinline__ int a_off(int lane) {
  return (lane & 15) * S + (lane >> 4) * 8;
}
template <int S>
__device__ __forceinline__ int b_nk(int lane) {
  return ((lane & 7) + ((lane >> 4) << 3)) * S + ((lane >> 3) & 1) * 8;
}
template <int S>
__device__ __forceinline__ int b_kn(int lane) {
  return ((lane & 7) + (((lane >> 3) & 1) << 3)) * S + (lane >> 4) * 8;
}

// x * mul rounded to bf16: q' = bf16(q * bf16(scale)) as stage_tile's op
struct ScaleBf16 {
  float mul;
  __device__ __forceinline__ bf16 operator()(bf16 x) const {
    return __float2bfloat16(__bfloat162float(x) * mul);
  }
};

// The ring's schedule, a template parameter of every bf16 flash kernel: the
// looped operand streams through `Stages` slots of shared memory, up to
// Stages - 1 tiles in flight while the block computes on the oldest.  K1 and
// K2 take 2; their kv-resident variants K1' and K2' (BUCTD_FLASH_KVRES) take
// kKvresStages, a deeper ring.
constexpr int kStages = 2;
constexpr int kKvresStages = 3;

}  // namespace tc
