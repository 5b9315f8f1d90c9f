// Asynchronous global -> shared copies (cp.async, sm_80 and later) for the
// rings of the tensor-core kernels (flash_fwd_tc.cuh, flash_fwd_tf32.cuh,
// flash_bwd_tc.cuh, flash_bwd_tf32.cuh, fused_block_tc.cuh,
// fused_block_tf32.cuh), and the tile loads that the flash kernels of both
// element types share (stage_tile, load_tile, zero_pad_tile, rows_aligned).
//
// They are the counterpart of the TPU kernels' pltpu.make_async_copy +
// DMA semaphores: a tile's copy is issued, the block computes on the tiles
// before it, and cp.async.wait_group waits for the copy to land.  One
// commit group is one slot of a ring.  A copy moves 4, 8 or 16
// bytes, and both addresses must be aligned to its width: copy_width picks the
// widest one that every row start of an operand allows.  Rows past the end of
// an operand are zero-filled (src-size 0: nothing is read).

#pragma once

#include <cstdint>

template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(dst), "l"(gmem), "n"(N), "r"(valid ? N : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <int W, int kThreads>
__device__ __forceinline__ void copy_rows_w(unsigned char* dst, int dst_stride,
                                            const unsigned char* src, int row_bytes,
                                            int row0, int rows, int limit) {
  const int chunks = row_bytes / W;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, c = i - r * chunks;
    const bool ok = row0 + r < limit;
    const unsigned char* from =
        ok ? src + ((size_t)(row0 + r) * row_bytes + (size_t)c * W) : src;
    cp_async<W>(dst + r * dst_stride + c * W, from, ok);
  }
}

// Issue the copies of rows [row0, row0 + rows) of a row-major array at src
// (rows of row_bytes, `limit` rows in all) into dst, whose rows are
// dst_stride bytes apart, in width-byte copies (16, 8 or 4).  Rows at or past
// `limit` are zero-filled.  Every thread of the block takes part.
template <int kThreads>
__device__ __forceinline__ void copy_rows(void* dst, int dst_stride, const void* src,
                                          int row_bytes, int row0, int rows, int limit,
                                          int width) {
  auto* d = static_cast<unsigned char*>(dst);
  const auto* s = static_cast<const unsigned char*>(src);
  if (width == 16)
    copy_rows_w<16, kThreads>(d, dst_stride, s, row_bytes, row0, rows, limit);
  else if (width == 8)
    copy_rows_w<8, kThreads>(d, dst_stride, s, row_bytes, row0, rows, limit);
  else
    copy_rows_w<4, kThreads>(d, dst_stride, s, row_bytes, row0, rows, limit);
}

// The widest copy (16, 8 or 4 bytes) that every row start of an array at ptr
// with rows of row_bytes is aligned to; 0 when not even 4 is.
inline int copy_width(const void* ptr, long long row_bytes) {
  const unsigned long long a =
      static_cast<unsigned long long>(reinterpret_cast<uintptr_t>(ptr)) |
      static_cast<unsigned long long>(row_bytes);
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 0;
}

// ---- (rows, d) tiles of the flash kernels, bf16 or f32 (T) ----
// A tile is `rows` rows of a row-major (limit, d) operand, from row row0,
// in shared memory as rows of D elements (D a multiple of 16, >= d) with row
// stride S; rows at or past `limit` and columns d..D are 0.

struct Identity {
  template <class T>
  __device__ __forceinline__ T operator()(T x) const { return x; }
};

// the tile through registers, `op` applied to every element read
template <int kThreads, int D, int S, class T, class Op = Identity>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, int row0, int rows,
                                           int limit, int d, Op op = Op()) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    dst[r * S + c] = row0 + r < limit && c < d ? op(src[(size_t)(row0 + r) * d + c]) : T(0.f);
  }
}

// the tile into a ring slot: cp.async in 16-byte copies when every row start
// is 16-byte aligned (zero_pad_tile cleared columns d..D once), else through
// registers
template <int kThreads, int D, int S, class T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0, int rows, int limit,
                                          int d, bool async) {
  if (async)
    copy_rows<kThreads>(dst, S * (int)sizeof(T), src, d * (int)sizeof(T), row0, rows, limit,
                        16);
  else
    stage_tile<kThreads, D, S>(dst, src, row0, rows, limit, d);
}

// columns d..D of `rows` rows: cp.async never writes them
template <int kThreads, int D, int S, class T>
__device__ __forceinline__ void zero_pad_tile(T* buf, int rows, int d) {
  if (d < D)
    for (int i = threadIdx.x; i < rows * (D - d); i += kThreads)
      buf[(i / (D - d)) * S + d + i % (D - d)] = T(0.f);
}

// every row start of a (rows, d) array of T at p is 16-byte aligned
template <class T>
inline bool rows_aligned(const void* p, int d) {
  return copy_width(p, (long long)sizeof(T) * d) == 16;
}
