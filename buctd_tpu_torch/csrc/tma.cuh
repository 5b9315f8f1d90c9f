// The Tensor Memory Accelerator (TMA, sm_90) and the shared-memory barriers
// (mbarrier) that report its copies, for the bf16 flash forward and backward
// (flash_fwd_wgmma.cuh, flash_bwd_wgmma.cuh) and the f32 flash forward
// (flash_fwd_tf32_wgmma.cuh).
//
// One thread asks for a whole box of a tensor to be copied into shared
// memory; the hardware computes the addresses, applies the 128-byte or
// 64-byte swizzle that wgmma's descriptors expect (wgmma_bf16.cuh,
// wgmma_tf32.cuh) or none, fills coordinates past
// the tensor's edge with zeros, and counts the bytes it wrote against the
// barrier named in the request.  A consumer waits on the barrier's phase.
//
// Tensor maps are encoded on the host by libcuda's cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint (nothing links libcuda by hand),
// and handed to the kernel by value as a __grid_constant__ parameter.

#pragma once

#include <cuda.h>   // CUtensorMap and libcuda's enums: types only, nothing linked
#include <cuda_runtime.h>

#include <cstdint>

namespace tma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a barrier that completes a phase after `count` arrivals (and the bytes
// announced by expect_tx)
__device__ __forceinline__ void init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of copies to come
__device__ __forceinline__ void expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// wait until the phase of parity `parity` has completed (a fresh barrier
// counts its phase before 0, of parity 1, as complete).  A wait that lasts
// kWaitLimitNs traps: a fault in the schedule ends the launch with an error
// instead of holding the card
constexpr uint64_t kWaitLimitNs = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  uint32_t done, tries = 0;
  uint64_t start = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (!done && (++tries & 1023u) == 0u) {
      const uint64_t t = now_ns();
      if (start == 0) start = t;
      else if (t - start > kWaitLimitNs) __trap();
    }
  } while (!done);
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// the box of a 3-d map at (c0, c1, c2) (innermost first) into dst, its bytes
// counted on bar
__device__ __forceinline__ void load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                        int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- host ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once in libcuda; null where it is
// missing
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A map of a contiguous bf16 (batch, rows, cols) tensor at base (16-byte
// aligned, cols a multiple of 8: TMA wants 16-byte strides) read in boxes of
// box_rows x 64 columns of one batch entry, with the 128-byte swizzle;
// coordinates past any edge read as zeros.  False where the encoding fails.
inline bool encode_bf16_3d(CUtensorMap* map, const void* base, int cols, int rows, int batch,
                           int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)cols * rows * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map of a contiguous f32 (batch, rows, cols) tensor at base (16-byte
// aligned, cols a multiple of 4) read in boxes of box_rows x box_cols of one
// batch entry: box_cols 16 (64 bytes) with the 64-byte swizzle where
// swizzle64, else any multiple of 4 up to 256 unswizzled (rows of box_cols
// f32, one after the other); coordinates past any edge read as zeros.  False
// where the encoding fails.
inline bool encode_f32_3d(CUtensorMap* map, const void* base, int cols, int rows, int batch,
                          int box_cols, int box_rows, bool swizzle64) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 4, (cuuint64_t)cols * rows * 4};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, strides,
            box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tma
