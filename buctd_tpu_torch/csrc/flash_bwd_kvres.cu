// Flash-attention backward with the streamed operands in a cp.async ring
// (Hopper, sm_90a): dq, dk, dv of out = dropout(softmax(q k^T * scale)) v
// from the forward's lse.  The same functions as K2 (flash_bwd.cu), with
// another schedule.
//
// Replaces buctd_tpu/ops/flash_attention.py::_dq_kernel_kvres (:245) and
// ::_dkv_kernel_kvres (:295), which the JAX package runs instead of
// _dq_kernel/_dkv_kernel when BUCTD_FLASH_KVRES is set (:684).  On the TPU the
// dq kernel keeps a q block resident and streams the kv sub-tiles through a
// double-buffered DMA pair; the dk/dv kernel keeps a kv block resident and
// streams the q-side operands (q, do, lse, delta) through four such pairs.
//
// Here both dtypes launch K2's tensor-core kernels, by K2's rules, with a
// deeper ring for the looped operand (K2's depth plus one: tf32::kKvresStages,
// tc::kKvresStages and t3b::kKvresStages, 3 slots, t3b's where shared memory
// holds them (d = 48 and 96 for dq; else K2's 2); hwb::kKvresStages, 4): f32
// (dtype 0) flash_bwd_dq_tf32_wgmma_kernel / flash_bwd_dkv_tf32_wgmma_kernel
// (flash_bwd_tf32_wgmma.cuh, TMA and wgmma, 3xTF32) where K2 takes them
// (t3b::takes), else flash_bwd_dq_tf32_kernel / flash_bwd_dkv_tf32_kernel
// (flash_bwd_tf32.cuh, mma.sync, 3xTF32); bf16 (dtype 1, the training step
// under the switch) flash_bwd_dq_wgmma_kernel / flash_bwd_dkv_wgmma_kernel
// (flash_bwd_wgmma.cuh, TMA and wgmma) where K2 takes them (hwb::takes), else
// flash_bwd_dq_tc_kernel / flash_bwd_dkv_tc_kernel (flash_bwd_tc.cuh), all of
// which round as K2 does (q * scale, do, ds and p * keep * c to bf16).  The
// depth of the ring changes no arithmetic, so K2' equals K2 bit for bit; rows
// that are not 16-byte aligned take the mma.sync kernels' register load path.
//
// C interface (bound with ctypes by buctd_tpu_torch/ops/flash_attention.py),
// the same as buctd_flash_bwd_dq / buctd_flash_bwd_dkv:
//   int buctd_flash_bwd_dq_kvres(q, k, v, dout, lse, delta, dq, bh, lq, lk, d,
//                                scale, keep_thr, keep_scale, seed, dtype, stream)
//   int buctd_flash_bwd_dkv_kvres(q, k, v, dout, lse, delta, dk, dv, bh, lq, lk,
//                                 d, scale, keep_thr, keep_scale, seed, dtype,
//                                 stream)
// q (bh, lq, d), k/v (bh, lk, d) and dout (bh, lq, d) contiguous, all f32
// (dtype 0) or all bf16 (dtype 1); lse and delta (bh, lq) f32; dq (bh, lq, d),
// dk/dv (bh, lk, d) f32, allocated by the caller.  On a refused argument they
// return cudaErrorInvalidValue without launching; else the cudaError_t of the
// launch.  They launch on `stream` and do not synchronise.

#include <cuda_runtime.h>

#include "flash_bwd_tc.cuh"
#include "flash_bwd_tf32.cuh"
#include "flash_bwd_tf32_wgmma.cuh"
#include "flash_bwd_wgmma.cuh"

namespace {

template <bool kDq>
int run(const tc::BwdArgs& a, int dtype, void* stream) {
  if (a.bh <= 0 || a.bh > 65535 || a.lq <= 0 || a.lk <= 0 || a.d <= 0 || a.d > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(t3b::takes(a.q, a.k, a.v, a.dout, a.d)
                     ? t3b::launch_bwd<t3b::kKvresStages, kDq>(a, s)
                     : tf32::launch_bwd<tf32::kKvresStages, kDq>(a, s));
  if (dtype == 1)
    return (int)(hwb::takes(a.q, a.k, a.v, a.dout, a.d)
                     ? hwb::launch_bwd<hwb::kKvresStages, kDq>(a, s)
                     : tc::launch_bwd<tc::kKvresStages, kDq>(a, s));
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int buctd_flash_bwd_dq_kvres(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse,
                                        const float* delta, float* dq, int bh, int lq,
                                        int lk, int d, float scale, unsigned keep_thr,
                                        float keep_scale, unsigned seed, int dtype,
                                        void* stream) {
  const tc::BwdArgs a{q,  k,  v, dout,  lse, delta, dq, nullptr, nullptr,
                      bh, lq, lk, d, scale, Dropout{keep_thr, keep_scale, seed}};
  return run<true>(a, dtype, stream);
}

extern "C" int buctd_flash_bwd_dkv_kvres(const void* q, const void* k, const void* v,
                                         const void* dout, const float* lse,
                                         const float* delta, float* dk, float* dv, int bh,
                                         int lq, int lk, int d, float scale,
                                         unsigned keep_thr, float keep_scale,
                                         unsigned seed, int dtype, void* stream) {
  const tc::BwdArgs a{q,  k,  v, dout,  lse, delta, nullptr, dk, dv,
                      bh, lq, lk, d, scale, Dropout{keep_thr, keep_scale, seed}};
  return run<false>(a, dtype, stream);
}
