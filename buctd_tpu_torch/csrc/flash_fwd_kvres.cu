// Flash-attention forward with K/V streamed through a deeper cp.async ring
// (Hopper, sm_90a): out = dropout(softmax(q k^T * scale)) v, plus the
// natural-log logsumexp of every query row.  The same function as K1
// (flash_fwd.cu), with another schedule.
//
// Replaces buctd_tpu/ops/flash_attention.py::_fwd_kernel_kvres (:139), which
// the JAX package runs instead of _fwd_kernel when BUCTD_FLASH_KVRES is set
// (:474).  That TPU kernel keeps a q block resident, walks the kv sub-tiles in
// a loop inside the kernel, and streams them from HBM through a hand
// double-buffered DMA pair: the copy of tile i+1 is started before tile i is
// computed (kv_dma(ki + 1, 1 - slot), :177-181).
//
// Here both dtypes launch K1's tensor-core kernels with a ring of
// kKvresStages K/V slots (K1 takes two): f32 (dtype 0, the evaluation path
// under the switch) flash_fwd_tf32_wgmma_kernel (flash_fwd_tf32_wgmma.cuh,
// TMA and wgmma in 3xTF32, where shared memory holds three slots: d = 48,
// not 96 or 112, where it runs K1's two) where K1 takes it (t3::takes), else
// flash_fwd_tf32_kernel (flash_fwd_tf32.cuh, 3xTF32 mma.sync); bf16 (dtype
// 1, the training step and bf16 evaluation under the switch)
// flash_fwd_wgmma_kernel (flash_fwd_wgmma.cuh, TMA and wgmma) where K1 takes
// it (hw::takes), else flash_fwd_tc_kernel (flash_fwd_tc.cuh), the same
// choices as K1's.  The depth of the ring changes no arithmetic, so K1'
// equals K1 bit for bit; rows that are not 16-byte aligned take the mma.sync
// kernels' register load path.
//
// C interface (bound with ctypes by buctd_tpu_torch/ops/flash_attention.py),
// the same as buctd_flash_fwd:
//   int buctd_flash_fwd_kvres(q, k, v, out, lse, bh, lq, lk, d, scale,
//                             keep_thr, keep_scale, seed, dtype, stream)
//   int buctd_flash_fwd_kvres_blocks_per_sm(d, dropout): blocks of the
//       bf16 wgmma kernel with this ring resident on one SM (0 where it has
//       none)
//   int buctd_flash_fwd_kvres_tf32_blocks_per_sm(d, dropout): the same for
//       the f32 wgmma kernel
// q (bh, lq, d), k/v (bh, lk, d) contiguous, f32 (dtype 0) or bf16 (dtype 1);
// out (bh, lq, d) and lse (bh, lq) f32, allocated by the caller.  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue, without launching, on a
// refused argument); launches on `stream` and does not synchronise.

#include <cuda_runtime.h>

#include "flash_fwd_tc.cuh"
#include "flash_fwd_tf32.cuh"
#include "flash_fwd_tf32_wgmma.cuh"
#include "flash_fwd_wgmma.cuh"

extern "C" int buctd_flash_fwd_kvres(const void* q, const void* k, const void* v,
                                     void* out, void* lse, int bh, int lq, int lk, int d,
                                     float scale, unsigned keep_thr, float keep_scale,
                                     unsigned seed, int dtype, void* stream) {
  if (bh <= 0 || bh > 65535 || lq <= 0 || lk <= 0 || d <= 0 || d > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dr{keep_thr, keep_scale, seed};
  auto* o = static_cast<float*>(out);
  auto* m = static_cast<float*>(lse);
  if (dtype == 0)
    return (int)(t3::takes(q, k, v, d)
                     ? t3::launch_fwd<t3::kKvresStages>(q, k, v, o, m, bh, lq, lk, d, scale,
                                                        dr, s)
                     : tf32::launch_fwd<tf32::kKvresStages>(q, k, v, o, m, bh, lq, lk, d,
                                                            scale, dr, s));
  if (dtype == 1)
    return (int)(hw::takes(q, k, v, d)
                     ? hw::launch_fwd<tc::kKvresStages>(q, k, v, o, m, bh, lq, lk, d, scale,
                                                        dr, s)
                     : tc::launch_fwd<tc::kKvresStages>(q, k, v, o, m, bh, lq, lk, d, scale,
                                                        dr, s));
  return (int)cudaErrorInvalidValue;
}

extern "C" int buctd_flash_fwd_kvres_blocks_per_sm(int d, int dropout) {
  return hw::blocks_per_sm<tc::kKvresStages>(d, dropout != 0);
}

extern "C" int buctd_flash_fwd_kvres_tf32_blocks_per_sm(int d, int dropout) {
  return t3::blocks_per_sm<t3::kKvresStages>(d, dropout != 0);
}
