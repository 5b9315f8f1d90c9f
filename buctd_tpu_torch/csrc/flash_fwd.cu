// Flash-attention forward for Hopper (sm_90a): out = dropout(softmax(q k^T *
// scale)) v, plus the natural-log logsumexp of every query row.
//
// Replaces buctd_tpu/ops/flash_attention.py::_fwd_kernel (Pallas, TPU).  The
// TPU kernel walks a (bh, q-block, kv-block) grid in order and carries the
// running max / sum / accumulator in VMEM scratch across the kv axis.  Here one
// thread block owns one (bh, 64-row q tile) and walks every K/V tile in a loop
// of its own, so the carry lives in registers and nothing is shared between
// blocks.  No (L_q, L_k) matrix ever reaches device memory.
//
// Both dtypes run on the tensor cores, behind one C entry, each with a
// two-stage K/V ring:
//
// f32 (dtype 0; serving and evaluation): flash_fwd_tf32_wgmma_kernel
// (flash_fwd_tf32_wgmma.cuh: TMA loads, a producer warp, split warps, two
// consumer warpgroups on wgmma) wherever its TMA loads take the call
// (t3::takes: d a multiple of 8, q, k and v 16-byte aligned), else
// flash_fwd_tf32_kernel (flash_fwd_tf32.cuh: mma.sync, cp.async, any row
// alignment).  Both are 3xTF32: every operand split into two tf32 halves and
// every product taken in three passes, f32-accurate to about 2^-21 relative,
// as the JAX path's Precision.HIGHEST is on the TPU.  They round nothing to a
// narrower type.
//
// bf16 (dtype 1; the autocast training step, bf16 serving and evaluation):
// flash_fwd_wgmma_kernel (flash_fwd_wgmma.cuh: TMA loads, a producer warp,
// two consumer warpgroups on wgmma) wherever its TMA loads take the call
// (hw::takes: d a multiple of 8, q, k and v 16-byte aligned), else
// flash_fwd_tc_kernel (flash_fwd_tc.cuh: mma.sync, cp.async, any row
// alignment).  Both round q * scale and p * keep * c to bf16 where JAX's
// kernel does, so the lse they hand K2 is that of K2's logits.
//
// A second C entry, buctd_flash_fwd_simt, launches flash_fwd_kernel below,
// the f32 forward on the CUDA cores that serving and evaluation ran before
// the tf32 kernel: a register-tiled SIMT kernel (each thread holds a 4 x 8
// patch of the 64 x 64 logit tile and a 4 x D/8 patch of the output, operands
// staged in shared memory with odd row strides, the softmax in the exp2
// domain with log2(e) folded into the query scale), bound by its shared-memory
// reads (12 words a thread per 32 FMAs).  No path calls it: it is kept as the
// accuracy yardstick of the card tests, which hold f32 K1 at 6912 keys to
// twice its error against the plain forward.
//
// Dropout (training), as in the TPU kernel (:120-125): the un-normalized p of
// the online softmax is masked and scaled by 1/(1-p) AFTER it entered the
// running sum l, so the normalizer stays mask-free and the result equals
// dropout applied to the normalized probabilities.  The mask bits come from
// dropout_hash.cuh (one hash per weight, keyed by its global (bh, row, col)),
// so the backward kernels (flash_bwd.cu) regenerate the same mask.
// keep_thr == 0 means no dropout.
//
// A third, buctd_flash_fwd_mma, launches the mma.sync kernel of either
// dtype for any call (flash_fwd_tf32_kernel for f32, flash_fwd_tc_kernel for
// bf16): the kernels that each dtype ran before its wgmma kernel, kept so
// that chip_smoke.py and tools/bench_flash_fwd.py can time the two in turns.
//
// C interface (bound with ctypes by buctd_tpu_torch/ops/flash_attention.py):
//   int buctd_flash_fwd(q, k, v, out, lse, bh, lq, lk, d, scale,
//                       keep_thr, keep_scale, seed, dtype, stream)
//   int buctd_flash_fwd_simt(the same arguments; dtype must be 0)
//   int buctd_flash_fwd_mma(the same arguments)
//   int buctd_flash_fwd_blocks_per_sm(d, dropout): blocks of the bf16 wgmma
//       kernel resident on one SM at head dim d (0 where it has none)
//   int buctd_flash_fwd_tf32_blocks_per_sm(d, dropout): the same for the
//       f32 wgmma kernel
// q (bh, lq, d), k/v (bh, lk, d) contiguous, f32 (dtype 0) or bf16 (dtype 1);
// out (bh, lq, d) f32 and lse (bh, lq) f32, allocated by the caller.  Returns
// the cudaError_t of the launch (0 on success).  Launches on `stream` and does
// not synchronise.

#include <cuda_runtime.h>

#include "dropout_hash.cuh"
#include "flash_fwd_tc.cuh"
#include "flash_fwd_tf32.cuh"
#include "flash_fwd_tf32_wgmma.cuh"
#include "flash_fwd_wgmma.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;   // 16 row groups x 8 column groups
constexpr int kPStride = kBlockK + 1;
using tc::kLn2;
using tc::kLog2e;
constexpr float kNegBig = -1e30f;   // finite: keeps (m_old - m_new) free of inf - inf

template <int D>
constexpr int smem_floats() {
  // q and k tiles with odd strides, v tile dense, p tile with odd stride
  return kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D + kBlockQ * kPStride;
}

// D is the head dim rounded up to a multiple of 16; d <= D is the real one.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int lq, int lk, int d, float qscale,
                 uint32_t keep_thr, float keep_scale, uint32_t seed) {
  constexpr int DS = D + 1;
  constexpr int DC = D / 8;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                   // kBlockQ x DS
  float* ks = qs + kBlockQ * DS;      // kBlockK x DS
  float* vs = ks + kBlockK * DS;      // kBlockK x D
  float* ps = vs + kBlockK * D;       // kBlockQ x kPStride

  const int tid = threadIdx.x;
  const int ty = tid >> 3;   // rows ty + 16 i
  const int tx = tid & 7;    // logit columns tx + 8 j, output columns tx + 8 j
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const float* qb = q + (size_t)bh * lq * d;
  const float* kb = k + (size_t)bh * lk * d;
  const float* vb = v + (size_t)bh * lk * d;

  // q tile, pre-scaled by scale * log2(e); rows past lq and columns past d are 0
  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (q0 + r < lq && c < d) x = qb[(size_t)(q0 + r) * d + c] * qscale;
    qs[r * DS + c] = x;
  }

  const bool drop = keep_thr != 0u;
  float m[4], l[4], o[4][DC];
  uint32_t row_key[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_key[i] = dropout_row_key(seed, (uint32_t)bh, (uint32_t)(q0 + ty + 16 * i));
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) o[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < lk; k0 += kBlockK) {
    __syncthreads();   // the previous tile's k/v/p reads are done
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < lk && c < d) {
        const size_t off = (size_t)(k0 + r) * d + c;
        kx = kb[off];
        vx = vb[off];
      }
      ks[r * DS + c] = kx;
      vs[r * D + c] = vx;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * DS + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = ks[(tx + 8 * j) * DS + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
    // ragged L_k tail: padded keys get no weight
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (k0 + tx + 8 * j >= lk)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = kNegBig;

    // online softmax; the 8 threads sharing a row are 8 neighbouring lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, s[i][j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p = exp2f(s[i][j] - m_new);
        sum += p;
        if (drop)   // after the sum: l stays the mask-free normalizer
          p = dropout_bits(row_key[i], (uint32_t)(k0 + tx + 8 * j)) >= keep_thr
                  ? p * keep_scale : 0.f;
        ps[(ty + 16 * i) * kPStride + tx + 8 * j] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) o[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float a[4], b[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ps[(ty + 16 * i) * kPStride + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) b[j] = vs[kk * D + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) o[i][j] = fmaf(a[i], b[j], o[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= lq) continue;
    const float inv = 1.f / l[i];
    float* orow = out + ((size_t)bh * lq + r) * d;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + 8 * j;
      if (c < d) orow[c] = o[i][j] * inv;
    }
    if (tx == 0) lse[(size_t)bh * lq + r] = (m[i] + log2f(l[i])) * kLn2;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int bh, int lq, int lk, int d, float scale,
                   Dropout dr, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), static_cast<float*>(lse),
      lq, lk, d, scale * kLog2e, dr.keep_thr, dr.keep_scale, dr.seed);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     void* lse, int bh, int lq, int lk, int d, float scale,
                     Dropout dr, cudaStream_t s) {
  switch ((d + 15) / 16) {
    case 1: return launch<16>(q, k, v, out, lse, bh, lq, lk, d, scale, dr, s);
    case 2: return launch<32>(q, k, v, out, lse, bh, lq, lk, d, scale, dr, s);
    case 3: return launch<48>(q, k, v, out, lse, bh, lq, lk, d, scale, dr, s);
    case 4: return launch<64>(q, k, v, out, lse, bh, lq, lk, d, scale, dr, s);
    case 5: return launch<80>(q, k, v, out, lse, bh, lq, lk, d, scale, dr, s);
    case 6: return launch<96>(q, k, v, out, lse, bh, lq, lk, d, scale, dr, s);
    case 7: return launch<112>(q, k, v, out, lse, bh, lq, lk, d, scale, dr, s);
    case 8: return launch<128>(q, k, v, out, lse, bh, lq, lk, d, scale, dr, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int buctd_flash_fwd(const void* q, const void* k, const void* v,
                               void* out, void* lse, int bh, int lq, int lk,
                               int d, float scale, unsigned keep_thr,
                               float keep_scale, unsigned seed, int dtype,
                               void* stream) {
  if (bh <= 0 || bh > 65535 || lq <= 0 || lk <= 0 || d <= 0 || d > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dr{keep_thr, keep_scale, seed};
  auto* o = static_cast<float*>(out);
  auto* m = static_cast<float*>(lse);
  if (dtype == 0)
    return (int)(t3::takes(q, k, v, d)
                     ? t3::launch_fwd<t3::kStages>(q, k, v, o, m, bh, lq, lk, d, scale, dr, s)
                     : tf32::launch_fwd<tf32::kStages>(q, k, v, o, m, bh, lq, lk, d, scale, dr,
                                                       s));
  if (dtype == 1)
    return (int)(hw::takes(q, k, v, d)
                     ? hw::launch_fwd<hw::kStages>(q, k, v, o, m, bh, lq, lk, d, scale, dr, s)
                     : tc::launch_fwd<tc::kStages>(q, k, v, o, m, bh, lq, lk, d, scale, dr, s));
  return (int)cudaErrorInvalidValue;
}

extern "C" int buctd_flash_fwd_mma(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int bh, int lq, int lk, int d, float scale,
                                   unsigned keep_thr, float keep_scale, unsigned seed,
                                   int dtype, void* stream) {
  if (bh <= 0 || bh > 65535 || lq <= 0 || lk <= 0 || d <= 0 || d > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dr{keep_thr, keep_scale, seed};
  auto* o = static_cast<float*>(out);
  auto* m = static_cast<float*>(lse);
  if (dtype == 0)
    return (int)tf32::launch_fwd<tf32::kStages>(q, k, v, o, m, bh, lq, lk, d, scale, dr, s);
  if (dtype == 1)
    return (int)tc::launch_fwd<tc::kStages>(q, k, v, o, m, bh, lq, lk, d, scale, dr, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int buctd_flash_fwd_blocks_per_sm(int d, int dropout) {
  return hw::blocks_per_sm<hw::kStages>(d, dropout != 0);
}

extern "C" int buctd_flash_fwd_tf32_blocks_per_sm(int d, int dropout) {
  return t3::blocks_per_sm<t3::kStages>(d, dropout != 0);
}

extern "C" int buctd_flash_fwd_simt(const void* q, const void* k, const void* v,
                                    void* out, void* lse, int bh, int lq, int lk,
                                    int d, float scale, unsigned keep_thr,
                                    float keep_scale, unsigned seed, int dtype,
                                    void* stream) {
  if (bh <= 0 || bh > 65535 || lq <= 0 || lk <= 0 || d <= 0 || d > 128 || dtype != 0)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(q, k, v, out, lse, bh, lq, lk, d, scale,
                       Dropout{keep_thr, keep_scale, seed}, static_cast<cudaStream_t>(stream));
}
