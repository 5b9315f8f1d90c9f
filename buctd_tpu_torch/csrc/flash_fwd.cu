// Flash-attention forward for Hopper (sm_90a): out = softmax(q k^T * scale) v,
// plus the natural-log logsumexp of every query row.
//
// Replaces buctd_tpu/ops/flash_attention.py::_fwd_kernel (Pallas, TPU).  The
// TPU kernel walks a (bh, q-block, kv-block) grid in order and carries the
// running max / sum / accumulator in VMEM scratch across the kv axis.  Here one
// thread block owns one (bh, 64-row q tile) and walks every K/V tile in a loop
// of its own, so the carry lives in registers and nothing is shared between
// blocks.  No (L_q, L_k) matrix ever reaches device memory.
//
// What bounds it on an H100: at the CoAM-W48 shapes (L = 6912, d = 48 and
// L = 1728, d = 96) the work is 4 * L_q * L_k * d operations against
// (L_q + 2 L_k) * d elements of input, i.e. thousands of operations per byte,
// far above the card's ridge: it is bound by arithmetic.  f32 operands must stay
// exact f32 (the JAX path runs them at Precision.HIGHEST), so the products are
// plain f32 FMAs on the CUDA cores (67 TFLOP/s peak), not TF32 tensor cores.
// This first version is a register-tiled SIMT kernel: each thread holds a
// 4 x 8 patch of the 64 x 64 logit tile and a 4 x D/8 patch of the output, the
// operands are staged in shared memory with odd row strides so the column
// walks are free of bank conflicts, and the softmax runs in the exp2 domain
// with log2(e) folded into the query scale.  bf16 operands are widened to f32
// when staged and take the same path (f32 accumulation).  wgmma/TMA and a
// tensor-core bf16 path are later work.
//
// C interface (bound with ctypes by buctd_tpu_torch/ops/flash_attention.py):
//   int buctd_flash_fwd(q, k, v, out, lse, bh, lq, lk, d, scale, dtype, stream)
// q (bh, lq, d), k/v (bh, lk, d) contiguous, f32 (dtype 0) or bf16 (dtype 1);
// out (bh, lq, d) f32 and lse (bh, lq) f32, allocated by the caller.  Returns
// the cudaError_t of the launch (0 on success).  Launches on `stream` and does
// not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;   // 16 row groups x 8 column groups
constexpr int kPStride = kBlockK + 1;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegBig = -1e30f;   // finite: keeps (m_old - m_new) free of inf - inf

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int D>
constexpr int smem_floats() {
  // q and k tiles with odd strides, v tile dense, p tile with odd stride
  return kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D + kBlockQ * kPStride;
}

// D is the head dim rounded up to a multiple of 16; d <= D is the real one.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int lq, int lk, int d, float qscale) {
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
  const T* qb = q + (size_t)bh * lq * d;
  const T* kb = k + (size_t)bh * lk * d;
  const T* vb = v + (size_t)bh * lk * d;

  // q tile, pre-scaled by scale * log2(e); rows past lq and columns past d are 0
  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (q0 + r < lq && c < d) x = to_f32(qb[(size_t)(q0 + r) * d + c]) * qscale;
    qs[r * DS + c] = x;
  }

  float m[4], l[4], o[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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
        kx = to_f32(kb[off]);
        vx = to_f32(vb[off]);
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
        const float p = exp2f(s[i][j] - m_new);
        sum += p;
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int bh, int lq, int lk, int d, float scale,
                   cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), lq, lk, d, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     void* lse, int bh, int lq, int lk, int d, float scale,
                     cudaStream_t stream) {
  switch ((d + 15) / 16) {
    case 1: return launch<T, 16>(q, k, v, out, lse, bh, lq, lk, d, scale, stream);
    case 2: return launch<T, 32>(q, k, v, out, lse, bh, lq, lk, d, scale, stream);
    case 3: return launch<T, 48>(q, k, v, out, lse, bh, lq, lk, d, scale, stream);
    case 4: return launch<T, 64>(q, k, v, out, lse, bh, lq, lk, d, scale, stream);
    case 5: return launch<T, 80>(q, k, v, out, lse, bh, lq, lk, d, scale, stream);
    case 6: return launch<T, 96>(q, k, v, out, lse, bh, lq, lk, d, scale, stream);
    case 7: return launch<T, 112>(q, k, v, out, lse, bh, lq, lk, d, scale, stream);
    case 8: return launch<T, 128>(q, k, v, out, lse, bh, lq, lk, d, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int buctd_flash_fwd(const void* q, const void* k, const void* v,
                               void* out, void* lse, int bh, int lq, int lk,
                               int d, float scale, int dtype, void* stream) {
  if (bh <= 0 || bh > 65535 || lq <= 0 || lk <= 0 || d <= 0 || d > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(q, k, v, out, lse, bh, lq, lk, d, scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, out, lse, bh, lq, lk, d, scale, s);
  return (int)cudaErrorInvalidValue;
}
