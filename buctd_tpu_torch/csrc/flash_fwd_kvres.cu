// Flash-attention forward with K/V streamed through a cp.async ring (Hopper,
// sm_90a): out = dropout(softmax(q k^T * scale)) v, plus the
// natural-log logsumexp of every query row.  The same function as K1
// (flash_fwd.cu), with another schedule.
//
// Replaces buctd_tpu/ops/flash_attention.py::_fwd_kernel_kvres (:139), which
// the JAX package runs instead of _fwd_kernel when BUCTD_FLASH_KVRES is set
// (:474).  That TPU kernel keeps a q block resident, walks the kv sub-tiles in
// a loop inside the kernel, and streams them from HBM through a hand
// double-buffered DMA pair: the copy of tile i+1 is started before tile i is
// computed (kv_dma(ki + 1, 1 - slot), :177-181).  Two designs, by dtype:
//
// f32 (dtype 0, the evaluation path under the switch): flash_fwd_kvres_kernel.
// One thread block owns one (bh, 64-row q tile), exactly as K1, and the K/V
// tiles stream through a two-stage ring in shared memory filled by cp.async
// (cp_async.cuh): while the block computes on tile i, tile i+1's copy is in
// flight.  What bounds it on an H100: as K1, 4 * L_q * L_k * d operations
// against (L_q + 2 L_k) * d elements, far above the card's ridge: arithmetic,
// on the CUDA cores' f32 FMAs (the JAX path runs f32 at Precision.HIGHEST).
// The ring takes the loads off the critical path of that arithmetic; it
// cannot make the FMAs faster.  Math, thread layout and dropout are K1's: a
// 4 x (BK/8) patch of the logit tile and a 4 x D/8 patch of the output per
// thread, the online softmax in the exp2 domain with log2(e) folded into the
// staged q, -1e30 for ragged keys, the mask of dropout_hash.cuh applied after
// p entered the running sum.  Shared memory: 2 stages x (K, V) x BK rows, each
// row d * 4 bytes plus 16 of padding (row starts stay 16-byte aligned for
// cp.async, and 8 consecutive rows fall in 8 distinct banks), the q tile with
// an odd row stride and the p tile.  The key-tile depth BK is 64 where that
// block fits in 113 KB (two blocks per SM), else 32: at d = 96, 64 keys would
// take 140.5 KB (one block per SM) and 32 take 82.5 KB.
//
// bf16 (dtype 1, the training step under the switch): K1's tensor-core kernel
// (flash_fwd_tc.cuh) with the kv-resident schedule, a ring of
// tc::kKvresStages K/V slots: it rounds as K1 does, and rows that are not
// 16-byte aligned take its register load path.
//
// C interface (bound with ctypes by buctd_tpu_torch/ops/flash_attention.py),
// the same as buctd_flash_fwd:
//   int buctd_flash_fwd_kvres(q, k, v, out, lse, bh, lq, lk, d, scale,
//                             keep_thr, keep_scale, seed, dtype, stream)
// q (bh, lq, d), k/v (bh, lk, d) contiguous, f32 (dtype 0) or bf16 (dtype 1);
// out (bh, lq, d) and lse (bh, lq) f32, allocated by the caller.  f32 K and V
// row starts must be 4-byte aligned; otherwise, and on any other refused
// argument, it returns cudaErrorInvalidValue without launching.  Returns the
// cudaError_t of the launch; launches on `stream` and does not synchronise.

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "dropout_hash.cuh"
#include "flash_fwd_tc.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kThreads = 128;   // 16 row groups x 8 column groups
constexpr int kTwoBlocksPerSm = 113 * 1024;
using tc::kLn2;
using tc::kLog2e;
constexpr float kNegBig = -1e30f;

// K/V row stride in floats: D * 4 + 16 bytes
template <int D>
__host__ __device__ constexpr int kv_stride() { return D + 4; }

template <int D, int BK>
constexpr int smem_bytes() {
  return 4 * BK * kv_stride<D>() * 4   // 2 stages x (K, V)
         + kBlockQ * (D + 1) * 4       // q
         + kBlockQ * (BK + 1) * 4;     // p
}

template <int D>
constexpr int pick_bk() { return smem_bytes<D, 64>() <= kTwoBlocksPerSm ? 64 : 32; }

template <int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kvres_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ lse, int lq, int lk, int d, float qscale,
                       uint32_t keep_thr, float keep_scale, uint32_t seed, int width) {
  constexpr int SK = kv_stride<D>();
  constexpr int DS = D + 1;
  constexpr int DC = D / 8;    // output columns per thread
  constexpr int KC = BK / 8;   // logit columns per thread
  constexpr int PS = BK + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* kv = reinterpret_cast<float*>(smem);   // [4][BK][SK]
  float* qs = kv + 4 * BK * SK;                  // kBlockQ x DS
  float* ps = qs + kBlockQ * DS;                 // kBlockQ x PS

  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const float* qb = q + (size_t)bh * lq * d;
  const float* kb = k + (size_t)bh * lk * d;
  const float* vb = v + (size_t)bh * lk * d;
  const int row_bytes = d * 4;
  const int n_k = (lk + BK - 1) / BK;

  // slot s holds K in kv[2s] and V in kv[2s + 1]
  auto issue = [&](int k0, int slot) {
    copy_rows<kThreads>(kv + (2 * slot) * BK * SK, SK * 4, kb, row_bytes, k0, BK, lk,
                        width);
    copy_rows<kThreads>(kv + (2 * slot + 1) * BK * SK, SK * 4, vb, row_bytes, k0, BK, lk,
                        width);
  };
  issue(0, 0);
  cp_async_commit();

  // columns d..D of the ring are never copied: zero them once (q's are zero
  // too, but 0 * garbage could be NaN)
  if (d < D)
    for (int i = tid; i < 4 * BK * (D - d); i += kThreads)
      kv[(i / (D - d)) * SK + d + i % (D - d)] = 0.f;

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

  for (int t = 0; t < n_k; ++t) {
    const int slot = t & 1, k0 = t * BK;
    if (t + 1 < n_k) issue(k0 + BK, slot ^ 1);   // the slot tile t-1 used
    cp_async_commit();                           // (an empty group on the last tile)
    cp_async_wait<1>();                          // tile t has landed
    __syncthreads();
    const float* ks = kv + (2 * slot) * BK * SK;
    const float* vs = ks + BK * SK;

    float s[4][KC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float a[4], b[KC];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * DS + c];
#pragma unroll
      for (int j = 0; j < KC; ++j) b[j] = ks[(tx + 8 * j) * SK + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KC; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < KC; ++j)
      if (k0 + tx + 8 * j >= lk)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = kNegBig;

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < KC; ++j) mx = fmaxf(mx, s[i][j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        float p = exp2f(s[i][j] - m_new);
        sum += p;
        if (drop)   // after the sum: l stays the mask-free normalizer
          p = dropout_bits(row_key[i], (uint32_t)(k0 + tx + 8 * j)) >= keep_thr
                  ? p * keep_scale : 0.f;
        ps[(ty + 16 * i) * PS + tx + 8 * j] = p;
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
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ps[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) b[j] = vs[kk * SK + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) o[i][j] = fmaf(a[i], b[j], o[i][j]);
    }
    __syncthreads();   // this slot and the p tile are free again
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
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* lse,
                   int bh, int lq, int lk, int d, float scale, Dropout dr, int width,
                   cudaStream_t stream) {
  constexpr int BK = pick_bk<D>();
  constexpr int smem = smem_bytes<D, BK>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kvres_kernel<D, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_kvres_kernel<D, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), static_cast<float*>(lse),
      lq, lk, d, scale * kLog2e, dr.keep_thr, dr.keep_scale, dr.seed, width);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, void* lse,
                     int bh, int lq, int lk, int d, float scale, Dropout dr,
                     cudaStream_t s) {
  const long long row_bytes = 4LL * d;
  const int wk = copy_width(k, row_bytes), wv = copy_width(v, row_bytes);
  const int width = wk < wv ? wk : wv;
  if (width == 0) return cudaErrorInvalidValue;
#define BUCTD_FWD_CASE(n)                                                      \
  case n / 16:                                                                 \
    return launch<n>(q, k, v, out, lse, bh, lq, lk, d, scale, dr, width, s);
  switch ((d + 15) / 16) {
    BUCTD_FWD_CASE(16)
    BUCTD_FWD_CASE(32)
    BUCTD_FWD_CASE(48)
    BUCTD_FWD_CASE(64)
    BUCTD_FWD_CASE(80)
    BUCTD_FWD_CASE(96)
    BUCTD_FWD_CASE(112)
    BUCTD_FWD_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef BUCTD_FWD_CASE
}

}  // namespace

extern "C" int buctd_flash_fwd_kvres(const void* q, const void* k, const void* v,
                                     void* out, void* lse, int bh, int lq, int lk, int d,
                                     float scale, unsigned keep_thr, float keep_scale,
                                     unsigned seed, int dtype, void* stream) {
  if (bh <= 0 || bh > 65535 || lq <= 0 || lk <= 0 || d <= 0 || d > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dr{keep_thr, keep_scale, seed};
  if (dtype == 0) return (int)dispatch(q, k, v, out, lse, bh, lq, lk, d, scale, dr, s);
  if (dtype == 1)
    return (int)tc::launch_fwd<tc::kKvresStages>(q, k, v, static_cast<float*>(out),
                                                 static_cast<float*>(lse), bh, lq, lk, d,
                                                 scale, dr, s);
  return (int)cudaErrorInvalidValue;
}
