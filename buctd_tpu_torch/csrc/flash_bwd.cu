// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of
// out = dropout(softmax(q k^T * scale)) v, from the forward's lse.
//
// Replaces buctd_tpu/ops/flash_attention.py::_dq_kernel (:212) and
// ::_dkv_kernel (:363), the TPU kernels behind the custom VJP (:959-971),
// reached through _flash_bwd_impl (:681-768).  With p = exp(s - lse)
// recomputed per tile (s = scale * q k^T), keep the dropout mask and
// c = 1 / (1 - p_drop):
//   g  = do v^T,   ds = p * (g * keep * c - delta),   delta = rowsum(do * out)
//   dq = scale * ds k,   dv = (p * keep * c)^T do,   dk = scale * ds^T q
// As on the TPU there are two kernels and no atomics, so the gradients are
// deterministic: the dq kernel gives one block a (bh, q tile) and loops over
// key tiles; the dk/dv kernel gives one block a (bh, key tile) and loops over
// q tiles.  The TPU grid carried the sums across its sequential axis in VMEM
// scratch; here the loop is inside the block and the sums live in registers.
// No (L_q, L_k) matrix reaches device memory.  p is recomputed in the exp2
// domain (log2(e) applied in f32 to s and to lse, which the forward writes in
// the natural log), and the dropout mask is regenerated from dropout_hash.cuh,
// keyed by the global (bh, row, col).  Two designs, by the operands' dtype:
//
// f32 (dtype 0; the f32 train step): on the tensor cores in 3xTF32: every
// operand split into two tf32 halves and every product taken in three
// passes, f32-accurate to about 2^-21 relative, as JAX's f32 kernels are at
// Precision.HIGHEST (_mxu_precision :68).  They round nothing to a narrower
// type.  Two designs, by shape, behind the same C entries: the TMA + wgmma
// kernels flash_bwd_dq_tf32_wgmma_kernel and flash_bwd_dkv_tf32_wgmma_kernel
// (flash_bwd_tf32_wgmma.cuh: a TMA warp, split warps that write the looped
// operand's tf32 halves as read and transposed, consumer warpgroups on tf32
// wgmma) wherever their TMA loads take the call (t3b::takes: d a multiple of
// 8 and at most 128, q, k, v and do 16-byte aligned: d = 48, 96 and 112 on
// every path); the mma.sync kernels flash_bwd_dq_tf32_kernel and
// flash_bwd_dkv_tf32_kernel (flash_bwd_tf32.cuh, with a cp.async ring and any
// 4-byte row alignment) take the other f32 calls.  Their designs, and what
// bounds them, are described there.

// A second pair of C entries, buctd_flash_bwd_dq_simt and
// buctd_flash_bwd_dkv_simt, launches flash_bwd_dq_kernel and
// flash_bwd_dkv_kernel below, the exact-f32 SIMT kernels that the f32 path
// ran before the tensor-core ones: register-tiled like flash_fwd.cu's SIMT
// forward, each thread owning a 4 x 4 (dq) or 2 x 8 (dk/dv) patch of the
// logit tile, operands staged in shared memory with odd row strides so
// column walks are free of bank conflicts; dq takes 64-row q tiles and
// 32-key tiles, dk/dv 32-key tiles and 64-row q tiles.  6 (dq) and 8 (dk/dv)
// x L_q L_k d operations bound them by f32 FMA issue.  No path calls them:
// they are kept so that chip_smoke.py and tools/bench_flash_bwd.py can time
// the two f32 designs in turns.
//
// bf16 (dtype 1, the autocast training step): on the tensor cores, two
// designs (below).  Both round where JAX's kernels do at Precision.DEFAULT
// (the MXU's single bf16 pass) and accumulate in f32:
//   q' = bf16(q * bf16(scale))  (q_ref[0] * asarray(scale, q.dtype), :221,
//        :375), used for s = q' k^T and for dk = ds^T q', which then takes no
//        scale; dq takes * scale in f32 at the end (:242);
//   do, in bf16 (the MXU pass of :228, :390): the wrapper casts it once, a
//        (BH, L, d) pass that halves the dk/dv kernel's re-reads of do;
//   ds, in bf16 (ds.astype(kb.dtype), :235, :396);
//   p * keep * c, in bf16 for dv (the MXU pass of :386).
// ops/flash_attention.py::flash_attention_backward_reference rounds at the same
// points for bf16 operands.
//
// Two bf16 designs, by shape, behind the same C entries: the TMA + wgmma
// kernels flash_bwd_dq_wgmma_kernel and flash_bwd_dkv_wgmma_kernel
// (flash_bwd_wgmma.cuh: a TMA warp that streams the looped operand through
// a ring, two consumer warpgroups on wgmma) wherever their TMA loads take
// the call (hwb::takes: d a multiple of 8 and at most 128, q, k, v and the
// cast do 16-byte aligned: d = 48, 96 and 112 on every path); the mma.sync
// kernels flash_bwd_dq_tc_kernel and flash_bwd_dkv_tc_kernel
// (flash_bwd_tc.cuh, on mma_bf16.cuh, with a cp.async ring and any row
// alignment) take the other bf16 calls.  What
// bounds them, at the training steps' calls (BH 32 at (L, d) = (6912, 48),
// (1728, 96) and TransPose-H's (6912, 112)): the products, 3 (dq) or 4
// (dk/dv) of 2 L_q L_k d operations at 989 TFLOP/s (0.50 and 0.67 ms at
// CoAM-W48's two calls, 1.04 and 1.39 ms at TransPose-H's); one MUFU.EX2 a
// (row, key) pair (0.39 ms at CoAM-W48, 16 a clock on each of 132 SMs at
// 1.98 GHz); with dropout the hash, about 10 integer operations a pair at 64
// a clock on each SM (0.97 and 0.91 ms).  So the products lead at d = 112
// and the hash at d = 48 and 96: the wgmma kernels overlap the exp2 and the
// hash of S with G's product and take the products off the mma.sync
// kernels' shared-memory pace.  This file launches the wgmma kernels with a
// three-stage ring (hwb::kStages) and the mma.sync ones with two
// (tc::kStages); flash_bwd_kvres.cu (K2') each with a deeper one
// (hwb::kKvresStages, tc::kKvresStages).
//
// A third pair of C entries, buctd_flash_bwd_dq_mma and buctd_flash_bwd_dkv_mma,
// launches the mma.sync kernels of either dtype for any call (bf16:
// flash_bwd_tc.cuh; f32: flash_bwd_tf32.cuh): each dtype's backward before
// its wgmma kernels, kept so that chip_smoke.py and tools/bench_flash_bwd.py
// can time the two in turns.
//
// C interface (bound with ctypes by buctd_tpu_torch/ops/flash_attention.py):
//   int buctd_flash_bwd_dq(q, k, v, dout, lse, delta, dq, bh, lq, lk, d, scale,
//                          keep_thr, keep_scale, seed, dtype, stream)
//   int buctd_flash_bwd_dkv(q, k, v, dout, lse, delta, dk, dv, bh, lq, lk, d,
//                           scale, keep_thr, keep_scale, seed, dtype, stream)
//   int buctd_flash_bwd_dq_simt, buctd_flash_bwd_dkv_simt (the same
//                           arguments; dtype must be 0)
//   int buctd_flash_bwd_dq_mma, buctd_flash_bwd_dkv_mma (the same arguments)
//   int buctd_flash_bwd_blocks_per_sm(d, dropout, dq): blocks of the bf16
//       wgmma dq (dq != 0) or dk/dv kernel resident on one SM at head dim d
//       (0 where it has none)
//   int buctd_flash_bwd_tf32_blocks_per_sm(d, dropout, dq): the same for the
//       f32 wgmma kernels
// q (bh, lq, d), k/v (bh, lk, d) and dout (bh, lq, d) contiguous, all f32
// (dtype 0) or all bf16 (dtype 1); lse and delta (bh, lq) f32; dq (bh, lq, d)
// and dk/dv (bh, lk, d) f32, allocated by the caller.  Each returns the
// cudaError_t of its launch; it launches on `stream` and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dropout_hash.cuh"
#include "flash_bwd_tc.cuh"
#include "flash_bwd_tf32.cuh"
#include "flash_bwd_tf32_wgmma.cuh"
#include "flash_bwd_wgmma.cuh"

namespace {

using tc::kLn2;
using tc::kLog2e;
using Args = tc::BwdArgs;

// ================================================ f32: SIMT, the A/B only ====
constexpr int kThreads = 128;   // 16 row groups (ty) x 8 column groups (tx)
constexpr int kTileQ = 64;
constexpr int kTileK = 32;

// rows x D tile of src (row stride d) into dst (row stride D + 1), scaled;
// rows past `limit` and columns past d are 0
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int row0, int rows,
                                      int limit, int d, float mul) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (row0 + r < limit && c < d) x = src[(size_t)(row0 + r) * d + c] * mul;
    dst[r * (D + 1) + c] = x;
  }
}

// ------------------------------------------------------------------- dq ----
template <int D>
constexpr int dq_smem_floats() {
  // q, do (64 x D+1); k, v (32 x D+1); ds (64 x 33)
  return 2 * kTileQ * (D + 1) + 2 * kTileK * (D + 1) + kTileQ * (kTileK + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int lq, int lk, int d, float scale,
                    Dropout dr) {
  constexpr int DS = D + 1;
  constexpr int DC = D / 8;             // dq columns per thread
  constexpr int KC = kTileK / 8;        // logit columns per thread
  constexpr int SS = kTileK + 1;
  extern __shared__ float smem[];
  float* qs = smem;                     // kTileQ x DS, q * scale * log2(e)
  float* dos = qs + kTileQ * DS;        // kTileQ x DS
  float* ks = dos + kTileQ * DS;        // kTileK x DS
  float* vs = ks + kTileK * DS;         // kTileK x DS
  float* dss = vs + kTileK * DS;        // kTileQ x SS

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int bh = blockIdx.y, q0 = blockIdx.x * kTileQ;
  const bool drop = dr.keep_thr != 0u;

  stage<D>(qs, q + (size_t)bh * lq * d, q0, kTileQ, lq, d, scale * kLog2e);
  stage<D>(dos, dout + (size_t)bh * lq * d, q0, kTileQ, lq, d, 1.f);

  float lse2[4], dl[4], acc[4][DC];
  uint32_t row_key[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse2[i] = r < lq ? lse[(size_t)bh * lq + r] * kLog2e : 0.f;
    dl[i] = r < lq ? delta[(size_t)bh * lq + r] : 0.f;
    row_key[i] = dropout_row_key(dr.seed, (uint32_t)bh, (uint32_t)r);
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  const float* kb = k + (size_t)bh * lk * d;
  const float* vb = v + (size_t)bh * lk * d;
  for (int k0 = 0; k0 < lk; k0 += kTileK) {
    __syncthreads();   // the previous tile's k/ds reads are done
    stage<D>(ks, kb, k0, kTileK, lk, d, 1.f);
    stage<D>(vs, vb, k0, kTileK, lk, d, 1.f);
    __syncthreads();

    float s[4][KC], g[4][KC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KC; ++j) s[i][j] = g[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float aq[4], ad[4], bk[KC], bv[KC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        aq[i] = qs[(ty + 16 * i) * DS + c];
        ad[i] = dos[(ty + 16 * i) * DS + c];
      }
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        bk[j] = ks[(tx + 8 * j) * DS + c];
        bv[j] = vs[(tx + 8 * j) * DS + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          s[i][j] = fmaf(aq[i], bk[j], s[i][j]);
          g[i][j] = fmaf(ad[i], bv[j], g[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const int col = k0 + tx + 8 * j;
        const float p = col < lk ? exp2f(s[i][j] - lse2[i]) : 0.f;
        float gk = g[i][j];
        if (drop)
          gk = dropout_bits(row_key[i], (uint32_t)col) >= dr.keep_thr
                   ? gk * dr.keep_scale : 0.f;
        dss[(ty + 16 * i) * SS + tx + 8 * j] = p * (gk - dl[i]);
      }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[4], b[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dss[(ty + 16 * i) * SS + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) b[j] = ks[kk * DS + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= lq) continue;
    float* row = dq + ((size_t)bh * lq + r) * d;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + 8 * j;
      if (c < d) row[c] = acc[i][j] * scale;
    }
  }
}

// ------------------------------------------------------------------ dkv ----
template <int D>
constexpr int dkv_smem_floats() {
  // k, v (32 x D+1); q, do (64 x D+1); p*keep and ds (32 x 65); lse2, delta
  return 2 * kTileK * (D + 1) + 2 * kTileQ * (D + 1) + 2 * kTileK * (kTileQ + 1) +
         2 * kTileQ;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int lq, int lk,
                     int d, float scale, Dropout dr) {
  constexpr int DS = D + 1;
  constexpr int DC = D / 8;             // dk/dv columns per thread
  constexpr int KR = kTileK / 16;       // key rows per thread
  constexpr int QC = kTileQ / 8;        // q columns per thread
  constexpr int PS = kTileQ + 1;
  extern __shared__ float smem[];
  float* ks = smem;                     // kTileK x DS
  float* vs = ks + kTileK * DS;         // kTileK x DS
  float* qs = vs + kTileK * DS;         // kTileQ x DS, q * scale * log2(e)
  float* dos = qs + kTileQ * DS;        // kTileQ x DS
  float* pks = dos + kTileQ * DS;       // kTileK x PS: p * keep * c
  float* dss = pks + kTileK * PS;       // kTileK x PS: ds
  float* lse2s = dss + kTileK * PS;     // kTileQ
  float* dls = lse2s + kTileQ;          // kTileQ

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int bh = blockIdx.y, k0 = blockIdx.x * kTileK;
  const bool drop = dr.keep_thr != 0u;
  const float qscale = scale * kLog2e;

  stage<D>(ks, k + (size_t)bh * lk * d, k0, kTileK, lk, d, 1.f);
  stage<D>(vs, v + (size_t)bh * lk * d, k0, kTileK, lk, d, 1.f);

  float acc_k[KR][DC], acc_v[KR][DC];
#pragma unroll
  for (int i = 0; i < KR; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const float* qb = q + (size_t)bh * lq * d;
  const float* dob = dout + (size_t)bh * lq * d;
  for (int q0 = 0; q0 < lq; q0 += kTileQ) {
    __syncthreads();   // the previous tile's q/do/p/ds reads are done
    stage<D>(qs, qb, q0, kTileQ, lq, d, qscale);
    stage<D>(dos, dob, q0, kTileQ, lq, d, 1.f);
    if (tid < kTileQ) {
      const int r = q0 + tid;
      lse2s[tid] = r < lq ? lse[(size_t)bh * lq + r] * kLog2e : 0.f;
      dls[tid] = r < lq ? delta[(size_t)bh * lq + r] : 0.f;
    }
    __syncthreads();

    // transposed logits: rows = keys ty + 16 i, columns = queries tx + 8 j
    float s[KR][QC], g[KR][QC];
#pragma unroll
    for (int i = 0; i < KR; ++i)
#pragma unroll
      for (int j = 0; j < QC; ++j) s[i][j] = g[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float ak[KR], av[KR], bq[QC], bd[QC];
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        ak[i] = ks[(ty + 16 * i) * DS + c];
        av[i] = vs[(ty + 16 * i) * DS + c];
      }
#pragma unroll
      for (int j = 0; j < QC; ++j) {
        bq[j] = qs[(tx + 8 * j) * DS + c];
        bd[j] = dos[(tx + 8 * j) * DS + c];
      }
#pragma unroll
      for (int i = 0; i < KR; ++i)
#pragma unroll
        for (int j = 0; j < QC; ++j) {
          s[i][j] = fmaf(ak[i], bq[j], s[i][j]);
          g[i][j] = fmaf(av[i], bd[j], g[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < QC; ++j) {
      const int qc = tx + 8 * j, r = q0 + qc;
      const uint32_t row_key = dropout_row_key(dr.seed, (uint32_t)bh, (uint32_t)r);
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        const int kr = ty + 16 * i;
        const float p = r < lq ? exp2f(s[i][j] - lse2s[qc]) : 0.f;
        float pk = p, gk = g[i][j];
        if (drop) {
          const bool keep = dropout_bits(row_key, (uint32_t)(k0 + kr)) >= dr.keep_thr;
          pk = keep ? p * dr.keep_scale : 0.f;
          gk = keep ? gk * dr.keep_scale : 0.f;
        }
        pks[kr * PS + qc] = pk;
        dss[kr * PS + qc] = p * (gk - dls[qc]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < kTileQ; ++qq) {
      float ap[KR], as[KR], bd[DC], bq[DC];
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        ap[i] = pks[(ty + 16 * i) * PS + qq];
        as[i] = dss[(ty + 16 * i) * PS + qq];
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        bd[j] = dos[qq * DS + tx + 8 * j];
        bq[j] = qs[qq * DS + tx + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < KR; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          acc_v[i][j] = fmaf(ap[i], bd[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(as[i], bq[j], acc_k[i][j]);
        }
    }
  }

  // dk = scale * ds^T q = ds^T (q * scale * log2 e) * ln 2
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= lk) continue;
    float* rk = dk + ((size_t)bh * lk + r) * d;
    float* rv = dv + ((size_t)bh * lk + r) * d;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + 8 * j;
      if (c < d) {
        rk[c] = acc_k[i][j] * kLn2;
        rv[c] = acc_v[i][j];
      }
    }
  }
}

template <int D>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  const int smem = dq_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.lq + kTileQ - 1) / kTileQ, a.bh);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      a.dq, a.lq, a.lk, a.d, a.scale, a.dr);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  const int smem = dkv_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.lk + kTileK - 1) / kTileK, a.bh);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      a.dk, a.dv, a.lq, a.lk, a.d, a.scale, a.dr);
  return cudaGetLastError();
}

// the SIMT kernels (f32 only), the head dim rounded up to a multiple of 16
template <bool kDq>
cudaError_t dispatch_simt(const Args& a, cudaStream_t s) {
#define BUCTD_BWD_CASE(n) \
  case n / 16: return kDq ? launch_dq<n>(a, s) : launch_dkv<n>(a, s);
  switch ((a.d + 15) / 16) {
    BUCTD_BWD_CASE(16)
    BUCTD_BWD_CASE(32)
    BUCTD_BWD_CASE(48)
    BUCTD_BWD_CASE(64)
    BUCTD_BWD_CASE(80)
    BUCTD_BWD_CASE(96)
    BUCTD_BWD_CASE(112)
    BUCTD_BWD_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef BUCTD_BWD_CASE
}

// The kernels of a C entry: the tensor cores by dtype and shape (kAuto), the
// SIMT kernels (f32 only) or the mma.sync ones of either dtype
enum Kernels { kAuto, kSimt, kMma };

// each dtype takes its wgmma kernels where their rule holds (bf16:
// hwb::takes; f32: t3b::takes), else its mma.sync ones
template <bool kDq>
int run(const Args& a, int dtype, void* stream, Kernels which = kAuto) {
  if (a.bh <= 0 || a.bh > 65535 || a.lq <= 0 || a.lk <= 0 || a.d <= 0 || a.d > 128 ||
      (dtype != 0 && dtype != 1) || (which == kSimt && dtype != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which == kSimt) return (int)dispatch_simt<kDq>(a, s);
  if (dtype == 1)
    return (int)(which == kAuto && hwb::takes(a.q, a.k, a.v, a.dout, a.d)
                     ? hwb::launch_bwd<hwb::kStages, kDq>(a, s)
                     : tc::launch_bwd<tc::kStages, kDq>(a, s));
  return (int)(which == kAuto && t3b::takes(a.q, a.k, a.v, a.dout, a.d)
                   ? t3b::launch_bwd<t3b::kStages, kDq>(a, s)
                   : tf32::launch_bwd<tf32::kStages, kDq>(a, s));
}

}  // namespace

extern "C" int buctd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, float* dq, int bh, int lq,
                                  int lk, int d, float scale, unsigned keep_thr,
                                  float keep_scale, unsigned seed, int dtype,
                                  void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, bh, lq, lk, d, scale,
               Dropout{keep_thr, keep_scale, seed}};
  return run<true>(a, dtype, stream);
}

extern "C" int buctd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, float* dk, float* dv, int bh,
                                   int lq, int lk, int d, float scale,
                                   unsigned keep_thr, float keep_scale, unsigned seed,
                                   int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, bh, lq, lk, d, scale,
               Dropout{keep_thr, keep_scale, seed}};
  return run<false>(a, dtype, stream);
}

extern "C" int buctd_flash_bwd_dq_simt(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse,
                                       const float* delta, float* dq, int bh, int lq,
                                       int lk, int d, float scale, unsigned keep_thr,
                                       float keep_scale, unsigned seed, int dtype,
                                       void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, bh, lq, lk, d, scale,
               Dropout{keep_thr, keep_scale, seed}};
  return run<true>(a, dtype, stream, kSimt);
}

extern "C" int buctd_flash_bwd_dkv_simt(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse,
                                        const float* delta, float* dk, float* dv, int bh,
                                        int lq, int lk, int d, float scale,
                                        unsigned keep_thr, float keep_scale,
                                        unsigned seed, int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, bh, lq, lk, d, scale,
               Dropout{keep_thr, keep_scale, seed}};
  return run<false>(a, dtype, stream, kSimt);
}

extern "C" int buctd_flash_bwd_dq_mma(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse,
                                      const float* delta, float* dq, int bh, int lq,
                                      int lk, int d, float scale, unsigned keep_thr,
                                      float keep_scale, unsigned seed, int dtype,
                                      void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, bh, lq, lk, d, scale,
               Dropout{keep_thr, keep_scale, seed}};
  return run<true>(a, dtype, stream, kMma);
}

extern "C" int buctd_flash_bwd_dkv_mma(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse,
                                       const float* delta, float* dk, float* dv, int bh,
                                       int lq, int lk, int d, float scale,
                                       unsigned keep_thr, float keep_scale,
                                       unsigned seed, int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, bh, lq, lk, d, scale,
               Dropout{keep_thr, keep_scale, seed}};
  return run<false>(a, dtype, stream, kMma);
}

extern "C" int buctd_flash_bwd_blocks_per_sm(int d, int dropout, int dq) {
  return hwb::blocks_per_sm<hwb::kStages>(d, dropout != 0, dq != 0);
}

extern "C" int buctd_flash_bwd_tf32_blocks_per_sm(int d, int dropout, int dq) {
  return t3b::blocks_per_sm<t3b::kStages>(d, dropout != 0, dq != 0);
}
