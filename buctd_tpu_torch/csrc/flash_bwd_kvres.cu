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
// Two designs, by dtype:
//
// f32 (dtype 0):
//   flash_bwd_dq_kvres_kernel  one block per (bh, 64-row q tile): q (scaled
//     by scale * log2 e) and do staged once; 32-key K/V tiles stream through
//     a two-stage ring;
//   flash_bwd_dkv_kvres_kernel one block per (bh, 32-key tile): K and V staged
//     once; BQ-row tiles of q, do, lse and delta stream through a two-stage
//     ring.
// While a block computes on tile i, tile i+1's copy is in flight
// (cp_async.cuh).  The math is K2's f32 math, with the same thread layout:
// with p = exp2(s - lse * log2 e), keep the dropout mask and
// c = 1 / (1 - p_drop),
//   g = do v^T,  ds = p * (g * keep * c - delta),
//   dq = scale * ds k,  dv = (p * keep * c)^T do,  dk = scale * ds^T q,
// no atomics (each block owns its outputs), so the gradients are
// deterministic; the mask is regenerated from dropout_hash.cuh.  What bounds
// it on an H100: 6 (dq) and 8 (dk/dv) * L_q * L_k * d operations against a
// few (L, d) operands: arithmetic, f32 FMAs on the CUDA cores.  Shared
// memory, per block: dq 2 x 2 x 32 K/V rows + q, do (64 x D+1) and ds
// (64 x 33); at d = 96 106.75 KB (two blocks per SM).  dk/dv: K, V
// (32 x D+1), p*keep and ds (32 x BQ+1), and 2 stages of q, do, lse, delta
// (BQ rows); BQ is 64 where the block fits in 113 KB (two blocks per SM),
// else 32.  Streamed rows are padded by 16 bytes: 16-byte aligned for
// cp.async, and 8 consecutive rows in 8 distinct banks.
//
// bf16 (dtype 1, the training step under the switch): K2's tensor-core
// kernels (flash_bwd_tc.cuh) with the kv-resident schedule, a ring of
// tc::kKvresStages slots for the looped operand: they round as K2 does
// (q * scale, do, ds and p * keep * c to bf16), and rows that are not 16-byte
// aligned take their register load path.
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
// dk/dv (bh, lk, d) f32, allocated by the caller.  With f32 operands the
// streamed operands' row starts must be 4-byte aligned; otherwise, and on any
// other refused argument, they return cudaErrorInvalidValue without
// launching.  Each returns the cudaError_t of its launch; it launches on
// `stream` and does not synchronise.

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "dropout_hash.cuh"
#include "flash_bwd_tc.cuh"

namespace {

constexpr int kThreads = 128;   // 16 row groups (ty) x 8 column groups (tx)
constexpr int kTileQ = 64;
constexpr int kTileK = 32;
constexpr int kTwoBlocksPerSm = 113 * 1024;
using tc::kLog2e;
using Args = tc::BwdArgs;

// streamed row stride in floats: D * 4 + 16 bytes
template <int D>
__host__ __device__ constexpr int ring_stride() { return D + 4; }

// rows x D tile of src (row stride d) into dst (row stride D + 1), scaled;
// rows past `limit` and columns past d are 0 (synchronous loads)
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

// columns d..D of `rows` rows (stride `stride`) are never copied: zero them
template <int D>
__device__ __forceinline__ void zero_pad(float* buf, int rows, int stride, int d) {
  if (d < D)
    for (int i = threadIdx.x; i < rows * (D - d); i += kThreads)
      buf[(i / (D - d)) * stride + d + i % (D - d)] = 0.f;
}

// ------------------------------------------------------------------- dq ----
template <int D>
constexpr int dq_smem_bytes() {
  return 4 * kTileK * ring_stride<D>() * 4                   // 2 stages x (K, V)
         + 2 * kTileQ * (D + 1) * 4                          // q, do
         + kTileQ * (kTileK + 1) * 4;                        // ds
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kvres_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dq, int lq, int lk, int d, float scale,
                          Dropout dr, int width) {
  constexpr int SK = ring_stride<D>();
  constexpr int DS = D + 1;
  constexpr int DC = D / 8;             // dq columns per thread
  constexpr int KC = kTileK / 8;        // logit columns per thread
  constexpr int SS = kTileK + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* kv = reinterpret_cast<float*>(smem);   // [4][32][SK]
  float* qs = kv + 4 * kTileK * SK;              // kTileQ x DS
  float* dos = qs + kTileQ * DS;                 // kTileQ x DS
  float* dss = dos + kTileQ * DS;                // kTileQ x SS

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int bh = blockIdx.y, q0 = blockIdx.x * kTileQ;
  const bool drop = dr.keep_thr != 0u;
  const float* kb = k + (size_t)bh * lk * d;
  const float* vb = v + (size_t)bh * lk * d;
  const int row_bytes = d * 4;
  const int n_k = (lk + kTileK - 1) / kTileK;

  auto issue = [&](int k0, int slot) {
    copy_rows<kThreads>(kv + (2 * slot) * kTileK * SK, SK * 4, kb, row_bytes, k0, kTileK,
                        lk, width);
    copy_rows<kThreads>(kv + (2 * slot + 1) * kTileK * SK, SK * 4, vb, row_bytes, k0,
                        kTileK, lk, width);
  };
  issue(0, 0);
  cp_async_commit();
  zero_pad<D>(kv, 4 * kTileK, SK, d);

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

  for (int t = 0; t < n_k; ++t) {
    const int slot = t & 1, k0 = t * kTileK;
    if (t + 1 < n_k) issue(k0 + kTileK, slot ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* ks = kv + (2 * slot) * kTileK * SK;
    const float* vs = ks + kTileK * SK;

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
        bk[j] = ks[(tx + 8 * j) * SK + c];
        bv[j] = vs[(tx + 8 * j) * SK + c];
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
      for (int j = 0; j < DC; ++j) b[j] = ks[kk * SK + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();   // this slot and the ds tile are free again
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
template <int D, int BQ>
constexpr int dkv_smem_bytes() {
  return 2 * (2 * BQ * ring_stride<D>() * 4               // q, do
              + 2 * BQ * 4)                               // lse, delta
         + 2 * kTileK * (D + 1) * 4                       // k, v
         + 2 * kTileK * (BQ + 1) * 4;                     // p*keep, ds
}

template <int D>
constexpr int pick_bq() {
  return dkv_smem_bytes<D, 64>() <= kTwoBlocksPerSm ? 64 : 32;
}

template <int D, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kvres_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv, int lq, int lk,
                           int d, float scale, Dropout dr, int width_q, int width_do) {
  constexpr int SQ = ring_stride<D>();
  constexpr int SD = ring_stride<D>();
  constexpr int DS = D + 1;
  constexpr int DC = D / 8;             // dk/dv columns per thread
  constexpr int KR = kTileK / 16;       // key rows per thread
  constexpr int QC = BQ / 8;            // q columns per thread
  constexpr int PS = BQ + 1;
  // one ring stage: q | do | lse | delta, each part 16-byte aligned
  constexpr int kQBytes = BQ * SQ * 4;
  constexpr int kDoBytes = BQ * SD * 4;
  constexpr int kStage = kQBytes + kDoBytes + 2 * BQ * 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem + 2 * kStage);   // kTileK x DS
  float* vs = ks + kTileK * DS;                              // kTileK x DS
  float* pks = vs + kTileK * DS;                             // kTileK x PS: p * keep * c
  float* dss = pks + kTileK * PS;                            // kTileK x PS: ds

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int bh = blockIdx.y, k0 = blockIdx.x * kTileK;
  const bool drop = dr.keep_thr != 0u;
  const float qscale = scale * kLog2e;
  const float* qb = q + (size_t)bh * lq * d;
  const float* dob = dout + (size_t)bh * lq * d;
  const float* lseb = lse + (size_t)bh * lq;
  const float* deltab = delta + (size_t)bh * lq;
  const int n_q = (lq + BQ - 1) / BQ;

  auto q_of = [&](int slot) { return reinterpret_cast<float*>(smem + slot * kStage); };
  auto do_of = [&](int slot) {
    return reinterpret_cast<float*>(smem + slot * kStage + kQBytes);
  };
  auto lse_of = [&](int slot) {
    return reinterpret_cast<float*>(smem + slot * kStage + kQBytes + kDoBytes);
  };
  auto issue = [&](int q0, int slot) {
    copy_rows<kThreads>(q_of(slot), SQ * 4, qb, d * 4, q0, BQ, lq, width_q);
    copy_rows<kThreads>(do_of(slot), SD * 4, dob, d * 4, q0, BQ, lq, width_do);
    copy_rows<kThreads>(lse_of(slot), 4, lseb, 4, q0, BQ, lq, 4);
    copy_rows<kThreads>(lse_of(slot) + BQ, 4, deltab, 4, q0, BQ, lq, 4);
  };
  issue(0, 0);
  cp_async_commit();
  for (int slot = 0; slot < 2; ++slot) {
    zero_pad<D>(q_of(slot), BQ, SQ, d);
    zero_pad<D>(do_of(slot), BQ, SD, d);
  }
  stage<D>(ks, k + (size_t)bh * lk * d, k0, kTileK, lk, d, 1.f);
  stage<D>(vs, v + (size_t)bh * lk * d, k0, kTileK, lk, d, 1.f);

  float acc_k[KR][DC], acc_v[KR][DC];
#pragma unroll
  for (int i = 0; i < KR; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int t = 0; t < n_q; ++t) {
    const int slot = t & 1, q0 = t * BQ;
    if (t + 1 < n_q) issue(q0 + BQ, slot ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* qs = q_of(slot);
    const float* dos = do_of(slot);
    const float* lses = lse_of(slot);
    const float* dls = lses + BQ;

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
        bq[j] = qs[(tx + 8 * j) * SQ + c];
        bd[j] = dos[(tx + 8 * j) * SD + c];
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
      const float lse2 = lses[qc] * kLog2e;
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        const int kr = ty + 16 * i;
        const float p = r < lq ? exp2f(s[i][j] * qscale - lse2) : 0.f;
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
    for (int qq = 0; qq < BQ; ++qq) {
      float ap[KR], as[KR], bd[DC], bq[DC];
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        ap[i] = pks[(ty + 16 * i) * PS + qq];
        as[i] = dss[(ty + 16 * i) * PS + qq];
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        bd[j] = dos[qq * SD + tx + 8 * j];
        bq[j] = qs[qq * SQ + tx + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < KR; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          acc_v[i][j] = fmaf(ap[i], bd[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(as[i], bq[j], acc_k[i][j]);
        }
    }
    __syncthreads();   // this slot and the p/ds tiles are free again
  }

  // dk = scale * ds^T q (q was streamed unscaled)
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
        rk[c] = acc_k[i][j] * scale;
        rv[c] = acc_v[i][j];
      }
    }
  }
}

template <int D>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  const long long row_bytes = 4LL * a.d;
  const int wk = copy_width(a.k, row_bytes), wv = copy_width(a.v, row_bytes);
  const int width = wk < wv ? wk : wv;
  if (width == 0) return cudaErrorInvalidValue;
  constexpr int smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kvres_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.lq + kTileQ - 1) / kTileQ, a.bh);
  flash_bwd_dq_kvres_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      a.dq, a.lq, a.lk, a.d, a.scale, a.dr, width);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  const int width_q = copy_width(a.q, 4LL * a.d);
  const int width_do = copy_width(a.dout, 4LL * a.d);
  if (width_q == 0 || width_do == 0 || copy_width(a.lse, 4) == 0 ||
      copy_width(a.delta, 4) == 0)
    return cudaErrorInvalidValue;
  constexpr int BQ = pick_bq<D>();
  constexpr int smem = dkv_smem_bytes<D, BQ>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kvres_kernel<D, BQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.lk + kTileK - 1) / kTileK, a.bh);
  flash_bwd_dkv_kvres_kernel<D, BQ><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      a.dk, a.dv, a.lq, a.lk, a.d, a.scale, a.dr, width_q, width_do);
  return cudaGetLastError();
}

// f32 operands take the SIMT kernels, bf16 K2's tensor-core kernels with the
// kv-resident ring
template <bool kDq>
cudaError_t dispatch(const Args& a, int dtype, cudaStream_t s) {
  if (dtype == 1) return tc::launch_bwd<tc::kKvresStages, kDq>(a, s);
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

template <bool kDq>
int run(const Args& a, int dtype, void* stream) {
  if (a.bh <= 0 || a.bh > 65535 || a.lq <= 0 || a.lk <= 0 || a.d <= 0 || a.d > 128 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch<kDq>(a, dtype, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int buctd_flash_bwd_dq_kvres(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse,
                                        const float* delta, float* dq, int bh, int lq,
                                        int lk, int d, float scale, unsigned keep_thr,
                                        float keep_scale, unsigned seed, int dtype,
                                        void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, bh, lq, lk, d, scale,
               Dropout{keep_thr, keep_scale, seed}};
  return run<true>(a, dtype, stream);
}

extern "C" int buctd_flash_bwd_dkv_kvres(const void* q, const void* k, const void* v,
                                         const void* dout, const float* lse,
                                         const float* delta, float* dk, float* dv, int bh,
                                         int lq, int lk, int d, float scale,
                                         unsigned keep_thr, float keep_scale,
                                         unsigned seed, int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, bh, lq, lk, d, scale,
               Dropout{keep_thr, keep_scale, seed}};
  return run<false>(a, dtype, stream);
}
