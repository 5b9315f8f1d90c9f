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
// f32 (dtype 0): flash_bwd_dq_kernel, flash_bwd_dkv_kernel.  JAX runs f32 at
// Precision.HIGHEST (_mxu_precision :68), so these are exact f32 on the CUDA
// cores (no TF32): register-tiled SIMT like flash_fwd.cu, each thread owning a
// 4 x 4 (dq) or 2 x 8 (dk/dv) patch of the logit tile, operands staged in
// shared memory with odd row strides so column walks are free of bank
// conflicts; dq takes 64-row q tiles and 32-key tiles, dk/dv 32-key tiles and
// 64-row q tiles.  6 (dq) and 8 (dk/dv) x L_q L_k d operations against a few
// (L, d) operands bound them by f32 FMA issue.
//
// bf16 (dtype 1, the autocast training step): flash_bwd_dq_tc_kernel,
// flash_bwd_dkv_tc_kernel, on the tensor cores.  They round where JAX's kernels
// do at Precision.DEFAULT (the MXU's single bf16 pass) and accumulate in f32:
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
// What bounds the bf16 kernels.  At the training step's two calls (BH 32 at
// (L, d) = (6912, 48) and (1728, 96): 1.624e9 (row, key) pairs per kernel):
//   tensor cores  3 (dq) or 4 (dk/dv) products of 2 L_q L_k d operations:
//                 0.50 and 0.67 ms at 989 TFLOP/s;
//   MUFU ex2      one exp2 per pair, 16 a clock on each of 132 SMs: 0.39 ms
//                 at 1.98 GHz;
//   dropout hash  about 10 integer operations per pair (dropout_hash.cuh), 64
//                 a clock per SM: about 0.97 ms, the largest of the three.
// mma.sync (m16n8k16, bf16 in, f32 accumulate) takes the products below the
// other two floors, so it, and not wgmma/TMA, is the first step: wgmma pays
// only once the tensor cores set the pace.  The design:
//   * each of a block's 4 warps owns 16 rows of the block's 64-row tile (q
//     rows for dq, keys for dk/dv).  s, g = do v^T, p and ds stay in the mma
//     accumulators and are packed to bf16x2 as the A operand of the next
//     product (the m16n8 accumulator layout of two adjacent n-tiles is the
//     m16k16 A layout): dq += ds k; the dk/dv warps hold s^T and g^T, so
//     (p keep c)^T and ds^T are A fragments for dv += .. do and dk += .. q'.
//     No (L_q, L_k) tile passes through shared memory;
//   * B operands come from shared memory by ldmatrix (.trans where the
//     contraction runs down the rows); rows are padded by 16 bytes, an odd
//     number of 16-byte units, so the 8 rows of an 8x8 matrix fall in 8
//     distinct bank groups;
//   * the looped operand streams through a two-stage cp.async ring
//     (cp_async.cuh): K and V tiles for dq; q, do, lse and delta tiles for
//     dk/dv, whose key tile is 64 keys (the SIMT kernel's was 32), halving
//     its passes over q and do.  The block's own tile (q' and do for dq, K and
//     V for dk/dv) is staged once through registers;
//   * the exp2 and the hash are one pass over the accumulators per tile, the
//     per-row (dq) or per-query (dk/dv, from the ring) lse, delta and row key
//     read once per tile; the row keys of a dk/dv q tile are hashed once
//     per block into the ring;
//   * a streamed operand whose rows are not 16-byte aligned (d * 2 bytes or
//     its address) goes through registers into the same ring: a load path of
//     the kernel, never another kernel;
//   * d is padded with zeros in shared memory to the next multiple of 16;
//     keys >= L_k get p = 0, and queries >= L_q contribute nothing.
// The looped tile (keys for dq, q rows for dk/dv) is 64 wide at d <= 64 and 32
// above, which keeps the accumulators in registers at d = 128; at d <= 48 the
// dk/dv kernel is held to 3 blocks a SM (kDkvMinBlocks).
//
// C interface (bound with ctypes by buctd_tpu_torch/ops/flash_attention.py):
//   int buctd_flash_bwd_dq(q, k, v, dout, lse, delta, dq, bh, lq, lk, d, scale,
//                          keep_thr, keep_scale, seed, dtype, stream)
//   int buctd_flash_bwd_dkv(q, k, v, dout, lse, delta, dk, dv, bh, lq, lk, d,
//                           scale, keep_thr, keep_scale, seed, dtype, stream)
// q (bh, lq, d), k/v (bh, lk, d) and dout (bh, lq, d) contiguous, all f32
// (dtype 0) or all bf16 (dtype 1); lse and delta (bh, lq) f32; dq (bh, lq, d)
// and dk/dv (bh, lk, d) f32, allocated by the caller.  Each returns the
// cudaError_t of its launch; it launches on `stream` and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"
#include "dropout_hash.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  float *dq, *dk, *dv;
  int bh, lq, lk, d;
  float scale;
  Dropout dr;
};

// ============================================================ f32: SIMT ====
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

// ================================================= bf16: tensor cores ====
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // the block's own tile: q rows (dq), keys (dk/dv)

// the looped tile: keys (dq) or q rows (dk/dv)
template <int D>
__host__ __device__ constexpr int loop_tile() { return D <= 64 ? 64 : 32; }

// Uncapped, dk/dv at d = 48 holds 204 registers a thread, 2 blocks a SM; held
// to 3 blocks (168 registers, no spill) it runs 21% faster at (32, 6912, 48)
// on an H100 (tools/bench_flash_bwd.py).  From d = 64 the cap spills, and the
// kernel keeps its registers.
template <int D>
constexpr int kDkvMinBlocks = D <= 48 ? 3 : 1;

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

// rows x D tile of src (row stride d) into dst (row stride stride<D>()) through
// registers, times `mul` and rounded to bf16 when `scaled`; rows past `limit`
// and columns past d are 0
template <int D>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int row0, int rows,
                                      int limit, int d, float mul, bool scaled) {
  constexpr int S = stride<D>();
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    bf16 x = __float2bfloat16(0.f);
    if (row0 + r < limit && c < d) {
      x = src[(size_t)(row0 + r) * d + c];
      if (scaled) x = __float2bfloat16(__bfloat162float(x) * mul);
    }
    dst[r * S + c] = x;
  }
}

// rows [row0, row0 + rows) of src into a ring slot: cp.async in 16-byte copies
// when every row start is 16-byte aligned (zero_pad cleared columns d..D once),
// else through registers
template <int D>
__device__ __forceinline__ void load(bf16* dst, const bf16* src, int row0, int rows,
                                     int limit, int d, bool async) {
  if (async)
    copy_rows<kThreads>(dst, stride<D>() * 2, src, d * 2, row0, rows, limit, 16);
  else
    stage<D>(dst, src, row0, rows, limit, d, 1.f, false);
}

// columns d..D of `rows` rows: cp.async never writes them
template <int D>
__device__ __forceinline__ void zero_pad(bf16* buf, int rows, int d) {
  constexpr int S = stride<D>();
  if (d < D)
    for (int i = threadIdx.x; i < rows * (D - d); i += kThreads)
      buf[(i / (D - d)) * S + d + i % (D - d)] = __float2bfloat16(0.f);
}

// ------------------------------------------------------------------- dq ----
template <int D>
constexpr int dq_smem_bytes() {
  // q', do (kRows x S); 2 stages x (K, V) (BC x S)
  return (2 * kRows + 4 * loop_tile<D>()) * stride<D>() * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dq, int lq, int lk, int d, float scale,
                       Dropout dr, bool async_kv) {
  constexpr int S = stride<D>(), BC = loop_tile<D>();
  constexpr int KD = D / 16;      // k16 steps over d
  constexpr int NC = BC / 8;      // n8 tiles over the key tile
  constexpr int ND = D / 8;       // n8 tiles over d
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);   // kRows x S: q' = bf16(q * bf16(scale))
  bf16* dos = qs + kRows * S;                  // kRows x S: do
  bf16* ring = dos + kRows * S;                // [stage][K, V]: BC x S each

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const bool drop = dr.keep_thr != 0u;
  const bf16* kb = k + (size_t)bh * lk * d;
  const bf16* vb = v + (size_t)bh * lk * d;
  const int n_k = (lk + BC - 1) / BC;

  auto issue = [&](int t, int slot) {
    load<D>(ring + (2 * slot) * BC * S, kb, t * BC, BC, lk, d, async_kv);
    load<D>(ring + (2 * slot + 1) * BC * S, vb, t * BC, BC, lk, d, async_kv);
  };
  if (async_kv) zero_pad<D>(ring, 4 * BC, d);
  issue(0, 0);
  cp_async_commit();
  stage<D>(qs, q + (size_t)bh * lq * d, q0, kRows, lq, d,
           __bfloat162float(__float2bfloat16(scale)), true);
  stage<D>(dos, dout + (size_t)bh * lq * d, q0, kRows, lq, d, 1.f, false);

  // the lane's rows: gid and gid + 8 of its warp's 16
  float nlse2[2], dl[2];
  uint32_t row_key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + warp * 16 + gid + 8 * i;
    nlse2[i] = r < lq ? -lse[(size_t)bh * lq + r] * kLog2e : 0.f;
    dl[i] = r < lq ? delta[(size_t)bh * lq + r] : 0.f;
    row_key[i] = dropout_row_key(dr.seed, (uint32_t)bh, (uint32_t)r);
  }
  __syncthreads();   // q' and do staged
  uint32_t qa[KD][4], da[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    ldsm(qa[kk], qs + warp * 16 * S + kk * 16 + a_off<S>(lane));
    ldsm(da[kk], dos + warp * 16 * S + kk * 16 + a_off<S>(lane));
  }
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < n_k; ++t) {
    const int slot = t & 1, k0 = t * BC;
    if (t + 1 < n_k) issue(t + 1, slot ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ks = ring + (2 * slot) * BC * S;
    const bf16* vs = ks + BC * S;

    // s = q' k^T, g = do v^T: the warp's 16 rows x BC keys
    float s[NC][4], g[NC][4];
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = g[j][e] = 0.f;
#pragma unroll
    for (int n = 0; n < NC / 2; ++n)
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t b[4];
        ldsm(b, ks + n * 16 * S + kk * 16 + b_nk<S>(lane));
        mma(s[2 * n], qa[kk], b[0], b[1]);
        mma(s[2 * n + 1], qa[kk], b[2], b[3]);
        ldsm(b, vs + n * 16 * S + kk * 16 + b_nk<S>(lane));
        mma(g[2 * n], da[kk], b[0], b[1]);
        mma(g[2 * n + 1], da[kk], b[2], b[3]);
      }

    // ds = p (g keep c - delta), over s in place
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = k0 + j * 8 + tig * 2 + (e & 1);
        const float p = col < lk ? exp2f(fmaf(s[j][e], kLog2e, nlse2[i])) : 0.f;
        float gk = g[j][e];
        if (drop)
          gk = dropout_bits(row_key[i], (uint32_t)col) >= dr.keep_thr
                   ? gk * dr.keep_scale : 0.f;
        s[j][e] = p * (gk - dl[i]);
      }
    uint32_t dsa[NC / 2][4];
    to_a<NC>(dsa, s);

    // dq += ds k
#pragma unroll
    for (int kk = 0; kk < NC / 2; ++kk)
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t b[4];
        ldsm_t(b, ks + kk * 16 * S + n * 16 + b_kn<S>(lane));
        mma(acc[2 * n], dsa[kk], b[0], b[1]);
        mma(acc[2 * n + 1], dsa[kk], b[2], b[3]);
      }
    __syncthreads();   // this slot is free again
  }

#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = q0 + warp * 16 + gid + 8 * (e >> 1), c = j * 8 + tig * 2 + (e & 1);
      if (r < lq && c < d) dq[((size_t)bh * lq + r) * d + c] = acc[j][e] * scale;
    }
}

// ------------------------------------------------------------------ dkv ----
template <int D>
constexpr int dkv_smem_bytes() {
  // K, V (kRows x S); 2 stages x (q, do) (BR x S); 2 stages x (lse, delta,
  // row keys) (BR)
  return (2 * kRows + 4 * loop_tile<D>()) * stride<D>() * 2 + 2 * 3 * loop_tile<D>() * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads, kDkvMinBlocks<D>)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv, int lq, int lk,
                        int d, float scale, Dropout dr, bool async_q) {
  constexpr int S = stride<D>(), BR = loop_tile<D>();
  constexpr int KD = D / 16;      // k16 steps over d
  constexpr int NR = BR / 8;      // n8 tiles over the q tile
  constexpr int ND = D / 8;       // n8 tiles over d
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);   // kRows x S
  bf16* vs = ks + kRows * S;                   // kRows x S
  bf16* ring = vs + kRows * S;                 // [stage][q, do]: BR x S each
  float* stats = reinterpret_cast<float*>(ring + 4 * BR * S);   // [stage][lse, delta, key]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, k0 = blockIdx.x * kRows;
  const bool drop = dr.keep_thr != 0u;
  const float sb = __bfloat162float(__float2bfloat16(scale));
  const bf16* qb = q + (size_t)bh * lq * d;
  const bf16* dob = dout + (size_t)bh * lq * d;
  const float* lseb = lse + (size_t)bh * lq;
  const float* deltab = delta + (size_t)bh * lq;
  const int n_q = (lq + BR - 1) / BR;

  auto issue = [&](int t, int slot) {
    load<D>(ring + (2 * slot) * BR * S, qb, t * BR, BR, lq, d, async_q);
    load<D>(ring + (2 * slot + 1) * BR * S, dob, t * BR, BR, lq, d, async_q);
    float* st = stats + slot * 3 * BR;
    copy_rows<kThreads>(st, 4, lseb, 4, t * BR, BR, lq, 4);
    copy_rows<kThreads>(st + BR, 4, deltab, 4, t * BR, BR, lq, 4);
  };
  if (async_q) zero_pad<D>(ring, 4 * BR, d);
  issue(0, 0);
  cp_async_commit();
  stage<D>(ks, k + (size_t)bh * lk * d, k0, kRows, lk, d, 1.f, false);
  stage<D>(vs, v + (size_t)bh * lk * d, k0, kRows, lk, d, 1.f, false);

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int t = 0; t < n_q; ++t) {
    const int slot = t & 1, q0 = t * BR;
    if (t + 1 < n_q) issue(t + 1, slot ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    const float* st = stats + slot * 3 * BR;
    uint32_t* keys = reinterpret_cast<uint32_t*>(stats + slot * 3 * BR + 2 * BR);
    if (drop)
      for (int i = threadIdx.x; i < BR; i += kThreads)
        keys[i] = dropout_row_key(dr.seed, (uint32_t)bh, (uint32_t)(q0 + i));
    __syncthreads();
    // q' = bf16(q * bf16(scale)), in place: the ring holds q as copied
    bf16* qs = ring + (2 * slot) * BR * S;
    const bf16* dos = qs + BR * S;
    for (int i = threadIdx.x; i < BR * D / 8; i += kThreads) {
      const int r = i / (D / 8), c = (i - r * (D / 8)) * 8;
      uint4 x = *reinterpret_cast<const uint4*>(qs + r * S + c);
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        h[j] = __floats2bfloat162_rn(f.x * sb, f.y * sb);
      }
      *reinterpret_cast<uint4*>(qs + r * S + c) = x;
    }
    __syncthreads();

    // s^T = k q'^T, g^T = v do^T: the warp's 16 keys x BR queries
    float s[NR][4], g[NR][4];
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = g[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      ldsm(ka, ks + warp * 16 * S + kk * 16 + a_off<S>(lane));
      ldsm(va, vs + warp * 16 * S + kk * 16 + a_off<S>(lane));
#pragma unroll
      for (int n = 0; n < NR / 2; ++n) {
        uint32_t b[4];
        ldsm(b, qs + n * 16 * S + kk * 16 + b_nk<S>(lane));
        mma(s[2 * n], ka, b[0], b[1]);
        mma(s[2 * n + 1], ka, b[2], b[3]);
        ldsm(b, dos + n * 16 * S + kk * 16 + b_nk<S>(lane));
        mma(g[2 * n], va, b[0], b[1]);
        mma(g[2 * n + 1], va, b[2], b[3]);
      }
    }

    // p keep c over s, ds = p (g keep c - delta) over g; the lane's keys are
    // gid and gid + 8 of its warp's 16, its queries 8 j + 2 tig, +1
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int c = j * 8 + tig * 2 + cc;
        const bool valid = q0 + c < lq;
        const float nl = -st[c] * kLog2e, dlt = st[BR + c];
        const uint32_t rk = drop ? keys[c] : 0u;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 2 * i + cc;
          const float p = valid ? exp2f(fmaf(s[j][e], kLog2e, nl)) : 0.f;
          float pk = p, gk = g[j][e];
          if (drop) {
            const uint32_t key = (uint32_t)(k0 + warp * 16 + gid + 8 * i);
            const bool keep = dropout_bits(rk, key) >= dr.keep_thr;
            pk = keep ? p * dr.keep_scale : 0.f;
            gk = keep ? gk * dr.keep_scale : 0.f;
          }
          s[j][e] = pk;
          g[j][e] = p * (gk - dlt);
        }
      }
    uint32_t pa[NR / 2][4], dsa[NR / 2][4];
    to_a<NR>(pa, s);
    to_a<NR>(dsa, g);

    // dv += (p keep c)^T do, dk += ds^T q'
#pragma unroll
    for (int kk = 0; kk < NR / 2; ++kk)
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t b[4];
        ldsm_t(b, dos + kk * 16 * S + n * 16 + b_kn<S>(lane));
        mma(dva[2 * n], pa[kk], b[0], b[1]);
        mma(dva[2 * n + 1], pa[kk], b[2], b[3]);
        ldsm_t(b, qs + kk * 16 * S + n * 16 + b_kn<S>(lane));
        mma(dka[2 * n], dsa[kk], b[0], b[1]);
        mma(dka[2 * n + 1], dsa[kk], b[2], b[3]);
      }
    __syncthreads();   // this slot is free again
  }

#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = k0 + warp * 16 + gid + 8 * (e >> 1), c = j * 8 + tig * 2 + (e & 1);
      if (r < lk && c < d) {
        dk[((size_t)bh * lk + r) * d + c] = dka[j][e];
        dv[((size_t)bh * lk + r) * d + c] = dva[j][e];
      }
    }
}

// every row start of a (rows, d) bf16 array at p is 16-byte aligned
inline bool rows_aligned(const void* p, int d) { return copy_width(p, 2LL * d) == 16; }

template <int D>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool async_kv = rows_aligned(a.k, a.d) && rows_aligned(a.v, a.d);
  const dim3 grid((a.lq + kRows - 1) / kRows, a.bh);
  flash_bwd_dq_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
      a.dq, a.lq, a.lk, a.d, a.scale, a.dr, async_kv);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool async_q = rows_aligned(a.q, a.d) && rows_aligned(a.dout, a.d);
  const dim3 grid((a.lk + kRows - 1) / kRows, a.bh);
  flash_bwd_dkv_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
      a.dk, a.dv, a.lq, a.lk, a.d, a.scale, a.dr, async_q);
  return cudaGetLastError();
}

}  // namespace tc

// f32 operands take the SIMT kernels, bf16 the tensor-core ones
template <bool kDq>
cudaError_t dispatch(const Args& a, int dtype, cudaStream_t s) {
#define BUCTD_BWD_CASE(n)                                                \
  case n / 16:                                                           \
    if (dtype == 0) return kDq ? launch_dq<n>(a, s) : launch_dkv<n>(a, s); \
    return kDq ? tc::launch_dq<n>(a, s) : tc::launch_dkv<n>(a, s);
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
