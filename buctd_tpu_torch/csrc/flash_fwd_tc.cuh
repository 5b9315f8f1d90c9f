// K1's bf16 forward on the tensor cores: flash_fwd_tc_kernel, out =
// dropout(softmax(q k^T * scale)) v and the natural-log lse of every row, for
// bf16 operands (the autocast training step).  Included by flash_fwd.cu, which
// launches it with a two-stage ring (K1, tc::kStages), and by
// flash_fwd_kvres.cu, which launches the same kernel with the deeper ring of
// the kv-resident schedule (K1', tc::kKvresStages).
//
// It computes what JAX's _fwd_kernel (buctd_tpu/ops/flash_attention.py:86)
// computes for bf16 operands at Precision.DEFAULT:
//   q' = bf16(q * bf16(scale))                      (:99), staged once;
//   s  = q' k^T with f32 sums                        (:107-109);
//   m, the running row max; p = exp(s - m) in f32; l = l alpha + sum(p) over
//        the unrounded, mask-free p                  (:112-118);
//   o  = o alpha + bf16(p keep c) v with f32 sums    (:126-128);
//   out = o / max(l, 1e-30), lse = m + ln max(l, 1e-30)   (:131-133).
// ops/flash_attention.py::flash_attention_reference rounds at the same points
// (relative to the final row max; this kernel, like JAX's, rounds p relative
// to the running max).
//
// What bounds it.  At the training step's two calls (BH 32 at (L, d) =
// (6912, 48) and (1728, 96): 1.624e9 (row, key) pairs), at 1980 MHz:
//   tensor cores  two products of 2 L_q L_k d operations: 0.334 ms;
//   MUFU ex2      one exp2 a pair, 16 a clock on each of 132 SMs: 0.388 ms;
//   dropout hash  about 10 integer operations a pair (dropout_hash.cuh), 64 a
//                 clock an SM: about 0.97 ms, the largest.
// The design, written for this card (not transcribed from the Pallas grid):
//   * a block owns a (bh, 64-row q tile); each of its 4 warps owns 16 rows.
//     q' is staged once through registers and kept as A fragments;
//   * K and V tiles of BK keys (64 at d <= 64, 32 above, which keeps the
//     accumulators in registers at d = 128) stream through a Stages-deep
//     cp.async ring; rows that are not 16-byte aligned go through registers
//     into the same ring (a load path of the kernel, never another kernel);
//     d is zero-padded to a multiple of 16 in shared memory;
//   * s = q' K^T by mma.sync m16n8k16 (bf16 in, f32 accumulate) with K as the
//     B operand through ldmatrix; s stays in the accumulators, is scaled by
//     log2 e in f32, keys >= L_k get -inf, and the row max is taken over the 4
//     lanes that share a row (__shfl_xor_sync 1, 2);
//   * p = exp2(s log2 e - m) (K6 measured expf at a third more than exp2f);
//     each lane keeps its share of l and the 4 shares are summed once, at the
//     end; the dropout hash is keyed by the lane's global (bh, row, col) from
//     the accumulator layout, as K2's kernels key it, so they regenerate the
//     mask;
//   * bf16(p keep c) is packed from the accumulators straight into A
//     fragments (to_a: the m16n8 layout of two n-tiles is the m16k16 A
//     layout) for o += p V, with V as the B operand through ldmatrix.trans.
//     No (L_q, L_k) tile passes through shared memory.

#pragma once

#include <math.h>

#include "dropout_hash.cuh"
#include "mma_bf16.cuh"

namespace tc {

// the forward's key tile
template <int D>
__host__ __device__ constexpr int fwd_key_tile() { return D <= 64 ? 64 : 32; }

template <int D, int Stages>
constexpr int fwd_smem_bytes() {
  // q' (kRows x S); Stages x (K, V) (BK x S)
  return (kRows + 2 * Stages * fwd_key_tile<D>()) * stride<D>() * 2;
}

template <int D, int Stages>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, float* __restrict__ out,
                    float* __restrict__ lse, int lq, int lk, int d, float scale,
                    Dropout dr, bool async_kv) {
  constexpr int S = stride<D>(), BK = fwd_key_tile<D>();
  constexpr int KD = D / 16;      // k16 steps over d
  constexpr int NK = BK / 8;      // n8 tiles over the key tile
  constexpr int ND = D / 8;       // n8 tiles over d
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);   // kRows x S: q' = bf16(q * bf16(scale))
  bf16* ring = qs + kRows * S;                 // [slot][K, V]: BK x S each

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const bool drop = dr.keep_thr != 0u;
  const bf16* kb = k + (size_t)bh * lk * d;
  const bf16* vb = v + (size_t)bh * lk * d;
  const int n_k = (lk + BK - 1) / BK;

  auto issue = [&](int t) {   // key tile t into slot t % Stages
    bf16* slot = ring + (t % Stages) * 2 * BK * S;
    load_tile<kThreads, D, S>(slot, kb, t * BK, BK, lk, d, async_kv);
    load_tile<kThreads, D, S>(slot + BK * S, vb, t * BK, BK, lk, d, async_kv);
  };
  if (async_kv) zero_pad_tile<kThreads, D, S>(ring, 2 * Stages * BK, d);
  for (int t = 0; t < Stages - 1; ++t) {
    if (t < n_k) issue(t);
    cp_async_commit();
  }
  stage_tile<kThreads, D, S>(qs, q + (size_t)bh * lq * d, q0, kRows, lq, d,
                             ScaleBf16{__bfloat162float(__float2bfloat16(scale))});

  // the lane's rows: gid and gid + 8 of its warp's 16.  m is the running max
  // of the log2-domain logits, l the lane's share of the running sum.
  float m[2], l[2];
  uint32_t row_key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + warp * 16 + gid + 8 * i;
    row_key[i] = dropout_row_key(dr.seed, (uint32_t)bh, (uint32_t)r);
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  __syncthreads();   // q' staged
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) ldsm(qa[kk], qs + warp * 16 * S + kk * 16 + a_off<S>(lane));
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int t = 0; t < n_k; ++t) {
    const int k0 = t * BK;
    if (t + Stages - 1 < n_k) issue(t + Stages - 1);   // the slot tile t - 1 used
    cp_async_commit();                                 // (an empty group near the end)
    cp_async_wait<Stages - 1>();                       // tile t has landed
    __syncthreads();
    const bf16* ks = ring + (t % Stages) * 2 * BK * S;
    const bf16* vs = ks + BK * S;

    // s = q' k^T: the warp's 16 rows x BK keys
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int n = 0; n < NK / 2; ++n)
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t b[4];
        ldsm(b, ks + n * 16 * S + kk * 16 + b_nk<S>(lane));
        mma(s[2 * n], qa[kk], b[0], b[1]);
        mma(s[2 * n + 1], qa[kk], b[2], b[3]);
      }

    // log2-domain logits, keys >= L_k at -inf; the row max over the tile and
    // the 4 lanes of the row (every tile holds a key < L_k, so it is finite)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + tig * 2 + (e & 1);
        s[j][e] = col < lk ? s[j][e] * kLog2e : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);   // 0 on the first tile (m = -inf)
      m[i] = mx[i];
      l[i] *= alpha[i];
    }

    // p = exp2(s - m) over s; l takes p before dropout, unrounded
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = exp2f(s[j][e] - m[i]);
        l[i] += p;
        if (drop)
          p = dropout_bits(row_key[i], (uint32_t)(k0 + j * 8 + tig * 2 + (e & 1))) >=
                      dr.keep_thr
                  ? p * dr.keep_scale : 0.f;
        s[j][e] = p;
      }
    uint32_t pa[NK / 2][4];
    to_a<NK>(pa, s);   // bf16(p keep c)

    // o = o alpha + p v
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk)
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t b[4];
        ldsm_t(b, vs + kk * 16 * S + n * 16 + b_kn<S>(lane));
        mma(o[2 * n], pa[kk], b[0], b[1]);
        mma(o[2 * n + 1], pa[kk], b[2], b[3]);
      }
    __syncthreads();   // this slot is free again
  }

  // out = o / max(l, 1e-30), lse = (m + log2 l) ln 2, l summed over the row's
  // 4 lanes
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = q0 + warp * 16 + gid + 8 * (e >> 1), c = j * 8 + tig * 2 + (e & 1);
      if (r < lq && c < d) out[((size_t)bh * lq + r) * d + c] = o[j][e] / l[e >> 1];
    }
  if (tig == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + warp * 16 + gid + 8 * i;
      if (r < lq) lse[(size_t)bh * lq + r] = (m[i] + log2f(l[i])) * kLn2;
    }
}

template <int D, int Stages>
cudaError_t launch_fwd_d(const void* q, const void* k, const void* v, float* out,
                         float* lse, int bh, int lq, int lk, int d, float scale,
                         Dropout dr, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D, Stages>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_kernel<D, Stages>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool async_kv = rows_aligned<bf16>(k, d) && rows_aligned<bf16>(v, d);
  const dim3 grid((lq + kRows - 1) / kRows, bh);
  flash_fwd_tc_kernel<D, Stages><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      out, lse, lq, lk, d, scale, dr, async_kv);
  return cudaGetLastError();
}

// q (bh, lq, d), k/v (bh, lk, d) bf16; out (bh, lq, d) and lse (bh, lq) f32
template <int Stages>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, float* out, float* lse,
                       int bh, int lq, int lk, int d, float scale, Dropout dr,
                       cudaStream_t s) {
#define BUCTD_TC_FWD_CASE(n)                                                         \
  case n / 16:                                                                       \
    return launch_fwd_d<n, Stages>(q, k, v, out, lse, bh, lq, lk, d, scale, dr, s);
  switch ((d + 15) / 16) {
    BUCTD_TC_FWD_CASE(16)
    BUCTD_TC_FWD_CASE(32)
    BUCTD_TC_FWD_CASE(48)
    BUCTD_TC_FWD_CASE(64)
    BUCTD_TC_FWD_CASE(80)
    BUCTD_TC_FWD_CASE(96)
    BUCTD_TC_FWD_CASE(112)
    BUCTD_TC_FWD_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef BUCTD_TC_FWD_CASE
}

}  // namespace tc
