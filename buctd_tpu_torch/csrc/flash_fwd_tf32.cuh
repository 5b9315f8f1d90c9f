// K1's f32 forward on the tensor cores: flash_fwd_tf32_kernel, out =
// dropout(softmax(q k^T * scale)) v and the natural-log lse of every row, for
// f32 operands (serving and evaluation).  Included by flash_fwd.cu, which
// launches it with a two-stage ring (K1, tf32::kStages), and by
// flash_fwd_kvres.cu, which launches the same kernel with the deeper ring of
// the kv-resident schedule (K1', tf32::kKvresStages), for the f32 calls that
// the TMA + wgmma kernel does not take (flash_fwd_tf32_wgmma.cuh::takes: a
// head dim no multiple of 8, unaligned bases), and by buctd_flash_fwd_mma for
// any f32 call (the A/B).
//
// It computes what JAX's _fwd_kernel (buctd_tpu/ops/flash_attention.py:86)
// computes for f32 operands at Precision.HIGHEST, and rounds nothing to a
// narrower type: both products are 3xTF32 (mma_tf32.cuh), f32-accurate to
// about 2^-21 relative, and p enters p v unrounded (split, like every other
// operand, into hi + lo).
//
// What bounds it.  At the evaluation path's two calls (BH 64 at (L, d) =
// (6912, 48) and (1728, 96): 3.25e9 (row, key) pairs, 6.60e11 operations), on
// an H100 SXM:
//   tensor cores  three tf32 passes of both products: 3 x 6.60e11 / 494.7
//                 TFLOP/s = 4.00 ms;
//   MUFU ex2      one exp2 a pair, 16 a clock on each of 132 SMs at 1980 MHz:
//                 0.78 ms;
//   the splits    every operand is split (cvt, and, sub, cvt) before its
//                 three products: K and V once a tile for the whole block,
//                 p in every warp.
// The CUDA cores' f32 FMAs, which the SIMT kernel flash_fwd_kernel
// (flash_fwd.cu) runs, bound the same work at 9.86 ms.
// The design, written for this card (not transcribed from the Pallas grid),
// is the bf16 kernel's (flash_fwd_tc.cuh) with the tf32 fragments and a wider
// block:
//   * a block owns a (bh, 128-row q tile); each of its 8 warps owns 16 rows.
//     q' = q * scale * log2 e (log2 e folded in f32, before the split) is
//     read once from global memory and split into the warp's hi and lo A
//     fragments, kept in registers;
//   * K and V tiles of 64 keys (32 from d = 96) stream through a Stages-deep
//     cp.async ring of f32 rows with stride D + 4; rows that are not 16-byte aligned (d = 47)
//     go through registers into the same ring; d is zero-padded to a
//     multiple of 16 in shared memory.  Once a tile has landed, the block
//     splits it once: hi in place in its slot, lo in a buffer beside the
//     ring.  Every warp reads every K and V fragment, so splitting a
//     fragment in registers would repeat each split in all 8 warps;
//     tools/bench_flash_fwd.py times 4-warp blocks, 32-key tiles and one
//     block an SM against these choices;
//   * s = q' K^T by mma.sync m16n8k8 (3xTF32, f32 accumulate) with K as the
//     B operand (b0 = K[key g][t], b1 = K[key g][t + 4]); s stays in the
//     accumulators, keys >= L_k get -inf, the row max is taken over the 4
//     lanes that share a row (__shfl_xor_sync 1, 2);
//   * p = exp2(s - m); each lane keeps its share of l, unrounded and
//     mask-free, and the 4 shares are summed once, at the end; dropout after
//     the sum, the hash keyed by the lane's true (bh, row, key);
//   * p V with p taken from the accumulators without a shuffle: a lane's C
//     holds keys 2t, 2t + 1 of an 8-key chunk, its A columns t, t + 4, so A
//     column t takes key 2t and column t + 4 key 2t + 1, and V's B fragment is
//     read in the same order: b0 = V[2t][g], b1 = V[2t + 1][g].  With the
//     D + 4 stride both the K and the permuted V reads are free of bank
//     conflicts.  No (L_q, L_k) tile passes through shared memory;
//   * each tile's p V starts from zero accumulators and enters o with one
//     f32 fma (o = o alpha + pv).  The tensor cores add into an accumulator
//     less exactly than an f32 add: with o itself as the accumulator of
//     every tile, the error grew with L_k to many times the SIMT kernel's,
//     and the f32 train step's K2, whose delta is rowsum(do out), missed its
//     gate against float64 (tests/test_torch_port_cuda.py holds out at long
//     rows to the SIMT kernel's accuracy).
//   * shared memory: (2 Stages + 2) x BK rows x (D + 4) words: 80 KB a block
//     at d = 48 with K1's two stages, 101 KB at d = 128; the registers (q's
//     hi and lo, o, the tile's pv and s) are capped at 128 below d = 96, so
//     that two blocks of 256 threads fit an SM (fwd_min_blocks).

#pragma once

#include <math.h>

#include "dropout_hash.cuh"
#include "mma_tf32.cuh"

namespace tf32 {

// the forward's key tile: 64 below d = 96, 32 from there, which keeps o, pv
// and s in registers at d = 128 (tools/bench_flash_fwd.py times 32 at every d)
template <int D>
__host__ __device__ constexpr int fwd_key_tile() { return D < 96 ? 64 : 32; }

// blocks an SM that the registers must allow: two below d = 96, where the
// 128-register cap costs a few spills and doubles the warps an SM holds
// (tools/bench_flash_fwd.py times one); one from there, where it would spill
// much more
template <int D>
__host__ __device__ constexpr int fwd_min_blocks() { return D < 96 ? 2 : 1; }

template <int D, int Stages>
constexpr int fwd_smem_bytes() {
  // Stages x (K, V) and the current tile's (K lo, V lo), BK x S words each
  return (2 * Stages + 2) * fwd_key_tile<D>() * stride<D>() * 4;
}

template <int D, int Stages>
__global__ void __launch_bounds__(kThreads, fwd_min_blocks<D>())
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, int lq, int lk, int d, float qscale,
                      Dropout dr, bool async_kv) {
  constexpr int S = stride<D>(), BK = fwd_key_tile<D>();
  constexpr int KD = D / 8;    // k8 steps over d
  constexpr int NK = BK / 8;   // n8 tiles over the key tile, k8 steps of p v
  constexpr int ND = D / 8;    // n8 tiles over d
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);   // [slot][K, V]: BK x S each
  float* lo = ring + 2 * Stages * BK * S;         // the current tile's K lo, V lo

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const bool drop = dr.keep_thr != 0u;
  const float* kb = k + (size_t)bh * lk * d;
  const float* vb = v + (size_t)bh * lk * d;
  const int n_k = (lk + BK - 1) / BK;

  auto issue = [&](int tile) {   // key tile `tile` into slot tile % Stages
    float* slot = ring + (tile % Stages) * 2 * BK * S;
    load_tile<kThreads, D, S>(slot, kb, tile * BK, BK, lk, d, async_kv);
    load_tile<kThreads, D, S>(slot + BK * S, vb, tile * BK, BK, lk, d, async_kv);
  };
  if (async_kv) zero_pad_tile<kThreads, D, S>(ring, 2 * Stages * BK, d);
  for (int i = 0; i < Stages - 1; ++i) {
    if (i < n_k) issue(i);
    cp_async_commit();
  }

  // the warp's A fragments of q', split once (a0 (gid, tig), a1 (gid + 8,
  // tig), a2 (gid, tig + 4), a3 (gid + 8, tig + 4) of each 8-column step);
  // rows past L_q and columns past d are 0
  const float* qb = q + (size_t)bh * lq * d;
  uint32_t q_hi[KD][4], q_lo[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = q0 + warp * 16 + gid + 8 * (e & 1), c = kk * 8 + tig + 4 * (e >> 1);
      split(r < lq && c < d ? qb[(size_t)r * d + c] * qscale : 0.f, q_hi[kk][e], q_lo[kk][e]);
    }

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
    // the tile split once for the whole block: hi = tf32(x) in place in the
    // slot, lo = tf32(x - hi) beside it (every warp reads every fragment)
    float* slot = ring + (t % Stages) * 2 * BK * S;
    split_tile<kThreads, D, S>(slot, lo, 2 * BK, 1.f);
    __syncthreads();
    const auto* k_hi = reinterpret_cast<const uint32_t*>(slot);
    const auto* v_hi = k_hi + BK * S;
    const auto* k_lo = reinterpret_cast<const uint32_t*>(lo);
    const auto* v_lo = k_lo + BK * S;

    // s = q' k^T: the warp's 16 rows x BK keys
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const int at = (n * 8 + gid) * S + kk * 8 + tig;   // K[key gid][tig], [tig + 4]
        const uint32_t b_hi[2] = {k_hi[at], k_hi[at + 4]}, b_lo[2] = {k_lo[at], k_lo[at + 4]};
        mma3(s[n], q_hi[kk], q_lo[kk], b_hi, b_lo);
      }

    // keys >= L_k at -inf (only the last tile has any); the row max over the
    // tile and the 4 lanes of the row (every tile holds a key < L_k, so it
    // is finite)
    if (k0 + BK > lk)
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + j * 8 + tig * 2 + (e & 1) >= lk) s[j][e] = -INFINITY;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);   // 0 on the first tile (m = -inf)
      m[i] = mx[i];
      l[i] *= alpha[i];
    }

    // p = exp2(s - m) over s; l takes p before dropout
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

    // pv = p v, 8 keys a step: A column tig takes key 2 tig (c0, c2), column
    // tig + 4 key 2 tig + 1 (c1, c3); V's B fragment in the same order.  The
    // tile's pv starts from 0 and enters o with one f32 fma: the tensor
    // cores add into their accumulator less exactly than an f32 add does,
    // and o would take every tile's products through it
    float pv[ND][4];
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t a_hi[4], a_lo[4];
      c_to_a(s[kk], a_hi, a_lo);
      const int row = (kk * 8 + 2 * tig) * S + gid;   // V[key 2 tig][gid], [2 tig + 1]
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int at = row + n * 8;
        const uint32_t b_hi[2] = {v_hi[at], v_hi[at + S]}, b_lo[2] = {v_lo[at], v_lo[at + S]};
        mma3(pv[n], a_hi, a_lo, b_hi, b_lo);
      }
    }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = fmaf(o[j][e], alpha[e >> 1], pv[j][e]);
    __syncthreads();   // this slot and the lo buffer are free again
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
cudaError_t launch_fwd_d(const float* q, const float* k, const float* v, float* out,
                         float* lse, int bh, int lq, int lk, int d, float scale,
                         Dropout dr, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D, Stages>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tf32_kernel<D, Stages>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool async_kv = rows_aligned<float>(k, d) && rows_aligned<float>(v, d);
  const dim3 grid((lq + kRows - 1) / kRows, bh);
  flash_fwd_tf32_kernel<D, Stages><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, lse, lq, lk, d, scale * kLog2e, dr, async_kv);
  return cudaGetLastError();
}

// q (bh, lq, d), k/v (bh, lk, d) f32 with 4-byte aligned rows (every f32
// tensor's); out (bh, lq, d) and lse (bh, lq) f32
template <int Stages>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, float* out, float* lse,
                       int bh, int lq, int lk, int d, float scale, Dropout dr,
                       cudaStream_t s) {
  if (copy_width(q, 4LL * d) == 0 || copy_width(k, 4LL * d) == 0 ||
      copy_width(v, 4LL * d) == 0)
    return cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
#define BUCTD_TF32_FWD_CASE(n)                                                          \
  case n / 16:                                                                          \
    return launch_fwd_d<n, Stages>(qf, kf, vf, out, lse, bh, lq, lk, d, scale, dr, s);
  switch ((d + 15) / 16) {
    BUCTD_TF32_FWD_CASE(16)
    BUCTD_TF32_FWD_CASE(32)
    BUCTD_TF32_FWD_CASE(48)
    BUCTD_TF32_FWD_CASE(64)
    BUCTD_TF32_FWD_CASE(80)
    BUCTD_TF32_FWD_CASE(96)
    BUCTD_TF32_FWD_CASE(112)
    BUCTD_TF32_FWD_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef BUCTD_TF32_FWD_CASE
}

}  // namespace tf32
