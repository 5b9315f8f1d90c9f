// K2's f32 kernels on the tensor cores: flash_bwd_dq_tf32_kernel and
// flash_bwd_dkv_tf32_kernel (see flash_bwd.cu's header for the math).
// Included by flash_bwd.cu, which launches them with a two-stage ring (K2,
// tf32::kStages), and by flash_bwd_kvres.cu, which launches the same kernels
// with the deeper ring of the kv-resident schedule (K2', tf32::kKvresStages).
//
// They compute what JAX's _dq_kernel and _dkv_kernel
// (buctd_tpu/ops/flash_attention.py:212, :363) compute for f32 operands at
// Precision.HIGHEST and round nothing to a narrower type: every product is
// 3xTF32 (mma_tf32.cuh), f32-accurate to about 2^-21 relative.
// ops/flash_attention.py::backward_tf32 emulates them.
//
// What bounds them.  At the f32 training shapes (BH 32 at (L, d) = (6912,
// 48) and (1728, 96): 1.624e9 (row, key) pairs a kernel), on an H100 SXM:
//   tensor cores  three tf32 passes of dq's 3 and dk/dv's 4 products of
//                 2 L_q L_k d operations: 3.00 and 4.00 ms at 494.7 TFLOP/s;
//   MUFU ex2      one exp2 a pair: 0.39 ms at 1.98 GHz;
//   dropout hash  about 10 integer operations a pair: 0.97 ms;
//   the splits    every operand is split (cvt, and, sub, cvt) before its three
//                 products: the looped tile once a tile for the block, the
//                 accumulators that become A operands in every warp.
// The SIMT kernels of flash_bwd.cu bound the same work on the CUDA cores'
// f32 FMAs at 7.39 and 9.86 ms.
//
// The design is the bf16 kernels' (flash_bwd_tc.cuh) in the tf32 fragments
// of f32 K1 (flash_fwd_tf32.cuh):
//   * each of a block's 4 warps owns 16 rows of the block's 64-row tile (q
//     rows for dq, keys for dk/dv).  q' = q * scale * log2 e, rounded to f32
//     before its split, gives s = q' k^T in the exp2 domain, in both kernels
//     from the same operand, and dk = ds^T q' ln 2;
//   * the block's own tile (q' and do for dq, K and V for dk/dv) is the A
//     operand of s and g.  dq's, up to d = 48, is read from device memory
//     once, split and kept in registers (D registers an operand, hi and lo);
//     above, and for dk/dv at every d, the tile is staged in shared memory
//     in f32 and a fragment is split as it is read, once a looped tile (at
//     d = 96 the register fragments alone would take 192 registers; at d =
//     48 registers made dq 19% faster and dk/dv 4% slower, 255 registers
//     against 130, on an H100: tools/bench_flash_bwd.py --dtype float32);
//   * the looped operand (K and V for dq; q, do, lse and delta for dk/dv)
//     streams through a Stages-deep cp.async ring of rows of stride D + 4
//     words; rows that are not 16-byte aligned go through registers into the
//     same ring.  Once a tile has landed the block splits it once: hi in
//     place, lo in a buffer beside the ring, q scaled to q' first;
//   * s and g stay in the accumulators (B: the looped rows, T[row g][t],
//     T[row g][t + 4]); ds, and for dv p keep c, become the A operand of the
//     last products without a shuffle (tf32::c_to_a: A column t takes the
//     looped row 2t, column t + 4 row 2t + 1) with the B operand read in the
//     same order (K for dq, do and q' for dk/dv: T[2t][g], T[2t + 1][g]).
//     Both reads are free of bank conflicts at the D + 4 stride
//     (tests/test_torch_port_flash_bwd_tf32.py models every product's
//     fragments and addresses).  No (L_q, L_k) tile passes through shared
//     memory;
//   * each looped tile's products of dq (dk, dv) start from zero and enter
//     the f32 sums with one add: the tensor cores' accumulator is not an f32
//     add (f32 K1 found it), and these sums run over up to 6912 keys or rows;
//   * the dropout mask comes from dropout_hash.cuh, keyed by the true (bh,
//     row, key); keys >= L_k get p = 0 and queries >= L_q contribute nothing.
// The looped tile is 64 keys for dq up to d = 48, else 32 (keys or q rows),
// which keeps s, g, the sums and a tile's products in registers.

#pragma once

#include "dropout_hash.cuh"
#include "flash_bwd_tc.cuh"   // tc::BwdArgs, the kernels' argument block
#include "mma_tf32.cuh"

namespace tf32 {

constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdRows = 16 * kBwdWarps;   // the block's own tile

// dq's own operands' A fragments kept in registers (else, and always for
// dk/dv, read from shared memory and split each looped tile)
template <int D>
__host__ __device__ constexpr bool bwd_reg_a() { return D <= 48; }

// the looped tile: keys (dq) or q rows (dk/dv)
template <int D, bool kDq>
__host__ __device__ constexpr int bwd_loop_tile() { return kDq && D <= 48 ? 64 : 32; }

// the warp's 16-row A fragment of k-step kk: from registers (RegA), or split
// from the warp's rows of a shared f32 tile
template <int D, bool RegA, int KD>
__device__ __forceinline__ void own_frag(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                         const uint32_t (&rhi)[KD][4],
                                         const uint32_t (&rlo)[KD][4], const float* tile,
                                         int kk) {
  if constexpr (RegA) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[e] = rhi[kk][e];
      lo[e] = rlo[kk][e];
    }
  } else {
    a_frag<stride<D>()>(hi, lo, tile, kk * 8);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// acc += part, the fold of one looped tile's products
template <int N>
__device__ __forceinline__ void fold(float (&acc)[N][4], const float (&part)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
}

// part = a b over one looped tile: a the warp's NL m16n8 accumulator tiles
// (16 rows x 8 NL looped rows), b the tile's (looped rows, D) operand, split
// (hi at b_hi, lo at b_lo, row stride S), read in the permuted order
template <int D, int NL>
__device__ __forceinline__ void product_from_acc(float (&part)[D / 8][4],
                                                 const float (&a)[NL][4],
                                                 const uint32_t* b_hi, const uint32_t* b_lo) {
  constexpr int S = stride<D>();
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  zero(part);
#pragma unroll
  for (int kk = 0; kk < NL; ++kk) {
    uint32_t ah[4], al[4];
    c_to_a(a[kk], ah, al);
    const int row = (kk * 8 + 2 * tig) * S + gid;   // B[2 tig][gid], B[2 tig + 1][gid]
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int at = row + n * 8;
      const uint32_t bh[2] = {b_hi[at], b_hi[at + S]}, bl[2] = {b_lo[at], b_lo[at + S]};
      mma3(part[n], ah, al, bh, bl);
    }
  }
}

// ------------------------------------------------------------------- dq ----
template <int D, int Stages>
constexpr int dq_smem_bytes() {
  // Stages x (K, V) and the current tile's (K lo, V lo), BC x S each; q' and
  // do (kBwdRows x S each) above d = 48
  return ((2 * Stages + 2) * bwd_loop_tile<D, true>() + (bwd_reg_a<D>() ? 0 : 2 * kBwdRows)) *
         stride<D>() * 4;
}

template <int D, int Stages>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, int lq, int lk, int d, float scale,
                         Dropout dr, bool async_kv) {
  constexpr int S = stride<D>(), BC = bwd_loop_tile<D, true>();
  constexpr int KD = D / 8;    // k8 steps over d
  constexpr int NC = BC / 8;   // n8 tiles over the key tile
  constexpr int ND = D / 8;    // n8 tiles over d
  constexpr int KR = bwd_reg_a<D>() ? KD : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);   // [slot][K, V]: BC x S each
  float* lo = ring + 2 * Stages * BC * S;         // the current tile's K lo, V lo
  float* qs = lo + 2 * BC * S;                    // q', do above d = 48: kBwdRows x S
  float* dos = qs + kBwdRows * S;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * kBwdRows;
  const bool drop = dr.keep_thr != 0u;
  const float qscale = scale * kLog2e;
  const float* kb = k + (size_t)bh * lk * d;
  const float* vb = v + (size_t)bh * lk * d;
  const int n_k = (lk + BC - 1) / BC;

  auto issue = [&](int t) {   // key tile t into slot t % Stages
    float* slot = ring + (t % Stages) * 2 * BC * S;
    load_tile<kBwdThreads, D, S>(slot, kb, t * BC, BC, lk, d, async_kv);
    load_tile<kBwdThreads, D, S>(slot + BC * S, vb, t * BC, BC, lk, d, async_kv);
  };
  if (async_kv) zero_pad_tile<kBwdThreads, D, S>(ring, 2 * Stages * BC, d);
  for (int t = 0; t < Stages - 1; ++t) {
    if (t < n_k) issue(t);
    cp_async_commit();
  }

  // q' and do: the warp's A fragments, split once, or the block's tile
  const float* qb = q + (size_t)bh * lq * d;
  const float* dob = dout + (size_t)bh * lq * d;
  uint32_t qh[KR][4], ql[KR][4], dh[KR][4], dlo[KR][4];
  if constexpr (bwd_reg_a<D>()) {
    a_frags<KD>(qh, ql, qb, q0 + warp * 16, lq, d, qscale);
    a_frags<KD>(dh, dlo, dob, q0 + warp * 16, lq, d, 1.f);
  } else {
    stage_tile<kBwdThreads, D, S>(qs, qb, q0, kBwdRows, lq, d, MulRn{qscale});
    stage_tile<kBwdThreads, D, S>(dos, dob, q0, kBwdRows, lq, d);
  }

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
  float acc[ND][4];
  zero(acc);

  for (int t = 0; t < n_k; ++t) {
    const int k0 = t * BC;
    if (t + Stages - 1 < n_k) issue(t + Stages - 1);   // the slot tile t - 1 used
    cp_async_commit();                                 // (an empty group near the end)
    cp_async_wait<Stages - 1>();                       // tile t has landed
    __syncthreads();
    float* slot = ring + (t % Stages) * 2 * BC * S;
    split_tile<kBwdThreads, D, S>(slot, lo, 2 * BC, 1.f);
    __syncthreads();
    const auto* k_hi = reinterpret_cast<const uint32_t*>(slot);
    const auto* v_hi = k_hi + BC * S;
    const auto* k_lo = reinterpret_cast<const uint32_t*>(lo);
    const auto* v_lo = k_lo + BC * S;

    // s = q' K^T, g = do V^T: the warp's 16 rows x BC keys
    float s[NC][4], g[NC][4];
    zero(s);
    zero(g);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qah[4], qal[4], dah[4], dal[4];
      own_frag<D, bwd_reg_a<D>()>(qah, qal, qh, ql, qs + warp * 16 * S, kk);
      own_frag<D, bwd_reg_a<D>()>(dah, dal, dh, dlo, dos + warp * 16 * S, kk);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int at = (n * 8 + gid) * S + kk * 8 + tig;   // K[key gid][tig], [tig + 4]
        const uint32_t kh2[2] = {k_hi[at], k_hi[at + 4]}, kl2[2] = {k_lo[at], k_lo[at + 4]};
        mma3(s[n], qah, qal, kh2, kl2);
        const uint32_t vh2[2] = {v_hi[at], v_hi[at + 4]}, vl2[2] = {v_lo[at], v_lo[at + 4]};
        mma3(g[n], dah, dal, vh2, vl2);
      }
    }

    // ds = p (g keep c - delta), over s in place
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = k0 + j * 8 + tig * 2 + (e & 1);
        const float p = col < lk ? exp2f(s[j][e] + nlse2[i]) : 0.f;
        float gk = g[j][e];
        if (drop)
          gk = dropout_bits(row_key[i], (uint32_t)col) >= dr.keep_thr
                   ? gk * dr.keep_scale : 0.f;
        s[j][e] = p * (gk - dl[i]);
      }

    // dq += ds K, the tile's products from zero
    float part[ND][4];
    product_from_acc<D, NC>(part, s, k_hi, k_lo);
    fold(acc, part);
    __syncthreads();   // this slot and the lo buffer are free again
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
template <int D, int Stages>
constexpr int dkv_smem_bytes() {
  // Stages x (q, do) and the current tile's (q' lo, do lo), BR x S each; K
  // and V (kBwdRows x S each); Stages x (lse, delta, row keys) (BR each)
  constexpr int BR = bwd_loop_tile<D, false>();
  return (((2 * Stages + 2) * BR + 2 * kBwdRows) * stride<D>() + Stages * 3 * BR) * 4;
}

template <int D, int Stages>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int lq, int lk,
                          int d, float scale, Dropout dr, bool async_q) {
  constexpr int S = stride<D>(), BR = bwd_loop_tile<D, false>();
  constexpr int KD = D / 8;    // k8 steps over d
  constexpr int NR = BR / 8;   // n8 tiles over the q tile
  constexpr int ND = D / 8;    // n8 tiles over d
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);   // [slot][q, do]: BR x S each
  float* lo = ring + 2 * Stages * BR * S;         // the current tile's q' lo, do lo
  float* ks = lo + 2 * BR * S;                    // K, V: kBwdRows x S each
  float* vs = ks + kBwdRows * S;
  float* stats = vs + kBwdRows * S;               // [slot][lse, delta, row key]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, k0 = blockIdx.x * kBwdRows;
  const bool drop = dr.keep_thr != 0u;
  const float qscale = scale * kLog2e;
  const float* qb = q + (size_t)bh * lq * d;
  const float* dob = dout + (size_t)bh * lq * d;
  const float* lseb = lse + (size_t)bh * lq;
  const float* deltab = delta + (size_t)bh * lq;
  const int n_q = (lq + BR - 1) / BR;

  auto issue = [&](int t) {   // q tile t into slot t % Stages
    const int slot = t % Stages;
    float* qs = ring + 2 * slot * BR * S;
    load_tile<kBwdThreads, D, S>(qs, qb, t * BR, BR, lq, d, async_q);
    load_tile<kBwdThreads, D, S>(qs + BR * S, dob, t * BR, BR, lq, d, async_q);
    float* st = stats + slot * 3 * BR;
    copy_rows<kBwdThreads>(st, 4, lseb, 4, t * BR, BR, lq, 4);
    copy_rows<kBwdThreads>(st + BR, 4, deltab, 4, t * BR, BR, lq, 4);
  };
  if (async_q) zero_pad_tile<kBwdThreads, D, S>(ring, 2 * Stages * BR, d);
  for (int t = 0; t < Stages - 1; ++t) {
    if (t < n_q) issue(t);
    cp_async_commit();
  }

  // K and V: the block's tile, its fragments split as they are read
  stage_tile<kBwdThreads, D, S>(ks, k + (size_t)bh * lk * d, k0, kBwdRows, lk, d);
  stage_tile<kBwdThreads, D, S>(vs, v + (size_t)bh * lk * d, k0, kBwdRows, lk, d);

  float dka[ND][4], dva[ND][4];
  zero(dka);
  zero(dva);

  for (int t = 0; t < n_q; ++t) {
    const int slot = t % Stages, q0 = t * BR;
    if (t + Stages - 1 < n_q) issue(t + Stages - 1);
    cp_async_commit();
    cp_async_wait<Stages - 1>();
    const float* st = stats + slot * 3 * BR;
    uint32_t* keys = reinterpret_cast<uint32_t*>(stats + slot * 3 * BR + 2 * BR);
    if (drop)
      for (int i = threadIdx.x; i < BR; i += kBwdThreads)
        keys[i] = dropout_row_key(dr.seed, (uint32_t)bh, (uint32_t)(q0 + i));
    __syncthreads();
    float* qs = ring + 2 * slot * BR * S;
    split_tile<kBwdThreads, D, S>(qs, lo, BR, qscale);              // q' = q scale log2 e
    split_tile<kBwdThreads, D, S>(qs + BR * S, lo + BR * S, BR, 1.f);
    __syncthreads();
    const auto* q_hi = reinterpret_cast<const uint32_t*>(qs);
    const auto* do_hi = q_hi + BR * S;
    const auto* q_lo = reinterpret_cast<const uint32_t*>(lo);
    const auto* do_lo = q_lo + BR * S;

    // s^T = K q'^T, g^T = V do^T: the warp's 16 keys x BR queries
    float s[NR][4], g[NR][4];
    zero(s);
    zero(g);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t kah[4], kal[4], vah[4], val[4];
      a_frag<S>(kah, kal, ks + warp * 16 * S, kk * 8);
      a_frag<S>(vah, val, vs + warp * 16 * S, kk * 8);
#pragma unroll
      for (int n = 0; n < NR; ++n) {
        const int at = (n * 8 + gid) * S + kk * 8 + tig;   // q'[query gid][tig], [tig + 4]
        const uint32_t qh2[2] = {q_hi[at], q_hi[at + 4]}, ql2[2] = {q_lo[at], q_lo[at + 4]};
        mma3(s[n], kah, kal, qh2, ql2);
        const uint32_t dh2[2] = {do_hi[at], do_hi[at + 4]}, dl2[2] = {do_lo[at], do_lo[at + 4]};
        mma3(g[n], vah, val, dh2, dl2);
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
          const float p = valid ? exp2f(s[j][e] + nl) : 0.f;
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

    // dv += (p keep c)^T do, dk += ds^T q', each tile's products from zero
    float part[ND][4];
    product_from_acc<D, NR>(part, s, do_hi, do_lo);
    fold(dva, part);
    product_from_acc<D, NR>(part, g, q_hi, q_lo);
    fold(dka, part);
    __syncthreads();   // this slot and the lo buffer are free again
  }

  // dk = scale ds^T q = ds^T q' ln 2
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = k0 + warp * 16 + gid + 8 * (e >> 1), c = j * 8 + tig * 2 + (e & 1);
      if (r < lk && c < d) {
        dk[((size_t)bh * lk + r) * d + c] = dka[j][e] * kLn2;
        dv[((size_t)bh * lk + r) * d + c] = dva[j][e];
      }
    }
}

// ------------------------------------------------------------- launches ----
template <int D, int Stages>
cudaError_t launch_dq(const tc::BwdArgs& a, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D, Stages>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tf32_kernel<D, Stages>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool async_kv = rows_aligned<float>(a.k, a.d) && rows_aligned<float>(a.v, a.d);
  const dim3 grid((a.lq + kBwdRows - 1) / kBwdRows, a.bh);
  flash_bwd_dq_tf32_kernel<D, Stages><<<grid, kBwdThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      a.dq, a.lq, a.lk, a.d, a.scale, a.dr, async_kv);
  return cudaGetLastError();
}

template <int D, int Stages>
cudaError_t launch_dkv(const tc::BwdArgs& a, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<D, Stages>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_tf32_kernel<D, Stages>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool async_q = rows_aligned<float>(a.q, a.d) && rows_aligned<float>(a.dout, a.d);
  const dim3 grid((a.lk + kBwdRows - 1) / kBwdRows, a.bh);
  flash_bwd_dkv_tf32_kernel<D, Stages><<<grid, kBwdThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      a.dk, a.dv, a.lq, a.lk, a.d, a.scale, a.dr, async_q);
  return cudaGetLastError();
}

// dq (kDq) or dk/dv of f32 operands with 4-byte aligned rows (every f32
// tensor's), the head dim rounded up to a multiple of 16
template <int Stages, bool kDq>
cudaError_t launch_bwd(const tc::BwdArgs& a, cudaStream_t s) {
  if (copy_width(a.q, 4LL * a.d) == 0 || copy_width(a.k, 4LL * a.d) == 0 ||
      copy_width(a.v, 4LL * a.d) == 0 || copy_width(a.dout, 4LL * a.d) == 0)
    return cudaErrorInvalidValue;
// (qualified: the bf16 launch_dq/launch_dkv, found by ADL on tc::BwdArgs,
// take the same arguments)
#define BUCTD_TF32_BWD_CASE(n) \
  case n / 16: return kDq ? tf32::launch_dq<n, Stages>(a, s) : tf32::launch_dkv<n, Stages>(a, s);
  switch ((a.d + 15) / 16) {
    BUCTD_TF32_BWD_CASE(16)
    BUCTD_TF32_BWD_CASE(32)
    BUCTD_TF32_BWD_CASE(48)
    BUCTD_TF32_BWD_CASE(64)
    BUCTD_TF32_BWD_CASE(80)
    BUCTD_TF32_BWD_CASE(96)
    BUCTD_TF32_BWD_CASE(112)
    BUCTD_TF32_BWD_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef BUCTD_TF32_BWD_CASE
}

}  // namespace tf32
