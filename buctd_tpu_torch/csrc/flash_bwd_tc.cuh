// K2's mma.sync bf16 kernels: flash_bwd_dq_tc_kernel and
// flash_bwd_dkv_tc_kernel (see flash_bwd.cu's header for the math, the
// rounding points and what bounds them).  bf16 K2 and K2' run them where the
// TMA + wgmma kernels of flash_bwd_wgmma.cuh do not take the call (hwb::takes:
// a head dim that is no multiple of 8, such as 6 or 47, or a base that is not
// 16-byte aligned; no model path), and buctd_flash_bwd_dq_mma /
// buctd_flash_bwd_dkv_mma launch them at any shape, for the A/B against the
// wgmma kernels.  Included by flash_bwd.cu, which launches them with a
// two-stage ring (K2), and by flash_bwd_kvres.cu, which launches the same
// kernels with the deeper ring of the kv-resident schedule (K2',
// tc::kKvresStages): the ring depth is the template parameter Stages.
//
// The design, for both kernels:
//   * each of a block's 4 warps owns 16 rows of the block's 64-row tile (q
//     rows for dq, keys for dk/dv).  s, g = do v^T, p and ds stay in the mma
//     accumulators and are packed to bf16x2 as the A operand of the next
//     product (to_a): dq += ds k; the dk/dv warps hold s^T and g^T, so
//     (p keep c)^T and ds^T are A fragments for dv += .. do and dk += .. q'.
//     No (L_q, L_k) tile passes through shared memory;
//   * B operands come from shared memory by ldmatrix (.trans where the
//     contraction runs down the rows);
//   * the looped operand streams through a Stages-deep cp.async ring: K and V
//     tiles for dq; q, do, lse and delta tiles for dk/dv.  The block's own
//     tile (q' and do for dq, K and V for dk/dv) is staged once through
//     registers;
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

#pragma once

#include "dropout_hash.cuh"
#include "mma_bf16.cuh"

namespace tc {

// the looped tile: keys (dq) or q rows (dk/dv)
template <int D>
__host__ __device__ constexpr int loop_tile() { return D <= 64 ? 64 : 32; }

// Uncapped, dk/dv at d = 48 holds 204 registers a thread, 2 blocks a SM; held
// to 3 blocks (168 registers, no spill) it runs 21% faster at (32, 6912, 48)
// on an H100 (tools/bench_flash_bwd.py).  From d = 64 the cap spills, and the
// kernel keeps its registers.
template <int D>
constexpr int kDkvMinBlocks = D <= 48 ? 3 : 1;

// ------------------------------------------------------------------- dq ----
template <int D, int Stages>
constexpr int dq_smem_bytes() {
  // q', do (kRows x S); Stages x (K, V) (BC x S)
  return (2 * kRows + 2 * Stages * loop_tile<D>()) * stride<D>() * 2;
}

template <int D, int Stages>
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
  bf16* ring = dos + kRows * S;                // [slot][K, V]: BC x S each

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const bool drop = dr.keep_thr != 0u;
  const bf16* kb = k + (size_t)bh * lk * d;
  const bf16* vb = v + (size_t)bh * lk * d;
  const int n_k = (lk + BC - 1) / BC;

  auto issue = [&](int t) {   // key tile t into slot t % Stages
    bf16* slot = ring + (t % Stages) * 2 * BC * S;
    load_tile<kThreads, D, S>(slot, kb, t * BC, BC, lk, d, async_kv);
    load_tile<kThreads, D, S>(slot + BC * S, vb, t * BC, BC, lk, d, async_kv);
  };
  if (async_kv) zero_pad_tile<kThreads, D, S>(ring, 2 * Stages * BC, d);
  for (int t = 0; t < Stages - 1; ++t) {
    if (t < n_k) issue(t);
    cp_async_commit();
  }
  stage_tile<kThreads, D, S>(qs, q + (size_t)bh * lq * d, q0, kRows, lq, d,
                             ScaleBf16{__bfloat162float(__float2bfloat16(scale))});
  stage_tile<kThreads, D, S>(dos, dout + (size_t)bh * lq * d, q0, kRows, lq, d);

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
    const int k0 = t * BC;
    if (t + Stages - 1 < n_k) issue(t + Stages - 1);   // the slot tile t - 1 used
    cp_async_commit();                                 // (an empty group near the end)
    cp_async_wait<Stages - 1>();                       // tile t has landed
    __syncthreads();
    const bf16* ks = ring + (t % Stages) * 2 * BC * S;
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
template <int D, int Stages>
constexpr int dkv_smem_bytes() {
  // K, V (kRows x S); Stages x (q, do) (BR x S); Stages x (lse, delta, row
  // keys) (BR)
  return (2 * kRows + 2 * Stages * loop_tile<D>()) * stride<D>() * 2 +
         Stages * 3 * loop_tile<D>() * 4;
}

template <int D, int Stages>
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
  bf16* ring = vs + kRows * S;                 // [slot][q, do]: BR x S each
  float* stats = reinterpret_cast<float*>(ring + 2 * Stages * BR * S);   // [slot][lse, delta, key]

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

  auto issue = [&](int t) {   // q tile t into slot t % Stages
    const int slot = t % Stages;
    bf16* qs = ring + (2 * slot) * BR * S;
    load_tile<kThreads, D, S>(qs, qb, t * BR, BR, lq, d, async_q);
    load_tile<kThreads, D, S>(qs + BR * S, dob, t * BR, BR, lq, d, async_q);
    float* st = stats + slot * 3 * BR;
    copy_rows<kThreads>(st, 4, lseb, 4, t * BR, BR, lq, 4);
    copy_rows<kThreads>(st + BR, 4, deltab, 4, t * BR, BR, lq, 4);
  };
  if (async_q) zero_pad_tile<kThreads, D, S>(ring, 2 * Stages * BR, d);
  for (int t = 0; t < Stages - 1; ++t) {
    if (t < n_q) issue(t);
    cp_async_commit();
  }
  stage_tile<kThreads, D, S>(ks, k + (size_t)bh * lk * d, k0, kRows, lk, d);
  stage_tile<kThreads, D, S>(vs, v + (size_t)bh * lk * d, k0, kRows, lk, d);

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int t = 0; t < n_q; ++t) {
    const int slot = t % Stages, q0 = t * BR;
    if (t + Stages - 1 < n_q) issue(t + Stages - 1);
    cp_async_commit();
    cp_async_wait<Stages - 1>();
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

// ------------------------------------------------------------- launches ----
// The kernels' operands: q (bh, lq, d), k/v (bh, lk, d), dout (bh, lq, d), all
// bf16; lse, delta (bh, lq) f32; dq (bh, lq, d), dk/dv (bh, lk, d) f32.
struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  float *dq, *dk, *dv;
  int bh, lq, lk, d;
  float scale;
  Dropout dr;
};

template <int D, int Stages>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D, Stages>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<D, Stages>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool async_kv = rows_aligned<bf16>(a.k, a.d) && rows_aligned<bf16>(a.v, a.d);
  const dim3 grid((a.lq + kRows - 1) / kRows, a.bh);
  flash_bwd_dq_tc_kernel<D, Stages><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
      a.dq, a.lq, a.lk, a.d, a.scale, a.dr, async_kv);
  return cudaGetLastError();
}

template <int D, int Stages>
cudaError_t launch_dkv(const BwdArgs& a, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<D, Stages>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<D, Stages>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool async_q = rows_aligned<bf16>(a.q, a.d) && rows_aligned<bf16>(a.dout, a.d);
  const dim3 grid((a.lk + kRows - 1) / kRows, a.bh);
  flash_bwd_dkv_tc_kernel<D, Stages><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
      a.dk, a.dv, a.lq, a.lk, a.d, a.scale, a.dr, async_q);
  return cudaGetLastError();
}

// dq (kDq) or dk/dv, the head dim rounded up to a multiple of 16
template <int Stages, bool kDq>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t s) {
#define BUCTD_TC_BWD_CASE(n) \
  case n / 16: return kDq ? launch_dq<n, Stages>(a, s) : launch_dkv<n, Stages>(a, s);
  switch ((a.d + 15) / 16) {
    BUCTD_TC_BWD_CASE(16)
    BUCTD_TC_BWD_CASE(32)
    BUCTD_TC_BWD_CASE(48)
    BUCTD_TC_BWD_CASE(64)
    BUCTD_TC_BWD_CASE(80)
    BUCTD_TC_BWD_CASE(96)
    BUCTD_TC_BWD_CASE(112)
    BUCTD_TC_BWD_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef BUCTD_TC_BWD_CASE
}

}  // namespace tc
