// K2's bf16 backward for Hopper: flash_bwd_dq_wgmma_kernel and
// flash_bwd_dkv_wgmma_kernel, dq, dk and dv of out = dropout(softmax(q k^T *
// scale)) v from the forward's lse, for bf16 operands, on TMA loads and
// warpgroup MMAs (wgmma).  Included by flash_bwd.cu (K2: a two-stage ring,
// kStages) and by flash_bwd_kvres.cu (K2': the same kernels with the deeper
// ring of tc::kKvresStages, so K2' equals K2 bit for bit).  Both take them for
// every bf16 call whose head dim is a multiple of 8 and whose q, k, v and do
// start 16-byte aligned (takes(): TMA wants 16-byte strides and bases); the
// other bf16 calls run the mma.sync kernels of flash_bwd_tc.cuh.
//
// They replace JAX's _dq_kernel (buctd_tpu/ops/flash_attention.py:212) and
// _dkv_kernel (:363), and the ring variants _dq_kernel_kvres (:245) and
// _dkv_kernel_kvres (:295), for bf16 operands at Precision.DEFAULT, and
// compute what the mma.sync kernels compute (flash_bwd.cu's header):
//   q' = bf16(q * bf16(scale)), used for s and for dk (which takes no scale);
//   do in bf16, cast once by the wrapper;
//   p  = exp2(s log2 e - lse log2 e), from the forward's natural-log lse;
//   ds = bf16(p (g keep c - delta)), g = do v^T;
//   dq = (ds k) scale, dv = bf16(p keep c)^T do, dk = ds^T q', f32 sums;
//   the mask is dropout_hash.cuh's hash of the global (bh, row, col).
// Two kernels and no atomics, as in JAX: one block a (bh, q tile) for dq and
// one a (bh, key tile) for dk/dv, so the gradients are deterministic.
//
// What bounds them.  dq's three products (s, g, ds k) and dk/dv's four (s^T,
// g^T, dv, dk), 2 L_q L_k d operations each at the dense bf16 rate; one
// MUFU.EX2 a (row, key) pair in each kernel; with dropout the hash (about 10
// integer operations a pair) in each.  At d = 112 (TransPose-H training) the
// products lead; at d = 48 and 96 (CoAM-W48) the hash does.
//
// The design, for both kernels:
//   * a block owns 64 kConsumers rows of its own operand (q rows for dq, keys
//     for dk/dv): warps 0 .. 4 kConsumers - 1 are consumer warpgroups of 64
//     rows each, then a TMA warp and, in dk/dv, two helper warps.  No
//     setmaxnreg: any block of more than 8 warps puts 3 warps on one of the
//     SM's 4 schedulers, and ptxas (12.9) then compiles every thread to 168
//     registers, whatever setmaxnreg asks (as in the forward).  The
//     accumulators are sized to that (the tiles below).  An 8-warp block of the two
//     consumer warpgroups alone, the TMA loads issued by whichever warpgroup
//     freed a slot last, ran 1.1x slower on an H100;
//   * the TMA warp's lane 0 loads the block's own tiles once (q and do for
//     dq, K and V for dk/dv), then the looped operand into a ring of Stages
//     slots with full and empty barriers (K and V for dq, each with barriers
//     of its own, so V of a tile is refilled while K is still read by dQ +=
//     ds K; q and do for dk/dv).  Rows are cut into 64-column panels of 128
//     bytes with the 128-byte swizzle; d is padded to a panel by TMA's zero
//     fill past the tensor's edge, and only ceil(d / 16) k16 steps are
//     issued.  Every wait traps after tma::kWaitLimitNs.  K2 takes a 3-slot
//     ring (2 left dq and dk/dv up to 1.3x slower), K2' 4;
//   * q' = bf16(q * bf16(scale)) is formed in shared memory, in place, over
//     the landed tile (JAX's rounding), then a proxy fence lets wgmma read
//     it: dq's own q tile once, each consumer warpgroup its own rows (then a
//     barrier of its 128 threads); each of dk/dv's ring slots by the helper
//     warps, which also load the slot's -lse log2 e, delta and dropout row
//     keys (rows past L_q get 0, which makes their p = 1 meet do = 0 and g =
//     delta = 0: they add nothing) and arrive on the slot's `ready` barrier.
//     dq's rows read their lse and delta by plain loads;
//   * each consumer warpgroup issues its products when ready: taking turns
//     at the tensor cores (the forward's kPingPong) ran up to 1.3x slower
//     here, and 16-row q tiles above d = 64 (no serialization) 1.2-1.4x
//     slower (tools/bench_flash_bwd.py's bq16);
//   * dq, a warpgroup's 64 q rows over key tiles of BK (dq_key_tile):
//     S = q' K^T and G = do V^T are wgmma.m64nBKk16 with A (q', do) and B
//     (the K or V tile, K-major) from shared memory, committed as two
//     groups: p = exp2 over S (and the dropout bits, kept as a mask) runs
//     while G's product is in flight; the col < L_k mask on the ragged last
//     tile only; ds goes to bf16 A fragments in registers (the m64
//     accumulator layout is the register-A layout, hw::to_p) and dQ += ds K
//     is wgmma with A from registers and B = the K tile read MN-major (the
//     transpose bit): no transpose pass, no (L_q, L_k) tile in shared memory.
//     dQ of tile t stays in flight while S and G of tile t + 1 are issued;
//   * dk/dv, a warpgroup's 64 keys over q tiles of BQ (dkv_q_tile): S^T =
//     K q'^T and G^T = V do^T with A = the resident K or V rows and B = the
//     ring's q' or do tile, K-major; p, keep and ds come out in (key, query)
//     layout, the register-A layout of dV += (p keep c)^T do and dK += ds^T
//     q', whose B is the same swizzled do or q' tile read MN-major: no second
//     copy.  lse, delta and the row keys are read per column pair from the
//     slot's stats.  S^T and G^T overlap as in dq; dV and dK of tile t stay
//     in flight while S^T and G^T of t + 1 are issued;
//   * the tiles, from the f32 registers a consumer thread holds: dq S BK / 2,
//     G BK / 2, ds fragments BK / 4, dQ D / 2; dk/dv S^T BQ / 2, G^T BQ / 2,
//     the p and ds fragments BQ / 4 each, dK D / 2, dV D / 2.  BK = 64 at
//     every d (152 with S and G of the next tile in flight at d = 112; 128 at
//     d = 48 would be 184); BQ = 64 up to d = 64 and 32 above (176 at d = 112,
//     where ptxas still serializes dk/dv's wgmma for want of registers:
//     C7512); accumulators that start from zero start opaque to the compiler
//     (a known zero materialized beside products in flight made ptxas
//     serialize them, C7515);
//   * dropout is a template parameter: the dropout-0 instantiation carries no
//     hash; with dropout each kernel hashes each (row, key) pair once.

#pragma once

#include <math.h>

#include "dropout_hash.cuh"
#include "flash_bwd_tc.cuh"
#include "flash_fwd_wgmma.cuh"
#include "mma_bf16.cuh"
#include "tma.cuh"
#include "wgmma_bf16.cuh"

namespace hwb {

using hw::kPanel;                                    // bf16 columns of a swizzled row
using hw::panels;
using tc::bf16;
constexpr int kConsumers = 2;                        // consumer warpgroups
constexpr int kRows = 64 * kConsumers;               // the block's own rows
// the consumers and a TMA warp (dq: 288 threads), and two helper warps that
// form q' and the stats of the ring's slots (dk/dv: 352; one left dk/dv up
// to 1.5x slower at dropout 0)
constexpr int kHelpers = 64;
constexpr int kDqThreads = 128 * kConsumers + 32;
constexpr int kDkvThreads = 128 * kConsumers + 32 + kHelpers;
constexpr int kStages = 3;                           // K2's ring
constexpr int kKvresStages = 4;                      // K2''s, deeper
constexpr int kDqKeyTile = 64;                       // dq's key tile at every d
constexpr int kDkvNarrowTile = 64;                   // dk/dv's q tile up to d = 64
constexpr int kDkvWideTile = 32;                     // and above
// S (S^T) and G (G^T) committed as two groups, the exp2 and the hash of S
// while G's product runs; false: one wait for both
constexpr bool kOverlap = true;

template <int D>
__host__ __device__ constexpr int dq_key_tile() { return kDqKeyTile; }

template <int D>
__host__ __device__ constexpr int dkv_q_tile() { return D <= 64 ? kDkvNarrowTile : kDkvWideTile; }

// a tile of `rows` rows of D columns: panels of rows x 128 bytes
template <int D>
__host__ __device__ constexpr int tile_bytes(int rows) { return panels<D>() * rows * 128; }

template <int D, int Stages>
__host__ __device__ constexpr int dq_smem_bytes() {
  // 1024 bytes of slack to align the tiles; q', do; Stages x (K, V); the
  // barriers
  return 1024 + 2 * tile_bytes<D>(kRows) + 2 * Stages * tile_bytes<D>(dq_key_tile<D>()) +
         8 * (1 + 4 * Stages);
}

template <int D, int Stages>
__host__ __device__ constexpr int dkv_smem_bytes() {
  // slack; K, V; Stages x (q', do); Stages x (-lse log2 e, delta, row key) a
  // q row; the barriers
  return 1024 + 2 * tile_bytes<D>(kRows) + 2 * Stages * tile_bytes<D>(dkv_q_tile<D>()) +
         Stages * 3 * dkv_q_tile<D>() * 4 + 8 * (1 + 3 * Stages);
}

// bf16 calls these kernels take: TMA's 16-byte strides and bases, for q, k,
// v and the cast do
inline bool takes(const void* q, const void* k, const void* v, const void* dout, int d) {
  return hw::takes(q, k, v, d) && reinterpret_cast<uintptr_t>(dout) % 16 == 0;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

// q' = bf16(q * sc) over `bytes` of a tile in place, by `n` threads (`h`
// the thread's index among them): the swizzle moves 16-byte chunks only, so
// whole rows are scaled as a flat array; padding stays 0.  Then the proxy
// fence that lets wgmma (the async proxy) see the stores.
__device__ __forceinline__ void scale_tile(unsigned char* tile, int bytes, int h, int n,
                                           float sc) {
#pragma unroll 4
  for (int i = h * 16; i < bytes; i += n * 16) {
    uint4 x = *reinterpret_cast<const uint4*>(tile + i);
    x.x = hw::scale_pair(x.x, sc);
    x.y = hw::scale_pair(x.y, sc);
    x.z = hw::scale_pair(x.z, sc);
    x.w = hw::scale_pair(x.w, sc);
    *reinterpret_cast<uint4*>(tile + i) = x;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// acc (64 x N) = A B^T over KD k16 steps, A the warpgroup's 64 rows of a tile
// at shared address a (panels of ARows rows), B the N-row tile at b, both
// K-major: one committed group behind a fence of its own, its first k-step
// write-only
template <int N, int KD, int ARows>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint32_t a, uint32_t b) {
  wg::keep(acc);
  wg::fence();
  wg::Ss<N>::mma_zero(acc, wg::sw128_desc(a, 16, 1024), wg::sw128_desc(b, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < KD; ++kk)
    wg::Ss<N>::mma(acc, wg::sw128_desc(a + (kk / 4) * ARows * 128 + (kk % 4) * 32, 16, 1024),
                   wg::sw128_desc(b + (kk / 4) * N * 128 + (kk % 4) * 32, 16, 1024));
  wg::commit();
  wg::keep(acc);
}

// the dropout bits of a tile, one a thread's accumulator element
template <int N>
struct KeepMask {
  uint32_t w[(N + 31) / 32];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < (N + 31) / 32; ++i) w[i] = 0u;
  }
  __device__ __forceinline__ void set(int i, bool keep) { w[i / 32] |= (uint32_t)keep << (i % 32); }
  __device__ __forceinline__ bool get(int i) const { return (w[i / 32] >> (i % 32)) & 1u; }
};

// ------------------------------------------------------------------- dq ----
template <int D, int Stages, bool kDrop>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dq, int lq, int lk, int d, float scale,
                          Dropout dr) {
  constexpr int BK = dq_key_tile<D>(), P = panels<D>();
  constexpr int KD = D / 16;        // k16 steps of S and G over d
  constexpr int KV = BK / 16;       // k16 steps of ds K over the key tile
  constexpr int QB = tile_bytes<D>(kRows), KB = tile_bytes<D>(BK);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);      // q', then the block's do
  unsigned char* dos = qs + QB;
  unsigned char* ks = dos + QB;                 // Stages slots of KB
  unsigned char* vs = ks + Stages * KB;
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(vs + Stages * KB);
  uint64_t* k_full = qdo_full + 1;
  uint64_t* k_empty = k_full + Stages;
  uint64_t* v_full = k_empty + Stages;
  uint64_t* v_empty = v_full + Stages;

  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const int n_k = (lk + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the warpgroup (kConsumers: the TMA warp's), broadcast from lane 0 so the
  // compiler sees the role branches warp-uniform
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    tma::init(qdo_full, 1);
    for (int s = 0; s < Stages; ++s) {
      tma::init(k_full + s, 1);
      tma::init(v_full + s, 1);
      tma::init(k_empty + s, 4 * kConsumers);
      tma::init(v_empty + s, 4 * kConsumers);
    }
    tma::fence_init();
  }
  __syncthreads();

  if (wgi == kConsumers) {
    // ---- the TMA warp: the block's q and do, then the K and V ring ----
    if (lane == 0) {
      tma::prefetch_map(&q_map);
      tma::prefetch_map(&do_map);
      tma::prefetch_map(&k_map);
      tma::prefetch_map(&v_map);
      tma::expect_tx(qdo_full, 2 * QB);
      for (int p = 0; p < P; ++p) {
        tma::load_3d(qs + p * kRows * 128, &q_map, qdo_full, p * kPanel, q0, bh);
        tma::load_3d(dos + p * kRows * 128, &do_map, qdo_full, p * kPanel, q0, bh);
      }
      for (int t = 0; t < n_k; ++t) {
        const int s = t % Stages;
        const uint32_t free_parity = ((t / Stages) & 1) ^ 1;
        tma::wait(k_empty + s, free_parity);
        tma::expect_tx(k_full + s, KB);
        for (int p = 0; p < P; ++p)
          tma::load_3d(ks + s * KB + p * BK * 128, &k_map, k_full + s, p * kPanel, t * BK, bh);
        tma::wait(v_empty + s, free_parity);
        tma::expect_tx(v_full + s, KB);
        for (int p = 0; p < P; ++p)
          tma::load_3d(vs + s * KB + p * BK * 128, &v_map, v_full + s, p * kPanel, t * BK, bh);
      }
    }
    return;
  }

  // ---- a consumer warpgroup: 64 q rows ----
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = 64 * wgi + 16 * (warp & 3) + gid;   // rows r0 and r0 + 8 of the tile
  float nl[2], dl[2];
  uint32_t row_key[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + r0 + 8 * h;
    nl[h] = r < lq ? -lse[(size_t)bh * lq + r] * tc::kLog2e : 0.f;
    dl[h] = r < lq ? delta[(size_t)bh * lq + r] : 0.f;
    row_key[h] = kDrop ? dropout_row_key(dr.seed, (uint32_t)bh, (uint32_t)r) : 0u;
  }
  // dQ from zero, opaque to the compiler: a known zero would be materialized
  // beside the products in flight, which makes ptxas serialize them (C7515)
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  wg::keep(acc);
  float s[BK / 2], g[BK / 2];
  uint32_t dsa[KV][4];
  KeepMask<BK / 2> keep;
  const uint32_t q_rows = tma::smem_u32(qs) + 64 * wgi * 128;   // the warpgroup's rows
  const uint32_t do_rows = tma::smem_u32(dos) + 64 * wgi * 128;
  const uint32_t k_base = tma::smem_u32(ks), v_base = tma::smem_u32(vs);
  // q' = bf16(q * bf16(scale)) over the warpgroup's rows of each panel, in
  // place, then a barrier of its 128 threads
  tma::wait(qdo_full, 0);
  for (int p = 0; p < P; ++p)
    scale_tile(qs + p * kRows * 128 + 64 * wgi * 128, 64 * 128, threadIdx.x & 127, 128,
               __bfloat162float(__float2bfloat16(scale)));
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wgi) : "memory");

  for (int t = 0; t < n_k; ++t) {
    const int slot = t % Stages;
    const uint32_t phase = (t / Stages) & 1;
    tma::wait(k_full + slot, phase);
    tma::wait(v_full + slot, phase);
    issue_ss<BK, KD, kRows>(s, q_rows, k_base + slot * KB);
    issue_ss<BK, KD, kRows>(g, do_rows, v_base + slot * KB);
    // S (and dQ of tile t - 1) done; with kOverlap G still runs
    wg::wait<kOverlap ? 1 : 0>();
    wg::keep(s);
    wg::keep(acc);
    wg::keep(dsa);
    if (t > 0 && lane == 0) tma::arrive(k_empty + (t - 1) % Stages);

    // p = exp2(s log2 e - lse log2 e); keys >= L_k (the ragged last tile
    // only) get p = 0
    const int k0 = t * BK;
    const bool ragged = t == n_k - 1 && lk - k0 < BK;
    if constexpr (kDrop) keep.clear();
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i >> 1) & 1, col = k0 + 8 * (i >> 2) + 2 * tig + (i & 1);
      float p = hw::exp2_mufu(fmaf(s[i], tc::kLog2e, nl[h]));
      if (ragged && col >= lk) p = 0.f;
      s[i] = p;
      if constexpr (kDrop) keep.set(i, dropout_bits(row_key[h], (uint32_t)col) >= dr.keep_thr);
    }
    if constexpr (kOverlap) wg::wait<0>();
    wg::keep(g);
    if (lane == 0) tma::arrive(v_empty + slot);

    // ds = p (g keep c - delta), to bf16 A fragments; dQ += ds K
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float gk = g[i];
      if constexpr (kDrop) gk = keep.get(i) ? gk * dr.keep_scale : 0.f;
      s[i] *= gk - dl[(i >> 1) & 1];
    }
    hw::to_p<BK>(dsa, s);
    hw::issue_o<D, BK>(acc, dsa, k_base + slot * KB);
  }
  wg::wait<0>();
  wg::keep(acc);

#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * tig;
    if (8 * j >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + r0 + 8 * h;
      if (r < lq)
        *reinterpret_cast<float2*>(dq + ((size_t)bh * lq + r) * d + c) =
            make_float2(acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
    }
  }
}

// ------------------------------------------------------------------ dkv ----
template <int D, int Stages, bool kDrop>
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv, int lq, int lk,
                           int d, float scale, Dropout dr) {
  constexpr int BQ = dkv_q_tile<D>(), P = panels<D>();
  constexpr int KD = D / 16;        // k16 steps of S^T and G^T over d
  constexpr int KQ = BQ / 16;       // k16 steps of dV and dK over the q tile
  constexpr int KVB = tile_bytes<D>(kRows), QB = tile_bytes<D>(BQ);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = align1024(smem_raw);      // the block's K, V
  unsigned char* vs = ks + KVB;
  unsigned char* qs = vs + KVB;                 // Stages slots of q' (QB each)
  unsigned char* dos = qs + Stages * QB;        // and of do
  float* stats = reinterpret_cast<float*>(dos + Stages * QB);   // [slot][-lse log2 e, delta, key]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + Stages * 3 * BQ);
  uint64_t* full = kv_full + 1;                 // TMA's q and do landed
  uint64_t* ready = full + Stages;              // q' and the stats formed
  uint64_t* empty = ready + Stages;             // the consumers are done with the slot

  const int bh = blockIdx.y, k0 = blockIdx.x * kRows;
  const int n_q = (lq + BQ - 1) / BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    tma::init(kv_full, 1);
    for (int s = 0; s < Stages; ++s) {
      tma::init(full + s, 1);
      tma::init(ready + s, kHelpers);
      tma::init(empty + s, 4 * kConsumers);
    }
    tma::fence_init();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {
    // ---- the TMA warp: the block's K and V, then the q and do ring ----
    if (lane == 0) {
      tma::prefetch_map(&k_map);
      tma::prefetch_map(&v_map);
      tma::prefetch_map(&q_map);
      tma::prefetch_map(&do_map);
      tma::expect_tx(kv_full, 2 * KVB);
      for (int p = 0; p < P; ++p) {
        tma::load_3d(ks + p * kRows * 128, &k_map, kv_full, p * kPanel, k0, bh);
        tma::load_3d(vs + p * kRows * 128, &v_map, kv_full, p * kPanel, k0, bh);
      }
      for (int t = 0; t < n_q; ++t) {
        const int s = t % Stages;
        tma::wait(empty + s, ((t / Stages) & 1) ^ 1);
        tma::expect_tx(full + s, 2 * QB);
        for (int p = 0; p < P; ++p) {
          tma::load_3d(qs + s * QB + p * BQ * 128, &q_map, full + s, p * kPanel, t * BQ, bh);
          tma::load_3d(dos + s * QB + p * BQ * 128, &do_map, full + s, p * kPanel, t * BQ, bh);
        }
      }
    }
    return;
  }
  if (warp > 4 * kConsumers) {
    // ---- the helper warps: each slot's q' = bf16(q * bf16(scale)) in
    // place, then -lse log2 e, delta and the dropout row key of its q rows
    // (rows past L_q get 0, which makes their p = 1 meet do = 0 and g =
    // delta = 0: they add nothing) ----
    const int h = threadIdx.x - 128 * kConsumers - 32;
    const float sc = __bfloat162float(__float2bfloat16(scale));
    for (int t = 0; t < n_q; ++t) {
      const int s = t % Stages;
      tma::wait(full + s, (t / Stages) & 1);
      scale_tile(qs + s * QB, QB, h, kHelpers, sc);
      float* st = stats + s * 3 * BQ;
      for (int i = h; i < BQ; i += kHelpers) {
        const int r = t * BQ + i;
        st[i] = r < lq ? -lse[(size_t)bh * lq + r] * tc::kLog2e : 0.f;
        st[BQ + i] = r < lq ? delta[(size_t)bh * lq + r] : 0.f;
        if constexpr (kDrop)
          reinterpret_cast<uint32_t*>(st)[2 * BQ + i] =
              dropout_row_key(dr.seed, (uint32_t)bh, (uint32_t)r);
      }
      tma::arrive(ready + s);
    }
    return;
  }

  // ---- a consumer warpgroup: 64 keys ----
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = 64 * wgi + 16 * (warp & 3) + gid;   // keys r0 and r0 + 8 of the tile
  const uint32_t key[2] = {(uint32_t)(k0 + r0), (uint32_t)(k0 + r0 + 8)};
  float dka[D / 2], dva[D / 2];   // from zero, opaque (as dq's dQ)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  wg::keep(dka);
  wg::keep(dva);
  float s[BQ / 2], g[BQ / 2];
  uint32_t pa[KQ][4], dsa[KQ][4];
  KeepMask<BQ / 2> keep;
  const uint32_t k_rows = tma::smem_u32(ks) + 64 * wgi * 128;   // the warpgroup's keys
  const uint32_t v_rows = tma::smem_u32(vs) + 64 * wgi * 128;
  const uint32_t q_base = tma::smem_u32(qs), do_base = tma::smem_u32(dos);
  tma::wait(kv_full, 0);

  for (int t = 0; t < n_q; ++t) {
    const int slot = t % Stages;
    tma::wait(full + slot, (t / Stages) & 1);    // do as TMA wrote it
    tma::wait(ready + slot, (t / Stages) & 1);   // q' and the stats
    issue_ss<BQ, KD, kRows>(s, k_rows, q_base + slot * QB);
    issue_ss<BQ, KD, kRows>(g, v_rows, do_base + slot * QB);
    // S^T (and dV, dK of tile t - 1) done; with kOverlap G^T still runs
    wg::wait<kOverlap ? 1 : 0>();
    wg::keep(s);
    wg::keep(dka);
    wg::keep(dva);
    wg::keep(pa);
    wg::keep(dsa);
    if (t > 0 && lane == 0) tma::arrive(empty + (t - 1) % Stages);

    // p = exp2(s log2 e - lse log2 e) of the lane's keys gid, gid + 8 and
    // queries 8 j + 2 tig, +1 (j = i / 4), lse and the row key per query
    const float* st = stats + slot * 3 * BQ;
    if constexpr (kDrop) keep.clear();
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int c = 8 * j + 2 * tig;
      const float2 nl = *reinterpret_cast<const float2*>(st + c);
      uint2 rk = make_uint2(0u, 0u);
      if constexpr (kDrop) rk = *reinterpret_cast<const uint2*>(st + 2 * BQ + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, h = e >> 1;
        s[i] = hw::exp2_mufu(fmaf(s[i], tc::kLog2e, (e & 1) ? nl.y : nl.x));
        if constexpr (kDrop)
          keep.set(i, dropout_bits((e & 1) ? rk.y : rk.x, key[h]) >= dr.keep_thr);
      }
    }
    if constexpr (kOverlap) wg::wait<0>();
    wg::keep(g);

    // p keep c over S^T, ds = p (g keep c - delta) over G^T, to bf16 A
    // fragments; dV += (p keep c)^T do, dK += ds^T q'
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(st + BQ + 8 * j + 2 * tig);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const float p = s[i];
        float gk = g[i];
        if constexpr (kDrop) {
          const bool kept = keep.get(i);
          s[i] = kept ? p * dr.keep_scale : 0.f;
          gk = kept ? gk * dr.keep_scale : 0.f;
        }
        g[i] = p * (gk - ((e & 1) ? dl.y : dl.x));
      }
    }
    hw::to_p<BQ>(pa, s);
    hw::to_p<BQ>(dsa, g);
    hw::issue_o<D, BQ>(dva, pa, do_base + slot * QB);
    hw::issue_o<D, BQ>(dka, dsa, q_base + slot * QB);
  }
  wg::wait<0>();
  wg::keep(dka);
  wg::keep(dva);

#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * tig;
    if (8 * j >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (int)key[h];
      if (r < lk) {
        const size_t at = ((size_t)bh * lk + r) * d + c;
        *reinterpret_cast<float2*>(dk + at) = make_float2(dka[4 * j + 2 * h],
                                                          dka[4 * j + 2 * h + 1]);
        *reinterpret_cast<float2*>(dv + at) = make_float2(dva[4 * j + 2 * h],
                                                          dva[4 * j + 2 * h + 1]);
      }
    }
  }
}

// ------------------------------------------------------------- launches ----
template <int D, int Stages, bool kDrop, bool kDq>
cudaError_t launch_d(const tc::BwdArgs& a, cudaStream_t stream) {
  constexpr int smem = kDq ? dq_smem_bytes<D, Stages>() : dkv_smem_bytes<D, Stages>();
  // the looped operand's box rows, and the block's own
  constexpr int loop = kDq ? dq_key_tile<D>() : dkv_q_tile<D>();
  const int q_rows = kDq ? kRows : loop, kv_rows = kDq ? loop : kRows;
  CUtensorMap qm, km, vm, dm;
  if (!tma::encode_bf16_3d(&qm, a.q, a.d, a.lq, a.bh, q_rows) ||
      !tma::encode_bf16_3d(&km, a.k, a.d, a.lk, a.bh, kv_rows) ||
      !tma::encode_bf16_3d(&vm, a.v, a.d, a.lk, a.bh, kv_rows) ||
      !tma::encode_bf16_3d(&dm, a.dout, a.d, a.lq, a.bh, q_rows))
    return cudaErrorInvalidValue;
  if constexpr (kDq) {
    auto* kernel = flash_bwd_dq_wgmma_kernel<D, Stages, kDrop>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.lq + kRows - 1) / kRows, a.bh);
    kernel<<<grid, kDqThreads, smem, stream>>>(qm, km, vm, dm, a.lse, a.delta, a.dq, a.lq, a.lk,
                                             a.d, a.scale, a.dr);
  } else {
    auto* kernel = flash_bwd_dkv_wgmma_kernel<D, Stages, kDrop>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.lk + kRows - 1) / kRows, a.bh);
    kernel<<<grid, kDkvThreads, smem, stream>>>(qm, km, vm, dm, a.lse, a.delta, a.dk, a.dv, a.lq,
                                             a.lk, a.d, a.scale, a.dr);
  }
  return cudaGetLastError();
}

// dq (kDq) or dk/dv for bf16 operands with takes(q, k, v, dout, d), the head
// dim rounded up to a multiple of 16
template <int Stages, bool kDq>
cudaError_t launch_bwd(const tc::BwdArgs& a, cudaStream_t s) {
  if (!takes(a.q, a.k, a.v, a.dout, a.d)) return cudaErrorInvalidValue;
  const bool drop = a.dr.keep_thr != 0u;
#define BUCTD_WG_BWD_CASE(n)                                                  \
  case n / 16:                                                                \
    return drop ? launch_d<n, Stages, true, kDq>(a, s) : launch_d<n, Stages, false, kDq>(a, s);
  switch ((a.d + 15) / 16) {
    BUCTD_WG_BWD_CASE(16)
    BUCTD_WG_BWD_CASE(32)
    BUCTD_WG_BWD_CASE(48)
    BUCTD_WG_BWD_CASE(64)
    BUCTD_WG_BWD_CASE(80)
    BUCTD_WG_BWD_CASE(96)
    BUCTD_WG_BWD_CASE(112)
    BUCTD_WG_BWD_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef BUCTD_WG_BWD_CASE
}

// blocks of the dq (kDq) or dk/dv kernel resident on one SM at head dim d
// (dropout or not), for a ring of Stages slots; 0 where d is out of range
template <int D, int Stages, bool kDq>
int blocks_per_sm_d(bool drop) {
  constexpr int smem = kDq ? dq_smem_bytes<D, Stages>() : dkv_smem_bytes<D, Stages>();
  const void* kernel =
      kDq ? (drop ? (const void*)flash_bwd_dq_wgmma_kernel<D, Stages, true>
                  : (const void*)flash_bwd_dq_wgmma_kernel<D, Stages, false>)
          : (drop ? (const void*)flash_bwd_dkv_wgmma_kernel<D, Stages, true>
                  : (const void*)flash_bwd_dkv_wgmma_kernel<D, Stages, false>);
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kDq ? kDqThreads : kDkvThreads,
                                                    smem) != cudaSuccess)
    return 0;
  return n;
}

template <int Stages>
int blocks_per_sm(int d, bool drop, bool dq) {
#define BUCTD_WG_BWD_OCC_CASE(n)                                                      \
  case n / 16:                                                                        \
    return dq ? blocks_per_sm_d<n, Stages, true>(drop) : blocks_per_sm_d<n, Stages, false>(drop);
  switch ((d + 15) / 16) {
    BUCTD_WG_BWD_OCC_CASE(16)
    BUCTD_WG_BWD_OCC_CASE(32)
    BUCTD_WG_BWD_OCC_CASE(48)
    BUCTD_WG_BWD_OCC_CASE(64)
    BUCTD_WG_BWD_OCC_CASE(80)
    BUCTD_WG_BWD_OCC_CASE(96)
    BUCTD_WG_BWD_OCC_CASE(112)
    BUCTD_WG_BWD_OCC_CASE(128)
    default: return 0;
  }
#undef BUCTD_WG_BWD_OCC_CASE
}

}  // namespace hwb
