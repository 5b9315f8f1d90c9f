// K1's bf16 forward for Hopper: flash_fwd_wgmma_kernel, out =
// dropout(softmax(q k^T * scale)) v and the natural-log lse of every row, for
// bf16 operands, on TMA loads and warpgroup MMAs (wgmma).  Included by
// flash_fwd.cu (K1: a two-stage ring, kStages) and by flash_fwd_kvres.cu (K1':
// the same kernel with the deeper ring of tc::kKvresStages, so K1' equals K1
// bit for bit).  Both take it for every bf16 call whose head dim is a
// multiple of 8 and whose q, k and v start 16-byte aligned (takes(): TMA
// wants 16-byte strides and bases); the other bf16 calls run
// flash_fwd_tc_kernel (flash_fwd_tc.cuh), the mma.sync kernel.
//
// It replaces JAX's _fwd_kernel (buctd_tpu/ops/flash_attention.py:86) and
// _fwd_kernel_kvres (:139) for bf16 operands at Precision.DEFAULT, and
// computes what flash_fwd_tc_kernel computes (flash_fwd_tc.cuh:8-18):
//   q' = bf16(q * bf16(scale)), formed once;
//   s  = q' k^T with f32 sums;
//   the online softmax in the exp2 domain, p = exp2(s log2 e - m) with m the
//        running max of s log2 e, l = l alpha + sum(p) over p before dropout;
//   o  = o alpha + bf16(p keep c) v with f32 sums, p rounded relative to the
//        running max after each key tile;
//   out = o / max(l, 1e-30) in f32, lse = (m + log2 max(l, 1e-30)) ln 2.
//
// What bounds it.  Its two products, 4 L_q L_k d operations at the dense bf16
// rate, and one MUFU.EX2 a (row, key) pair at 16 a clock on each SM: at
// d = 48 the two are about equal (CoAM-W48's branch 0 at BH 16: 0.148 and
// ~0.18 ms at 1980 MHz), at d = 112 the products lead; with dropout, the hash
// of dropout_hash.cuh (about 10 integer operations a pair) leads both.
//
// The design:
//   * a block owns a (bh, 128-row q tile): warps 0-7 are two consumer
//     warpgroups of 64 rows each, warp 8 is the producer.  Warps 9-11 only
//     complete the producer's warpgroup (setmaxnreg moves registers between
//     whole warpgroups): setmaxnreg.dec gives its registers back and
//     setmaxnreg.inc takes them for the consumers (kProducerRegs,
//     kConsumerRegs).  ptxas (12.9) still compiles the consumers' branch to
//     the launch's 168 registers a thread, so S, P and O are sized to fit
//     there: where they spill, ptxas serializes the wgmma (its C7512), which
//     the key tile and q' placement below avoid;
//   * the producer warp's lane 0 issues TMA loads: the q tile once, then the
//     K and V tiles of BK keys (key_tile) into a ring of Stages slots, each
//     slot with a full barrier (TMA's bytes landed) and an empty one (all 8
//     consumer warps are done with it), K and V apart, so K of tile t + 1
//     lands while V of tile t is still read.  Rows are cut into 64-column
//     panels of 128 bytes with the 128-byte swizzle; d is padded to a panel
//     in shared memory by TMA's zero fill past the tensor's edge, and only
//     ceil(d / 16) k16 steps are issued;
//   * each consumer warpgroup forms q' once from the staged q tile, in
//     registers, as the A fragments of m64k16 (JAX's rounding).  From
//     d = 64 (kQSmemFrom) it writes them back over its rows of the q tile
//     (a proxy fence and a barrier of its 128 threads), and S reads A from
//     there: that frees 4 x ceil(d / 16) registers;
//   * S = q' K^T: wgmma.m64nBKk16, A from registers (or the q tile), B = the
//     K tile from shared memory, K-major; BK = 128 up to d = 64 and
//     kWideKeyTile = 96 above, the largest at which S, P and O fit in the
//     168 registers without a spill (128 spills at d = 96 and 112);
//   * overlap, both ways: within a warpgroup, S of tile t and P V of tile
//     t - 1 are committed as two groups and the softmax of t waits for the
//     first only, so it runs while P V does; across the two warpgroups
//     (kPingPong) they take turns issuing their products (two named
//     barriers), so one's softmax meets the other's products;
//   * the softmax: p = exp2(fma(s, log2 e, -m log2 e)) on the MUFU, the
//     col < L_k mask on the ragged last tile only, the row max over the 4
//     lanes of a row by shuffles;
//   * P goes to bf16 A fragments in registers (the m64 accumulator layout
//     is the register-A layout, to_p), and O += P V is wgmma with A from
//     registers and B = the V tile read MN-major (the transpose bit): no
//     transpose pass, no (L_q, L_k) tile in shared memory;
//   * dropout is a template parameter: the dropout-0 instantiation, which
//     serving and evaluation run, carries no hash; with dropout the mask bit
//     of a weight is dropout_hash.cuh's hash of its global (bh, row, col), as
//     K2 regenerates it;
//   * one block an SM (its registers): 864 blocks at CoAM-W48's branch 0 or
//     TransPose-H's serving batch of 16 (6.5 waves on 132 SMs), 224 at
//     CoAM-W48's branch 1 (1.7 waves: that call's tail costs).

// The tensor maps are encoded on the host at every launch and passed by
// value (__grid_constant__).  A CUDA graph that captures a launch keeps the
// maps in its kernel node, so a replay reads the buffers of the capture: the
// serving buckets' graphs (graphs.py) replay on static buffers, which is what
// keeps their maps valid.

#pragma once

#include <math.h>

#include "dropout_hash.cuh"
#include "mma_bf16.cuh"
#include "tma.cuh"
#include "wgmma_bf16.cuh"

namespace hw {

using tc::bf16;
constexpr int kConsumers = 2;                        // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);     // and the producer warpgroup
constexpr int kRows = 64 * kConsumers;               // q rows a block
constexpr int kPanel = 64;                           // bf16 columns of a swizzled row
// setmaxnreg: the launch gives every thread 168 registers (65536 / 384);
// the producer warpgroup's 4 warps give back 144 each, which lets the 8
// consumer warps hold 240 (on the card; ptxas 12.9 still compiles their code
// to 168, the design note above)
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr bool kPingPong = true;
constexpr int kStages = 2;                           // K1's ring; K1' takes tc::kKvresStages
constexpr int kWideKeyTile = 96;                     // the key tile above d = 64
// from this (padded) head dim up, q' goes back into the q tile in shared
// memory and S reads its A operand from there, which frees the 4 x
// ceil(d / 16) registers of its fragments (room for 96-key tiles above
// d = 64); below it q' stays in registers
constexpr int kQSmemFrom = 64;

// the forward's key tile: the S accumulators (BK / 2 a thread), the P
// fragments (BK / 4) and O (D / 2) share the consumers' registers
template <int D>
__host__ __device__ constexpr int key_tile() { return D <= 64 ? 128 : kWideKeyTile; }

template <int D>
__host__ __device__ constexpr bool q_in_smem() { return D >= kQSmemFrom; }

template <int D>
__host__ __device__ constexpr int panels() { return (D + kPanel - 1) / kPanel; }

template <int D>
__host__ __device__ constexpr int q_bytes() { return panels<D>() * kRows * 128; }

template <int D>
__host__ __device__ constexpr int kv_bytes() { return panels<D>() * key_tile<D>() * 128; }

template <int D, int Stages>
__host__ __device__ constexpr int smem_bytes() {
  // 1024 bytes of slack to align the tiles; q; Stages x (K, V); the barriers
  return 1024 + q_bytes<D>() + 2 * Stages * kv_bytes<D>() + 8 * (1 + 4 * Stages);
}

// bf16 calls this kernel takes: TMA's 16-byte strides and bases
inline bool takes(const void* q, const void* k, const void* v, int d) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return d > 0 && d <= 128 && d % 8 == 0 && aligned(q) && aligned(k) && aligned(v);
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(256) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(256) : "memory");
}

// 2^x on the MUFU (ex2.approx.ftz: one instruction, results below 2^-126
// flushed to 0, far below anything that reaches a bf16 p next to the row's
// p = 1)
__device__ __forceinline__ float exp2_mufu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// q' = bf16(q * sc) of two bf16 values packed in a word
__device__ __forceinline__ uint32_t scale_pair(uint32_t w, float sc) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&w);
  return tc::pack(__bfloat162float(x.x) * sc, __bfloat162float(x.y) * sc);
}

// The online softmax of one key tile in place in its S accumulators s (the
// lane's rows h = 0, 1: gid and gid + 8 of its warp): keys k0 + col >= lk
// (`ragged`, the last tile only) get -inf; m, the running max of the raw
// logits, and l, the lane's share of the running sum, are updated, alpha is
// the factor that rescales O; s becomes p = exp2(fma(s, log2 e, -m log2 e))
// (l takes p before dropout), times keep c with dropout.
template <int BK, bool kDrop>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, int lk, bool ragged,
                                             int tig, const uint32_t (&row_key)[2],
                                             const Dropout& dr) {
  if (ragged) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      if (k0 + 8 * (i >> 2) + 2 * tig + (i & 1) >= lk) s[i] = -INFINITY;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float neg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {   // the row max over the 4 lanes of the row
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    neg[h] = -mx[h] * tc::kLog2e;
    alpha[h] = exp2_mufu(fmaf(m[h], tc::kLog2e, neg[h]));   // 0 on the first tile
    m[h] = mx[h];
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int h = (i >> 1) & 1;
    float p = exp2_mufu(fmaf(s[i], tc::kLog2e, neg[h]));
    l[h] += p;
    if constexpr (kDrop)
      p = dropout_bits(row_key[h], (uint32_t)(k0 + 8 * (i >> 2) + 2 * tig + (i & 1))) >=
                  dr.keep_thr
              ? p * dr.keep_scale : 0.f;
    s[i] = p;
  }
}

// bf16(p keep c) from the S accumulators as the A fragments of P V: the m64
// accumulator layout of n-tiles 2 k and 2 k + 1 is the register-A layout of
// k16 step k
template <int BK>
__device__ __forceinline__ void to_p(uint32_t (&pa)[BK / 16][4], const float (&s)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = tc::pack(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = tc::pack(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = tc::pack(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = tc::pack(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// S = q' K^T (64 x BK) of the K tile at shared address kt (read K-major), one
// committed group behind a fence of its own
template <int BK, int KD>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2], const uint32_t (&qa)[KD][4],
                                        uint32_t kt) {
  wg::keep(s);
  wg::fence();
  wg::mma_rs_zero<BK, 0>(s, qa[0], wg::sw128_desc(kt, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < KD; ++kk)
    wg::mma_rs<BK, 0>(s, qa[kk], wg::sw128_desc(kt + (kk / 4) * BK * 128 + (kk % 4) * 32, 16,
                                                1024));
  wg::commit();
  wg::keep(s);
}

// the same with A = q' from shared memory: the warpgroup's 64 rows of the q
// tile at shared address qt (panels of kRows rows), K-major
template <int BK, int KD>
__device__ __forceinline__ void issue_s_smem(float (&s)[BK / 2], uint32_t qt, uint32_t kt) {
  wg::keep(s);
  wg::fence();
  wg::Ss<BK>::mma_zero(s, wg::sw128_desc(qt, 16, 1024), wg::sw128_desc(kt, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < KD; ++kk)
    wg::Ss<BK>::mma(s, wg::sw128_desc(qt + (kk / 4) * kRows * 128 + (kk % 4) * 32, 16, 1024),
                    wg::sw128_desc(kt + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024));
  wg::commit();
  wg::keep(s);
}

// O (64 x D) += P (64 x BK, registers) V (the BK x D tile at shared address
// vt, read MN-major), one committed group behind a fence of its own: the
// softmax that runs while it does writes S's accumulators, never O's
template <int D, int BK>
__device__ __forceinline__ void issue_o(float (&o)[D / 2], const uint32_t (&pa)[BK / 16][4],
                                        uint32_t vt) {
  wg::keep(o);
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wg::mma_rs<D, 1>(o, pa[kk], wg::sw128_desc(vt + kk * 16 * 128, BK * 128, 1024));
  wg::commit();
  wg::keep(o);
}

template <int D, int Stages, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, float* __restrict__ out,
                       float* __restrict__ lse, int lq, int lk, int d, float scale,
                       Dropout dr) {
  constexpr int BK = key_tile<D>(), P = panels<D>();
  constexpr bool kQS = q_in_smem<D>();
  constexpr int KD = D / 16;       // k16 steps of S over d
  constexpr int KV = BK / 16;      // k16 steps of P V over the key tile
  constexpr int QB = q_bytes<D>(), KVB = kv_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ks = qs + QB;                  // Stages slots of KVB
  unsigned char* vs = ks + Stages * KVB;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + Stages * KVB);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + Stages;
  uint64_t* v_full = k_empty + Stages;
  uint64_t* v_empty = v_full + Stages;

  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const int n_k = (lk + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the warpgroup, broadcast from lane 0 so the compiler sees the role
  // branches warp-uniform, as setmaxnreg.sync.aligned needs
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    tma::init(q_full, 1);
    for (int s = 0; s < Stages; ++s) {
      tma::init(k_full + s, 1);
      tma::init(v_full + s, 1);
      tma::init(k_empty + s, 4 * kConsumers);
      tma::init(v_empty + s, 4 * kConsumers);
    }
    tma::fence_init();
  }
  __syncthreads();

  if (role == kConsumers) {
    // ---- the producer warpgroup: warp 8's lane 0 loads ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (warp == 4 * kConsumers && lane == 0) {
      tma::prefetch_map(&q_map);
      tma::prefetch_map(&k_map);
      tma::prefetch_map(&v_map);
      tma::expect_tx(q_full, QB);
      for (int p = 0; p < P; ++p)
        tma::load_3d(qs + p * kRows * 128, &q_map, q_full, p * kPanel, q0, bh);
      for (int t = 0; t < n_k; ++t) {
        const int s = t % Stages;
        const uint32_t free_parity = ((t / Stages) & 1) ^ 1;
        tma::wait(k_empty + s, free_parity);
        tma::expect_tx(k_full + s, KVB);
        for (int p = 0; p < P; ++p)
          tma::load_3d(ks + s * KVB + p * BK * 128, &k_map, k_full + s, p * kPanel, t * BK, bh);
        tma::wait(v_empty + s, free_parity);
        tma::expect_tx(v_full + s, KVB);
        for (int p = 0; p < P; ++p)
          tma::load_3d(vs + s * KVB + p * BK * 128, &v_map, v_full + s, p * kPanel, t * BK, bh);
      }
    }
  } else {
    // ---- a consumer warpgroup: 64 rows ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int wgi = role;
    const int gid = lane >> 2, tig = lane & 3;
    const int r0 = 64 * wgi + 16 * (warp & 3) + gid;   // rows r0 and r0 + 8 of the tile

    // q' as the A fragments of the KD k16 steps
    tma::wait(q_full, 0);
    const float sc = __bfloat162float(__float2bfloat16(scale));
    uint32_t qa[KD][4];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int r = r0 + 8 * (h & 1), c = 16 * kk + 8 * (h >> 1) + 2 * tig;
        const int cc = c % kPanel;
        unsigned char* at = qs + (c / kPanel) * kRows * 128 + r * 128 +
                            (((cc >> 3) ^ (r & 7)) << 4) + (cc & 7) * 2;
        qa[kk][h] = scale_pair(*reinterpret_cast<const uint32_t*>(at), sc);
        if constexpr (kQS) *reinterpret_cast<uint32_t*>(at) = qa[kk][h];
      }
    const uint32_t q_rows = tma::smem_u32(qs) + 64 * wgi * 128;   // the warpgroup's rows
    if constexpr (kQS) {
      // the generic stores seen by wgmma (the async proxy), across the
      // warpgroup's 4 warps
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" :: "r"(3 + wgi) : "memory");
    }

    uint32_t row_key[2];
    float m[2], l[2];   // m: the running max of the raw logits; l: the lane's share
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      row_key[i] = kDrop ? dropout_row_key(dr.seed, (uint32_t)bh, (uint32_t)(q0 + r0 + 8 * i))
                         : 0u;
      m[i] = -INFINITY;
      l[i] = 0.f;
    }
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float s[BK / 2];
    uint32_t pa[KV][4];

    const uint32_t k_base = tma::smem_u32(ks), v_base = tma::smem_u32(vs);
    // the turns (kPingPong): warpgroup 0 issues first; each sync on a
    // warpgroup's barrier (1 + wgi) meets one arrival of the other's
    if constexpr (kPingPong) {
      if (wgi == 1) bar_arrive(1);
    }

    // tile 0: S, its softmax, P
    tma::wait(k_full, 0);
    if constexpr (kPingPong) bar_sync(1 + wgi);
    if constexpr (kQS) issue_s_smem<BK, KD>(s, q_rows, k_base);
    else issue_s<BK, KD>(s, qa, k_base);
    if constexpr (kPingPong) bar_arrive(1 + (wgi ^ 1));
    wg::wait<0>();
    wg::keep(s);
    if (lane == 0) tma::arrive(k_empty);
    float alpha[2];
    softmax_tile<BK, kDrop>(s, m, l, alpha, 0, lk, n_k == 1 && lk < BK, tig, row_key, dr);
    to_p<BK>(pa, s);

    // tile t: S of t and O += P V of t - 1 in flight together; the softmax of
    // t waits for S only and runs while P V does
    for (int t = 1; t < n_k; ++t) {
      const int slot = t % Stages, prev = (t - 1) % Stages;
      tma::wait(k_full + slot, (t / Stages) & 1);
      tma::wait(v_full + prev, ((t - 1) / Stages) & 1);
      if constexpr (kPingPong) bar_sync(1 + wgi);
      if constexpr (kQS) issue_s_smem<BK, KD>(s, q_rows, k_base + slot * KVB);
      else issue_s<BK, KD>(s, qa, k_base + slot * KVB);
      issue_o<D, BK>(o, pa, v_base + prev * KVB);
      if constexpr (kPingPong) bar_arrive(1 + (wgi ^ 1));
      wg::wait<1>();
      wg::keep(s);
      if (lane == 0) tma::arrive(k_empty + slot);
      const int k0 = t * BK;
      softmax_tile<BK, kDrop>(s, m, l, alpha, k0, lk, t == n_k - 1 && lk - k0 < BK, tig,
                              row_key, dr);
      wg::wait<0>();
      wg::keep(o);
      wg::keep(pa);
      if (lane == 0) tma::arrive(v_empty + prev);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      to_p<BK>(pa, s);
    }
    const int last = (n_k - 1) % Stages;
    tma::wait(v_full + last, ((n_k - 1) / Stages) & 1);
    if constexpr (kPingPong) bar_sync(1 + wgi);
    issue_o<D, BK>(o, pa, v_base + last * KVB);
    if constexpr (kPingPong) {
      if (wgi == 0) bar_arrive(2);   // the other warpgroup's last turn
    }
    wg::wait<0>();
    wg::keep(o);
    if (lane == 0) tma::arrive(v_empty + last);

    // out = o / max(l, 1e-30), lse = (m log2 e + log2 l) ln 2, l summed over
    // the row's 4 lanes
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      l[i] = fmaxf(l[i], 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * tig;
      if (8 * j >= d) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = q0 + r0 + 8 * h;
        if (r < lq)
          *reinterpret_cast<float2*>(out + ((size_t)bh * lq + r) * d + c) =
              make_float2(o[4 * j + 2 * h] / l[h], o[4 * j + 2 * h + 1] / l[h]);
      }
    }
    if (tig == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = q0 + r0 + 8 * h;
        if (r < lq) lse[(size_t)bh * lq + r] = (m[h] * tc::kLog2e + log2f(l[h])) * tc::kLn2;
      }
  }
}

template <int D, int Stages, bool kDrop>
cudaError_t launch_fwd_d(const void* q, const void* k, const void* v, float* out, float* lse,
                         int bh, int lq, int lk, int d, float scale, Dropout dr,
                         cudaStream_t stream) {
  constexpr int smem = smem_bytes<D, Stages>();
  auto* kernel = flash_fwd_wgmma_kernel<D, Stages, kDrop>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm;
  if (!tma::encode_bf16_3d(&qm, q, d, lq, bh, kRows) ||
      !tma::encode_bf16_3d(&km, k, d, lk, bh, key_tile<D>()) ||
      !tma::encode_bf16_3d(&vm, v, d, lk, bh, key_tile<D>()))
    return cudaErrorInvalidValue;
  const dim3 grid((lq + kRows - 1) / kRows, bh);
  kernel<<<grid, kThreads, smem, stream>>>(qm, km, vm, out, lse, lq, lk, d, scale, dr);
  return cudaGetLastError();
}

template <int D, int Stages>
cudaError_t launch_fwd_drop(const void* q, const void* k, const void* v, float* out,
                            float* lse, int bh, int lq, int lk, int d, float scale, Dropout dr,
                            cudaStream_t s) {
  return dr.keep_thr != 0u
             ? launch_fwd_d<D, Stages, true>(q, k, v, out, lse, bh, lq, lk, d, scale, dr, s)
             : launch_fwd_d<D, Stages, false>(q, k, v, out, lse, bh, lq, lk, d, scale, dr, s);
}

// q (bh, lq, d), k/v (bh, lk, d) bf16 with takes(q, k, v, d); out (bh, lq, d)
// and lse (bh, lq) f32
template <int Stages>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, float* out, float* lse,
                       int bh, int lq, int lk, int d, float scale, Dropout dr,
                       cudaStream_t s) {
  if (!takes(q, k, v, d)) return cudaErrorInvalidValue;
#define BUCTD_WG_FWD_CASE(n)                                                            \
  case n / 16:                                                                          \
    return launch_fwd_drop<n, Stages>(q, k, v, out, lse, bh, lq, lk, d, scale, dr, s);
  switch ((d + 15) / 16) {
    BUCTD_WG_FWD_CASE(16)
    BUCTD_WG_FWD_CASE(32)
    BUCTD_WG_FWD_CASE(48)
    BUCTD_WG_FWD_CASE(64)
    BUCTD_WG_FWD_CASE(80)
    BUCTD_WG_FWD_CASE(96)
    BUCTD_WG_FWD_CASE(112)
    BUCTD_WG_FWD_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef BUCTD_WG_FWD_CASE
}

// blocks of the kernel resident on one SM at head dim d (dropout or not),
// for a ring of Stages slots; 0 where d is out of range
template <int Stages>
int blocks_per_sm(int d, bool drop) {
  int n = 0;
#define BUCTD_WG_OCC_CASE(D)                                                             \
  case D / 16:                                                                           \
    if (cudaFuncSetAttribute(drop ? flash_fwd_wgmma_kernel<D, Stages, true>              \
                                  : flash_fwd_wgmma_kernel<D, Stages, false>,            \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,                \
                             smem_bytes<D, Stages>()) != cudaSuccess ||                  \
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(                                   \
            &n, drop ? flash_fwd_wgmma_kernel<D, Stages, true>                           \
                     : flash_fwd_wgmma_kernel<D, Stages, false>,                         \
            kThreads, smem_bytes<D, Stages>()) != cudaSuccess)                           \
      return 0;                                                                          \
    return n;
  switch ((d + 15) / 16) {
    BUCTD_WG_OCC_CASE(16)
    BUCTD_WG_OCC_CASE(32)
    BUCTD_WG_OCC_CASE(48)
    BUCTD_WG_OCC_CASE(64)
    BUCTD_WG_OCC_CASE(80)
    BUCTD_WG_OCC_CASE(96)
    BUCTD_WG_OCC_CASE(112)
    BUCTD_WG_OCC_CASE(128)
    default: return 0;
  }
#undef BUCTD_WG_OCC_CASE
}

}  // namespace hw
