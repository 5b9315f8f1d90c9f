// K2's f32 backward for Hopper: flash_bwd_dq_tf32_wgmma_kernel and
// flash_bwd_dkv_tf32_wgmma_kernel, dq, dk and dv of out = dropout(softmax(q
// k^T * scale)) v from the forward's lse, for f32 operands, on TMA loads and
// warpgroup MMAs (wgmma) in 3xTF32.  Included by flash_bwd.cu (K2: a ring of
// kStages slots) and by flash_bwd_kvres.cu (K2': the same kernels with the
// deeper ring of kKvresStages where shared memory holds it, so K2' equals K2
// bit for bit).  Both take them for every f32 call whose head dim is a
// multiple of 8 (at most 128) and whose q, k, v and do start 16-byte aligned
// (takes(): TMA's 16-byte strides and bases, k8 steps); the other f32 calls
// run flash_bwd_tf32.cuh's mma.sync kernels.
//
// They replace JAX's _dq_kernel (buctd_tpu/ops/flash_attention.py:212) and
// _dkv_kernel (:363), and the ring variants _dq_kernel_kvres (:245) and
// _dkv_kernel_kvres (:295), for f32 operands at Precision.HIGHEST, and
// compute what the mma.sync kernels compute (flash_bwd.cu's header):
//   q' = q * scale * log2 e, rounded to f32 before its split;
//   s = q' k^T and g = do v^T;  p = exp2(s - lse log2 e);
//   ds = p (g keep c - delta);
//   dq = (ds k) scale, dv = (p keep c)^T do, dk = (ds^T q') ln 2.
// Every product is 3xTF32 (lo hi + hi lo + hi hi, the small terms first,
// every operand split as mma_tf32.cuh::split splits it); each looped tile's
// products of dq (dk, dv) start from zero and enter the f32 sums with one
// add (the tensor cores' accumulator is not an f32 add: flash_bwd_tf32.cuh);
// the dropout mask is dropout_hash.cuh's hash of the global (bh, row, key).
// Two kernels and no atomics, as in JAX: one block a (bh, q tile) for dq and
// one a (bh, key tile) for dk/dv, so the gradients are deterministic.
// ops/flash_attention.py::backward_tf32 emulates them over their tiles
// (tf32_wgmma_bwd_plan).
//
// What bounds them.  dq's three products (s, g, ds k) and dk/dv's four (s^T,
// g^T, dv, dk), 2 L_q L_k d operations each, in three passes at the dense
// TF32 rate, lead the MUFU's one exp2 a (row, key) pair and the hash at every
// d (flash_bwd_tf32.cuh's count: 3.00 and 4.00 ms against 0.39 and 0.97 at
// the f32 training shapes).  Next comes shared memory's 128 bytes a clock:
// s and g read their A operand (the block's own rows) from it at 2 KB a k8
// step whatever the looped tile's width, so a narrow tile makes them wait
// on shared memory rather than on the tensor cores.
//
// tf32 wgmma has no transposed operand (wgmma_tf32.cuh), and three of the
// five products contract over the looped index: dq += ds K wants K with the
// keys contiguous, dv += (p keep c)^T do and dk += ds^T q' want do and q'
// with the q rows contiguous.  So each looped operand is kept twice: as TMA
// wrote it (64-byte swizzle, rows K-major over d) for s and g, and
// transposed into the unswizzled core-matrix layout with its rows permuted
// for the products whose A is an accumulator (f32 K1's V^T:
// flash_fwd_tf32_wgmma.cuh), each in hi and lo.
//
// The design, for both kernels:
//   * a block owns 64 C rows of its own operands (q' and do for dq, K and V
//     for dk/dv), C from the plan below: warps 0 .. 4 C - 1 are C consumer
//     warpgroups of 64 rows each, then a TMA warp and the split warps
//     (kDqSplitWarps, kDkvSplitWarps).  No setmaxnreg;
//   * the TMA warp's lane 0 loads each warpgroup's own rows once (64-byte
//     swizzle in 16-column panels), then the looped operands (K and V for
//     dq; q and do for dk/dv) into a ring of slots, each with a full (TMA),
//     a ready (the split warps) and an empty (the consumers) barrier.  d is
//     padded to a multiple of 16 by TMA's zero fill past the tensor's edge;
//     every wait traps after tma::kWaitLimitNs;
//   * each consumer warpgroup forms its own rows' tf32 halves in place (hi
//     over the TMA image, lo at the same offset in a second buffer), q'
//     first for dq, so the swizzle needs no address arithmetic;
//   * the split warps split each landed looped tile: every element of K (dq)
//     or of q' = q * scale * log2 e and do (dk/dv) is read once from its
//     swizzled place, its hi written back over it and its lo at the same
//     offset of the lo tile, and both halves written transposed (K^T, q'^T,
//     do^T): a unit reads rows 8 a + vp + 2 e (e = 0..3) of one column and
//     writes them as positions 8 a + 4 vp + e, the order in which an
//     accumulator's columns are the tf32 A fragment's (f32 K1's V^T).  dq's
//     V is split in place elementwise; dk/dv's split warps also write the
//     slot's -lse log2 e, delta and dropout row keys, read from device
//     memory before they wait for the slot.  Then a proxy fence and the
//     slot's ready barrier.  With two slots the split of tile t + 1 has to
//     land while tile t's products run, so their latency sets the pace:
//     four split warps in dq and six in dk/dv (three: dq 1.09x and dk/dv
//     1.18x slower at d = 48; tools/bench_flash_bwd.py's split3) although
//     the blocks of more than 8 warps hold dk/dv to 128 or 168 registers,
//     where it spills;
//   * dq: a warpgroup's 64 q rows over key tiles of T keys: S = q' K^T and
//     G = do V^T, wgmma m64nTk8 with both operands from shared memory,
//     committed as two groups so that p = exp2 over S (and the dropout bits)
//     runs while G's product is in flight; the col < L_k mask on the ragged
//     last tile only; ds, split into hi and lo A fragments in the permuted
//     key order, and dQ's tile product = ds K^T-tile, wgmma m64nDk8 with A
//     from registers, from zero, waited for and folded into the f32 sums,
//     and the slot freed.  Keeping that product in flight across the next
//     tile's S and G (bf16 K2's schedule) ran 1.3-1.5x slower: it frees the
//     slot later, and a fold beside products in flight makes ptxas
//     serialize them (C7514) (kDqOverlap, variant overlap);
//   * dk/dv: a warpgroup's 64 keys over q tiles of T rows: S^T = K q'^T and
//     G^T = V do^T (A = the own K or V rows, B = the slot's q' or do as TMA
//     wrote them), p, keep and ds in (key, query) layout, whose columns are
//     the A fragments of dV's tile product (p keep c)^T do^T-tile and dK's
//     ds^T q'^T-tile, each from zero, waited for and folded in turn;
//   * the own operands' descriptors are formed at every looped tile from
//     addresses the compiler cannot follow (kFreshDescriptors): left to it,
//     ptxas kept all of them live across the loop and dk/dv spilled (1.55x
//     slower at d = 112, variant stale_desc);
//   * the plan (consumer warpgroups C, looped tile T) is the first of
//     (2, 32), (1, 32), (1, 16), (1, 8) whose shared memory for two slots
//     fits the block's 232,448 bytes (smem_for): the own rows take 16 x 64 C
//     x D bytes (hi and lo of two operands), a slot 24 T D (dq: K, V, K^T in
//     hi and lo) or 32 T D + 12 T (dk/dv: q', do, q'^T, do^T in hi and lo,
//     and the stats).  At the model paths: dq (2, 32) at d = 48, (1, 16) at
//     d = 96 and 112; dk/dv (2, 32) at 48, (1, 16) at 96 and 112.  K2' asks
//     for kKvresStages slots and takes the most that fit (never under two)
//     with K2's plan, so its arithmetic is K2's: three for dq at d = 48 and
//     96, two elsewhere on the model paths.  At T = 16 s and g read 2 KB of
//     A from shared memory for 8 clocks of tensor work a k8 step, about
//     2.5x: d = 96 and 112 run nearer their shared-memory pace than their
//     products';
//   * dropout is a template parameter: the dropout-0 instantiation carries no
//     hash; with dropout each kernel hashes each (row, key) pair once.
//
// The tensor maps are encoded on the host at every launch and passed by
// value (__grid_constant__), as in the forward.

#pragma once

#include <math.h>

#include "dropout_hash.cuh"
#include "flash_bwd_tc.cuh"           // tc::BwdArgs, the kernels' argument block
#include "flash_bwd_wgmma.cuh"        // hwb::KeepMask
#include "flash_fwd_tf32_wgmma.cuh"   // t3::issue_s, issue_pv, to_p, split4, vt_offset
#include "mma_tf32.cuh"
#include "tma.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"

namespace t3b {

// warps that split the looped tiles: dq's (K; V in place) and dk/dv's (q'
// and do, and the stats)
constexpr int kDqSplitWarps = 4;
constexpr int kDkvSplitWarps = 6;
constexpr int kPanel = 16;                           // f32 columns of a swizzled row
constexpr int kStages = 2;                           // K2's ring
constexpr int kKvresStages = 3;                      // K2''s, where it fits
constexpr int kSmemLimit = 232448;                   // a block's shared memory
constexpr int kPlans = 4;                            // (consumers, tile) in order of preference
// true: dq's tile product of tile t stays in flight while s and g of t + 1
// are issued, folded once g is done (its slot freed then); false: waited
// for at once, its slot freed at once
constexpr bool kDqOverlap = false;
// the own operands' shared addresses made opaque to the compiler at every
// looped tile, so that ptxas forms their wgmma descriptors there instead of
// keeping all of them (two registers each) live across the loop
constexpr bool kFreshDescriptors = true;
// named barriers: 0 is __syncthreads; each consumer warpgroup's own (its
// rows split)
constexpr int kOwnBar = 1;

__host__ __device__ constexpr int plan_consumers(int i) { return i == 0 ? 2 : 1; }
__host__ __device__ constexpr int plan_tile(int i) { return i < 2 ? 32 : (i == 2 ? 16 : 8); }
static_assert(plan_tile(0) <= 32 * kDkvSplitWarps, "dk/dv's split warps: a stats row a thread");

// bytes of shared memory of the dq (kDq) or dk/dv kernel at padded head dim
// D, c consumer warpgroups, looped tile t and `stages` slots: 1024 of slack
// to align the tiles; the own rows' two operands in hi and lo; the slots
// (dq: K, V, K^T; dk/dv: q', do, q'^T, do^T; each in hi and lo; dk/dv's
// stats); the barriers (own rows a warpgroup; full, ready, empty a slot)
__host__ __device__ constexpr int smem_for(bool dq, int D, int c, int t, int stages) {
  return 1024 + 4 * 64 * c * D * 4 + stages * (dq ? 6 * t * D * 4 : 8 * t * D * 4 + 3 * t * 4) +
         8 * (c + 3 * stages);
}

// the plan: the first (consumers, tile) whose two slots fit
template <int D, bool kDq>
__host__ __device__ constexpr int plan() {
  int i = 0;
  while (i + 1 < kPlans &&
         smem_for(kDq, D, plan_consumers(i), plan_tile(i), kStages) > kSmemLimit)
    ++i;
  return i;
}

template <int D, bool kDq>
__host__ __device__ constexpr int consumers() { return plan_consumers(plan<D, kDq>()); }

template <int D, bool kDq>
__host__ __device__ constexpr int loop_tile() { return plan_tile(plan<D, kDq>()); }

template <bool kDq>
__host__ __device__ constexpr int split_warps() { return kDq ? kDqSplitWarps : kDkvSplitWarps; }

// the consumers, a TMA warp and the split warps
template <int D, bool kDq>
__host__ __device__ constexpr int threads() {
  return 128 * consumers<D, kDq>() + 32 * (1 + split_warps<kDq>());
}

template <int D, bool kDq, int S>
__host__ __device__ constexpr int smem_bytes() {
  return smem_for(kDq, D, consumers<D, kDq>(), loop_tile<D, kDq>(), S);
}

// the slots a launch that asks for Want runs: the most up to Want that fit
template <int D, bool kDq, int Want>
__host__ __device__ constexpr int ring() {
  int s = Want;
  while (s > kStages &&
         smem_for(kDq, D, consumers<D, kDq>(), loop_tile<D, kDq>(), s) > kSmemLimit)
    --s;
  return s;
}

// f32 calls these kernels take: TMA's 16-byte strides and bases for q, k, v
// and do, d a multiple of 8 (k8 steps), at most 128
inline bool takes(const void* q, const void* k, const void* v, const void* dout, int d) {
  return t3::takes(q, k, v, d) && reinterpret_cast<uintptr_t>(dout) % 16 == 0;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

// byte offset of element (r, c) in a tile of T rows that TMA wrote with the
// 64-byte swizzle in 16-column panels: 16-byte chunk c % 16 / 4 of row r at
// chunk (c % 16 / 4) ^ (r / 2 % 4) of its panel
template <int T>
__device__ __forceinline__ int sw64_offset(int r, int c) {
  return (c / kPanel) * T * 64 + r * 64 + ((((c % kPanel) >> 2) ^ ((r >> 1) & 3)) << 4) +
         (c % 4) * 4;
}

// A landed looped tile (T rows, D columns, TMA's swizzled panels at nat)
// split by split warp sw of W: each element read once from its swizzled place,
// times mul rounded to f32 (q' = q scale log2 e; K and do: 1), hi written
// over it and lo at the same offset of nat_lo, and both transposed into the
// core-matrix layout at tr_hi / tr_lo in the permuted row order (a unit of
// lane vp, vc: rows 8 a + vp + 2 e of column c as positions 8 a + 4 vp + e)
template <int D, int T, int W>
__device__ __forceinline__ void split_transpose(unsigned char* nat, unsigned char* nat_lo,
                                                unsigned char* tr_hi, unsigned char* tr_lo,
                                                float mul, int sw, int lane) {
  constexpr int NIT = (T / 8) * (D / kPanel);   // a warp's 32 (column, 4 rows) units
  const int vp = (lane >> 3) & 1, vc = 8 * (lane >> 4) + (lane & 7);
  for (int it = sw; it < NIT; it += W) {
    const int a = it / (D / kPanel), c = kPanel * (it % (D / kPanel)) + vc;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int off = sw64_offset<T>(8 * a + vp + 2 * e, c);
      tf32::split(__fmul_rn(*reinterpret_cast<const float*>(nat + off), mul), hi[e], lo[e]);
      *reinterpret_cast<uint32_t*>(nat + off) = hi[e];
      *reinterpret_cast<uint32_t*>(nat_lo + off) = lo[e];
    }
    const int at = t3::vt_offset<T>(c, 2 * a + vp);
    *reinterpret_cast<uint4*>(tr_hi + at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(tr_lo + at) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// A warpgroup's own rows (QB bytes of one operand) split in place: hi over
// the TMA image, lo at the same offset in lo, each times mul first
__device__ __forceinline__ void split_own(unsigned char* hi, unsigned char* lo, int bytes,
                                          float mul) {
  for (int i = threadIdx.x & 127; i < bytes / 16; i += 128)
    t3::split4(reinterpret_cast<float4*>(hi) + i, reinterpret_cast<uint4*>(lo) + i, mul);
}

// a shared address the compiler cannot follow (kFreshDescriptors)
__device__ __forceinline__ uint32_t opaque(uint32_t a) {
  if constexpr (kFreshDescriptors) asm volatile("" : "+r"(a));
  return a;
}

template <int N>
__device__ __forceinline__ void fold(float* acc, const float (&part)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += part[i];
}

// acc (64 x D) += a B over one looped tile, from zero, waited for and
// folded: a the warpgroup's T / 8 A fragments (hi, lo), B^T the slot's
// transposed operand (hi at bh, lo at bl)
template <int D, int T>
__device__ __forceinline__ void product_fold(float (&acc)[D / 2], uint32_t (&ah)[T / 8][4],
                                             uint32_t (&al)[T / 8][4], uint32_t bh,
                                             uint32_t bl) {
  float part[D / 2];
  t3::issue_pv<D, T>(part, ah, al, bh, bl);
  wg::wait<0>();
  wg::keep(part);
  wg::keep(ah);
  wg::keep(al);
  fold(acc, part);
}

// ------------------------------------------------------------------- dq ----
template <int D, int Stages, bool kDrop>
__global__ void __launch_bounds__(threads<D, true>(), 1)
flash_bwd_dq_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap do_map,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               float* __restrict__ dq, int lq, int lk, int d, float scale,
                               Dropout dr) {
  constexpr int C = consumers<D, true>(), T = loop_tile<D, true>(), W = split_warps<true>();
  constexpr int QB = 64 * D * 4;     // a warpgroup's rows of one operand half
  constexpr int TB = T * D * 4;      // one tile of a slot
  constexpr int SLOT = 6 * TB;       // K hi, K lo, V hi, V lo, K^T hi, K^T lo
  extern __shared__ unsigned char smem_raw[];
  // own: [q' hi, q' lo, do hi, do lo], each C warpgroups' rows
  unsigned char* own = align1024(smem_raw);
  unsigned char* slots = own + 4 * C * QB;
  uint64_t* own_full = reinterpret_cast<uint64_t*>(slots + Stages * SLOT);
  uint64_t* full = own_full + C;
  uint64_t* ready = full + Stages;
  uint64_t* empty = ready + Stages;
  auto own_at = [&](int part, int w) { return own + (part * C + w) * QB; };

  const int bh = blockIdx.y, q0 = blockIdx.x * 64 * C;
  const int n_k = (lk + T - 1) / T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the warpgroup (C and above: the TMA and split warps'), broadcast from
  // lane 0 so the compiler sees the role branches warp-uniform
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const float qscale = scale * tf32::kLog2e;
  if (threadIdx.x == 0) {
    for (int w = 0; w < C; ++w) tma::init(own_full + w, 1);
    for (int s = 0; s < Stages; ++s) {
      tma::init(full + s, 1);
      tma::init(ready + s, W);
      tma::init(empty + s, 4 * C);
    }
    tma::fence_init();
  }
  __syncthreads();

  if (role >= C) {
    const int pw = warp - 4 * C;   // 0: the TMA warp; 1..W: split
    if (pw == 0) {
      if (lane == 0) {
        tma::prefetch_map(&q_map);
        tma::prefetch_map(&do_map);
        tma::prefetch_map(&k_map);
        tma::prefetch_map(&v_map);
        for (int w = 0; w < C; ++w) {
          tma::expect_tx(own_full + w, 2 * QB);
          for (int p = 0; p < D / kPanel; ++p) {
            tma::load_3d(own_at(0, w) + p * 64 * 64, &q_map, own_full + w, p * kPanel,
                         q0 + 64 * w, bh);
            tma::load_3d(own_at(2, w) + p * 64 * 64, &do_map, own_full + w, p * kPanel,
                         q0 + 64 * w, bh);
          }
        }
        for (int t = 0; t < n_k; ++t) {
          const int s = t % Stages;
          unsigned char* slot = slots + s * SLOT;
          tma::wait(empty + s, ((t / Stages) & 1) ^ 1);
          tma::expect_tx(full + s, 2 * TB);
          for (int p = 0; p < D / kPanel; ++p) {
            tma::load_3d(slot + p * T * 64, &k_map, full + s, p * kPanel, t * T, bh);
            tma::load_3d(slot + 2 * TB + p * T * 64, &v_map, full + s, p * kPanel, t * T, bh);
          }
        }
      }
    } else {
      // ---- the split warps: K natural and transposed, V in place ----
      const int sw = pw - 1;
      for (int t = 0; t < n_k; ++t) {
        const int s = t % Stages;
        unsigned char* slot = slots + s * SLOT;
        tma::wait(full + s, (t / Stages) & 1);
        split_transpose<D, T, W>(slot, slot + TB, slot + 4 * TB, slot + 5 * TB, 1.f, sw, lane);
        for (int i = 32 * sw + lane; i < TB / 16; i += 32 * W)
          t3::split4(reinterpret_cast<float4*>(slot + 2 * TB) + i,
                     reinterpret_cast<uint4*>(slot + 3 * TB) + i, 1.f);
        t3::fence_async();
        __syncwarp();
        if (lane == 0) tma::arrive(ready + s);
      }
    }
    return;
  }

  // ---- a consumer warpgroup: 64 q rows ----
  const int w = role;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = 64 * w + 16 * (warp & 3) + gid;   // rows r0 and r0 + 8 of the block
  tma::wait(own_full + w, 0);
  split_own(own_at(0, w), own_at(1, w), QB, qscale);   // q' = q scale log2 e
  split_own(own_at(2, w), own_at(3, w), QB, 1.f);
  t3::fence_async();
  t3::bar_sync(kOwnBar + w, 128);
  const uint32_t qh = tma::smem_u32(own_at(0, w)), ql = tma::smem_u32(own_at(1, w));
  const uint32_t dh = tma::smem_u32(own_at(2, w)), dlo = tma::smem_u32(own_at(3, w));

  float nl[2], dl[2];
  uint32_t row_key[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + r0 + 8 * h;
    nl[h] = r < lq ? -lse[(size_t)bh * lq + r] * tf32::kLog2e : 0.f;
    dl[h] = r < lq ? delta[(size_t)bh * lq + r] : 0.f;
    row_key[h] = kDrop ? dropout_row_key(dr.seed, (uint32_t)bh, (uint32_t)r) : 0u;
  }
  float acc[D / 2], part[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint32_t none[1][4] = {{0u, 0u, 0u, 0u}};   // issue_s's register A: unused
  uint32_t ah[T / 8][4], al[T / 8][4];               // ds, the A fragments of dQ's product
  hwb::KeepMask<T / 2> keep;

  for (int t = 0; t < n_k; ++t) {
    const int s = t % Stages;
    const uint32_t slot = tma::smem_u32(slots + s * SLOT);
    const int k0 = t * T;
    tma::wait(ready + s, (t / Stages) & 1);
    float sc[T / 2], g[T / 2];
    t3::issue_s<D, T, false, 1>(sc, none, opaque(qh), opaque(ql), slot, slot + TB);
    t3::issue_s<D, T, false, 1>(g, none, opaque(dh), opaque(dlo), slot + 2 * TB, slot + 3 * TB);
    wg::wait<1>();   // S done (and dQ's product of tile t - 1); G still runs
    wg::keep(sc);

    // p = exp2(s - lse log2 e); keys >= L_k (the ragged last tile only) get 0
    const bool ragged = t == n_k - 1 && lk - k0 < T;
    if constexpr (kDrop) keep.clear();
#pragma unroll
    for (int i = 0; i < T / 2; ++i) {
      const int h = (i >> 1) & 1, col = k0 + 8 * (i >> 2) + 2 * tig + (i & 1);
      float p = exp2f(sc[i] + nl[h]);
      if (ragged && col >= lk) p = 0.f;
      sc[i] = p;
      if constexpr (kDrop) keep.set(i, dropout_bits(row_key[h], (uint32_t)col) >= dr.keep_thr);
    }
    wg::wait<0>();
    wg::keep(g);
    if constexpr (kDqOverlap) {
      // dQ's product of tile t - 1, folded now that no product is in flight
      // (a read of its registers beside products in flight serializes them:
      // ptxas's C7514); its slot is free
      if (t > 0) {
        wg::keep(part);
        wg::keep(ah);
        wg::keep(al);
        fold(acc, part);
        if (lane == 0) tma::arrive(empty + (t - 1) % Stages);
      }
    }

    // ds = p (g keep c - delta), to hi and lo A fragments; dQ += ds K
#pragma unroll
    for (int i = 0; i < T / 2; ++i) {
      float gk = g[i];
      if constexpr (kDrop) gk = keep.get(i) ? gk * dr.keep_scale : 0.f;
      sc[i] *= gk - dl[(i >> 1) & 1];
    }
    t3::to_p<T>(ah, al, sc);
    if constexpr (kDqOverlap) {
      t3::issue_pv<D, T>(part, ah, al, slot + 4 * TB, slot + 5 * TB);   // folded next tile
    } else {
      product_fold<D, T>(acc, ah, al, slot + 4 * TB, slot + 5 * TB);
      if (lane == 0) tma::arrive(empty + s);
    }
  }
  if constexpr (kDqOverlap) {
    wg::wait<0>();
    wg::keep(part);
    fold(acc, part);
  }

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
__global__ void __launch_bounds__(threads<D, false>(), 1)
flash_bwd_dkv_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map,
                                const __grid_constant__ CUtensorMap do_map,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                float* __restrict__ dk, float* __restrict__ dv, int lq, int lk,
                                int d, float scale, Dropout dr) {
  constexpr int C = consumers<D, false>(), T = loop_tile<D, false>(), W = split_warps<false>();
  constexpr int QB = 64 * D * 4;     // a warpgroup's rows of one operand half
  constexpr int TB = T * D * 4;      // one tile of a slot
  // q' hi, q' lo, do hi, do lo, q'^T hi, q'^T lo, do^T hi, do^T lo
  constexpr int SLOT = 8 * TB;
  extern __shared__ unsigned char smem_raw[];
  // own: [K hi, K lo, V hi, V lo], each C warpgroups' rows
  unsigned char* own = align1024(smem_raw);
  unsigned char* slots = own + 4 * C * QB;
  float* stats = reinterpret_cast<float*>(slots + Stages * SLOT);   // [slot][-lse log2 e, delta, key]
  uint64_t* own_full = reinterpret_cast<uint64_t*>(stats + Stages * 3 * T);
  uint64_t* full = own_full + C;
  uint64_t* ready = full + Stages;
  uint64_t* empty = ready + Stages;
  auto own_at = [&](int part, int w) { return own + (part * C + w) * QB; };

  const int bh = blockIdx.y, k0 = blockIdx.x * 64 * C;
  const int n_q = (lq + T - 1) / T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int w = 0; w < C; ++w) tma::init(own_full + w, 1);
    for (int s = 0; s < Stages; ++s) {
      tma::init(full + s, 1);
      tma::init(ready + s, W);
      tma::init(empty + s, 4 * C);
    }
    tma::fence_init();
  }
  __syncthreads();

  if (role >= C) {
    const int pw = warp - 4 * C;   // 0: the TMA warp; 1..W: split
    if (pw == 0) {
      if (lane == 0) {
        tma::prefetch_map(&k_map);
        tma::prefetch_map(&v_map);
        tma::prefetch_map(&q_map);
        tma::prefetch_map(&do_map);
        for (int w = 0; w < C; ++w) {
          tma::expect_tx(own_full + w, 2 * QB);
          for (int p = 0; p < D / kPanel; ++p) {
            tma::load_3d(own_at(0, w) + p * 64 * 64, &k_map, own_full + w, p * kPanel,
                         k0 + 64 * w, bh);
            tma::load_3d(own_at(2, w) + p * 64 * 64, &v_map, own_full + w, p * kPanel,
                         k0 + 64 * w, bh);
          }
        }
        for (int t = 0; t < n_q; ++t) {
          const int s = t % Stages;
          unsigned char* slot = slots + s * SLOT;
          tma::wait(empty + s, ((t / Stages) & 1) ^ 1);
          tma::expect_tx(full + s, 2 * TB);
          for (int p = 0; p < D / kPanel; ++p) {
            tma::load_3d(slot + p * T * 64, &q_map, full + s, p * kPanel, t * T, bh);
            tma::load_3d(slot + 2 * TB + p * T * 64, &do_map, full + s, p * kPanel, t * T, bh);
          }
        }
      }
    } else {
      // ---- the split warps: q' and do natural and transposed, and each
      // slot's -lse log2 e, delta and dropout row keys (rows past L_q get 0)
      const int sw = pw - 1;
      const float qscale = scale * tf32::kLog2e;
      const float* lseb = lse + (size_t)bh * lq;
      const float* deltab = delta + (size_t)bh * lq;
      // the thread's row of a tile's stats (T <= 32 W rows)
      const int i = 32 * sw + lane;
      for (int t = 0; t < n_q; ++t) {
        const int s = t % Stages;
        unsigned char* slot = slots + s * SLOT;
        // the stats first, from device memory: their latency meets the wait
        const int r = t * T + i;
        const bool row = i < T && r < lq;
        const float nl = row ? -lseb[r] * tf32::kLog2e : 0.f, dlt = row ? deltab[r] : 0.f;
        const uint32_t rk = kDrop ? dropout_row_key(dr.seed, (uint32_t)bh, (uint32_t)r) : 0u;
        tma::wait(full + s, (t / Stages) & 1);
        split_transpose<D, T, W>(slot, slot + TB, slot + 4 * TB, slot + 5 * TB, qscale, sw,
                                 lane);
        split_transpose<D, T, W>(slot + 2 * TB, slot + 3 * TB, slot + 6 * TB, slot + 7 * TB,
                                 1.f, sw, lane);
        if (i < T) {
          float* st = stats + s * 3 * T;
          st[i] = nl;
          st[T + i] = dlt;
          reinterpret_cast<uint32_t*>(st)[2 * T + i] = rk;
        }
        t3::fence_async();
        __syncwarp();
        if (lane == 0) tma::arrive(ready + s);
      }
    }
    return;
  }

  // ---- a consumer warpgroup: 64 keys ----
  const int w = role;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = 64 * w + 16 * (warp & 3) + gid;   // keys r0 and r0 + 8 of the block
  const uint32_t key[2] = {(uint32_t)(k0 + r0), (uint32_t)(k0 + r0 + 8)};
  tma::wait(own_full + w, 0);
  split_own(own_at(0, w), own_at(1, w), QB, 1.f);
  split_own(own_at(2, w), own_at(3, w), QB, 1.f);
  t3::fence_async();
  t3::bar_sync(kOwnBar + w, 128);
  const uint32_t kh = tma::smem_u32(own_at(0, w)), kl = tma::smem_u32(own_at(1, w));
  const uint32_t vh = tma::smem_u32(own_at(2, w)), vl = tma::smem_u32(own_at(3, w));

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  const uint32_t none[1][4] = {{0u, 0u, 0u, 0u}};
  uint32_t ah[T / 8][4], al[T / 8][4];   // the A fragments of dV's and dK's products
  hwb::KeepMask<T / 2> keep;

  for (int t = 0; t < n_q; ++t) {
    const int s = t % Stages;
    const uint32_t slot = tma::smem_u32(slots + s * SLOT);
    const float* st = stats + s * 3 * T;
    const int q0 = t * T;
    tma::wait(ready + s, (t / Stages) & 1);
    float sc[T / 2], g[T / 2];
    t3::issue_s<D, T, false, 1>(sc, none, opaque(kh), opaque(kl), slot, slot + TB);
    t3::issue_s<D, T, false, 1>(g, none, opaque(vh), opaque(vl), slot + 2 * TB, slot + 3 * TB);
    wg::wait<1>();   // S^T done; G^T still runs
    wg::keep(sc);

    // p = exp2(s - lse log2 e) of the lane's keys gid, gid + 8 and queries
    // 8 j + 2 tig, +1 (j = i / 4); queries >= L_q (the ragged last tile
    // only) get 0
    const bool ragged = t == n_q - 1 && lq - q0 < T;
    if constexpr (kDrop) keep.clear();
#pragma unroll
    for (int j = 0; j < T / 8; ++j) {
      const int c = 8 * j + 2 * tig;
      const float2 nl = *reinterpret_cast<const float2*>(st + c);
      uint2 rk = make_uint2(0u, 0u);
      if constexpr (kDrop) rk = *reinterpret_cast<const uint2*>(st + 2 * T + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, h = e >> 1;
        float p = exp2f(sc[i] + ((e & 1) ? nl.y : nl.x));
        if (ragged && q0 + c + (e & 1) >= lq) p = 0.f;
        sc[i] = p;
        if constexpr (kDrop)
          keep.set(i, dropout_bits((e & 1) ? rk.y : rk.x, key[h]) >= dr.keep_thr);
      }
    }
    wg::wait<0>();
    wg::keep(g);

    // p keep c over S^T, ds = p (g keep c - delta) over G^T, to hi and lo A
    // fragments; dV += (p keep c)^T do, dK += ds^T q'
#pragma unroll
    for (int j = 0; j < T / 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(st + T + 8 * j + 2 * tig);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const float p = sc[i];
        float gk = g[i];
        if constexpr (kDrop) {
          const bool kept = keep.get(i);
          sc[i] = kept ? p * dr.keep_scale : 0.f;
          gk = kept ? gk * dr.keep_scale : 0.f;
        }
        g[i] = p * (gk - ((e & 1) ? dl.y : dl.x));
      }
    }
    t3::to_p<T>(ah, al, sc);
    product_fold<D, T>(dva, ah, al, slot + 6 * TB, slot + 7 * TB);
    t3::to_p<T>(ah, al, g);
    product_fold<D, T>(dka, ah, al, slot + 4 * TB, slot + 5 * TB);
    if (lane == 0) tma::arrive(empty + s);
  }

  // dk = scale ds^T q = ds^T q' ln 2
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * tig;
    if (8 * j >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (int)key[h];
      if (r < lk) {
        const size_t at = ((size_t)bh * lk + r) * d + c;
        *reinterpret_cast<float2*>(dk + at) =
            make_float2(dka[4 * j + 2 * h] * tf32::kLn2, dka[4 * j + 2 * h + 1] * tf32::kLn2);
        *reinterpret_cast<float2*>(dv + at) = make_float2(dva[4 * j + 2 * h],
                                                          dva[4 * j + 2 * h + 1]);
      }
    }
  }
}

// ------------------------------------------------------------- launches ----
// the kernel of a launch (if constexpr: a ternary would instantiate both at
// every ring depth either takes)
template <int D, int S, bool kDrop, bool kDq>
const void* kernel_of() {
  if constexpr (kDq) return (const void*)flash_bwd_dq_tf32_wgmma_kernel<D, S, kDrop>;
  else return (const void*)flash_bwd_dkv_tf32_wgmma_kernel<D, S, kDrop>;
}

template <int D, int Stages, bool kDrop, bool kDq>
cudaError_t launch_d(const tc::BwdArgs& a, cudaStream_t stream) {
  constexpr int S = ring<D, kDq, Stages>();
  constexpr int smem = smem_bytes<D, kDq, S>();
  static_assert(smem <= kSmemLimit, "the f32 wgmma backward's shared memory");
  constexpr int rows = 64 * consumers<D, kDq>(), T = loop_tile<D, kDq>();
  cudaError_t err = cudaFuncSetAttribute(kernel_of<D, S, kDrop, kDq>(),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // the own operands' maps read 64-row boxes, the looped ones T-row boxes
  const int q_box = kDq ? 64 : T, kv_box = kDq ? T : 64;
  CUtensorMap qm, km, vm, dm;
  if (!tma::encode_f32_3d(&qm, a.q, a.d, a.lq, a.bh, kPanel, q_box, true) ||
      !tma::encode_f32_3d(&km, a.k, a.d, a.lk, a.bh, kPanel, kv_box, true) ||
      !tma::encode_f32_3d(&vm, a.v, a.d, a.lk, a.bh, kPanel, kv_box, true) ||
      !tma::encode_f32_3d(&dm, a.dout, a.d, a.lq, a.bh, kPanel, q_box, true))
    return cudaErrorInvalidValue;
  if constexpr (kDq) {
    const dim3 grid((a.lq + rows - 1) / rows, a.bh);
    flash_bwd_dq_tf32_wgmma_kernel<D, S, kDrop><<<grid, threads<D, true>(), smem, stream>>>(
        qm, km, vm, dm, a.lse, a.delta, a.dq, a.lq, a.lk, a.d, a.scale, a.dr);
  } else {
    const dim3 grid((a.lk + rows - 1) / rows, a.bh);
    flash_bwd_dkv_tf32_wgmma_kernel<D, S, kDrop><<<grid, threads<D, false>(), smem, stream>>>(
        qm, km, vm, dm, a.lse, a.delta, a.dk, a.dv, a.lq, a.lk, a.d, a.scale, a.dr);
  }
  return cudaGetLastError();
}

// dq (kDq) or dk/dv of f32 operands with takes(q, k, v, dout, d), the head
// dim rounded up to a multiple of 16; Stages the ring asked for (ring() may
// give fewer)
template <int Stages, bool kDq>
cudaError_t launch_bwd(const tc::BwdArgs& a, cudaStream_t s) {
  if (!takes(a.q, a.k, a.v, a.dout, a.d)) return cudaErrorInvalidValue;
  const bool drop = a.dr.keep_thr != 0u;
#define BUCTD_T3B_BWD_CASE(n)                                                 \
  case n / 16:                                                                \
    return drop ? launch_d<n, Stages, true, kDq>(a, s) : launch_d<n, Stages, false, kDq>(a, s);
  switch ((a.d + 15) / 16) {
    BUCTD_T3B_BWD_CASE(16)
    BUCTD_T3B_BWD_CASE(32)
    BUCTD_T3B_BWD_CASE(48)
    BUCTD_T3B_BWD_CASE(64)
    BUCTD_T3B_BWD_CASE(80)
    BUCTD_T3B_BWD_CASE(96)
    BUCTD_T3B_BWD_CASE(112)
    BUCTD_T3B_BWD_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef BUCTD_T3B_BWD_CASE
}

// blocks of the dq (kDq) or dk/dv kernel resident on one SM at head dim d
// (dropout or not), for the ring Stages asks for; 0 where d is out of range
template <int D, int Stages, bool kDq>
int blocks_per_sm_d(bool drop) {
  constexpr int S = ring<D, kDq, Stages>();
  constexpr int smem = smem_bytes<D, kDq, S>();
  const void* kernel = drop ? kernel_of<D, S, true, kDq>() : kernel_of<D, S, false, kDq>();
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads<D, kDq>(), smem) !=
          cudaSuccess)
    return 0;
  return n;
}

template <int Stages>
int blocks_per_sm(int d, bool drop, bool dq) {
#define BUCTD_T3B_OCC_CASE(n)                                                              \
  case n / 16:                                                                             \
    return dq ? blocks_per_sm_d<n, Stages, true>(drop) : blocks_per_sm_d<n, Stages, false>(drop);
  switch ((d + 15) / 16) {
    BUCTD_T3B_OCC_CASE(16)
    BUCTD_T3B_OCC_CASE(32)
    BUCTD_T3B_OCC_CASE(48)
    BUCTD_T3B_OCC_CASE(64)
    BUCTD_T3B_OCC_CASE(80)
    BUCTD_T3B_OCC_CASE(96)
    BUCTD_T3B_OCC_CASE(112)
    BUCTD_T3B_OCC_CASE(128)
    default: return 0;
  }
#undef BUCTD_T3B_OCC_CASE
}

}  // namespace t3b
