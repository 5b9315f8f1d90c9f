// K1's f32 forward for Hopper: flash_fwd_tf32_wgmma_kernel, out =
// dropout(softmax(q k^T * scale)) v and the natural-log lse of every row, for
// f32 operands, on TMA loads and warpgroup MMAs (wgmma) in 3xTF32.  Included
// by flash_fwd.cu (K1: a ring of kStages key tiles) and by flash_fwd_kvres.cu
// (K1': the same kernel with the deeper ring of kKvresStages where shared
// memory holds it, so K1' equals K1 bit for bit).  Both take it for every
// f32 call whose head dim is a multiple of 8 and whose q, k and v start
// 16-byte aligned (takes(): TMA's 16-byte strides and bases, k8 steps); the
// other f32 calls run flash_fwd_tf32_kernel (flash_fwd_tf32.cuh), the
// mma.sync kernel.
//
// It replaces JAX's _fwd_kernel (buctd_tpu/ops/flash_attention.py:86) and
// _fwd_kernel_kvres (:139) for f32 operands at Precision.HIGHEST, and
// computes what flash_fwd_tf32_kernel computes: q' = q * scale * log2 e in
// f32, s = q' k^T and p v each in three tf32 passes (lo hi + hi lo + hi hi,
// every operand split as mma_tf32.cuh::split splits it, f32-accurate to
// about 2^-21 relative), the online softmax in the exp2 domain with exp2f,
// l summed over p before dropout, out = o / max(l, 1e-30), lse = (m + log2
// max(l, 1e-30)) ln 2.  Nothing is rounded to a narrower type.
//
// What bounds it.  Its two products, 4 L_q L_k d operations, in three passes
// at the dense TF32 rate: at d = 48 and 112 they lead the MUFU's one exp2 a
// (row, key) pair by about 5x and 11x.  Next comes shared memory's 128 bytes
// a clock: both products read their B operand from it, S reads q' (A) from it
// too, and every K and V element is split there once; at d = 112 that
// traffic is about 1.2x the tensor cores' time for the same tile (d = 48:
// 0.8x).
//
// The design:
//   * a block owns a (bh, 128-row q tile): warps 0-7 are two consumer
//     warpgroups of 64 rows each; warp 8 issues the TMA loads; warps 9-11
//     split K and V into the tf32 halves the tensor cores read (TMA copies,
//     it cannot split or transpose).  No setmaxnreg: every thread has the
//     launch's 168 registers, which the consumers' O, P V, S and P fit;
//   * q: each consumer warpgroup's 64 rows land by TMA with the 64-byte
//     swizzle in 16-column panels; the warpgroup forms q' = q * scale * log2 e
//     and splits it in place, elementwise (hi over q, lo at the same offset
//     in a second buffer), so the swizzle needs no address arithmetic here:
//     S reads q' lo, and above d = 48 (kQRegsUpTo) q' hi too, as A from
//     shared memory through 64-byte-swizzle descriptors.  Up to d = 48 q' hi
//     is read once into registers, from its swizzled place, as the A
//     fragments of S's two q' hi passes: 8% faster at d = 48, where S's A
//     reads from shared memory cost most (tools/bench_flash_fwd.py, variant
//     qsmem); q' hi and lo in registers (d of them) would not fit beside O
//     and P V at d = 112;
//   * K: each key tile of BK keys (key_tile) lands by TMA the same way and the
//     split warps split it in place (hi over K, lo beside it); S = q' K^T is
//     wgmma m64nBKk8 with both operands from shared memory, three passes
//     over d / 8 k8 steps, the small terms first;
//   * V: P V needs B = V with the keys contiguous, and tf32 has no transposed
//     operand, so each V tile lands unswizzled (rows of D f32) in the slot of
//     its lo half and the split warps write hi and lo transposed, into the
//     unswizzled core-matrix layout (wgmma_tf32.cuh): 8 columns of d x 4 key
//     positions a core matrix.  A lane's P accumulators hold keys 2 tig and
//     2 tig + 1 of each 8-key chunk, and the tf32 A fragment takes columns
//     tig and tig + 4: so A column tig takes key 2 tig and column tig + 4 key
//     2 tig + 1 (no shuffle), and V's key positions are permuted the same
//     way as they are written (position i <- key 2 i, position 4 + i <- key
//     2 i + 1 of each chunk), as flash_fwd_tf32_kernel permutes its B reads.
//     The raw tile is read whole before its lo half is written over it (the
//     split warps hold lo in registers across a barrier of their own);
//   * a ring of Stages slots (K hi, K lo, V^T hi, V^T lo), each with six
//     barriers: K and V landed (TMA), K and V split (the split warps), K and
//     V free (both consumer warpgroups done with S, with P V), so S of a tile
//     starts once its K is split, while its V is still being transposed;
//   * P: p = exp2f(s - m) in the S accumulators, split into hi and lo A
//     fragments in registers; P V is one wgmma m64nDk8 product with A from
//     registers (kPvSplitFrom: in two halves of d, each half's accumulators
//     fewer, 4% slower at d = 112), into zero accumulators that enter O with
//     one f32 fma (o = o alpha + pv): the tensor cores add into an
//     accumulator less exactly than an f32 add, and O taking every tile's
//     products through it lost accuracy with L_k (flash_fwd_tf32.cuh's
//     note);
//   * from d = 64 (kTurnsFrom) the two consumer warpgroups take turns
//     issuing their products (two named barriers), so one's softmax meets
//     the other's products; at d = 48 they issue when ready, 5% faster
//     there (variant turns_all), while without turns d = 96 ran 3-4% slower
//     (variant solo);
//   * dropout is a template parameter: the dropout-0 instantiation, which
//     serving and evaluation run, carries no hash; with dropout the mask bit
//     of a weight is dropout_hash.cuh's hash of its global (bh, row, col);
//   * shared memory (smem_bytes): q' hi and lo, 8 x 128 x D bytes, and 16 x
//     BK x D a slot: BK = 64 up to d = 64, 32 above, 16 at d = 128, where 32
//     does not leave room for two slots; K1' takes three slots where they
//     fit (d = 48: yes; d = 96 and 112: no, so there K1' runs K1's ring);
//   * one block an SM (its registers and shared memory): 864 blocks at
//     CoAM-W48's branch 0 or TransPose-H's serving batch of 16 (6.5 waves on
//     132 SMs).
//
// The tensor maps are encoded on the host at every launch and passed by
// value (__grid_constant__): a CUDA graph that captures a launch keeps them,
// and a replay reads the buffers of the capture (graphs.py replays on static
// buffers).

#pragma once

#include <math.h>

#include "dropout_hash.cuh"
#include "mma_tf32.cuh"
#include "tma.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"

namespace t3 {

constexpr int kConsumers = 2;                        // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);     // and the producer warpgroup
constexpr int kRows = 64 * kConsumers;               // q rows a block
constexpr int kPanel = 16;                           // f32 columns of a swizzled row
constexpr int kSplitWarps = 3;                       // warps that split K and V
constexpr int kTurnsFrom = 64;                       // turns at the tensor cores from this d
constexpr int kStages = 2;                           // K1's ring
constexpr int kKvresStages = 3;                      // K1''s, where it fits
constexpr int kNarrowKeyTile = 64;                   // the key tile up to d = 64
constexpr int kWideKeyTile = 32;                     // above
constexpr int kPvSplitFrom = 256;                    // P V in two halves of d from here
constexpr int kQRegsUpTo = 48;                       // q' hi in registers up to this d
constexpr int kSmemLimit = 232448;                   // a block's shared memory
// named barriers: 0 is __syncthreads; each consumer warpgroup's own (q'
// split); the split warps'; the turns
constexpr int kQBar = 1, kSplitBar = 1 + kConsumers, kTurnBar = 2 + kConsumers;

// bytes of shared memory at padded head dim D, key tile BK and Stages slots:
// 1024 of slack to align the tiles; q' hi and lo; the slots; the barriers
__host__ __device__ constexpr int smem_for(int D, int BK, int stages) {
  return 1024 + 2 * kRows * D * 4 + stages * 4 * BK * D * 4 + 8 * (kConsumers + 6 * stages);
}

// the key tile: kNarrowKeyTile up to d = 64, kWideKeyTile above, halved
// until two slots fit
template <int D>
__host__ __device__ constexpr int key_tile() {
  int bk = D <= 64 ? kNarrowKeyTile : kWideKeyTile;
  while (bk > 8 && smem_for(D, bk, 2) > kSmemLimit) bk /= 2;
  return bk;
}

// the slots a launch that asks for Want runs: the most up to Want that fit
template <int D, int Want>
__host__ __device__ constexpr int ring() {
  int s = Want;
  while (s > 2 && smem_for(D, key_tile<D>(), s) > kSmemLimit) --s;
  return s;
}

template <int D>
__host__ __device__ constexpr int pv_parts() { return D >= kPvSplitFrom ? 2 : 1; }

// the consumer warpgroups take turns issuing their products (two named
// barriers) from padded d kTurnsFrom; below it each issues when ready
template <int D>
__host__ __device__ constexpr bool turns() { return kConsumers > 1 && D >= kTurnsFrom; }

// q' hi as the A fragments of S's two q' hi passes in registers (d / 2 of
// them) up to padded d kQRegsUpTo, else read from shared memory; q' lo is
// read from shared memory at every d
template <int D>
__host__ __device__ constexpr bool q_in_regs() { return D <= kQRegsUpTo; }

template <int D, int Stages>
__host__ __device__ constexpr int smem_bytes() { return smem_for(D, key_tile<D>(), Stages); }

// f32 calls this kernel takes: TMA's 16-byte strides and bases, d a
// multiple of 8 (k8 steps), at most 128
inline bool takes(const void* q, const void* k, const void* v, int d) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return d > 0 && d <= 128 && d % 8 == 0 && aligned(q) && aligned(k) && aligned(v);
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
// this thread's generic stores to shared memory, seen by the async proxy
// (the wgmma that read them)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// four f32 at x split in place: hi over x, lo at `lo`, each times mul first
// (mul 1: K)
__device__ __forceinline__ void split4(float4* x, uint4* lo, float mul) {
  const float4 v = *x;
  uint32_t h[4], l[4];
  tf32::split(__fmul_rn(v.x, mul), h[0], l[0]);
  tf32::split(__fmul_rn(v.y, mul), h[1], l[1]);
  tf32::split(__fmul_rn(v.z, mul), h[2], l[2]);
  tf32::split(__fmul_rn(v.w, mul), h[3], l[3]);
  *reinterpret_cast<uint4*>(x) = make_uint4(h[0], h[1], h[2], h[3]);
  *lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// byte offset in a V^T tile (BK key positions) of the 4 positions 4 q .. 4 q
// + 3 of column c: core matrix (c / 8, q), row c % 8; a k8 step's two core
// matrices 128 bytes apart (LBO), the 8-column groups 32 BK apart (SBO)
template <int BK>
__device__ __forceinline__ int vt_offset(int c, int q) {
  return (c / 8) * (32 * BK) + q * 128 + (c % 8) * 16;
}

// The online softmax of one key tile in place in its S accumulators s (the
// lane's rows h = 0, 1: gid and gid + 8 of its warp), in the exp2 domain (q'
// carries log2 e): keys k0 + col >= lk (`ragged`, the last tile only) get
// -inf; m, the running max, and l, the lane's share of the running sum, are
// updated, alpha is the factor that rescales O; s becomes p = exp2f(s - m)
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
#pragma unroll
  for (int h = 0; h < 2; ++h) {   // the row max over the 4 lanes of the row
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = exp2f(m[h] - mx[h]);   // 0 on the first tile (m = -inf)
    m[h] = mx[h];
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int h = (i >> 1) & 1;
    float p = exp2f(s[i] - m[h]);
    l[h] += p;
    if constexpr (kDrop)
      p = dropout_bits(row_key[h], (uint32_t)(k0 + 8 * (i >> 2) + 2 * tig + (i & 1))) >=
                  dr.keep_thr
              ? p * dr.keep_scale : 0.f;
    s[i] = p;
  }
}

// p from the S accumulators split into the hi and lo A fragments of P V, in
// the permuted key order: a0 <- key 2 tig (c0), a1 <- its row gid + 8 (c2),
// a2 <- key 2 tig + 1 (c1), a3 <- its row gid + 8 (c3) of each 8-key chunk
template <int BK>
__device__ __forceinline__ void to_p(uint32_t (&ph)[BK / 8][4], uint32_t (&pl)[BK / 8][4],
                                     const float (&s)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    tf32::split(s[4 * kk + 0], ph[kk][0], pl[kk][0]);
    tf32::split(s[4 * kk + 2], ph[kk][1], pl[kk][1]);
    tf32::split(s[4 * kk + 1], ph[kk][2], pl[kk][2]);
    tf32::split(s[4 * kk + 3], ph[kk][3], pl[kk][3]);
  }
}

// S = q' K^T (64 x BK) in three passes (q' lo K hi, q' hi K lo, q' hi K hi),
// q' of the warpgroup (hi at qh, lo at ql: panels of 64 rows; with QR q' hi
// from the A fragments qr instead) and the K tile (hi at kh, lo at kl: panels
// of BK rows) read from shared memory, one committed group behind a fence of
// its own
template <int D, int BK, bool QR, int KQ>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2], const uint32_t (&qr)[KQ][4],
                                        uint32_t qh, uint32_t ql, uint32_t kh, uint32_t kl) {
  wg::keep(s);
  wg::fence();
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const uint32_t qa = pass == 0 ? ql : qh, kb = pass == 1 ? kl : kh;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint64_t b = wgt::sw64_desc(kb + (kk / 2) * BK * 64 + (kk % 2) * 32);
      if constexpr (QR) {
        if (pass > 0) {
          wgt::Rs<BK>::mma(s, qr[kk], b);
          continue;
        }
      }
      const uint64_t a = wgt::sw64_desc(qa + (kk / 2) * 64 * 64 + (kk % 2) * 32);
      if (pass == 0 && kk == 0) wgt::Ss<BK>::mma_zero(s, a, b);
      else wgt::Ss<BK>::mma(s, a, b);
    }
  }
  wg::commit();
  wg::keep(s);
}

// pv = P V^T-tile (64 x NP) in three passes (P lo V hi, P hi V lo, P hi V
// hi), P from registers, V^T's NP columns from vh / vl (core-matrix layout),
// from zero accumulators, one committed group behind a fence of its own
template <int NP, int BK>
__device__ __forceinline__ void issue_pv(float (&pv)[NP / 2], const uint32_t (&ph)[BK / 8][4],
                                         const uint32_t (&pl)[BK / 8][4], uint32_t vh,
                                         uint32_t vl) {
  wg::keep(pv);
  wg::fence();
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const uint32_t vb = pass == 1 ? vl : vh;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t b = wgt::il_desc(vb + kk * 256, 128, 32 * BK);
      const uint32_t (&a)[4] = pass == 0 ? pl[kk] : ph[kk];
      if (pass == 0 && kk == 0) wgt::Rs<NP>::mma_zero(pv, a, b);
      else wgt::Rs<NP>::mma(pv, a, b);
    }
  }
  wg::commit();
  wg::keep(pv);
}

template <int D, int Stages, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            float* __restrict__ out, float* __restrict__ lse, int lq, int lk,
                            int d, float qscale, Dropout dr) {
  constexpr int BK = key_tile<D>();
  constexpr int KV = BK / 8;                 // k8 steps of P V over the key tile
  constexpr int PARTS = pv_parts<D>(), NP = D / PARTS;
  constexpr int QB = 64 * D * 4;             // a warpgroup's q' hi (or lo)
  constexpr int TB = BK * D * 4;             // one tile: K hi, K lo, V^T hi or V^T lo
  constexpr int SLOT = 4 * TB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_hi = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_lo = q_hi + kConsumers * QB;
  unsigned char* slots = q_lo + kConsumers * QB;  // Stages slots: K hi, K lo, V^T hi, V^T lo
  uint64_t* q_full = reinterpret_cast<uint64_t*>(slots + Stages * SLOT);
  uint64_t* k_full = q_full + kConsumers;
  uint64_t* v_full = k_full + Stages;
  uint64_t* k_ready = v_full + Stages;
  uint64_t* v_ready = k_ready + Stages;
  uint64_t* k_empty = v_ready + Stages;
  uint64_t* v_empty = k_empty + Stages;

  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const int n_k = (lk + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the warpgroup, broadcast from lane 0 so the compiler sees the role
  // branches warp-uniform
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int w = 0; w < kConsumers; ++w) tma::init(q_full + w, 1);
    for (int s = 0; s < Stages; ++s) {
      tma::init(k_full + s, 1);
      tma::init(v_full + s, 1);
      tma::init(k_ready + s, kSplitWarps);
      tma::init(v_ready + s, kSplitWarps);
      tma::init(k_empty + s, 4 * kConsumers);
      tma::init(v_empty + s, 4 * kConsumers);
    }
    tma::fence_init();
  }
  __syncthreads();

  if (role == kConsumers) {
    const int pw = warp - 4 * kConsumers;   // 0: the TMA warp; 1..kSplitWarps: split
    if (pw == 0) {
      if (lane == 0) {
        tma::prefetch_map(&q_map);
        tma::prefetch_map(&k_map);
        tma::prefetch_map(&v_map);
        for (int w = 0; w < kConsumers; ++w) {
          tma::expect_tx(q_full + w, QB);
          for (int p = 0; p < D / kPanel; ++p)
            tma::load_3d(q_hi + w * QB + p * 64 * 64, &q_map, q_full + w, p * kPanel,
                         q0 + 64 * w, bh);
        }
        for (int t = 0; t < n_k; ++t) {
          const int s = t % Stages;
          const uint32_t free_parity = ((t / Stages) & 1) ^ 1;
          unsigned char* slot = slots + s * SLOT;
          tma::wait(k_empty + s, free_parity);
          tma::expect_tx(k_full + s, TB);
          for (int p = 0; p < D / kPanel; ++p)
            tma::load_3d(slot + p * BK * 64, &k_map, k_full + s, p * kPanel, t * BK, bh);
          // the raw V tile lands where its lo half goes (rows of D f32)
          tma::wait(v_empty + s, free_parity);
          tma::expect_tx(v_full + s, TB);
          tma::load_3d(slot + 3 * TB, &v_map, v_full + s, 0, t * BK, bh);
        }
      }
    } else if (pw <= kSplitWarps) {
      // ---- the split warps ----
      constexpr int NS = 32 * kSplitWarps;
      constexpr int NIT = (BK / 8) * (D / 16);   // V^T: a warp's 32 (column, 4 keys) units
      constexpr int ITS = (NIT + kSplitWarps - 1) / kSplitWarps;
      const int sw = pw - 1, st = 32 * sw + lane;
      // a warp's unit: key parity vp, column 16 panel + vc of key octet a
      const int vp = (lane >> 3) & 1, vc = 8 * (lane >> 4) + (lane & 7);
      for (int t = 0; t < n_k; ++t) {
        const int s = t % Stages;
        const uint32_t par = (t / Stages) & 1;
        unsigned char* slot = slots + s * SLOT;
        // K: hi in place, lo beside it, elementwise
        tma::wait(k_full + s, par);
        for (int i = st; i < TB / 16; i += NS)
          split4(reinterpret_cast<float4*>(slot) + i, reinterpret_cast<uint4*>(slot + TB) + i,
                 1.f);
        fence_async();
        __syncwarp();
        if (lane == 0) tma::arrive(k_ready + s);
        // V: each unit reads keys 8 a + vp + 2 e (e = 0..3) of column c and
        // writes them as positions 8 a + 4 vp + e of V^T's row c
        tma::wait(v_full + s, par);
        const float* raw = reinterpret_cast<const float*>(slot + 3 * TB);
        uint32_t lo[ITS][4];
#pragma unroll
        for (int i = 0; i < ITS; ++i) {
          const int it = sw + kSplitWarps * i;
          if (it < NIT) {
            const int a = it / (D / 16), c = 16 * (it % (D / 16)) + vc;
            uint32_t hi[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              tf32::split(raw[(8 * a + vp + 2 * e) * D + c], hi[e], lo[i][e]);
            *reinterpret_cast<uint4*>(slot + 2 * TB + vt_offset<BK>(c, 2 * a + vp)) =
                make_uint4(hi[0], hi[1], hi[2], hi[3]);
          }
        }
        bar_sync(kSplitBar, NS);   // the raw tile is read whole before lo covers it
#pragma unroll
        for (int i = 0; i < ITS; ++i) {
          const int it = sw + kSplitWarps * i;
          if (it < NIT) {
            const int a = it / (D / 16), c = 16 * (it % (D / 16)) + vc;
            *reinterpret_cast<uint4*>(slot + 3 * TB + vt_offset<BK>(c, 2 * a + vp)) =
                make_uint4(lo[i][0], lo[i][1], lo[i][2], lo[i][3]);
          }
        }
        fence_async();
        __syncwarp();
        if (lane == 0) tma::arrive(v_ready + s);
      }
    }
  } else {
    // ---- a consumer warpgroup: 64 rows ----
    const int wgi = role;
    const int gid = lane >> 2, tig = lane & 3;
    const int r0 = 64 * wgi + 16 * (warp & 3) + gid;   // rows r0 and r0 + 8 of the tile

    // q' = q * scale * log2 e, split in place: hi over q, lo beside it
    tma::wait(q_full + wgi, 0);
    for (int i = threadIdx.x & 127; i < QB / 16; i += 128)
      split4(reinterpret_cast<float4*>(q_hi + wgi * QB) + i,
             reinterpret_cast<uint4*>(q_lo + wgi * QB) + i, qscale);
    fence_async();
    bar_sync(kQBar + wgi, 128);
    const uint32_t qh = tma::smem_u32(q_hi + wgi * QB), ql = tma::smem_u32(q_lo + wgi * QB);
    // q' hi as registers (q_in_regs): the A fragment of row r, column c of
    // the warpgroup's rows, at its place in the 64-byte swizzle (16-byte chunk
    // c % 16 / 4 of row r at chunk (c % 16 / 4) ^ (r / 2 % 4) of its panel)
    constexpr bool QR = q_in_regs<D>();
    uint32_t qr[QR ? D / 8 : 1][4];
    if constexpr (QR) {
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int r = 16 * (warp & 3) + gid + 8 * (h & 1), c = 8 * kk + tig + 4 * (h >> 1);
          qr[kk][h] = *reinterpret_cast<const uint32_t*>(
              q_hi + wgi * QB + (c / 16) * 64 * 64 + r * 64 +
              ((((c % 16) >> 2) ^ ((r >> 1) & 3)) << 4) + (c % 4) * 4);
        }
    }

    uint32_t row_key[2];
    float m[2], l[2];   // m: the running max of the log2-domain logits; l: the lane's share
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
    // the turns (turns()): warpgroup 0 issues first; each sync on a
    // warpgroup's barrier meets one arrival of the other's
    if constexpr (turns<D>()) {
      if (wgi == 1) bar_arrive(kTurnBar, 256);
    }

    for (int t = 0; t < n_k; ++t) {
      const int s = t % Stages;
      const uint32_t par = (t / Stages) & 1;
      const uint32_t slot = tma::smem_u32(slots + s * SLOT);
      const int k0 = t * BK;

      tma::wait(k_ready + s, par);
      float sc[BK / 2];
      if constexpr (turns<D>()) bar_sync(kTurnBar + wgi, 256);
      issue_s<D, BK, QR>(sc, qr, qh, ql, slot, slot + TB);
      if constexpr (turns<D>()) bar_arrive(kTurnBar + (wgi ^ 1), 256);
      wg::wait<0>();
      wg::keep(sc);
      if (lane == 0) tma::arrive(k_empty + s);
      float alpha[2];
      softmax_tile<BK, kDrop>(sc, m, l, alpha, k0, lk, t == n_k - 1 && lk - k0 < BK, tig,
                              row_key, dr);
      uint32_t ph[KV][4], pl[KV][4];
      to_p<BK>(ph, pl, sc);

      tma::wait(v_ready + s, par);
#pragma unroll
      for (int part = 0; part < PARTS; ++part) {
        float pv[NP / 2];
        if constexpr (turns<D>()) bar_sync(kTurnBar + wgi, 256);
        issue_pv<NP, BK>(pv, ph, pl, slot + 2 * TB + part * (NP / 8) * 32 * BK,
                         slot + 3 * TB + part * (NP / 8) * 32 * BK);
        if constexpr (turns<D>()) {
          // the other warpgroup's last turn needs no arrival
          if (!(wgi == 1 && t == n_k - 1 && part == PARTS - 1))
            bar_arrive(kTurnBar + (wgi ^ 1), 256);
        }
        wg::wait<0>();
        wg::keep(pv);
        wg::keep(ph);
        wg::keep(pl);
#pragma unroll
        for (int i = 0; i < NP / 2; ++i) {
          const int at = part * (NP / 2) + i;
          o[at] = fmaf(o[at], alpha[(i >> 1) & 1], pv[i]);
        }
      }
      if (lane == 0) tma::arrive(v_empty + s);
    }

    // out = o / max(l, 1e-30), lse = (m + log2 l) ln 2, l summed over the
    // row's 4 lanes
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
        if (r < lq) lse[(size_t)bh * lq + r] = (m[h] + log2f(l[h])) * tf32::kLn2;
      }
  }
}

template <int D, int Stages, bool kDrop>
cudaError_t launch_fwd_d(const void* q, const void* k, const void* v, float* out, float* lse,
                         int bh, int lq, int lk, int d, float scale, Dropout dr,
                         cudaStream_t stream) {
  constexpr int S = ring<D, Stages>();
  constexpr int smem = smem_bytes<D, S>();
  static_assert(smem <= kSmemLimit, "the f32 wgmma forward's shared memory");
  auto* kernel = flash_fwd_tf32_wgmma_kernel<D, S, kDrop>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm;
  if (!tma::encode_f32_3d(&qm, q, d, lq, bh, kPanel, 64, true) ||
      !tma::encode_f32_3d(&km, k, d, lk, bh, kPanel, key_tile<D>(), true) ||
      !tma::encode_f32_3d(&vm, v, d, lk, bh, D, key_tile<D>(), false))
    return cudaErrorInvalidValue;
  const dim3 grid((lq + kRows - 1) / kRows, bh);
  kernel<<<grid, kThreads, smem, stream>>>(qm, km, vm, out, lse, lq, lk, d,
                                           scale * tf32::kLog2e, dr);
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

// q (bh, lq, d), k/v (bh, lk, d) f32 with takes(q, k, v, d); out (bh, lq, d)
// and lse (bh, lq) f32; Stages the ring asked for (ring() may give fewer)
template <int Stages>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, float* out, float* lse,
                       int bh, int lq, int lk, int d, float scale, Dropout dr,
                       cudaStream_t s) {
  if (!takes(q, k, v, d)) return cudaErrorInvalidValue;
#define BUCTD_T3_FWD_CASE(n)                                                            \
  case n / 16:                                                                          \
    return launch_fwd_drop<n, Stages>(q, k, v, out, lse, bh, lq, lk, d, scale, dr, s);
  switch ((d + 15) / 16) {
    BUCTD_T3_FWD_CASE(16)
    BUCTD_T3_FWD_CASE(32)
    BUCTD_T3_FWD_CASE(48)
    BUCTD_T3_FWD_CASE(64)
    BUCTD_T3_FWD_CASE(80)
    BUCTD_T3_FWD_CASE(96)
    BUCTD_T3_FWD_CASE(112)
    BUCTD_T3_FWD_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef BUCTD_T3_FWD_CASE
}

// blocks of the kernel resident on one SM at head dim d (dropout or not),
// for the ring Stages asks for; 0 where d is out of range
template <int Stages>
int blocks_per_sm(int d, bool drop) {
  int n = 0;
#define BUCTD_T3_OCC_CASE(D)                                                             \
  case D / 16: {                                                                         \
    constexpr int S = ring<D, Stages>();                                                 \
    auto* kernel = drop ? flash_fwd_tf32_wgmma_kernel<D, S, true>                        \
                        : flash_fwd_tf32_wgmma_kernel<D, S, false>;                      \
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,        \
                             smem_bytes<D, S>()) != cudaSuccess ||                       \
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,              \
                                                      smem_bytes<D, S>()) != cudaSuccess) \
      return 0;                                                                          \
    return n;                                                                            \
  }
  switch ((d + 15) / 16) {
    BUCTD_T3_OCC_CASE(16)
    BUCTD_T3_OCC_CASE(32)
    BUCTD_T3_OCC_CASE(48)
    BUCTD_T3_OCC_CASE(64)
    BUCTD_T3_OCC_CASE(80)
    BUCTD_T3_OCC_CASE(96)
    BUCTD_T3_OCC_CASE(112)
    BUCTD_T3_OCC_CASE(128)
    default: return 0;
  }
#undef BUCTD_T3_OCC_CASE
}

}  // namespace t3
