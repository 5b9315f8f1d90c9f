// K5's bf16 path on Hopper's tensor cores: the fused eval HRNet basic block
//   out = relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2 + x)
// as two implicit GEMMs with bf16 mma.sync m16n8k16 and f32 accumulators,
// the intermediate kept in shared memory.  Launched by csrc/fused_block.cu
// (buctd_fused_block, dtype 1); same contract as its SIMT kernel, points
// (a)-(d) there: bf16 taps and f32 sums, the intermediate rounded to bf16
// (round to nearest even) before conv2, zeros for the intermediate at halo
// positions outside the image, ((acc + b2) + x) in f32, relu, then bf16.
//
// What bounds it: operations.  36 C^2 flops a pixel against 4 C bytes moved
// (x in, out): at C = 48 over 400 flops a byte, above the card's 295.
//
// Design.  A block owns a TH x TW output tile of one image and every output
// channel.  Each conv is a GEMM: M = the tile's pixels, N = C_out, K = 9 C_in
// (tap-major, as the TPU kernel's _conv9).  No im2col buffer: a lane's A row
// is a pixel, and its ldmatrix row address is that pixel's row of the
// shared activation tile shifted by the tap (dy, dx).  Phase 1 runs conv1 on
// the tile plus a 1-pixel halo ((TH+2) x (TW+2) pixels, the input tile
// (TH+4) x (TW+4)), adds b1 in f32, applies relu, zeroes the positions
// outside the image, rounds to bf16 and stores to `ys` in shared memory;
// phase 2 runs conv2 from `ys` and the epilogue adds b2 and the residual,
// read from device memory.
//
// Shared memory (bf16 rows padded to an odd number of 16-byte units, so the
// 8 rows of one ldmatrix fall in distinct bank groups: tc::stride<D>()):
//   ring  Stages slots of one weight tile, KC input x NC output channels of
//         one tap (HWIO rows are (C_in, C_out) slices, read with ldsm_t);
//   xbuf  the input tile, KC channels; two buffers when C_pad > KC, so the
//         next chunk's copy overlaps this chunk's taps;
//   ys    the intermediate, (TH+2)(TW+2) pixels x C_pad channels.
// C_pad is C rounded up to 16; the pad channels are zero in every tile, so
// they add nothing.  Both phases walk one sequence of stages, (phase,
// output-channel chunk n, input-channel chunk, tap), each one weight tile
// through a cp.async ring (Stages - 1 tiles in flight); a stage at tap 0 of
// phase 1 also brings the input tile's chunk.  Warps split the tile's m16
// row tiles WM ways (round robin) and the NC columns WN ways, and keep
// (MT x NT) m16n8 accumulator tiles; the NC-wide chunks bound them.
//
// Accumulation.  The tensor cores' accumulator is not an f32 add (f32 K1's
// 3xTF32 kernel found it: csrc/flash_fwd_tf32.cuh); with kFold each tap's
// products (up to KC channels) start from zero and enter the running sum with
// an f32 add, which keeps K = 9 C terms as close to f32 as the SIMT kernel's
// sums.

#pragma once

#include "mma_bf16.cuh"

namespace k5tc {

using tc::bf16;

constexpr size_t kMaxSmem = 232448;   // 227 KB, a block's dynamic limit
// each tap's products from zero, then one f32 add into the running sums
// (false: the running sums in the tensor cores' accumulators)
constexpr bool kFold = true;

// max(v, 0) that keeps a NaN, as the plain version's relu does (fmaxf would
// make it 0)
__device__ __forceinline__ float relu(float v) { return isnan(v) ? v : fmaxf(v, 0.f); }

// A tile plan: used for C_pad up to CMax.  TH x TW output pixels; KC input
// channels a weight tile and input chunk; NC output channels a chunk; WM x WN
// warps; Stages slots in the weight ring, each Taps taps (1, 3 or 9) of one
// weight tile; Blocks blocks an SM that the registers must allow.
template <int CMax_, int TH_, int TW_, int KC_, int NC_, int WM_, int WN_, int Stages_,
          int Taps_, int Blocks_>
struct Plan {
  static constexpr int CMax = CMax_, TH = TH_, TW = TW_, KC = KC_, NC = NC_, WM = WM_,
                       WN = WN_, Stages = Stages_, Taps = Taps_, Blocks = Blocks_;
  static constexpr int kWarps = WM * WN, kThreads = 32 * kWarps;
  static constexpr int H1 = TH + 2, W1 = TW + 2;      // intermediate tile, with halo
  static constexpr int HX = TH + 4, WX = TW + 4;      // input tile of phase 1
  static constexpr int P1 = H1 * W1, P2 = TH * TW, PX = HX * WX;
  static constexpr int M1 = (P1 + 15) / 16, M2 = (P2 + 15) / 16;   // m16 row tiles
  static constexpr int MT1 = (M1 + WM - 1) / WM, MT2 = (M2 + WM - 1) / WM;
  static constexpr int MT = MT1 > MT2 ? MT1 : MT2;    // a warp's m16 tiles
  static constexpr int NT = NC / (8 * WN);            // a warp's n8 tiles
  static constexpr int SX = tc::stride<KC>(), SW = tc::stride<NC>();
  static constexpr int kSlot = Taps * KC * SW;        // elements of a ring slot
  static_assert(KC % 16 == 0 && NC % 16 == 0 && NT % 2 == 0 && Stages >= 2 && 9 % Taps == 0,
                "k16 steps, ldsm_t pairs of n8 tiles, whole tap groups");
  // a chunk's copy, issued Stages - 1 stages ahead, must not land in the
  // buffer the chunk two back still reads: 9 / Taps stages a chunk
  static_assert(Stages <= 9 / Taps + 1, "the input chunks' double buffer");

  static __host__ __device__ int cpad(int C) { return (C + 15) / 16 * 16; }
  static __host__ __device__ int xbufs(int C) { return cpad(C) > KC ? 2 : 1; }
  // the ring, the input tile, ys, and b1, b2 as f32
  static size_t smem(int C) {
    return sizeof(bf16) * ((size_t)Stages * kSlot + (size_t)xbufs(C) * PX * SX +
                           (size_t)P1 * (cpad(C) + 8)) +
           sizeof(float) * 2 * cpad(C);
  }
};

// The tile plans by C_pad (C rounded up to 16), the W48 branches' widths
// 48, 96, 192 and 384: 96x72 maps in 16x8 tiles, 48x36 in 16x12, 24x18 in
// 12x18 and 12x9 in 12x9 (one image a block).  tools/bench_block_variants.py
// times them against other choices.  buctd_tpu_torch/ops/fused_block.py's
// TC_PLANS states the same numbers for the CPU tests.
//                     CMax TH  TW  KC   NC WM WN Stages Taps Blocks
using Plan48 = Plan<    48, 16,  8, 48,  48, 4, 1, 2, 3, 2>;
using Plan96 = Plan<    96, 16, 12, 96,  48, 8, 1, 2, 3, 1>;
using Plan192 = Plan<  192, 12, 18, 32,  64, 4, 2, 2, 3, 1>;
using Plan384 = Plan<  384, 12,  9, 64, 128, 2, 4, 2, 1, 1>;

// rows ci0.. (KC of them) x columns n0.. (NC) of taps tap0.. (Taps) of HWIO
// w into a ring slot, tap-major; 0 past C.  T is bf16 here, f32 in
// fused_block_tf32.cuh, whose plans name the same members
template <class P, class T>
__device__ __forceinline__ void load_w(T* dst, const T* __restrict__ w, int tap0, int ci0,
                                       int n0, int C, bool vec) {
  constexpr int R = P::Taps * P::KC;                   // rows of the slot
  if (vec) {   // C a multiple of V: a 16-byte chunk is all in or all out
    constexpr int V = 16 / sizeof(T), CH = P::NC / V;
    for (int i = threadIdx.x; i < R * CH; i += P::kThreads) {
      const int r = i / CH, c = (i - r * CH) * V;
      const int t = r / P::KC, k = r - t * P::KC;
      const bool ok = ci0 + k < C && n0 + c < C;
      cp_async<16>(dst + r * P::SW + c,
                   ok ? w + ((size_t)(tap0 + t) * C + ci0 + k) * C + n0 + c : w, ok);
    }
  } else {
    for (int i = threadIdx.x; i < R * P::NC; i += P::kThreads) {
      const int r = i / P::NC, c = i - r * P::NC;
      const int t = r / P::KC, k = r - t * P::KC;
      dst[r * P::SW + c] = ci0 + k < C && n0 + c < C
                               ? w[((size_t)(tap0 + t) * C + ci0 + k) * C + n0 + c]
                               : T(0.f);
    }
  }
}

// channels ci0.. (KC) of the HX x WX input tile at (gy0, gx0); 0 outside the
// image and past C
template <class P, class T>
__device__ __forceinline__ void load_x(T* dst, const T* __restrict__ xb, int gy0, int gx0,
                                       int ci0, int H, int W, int C, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T), CH = P::KC / V;
    for (int i = threadIdx.x; i < P::PX * CH; i += P::kThreads) {
      const int px = i / CH, c = (i - px * CH) * V;
      const int gy = gy0 + px / P::WX, gx = gx0 + px % P::WX;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && ci0 + c < C;
      cp_async<16>(dst + px * P::SX + c, ok ? xb + ((size_t)gy * W + gx) * C + ci0 + c : xb,
                   ok);
    }
  } else {
    for (int i = threadIdx.x; i < P::PX * P::KC; i += P::kThreads) {
      const int px = i / P::KC, c = i - px * P::KC;
      const int gy = gy0 + px / P::WX, gx = gx0 + px % P::WX;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && ci0 + c < C;
      dst[px * P::SX + c] = ok ? xb[((size_t)gy * W + gx) * C + ci0 + c] : T(0.f);
    }
  }
}

// acc += the products of one tap: k extent kc (<= KC, a multiple of 16) of
// the weight tile wt against the A rows src + (base[i] + toff) * ss, for the
// warp's m16 tiles below `mtiles`
template <class P>
__device__ __forceinline__ void tap_mma(float (&acc)[P::MT][P::NT][4], const bf16* src,
                                        int ss, const int (&base)[P::MT], int toff,
                                        const bf16* wt, int kc, int wm, int wn, int lane,
                                        int mtiles) {
  const int acol = (lane >> 4) * 8;
  const bf16* bp = wt + tc::b_kn<P::SW>(lane) + wn * P::NT * 8;
#pragma unroll
  for (int k0 = 0; k0 < P::KC; k0 += 16) {
    if (k0 >= kc) break;
    // every fragment of the k16 step first: the ldmatrix latencies overlap,
    // and no mma waits on the load just before it
    uint32_t b[P::NT / 2][4], a[P::MT][4];
#pragma unroll
    for (int j = 0; j < P::NT / 2; ++j) tc::ldsm_t(b[j], bp + k0 * P::SW + j * 16);
#pragma unroll
    for (int i = 0; i < P::MT; ++i)
      if (wm + i * P::WM < mtiles) tc::ldsm(a[i], src + (base[i] + toff) * ss + k0 + acol);
#pragma unroll
    for (int i = 0; i < P::MT; ++i) {
      if (wm + i * P::WM >= mtiles) continue;
#pragma unroll
      for (int j = 0; j < P::NT; ++j)
        tc::mma(acc[i][j], a[i], b[j / 2][2 * (j & 1)], b[j / 2][2 * (j & 1) + 1]);
    }
  }
}

template <class P>
__device__ __forceinline__ void zero(float (&t)[P::MT][P::NT][4]) {
#pragma unroll
  for (int i = 0; i < P::MT; ++i)
#pragma unroll
    for (int j = 0; j < P::NT; ++j) t[i][j][0] = t[i][j][1] = t[i][j][2] = t[i][j][3] = 0.f;
}

template <class P, bool Fold>
__global__ void __launch_bounds__(P::kThreads, P::Blocks)
fused_block_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                      const bf16* __restrict__ w2, const bf16* __restrict__ b1,
                      const bf16* __restrict__ b2, bf16* __restrict__ out, int H, int W,
                      int C, int tiles_w, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cp = P::cpad(C), sy = cp + 8;
  const int nx = (cp + P::KC - 1) / P::KC, nn = (cp + P::NC - 1) / P::NC;
  constexpr int G = 9 / P::Taps;                      // tap groups: stages a chunk
  const int per_n = G * nx, per_phase = nn * per_n, total = 2 * per_phase;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* xbuf = ring + P::Stages * P::kSlot;
  bf16* ys = xbuf + P::xbufs(C) * P::PX * P::SX;
  float* bias = reinterpret_cast<float*>(ys + P::P1 * sy);   // b1, then b2; 0 past C
  for (int c = threadIdx.x; c < 2 * cp; c += P::kThreads) {
    const int k = c < cp ? c : c - cp;
    bias[c] = k < C ? __bfloat162float((c < cp ? b1 : b2)[k]) : 0.f;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % P::WM, wn = warp / P::WM;
  const int gid = lane >> 2, tig = lane & 3;
  const int ty0 = (blockIdx.x / tiles_w) * P::TH, tx0 = (blockIdx.x % tiles_w) * P::TW;
  const bf16* xb = x + (size_t)blockIdx.y * H * W * C;
  bf16* ob = out + (size_t)blockIdx.y * H * W * C;

  // a lane's A row in each of its m16 tiles: phase 1 indexes the input tile,
  // phase 2 ys; a row past the tile reads pixel 0, computed and never stored
  int base1[P::MT], base2[P::MT];
#pragma unroll
  for (int i = 0; i < P::MT; ++i) {
    const int p = (wm + i * P::WM) * 16 + (lane & 15);
    const int p1 = p < P::P1 ? p : 0, p2 = p < P::P2 ? p : 0;
    base1[i] = (p1 / P::W1) * P::WX + p1 % P::W1;
    base2[i] = (p2 / P::TW) * P::W1 + p2 % P::TW;
  }

  auto issue = [&](int s) {
    if (s < total) {
      const int phase = s / per_phase, r = s - phase * per_phase;
      const int n = r / per_n, ci = (r - n * per_n) / G, g = r - n * per_n - ci * G;
      load_w<P>(ring + (s % P::Stages) * P::kSlot, phase ? w2 : w1, g * P::Taps, ci * P::KC,
                n * P::NC, C, vec);
      if (phase == 0 && g == 0 && (nx > 1 || n == 0))
        load_x<P>(xbuf + ((n * nx + ci) & 1) * P::PX * P::SX, xb, ty0 - 2, tx0 - 2,
                  ci * P::KC, H, W, C, vec);
    }
    cp_async_commit();
  };

  float acc[P::MT][P::NT][4];
  float part[P::MT][P::NT][4];   // a tap's products, with Fold
  for (int s = 0; s < P::Stages - 1; ++s) issue(s);
  for (int s = 0; s < total; ++s) {
    cp_async_wait<P::Stages - 2>();
    __syncthreads();   // stage s landed for all; every warp is done with s - 1
    issue(s + P::Stages - 1);
    const int phase = s / per_phase, r = s - phase * per_phase;
    const int n = r / per_n, ci = (r - n * per_n) / G, g = r - n * per_n - ci * G;
    if (ci == 0 && g == 0) zero<P>(acc);
    const int kc = min(P::KC, cp - ci * P::KC);
    const bf16* xs = xbuf + (nx > 1 ? ((n * nx + ci) & 1) * P::PX * P::SX : 0);
#pragma unroll
    for (int t = 0; t < P::Taps; ++t) {
      const bf16* wt = ring + (s % P::Stages) * P::kSlot + t * P::KC * P::SW;
      const int tap = g * P::Taps + t, dy = tap / 3, dx = tap - dy * 3;
      auto products = [&](float (&d)[P::MT][P::NT][4]) {
        if (phase == 0)
          tap_mma<P>(d, xs, P::SX, base1, dy * P::WX + dx, wt, kc, wm, wn, lane, P::M1);
        else
          tap_mma<P>(d, ys + ci * P::KC, sy, base2, dy * P::W1 + dx, wt, kc, wm, wn, lane,
                     P::M2);
      };
      if constexpr (Fold) {
        zero<P>(part);
        products(part);
#pragma unroll
        for (int i = 0; i < P::MT; ++i)
#pragma unroll
          for (int j = 0; j < P::NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
      } else {
        products(acc);
      }
    }
    if (ci != nx - 1 || g != G - 1) continue;

    // ---- epilogue of output-channel chunk n
    const int c0 = n * P::NC + wn * P::NT * 8 + 2 * tig;
#pragma unroll
    for (int i = 0; i < P::MT; ++i) {
      const int mt = wm + i * P::WM;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mt * 16 + gid + 8 * h;
        if (phase == 0) {
          // y = relu(acc + b1) inside the image, 0 outside, as bf16 into ys
          if (p >= P::P1) continue;
          const int gy = ty0 - 1 + p / P::W1, gx = tx0 - 1 + p % P::W1;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int j = 0; j < P::NT; ++j) {
            const int c = c0 + 8 * j;
            if (c >= cp) continue;
            float v0 = 0.f, v1 = 0.f;
            if (inside) {
              v0 = relu(acc[i][j][2 * h] + bias[c]);
              v1 = relu(acc[i][j][2 * h + 1] + bias[c + 1]);
            }
            *reinterpret_cast<uint32_t*>(ys + p * sy + c) = tc::pack(v0, v1);
          }
        } else {
          // out = relu((acc + b2) + x) in f32, then bf16
          if (p >= P::P2) continue;
          const int gy = ty0 + p / P::TW, gx = tx0 + p % P::TW;
          if (gy >= H || gx >= W) continue;
          const size_t pix = ((size_t)gy * W + gx) * C;
#pragma unroll
          for (int j = 0; j < P::NT; ++j) {
            const int c = c0 + 8 * j;
            if (c >= C) continue;
            if (vec) {   // C even: c + 1 < C, 4-byte aligned pairs
              const __nv_bfloat162 xr = *reinterpret_cast<const __nv_bfloat162*>(xb + pix + c);
              const float z0 = (acc[i][j][2 * h] + bias[cp + c]) + __low2float(xr);
              const float z1 = (acc[i][j][2 * h + 1] + bias[cp + c + 1]) + __high2float(xr);
              *reinterpret_cast<uint32_t*>(ob + pix + c) = tc::pack(relu(z0), relu(z1));
            } else {
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (c + e < C) {
                  const float z = (acc[i][j][2 * h + e] + bias[cp + c + e]) +
                                  __bfloat162float(xb[pix + c + e]);
                  ob[pix + c + e] = __float2bfloat16_rn(relu(z));
                }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <class P>
int launch(const void* x, const void* w1, const void* w2, const void* b1, const void* b2,
           void* out, int B, int H, int W, int C, void* stream) {
  const size_t smem = P::smem(C);
  if (P::cpad(C) > P::CMax || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = fused_block_tc_kernel<P, kFold>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies need C % 8 == 0 and 16-byte aligned tensors; else the
  // tiles go through registers
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1) |
                      reinterpret_cast<uintptr_t>(w2) | reinterpret_cast<uintptr_t>(out);
  const int vec = C % 8 == 0 && a % 16 == 0;
  const int tiles_w = (W + P::TW - 1) / P::TW, tiles_h = (H + P::TH - 1) / P::TH;
  kern<<<dim3(tiles_w * tiles_h, B), P::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(b2), static_cast<bf16*>(out), H,
      W, C, tiles_w, vec);
  return (int)cudaGetLastError();
}

inline int run(const void* x, const void* w1, const void* w2, const void* b1, const void* b2,
               void* out, int B, int H, int W, int C, void* stream) {
  const int cp = Plan48::cpad(C);
  if (cp <= Plan48::CMax) return launch<Plan48>(x, w1, w2, b1, b2, out, B, H, W, C, stream);
  if (cp <= Plan96::CMax) return launch<Plan96>(x, w1, w2, b1, b2, out, B, H, W, C, stream);
  if (cp <= Plan192::CMax) return launch<Plan192>(x, w1, w2, b1, b2, out, B, H, W, C, stream);
  return launch<Plan384>(x, w1, w2, b1, b2, out, B, H, W, C, stream);
}

}  // namespace k5tc
