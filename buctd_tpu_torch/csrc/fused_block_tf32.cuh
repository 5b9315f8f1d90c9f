// K5's f32 path on Hopper's tensor cores: the fused eval HRNet basic block
//   out = relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2 + x)
// as two implicit GEMMs in 3xTF32 mma.sync m16n8k8 (mma_tf32.cuh: every
// operand split into hi = tf32(x) and lo = tf32(x - hi), each product in
// three passes, f32-accurate to about 2^-21 relative) with f32
// accumulators, the f32 intermediate kept in shared memory.  Launched by
// csrc/fused_block.cu (buctd_fused_block, dtype 0); the contract is points
// (a)-(d) there: f32 taps and sums, the intermediate in f32, zeros for it at
// halo positions outside the image, ((acc + b2) + x) in f32, then relu.
// ops/fused_block.py::fused_block_tf32 emulates its arithmetic.
//
// What bounds it: operations.  Three tf32 passes of 36 C^2 flops a pixel:
// over the four W48 branches at b128, 3 x 2.935e11 / 494.7 TFLOP/s = 1.78 ms
// (the CUDA cores' f32 FMAs, which the SIMT kernel runs, bound the same work
// at 4.38 ms).  Every block streams both convs' weights, 9 C^2 x 4 bytes
// each, from L2: at C >= 192 that traffic, 2.7 GB a branch at C = 384, may
// set the pace before the tensor cores do (PERF.md).
//
// Design: the bf16 kernel's (fused_block_tc.cuh: one block a TH x TW output
// tile with every output channel; conv1 on the tile and its halo into `ys`
// in shared memory, then conv2 from there; each conv an implicit GEMM with
// M = pixels, N = C_out, K = 9 C_in tap-major and no im2col buffer; one
// cp.async stage sequence over (phase, n chunk, c_in chunk, tap group) for
// the weight ring and the input chunks), with these changes for 4-byte
// elements and tf32 fragments:
//   * ldmatrix moves 16-bit elements, so fragments come by 32-bit loads and
//     each warp splits them in registers: A a0 (g, t), a1 (g + 8, t),
//     a2 (g, t + 4), a3 (g + 8, t + 4), a lane's rows g and g + 8 being two
//     tap-shifted pixel rows of the shared tile; B b0 (t, g), b1 (t + 4, g)
//     of the (C_in, C_out) weight tile;
//   * row strides: the input tile KC + 4 and ys C_pad + 4 words (4 times an
//     odd number: 8 consecutive pixels of a tile row fall in distinct groups
//     of 4 banks; where they wrap into the next row, which jumps by WX - W1
//     or W1 - TW, two may share one); the weight tile SW = 8 (mod 32) words,
//     so b0's 32 lanes (row t, column g) hit 32 distinct banks;
//   * the plans (below) are chosen again: the f32 intermediate alone, at the
//     bf16 kernel's 12x9 tiles and C = 384, would take 239,008 of a block's
//     232,448 bytes; smaller tiles pay more halo recompute;
//   * kFold: each tap's products (up to KC channels) start from zero and
//     enter the running sum with one f32 add; the tensor cores' accumulator
//     is not an f32 add (f32 K1 and bf16 K5 found it).
// C_pad is C rounded up to 8 (the k8 step); the pad channels are zero.

#pragma once

#include "fused_block_tc.cuh"   // load_w, load_x: the weight and input tiles
#include "mma_tf32.cuh"

namespace k5tf32 {

constexpr size_t kMaxSmem = 232448;   // 227 KB, a block's dynamic limit
// each tap's products from zero, then one f32 add into the running sums
// (false: the running sums in the tensor cores' accumulators)
constexpr bool kFold = true;

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
  static constexpr int SX = KC + 4;                   // words, 4 times an odd number
  static constexpr int SW = (NC + 23) / 32 * 32 + 8;  // words, 8 (mod 32)
  static constexpr int kSlot = Taps * KC * SW;        // words of a ring slot
  static_assert(KC % 8 == 0 && NC % (8 * WN) == 0 && Stages >= 2 && 9 % Taps == 0,
                "k8 steps, whole n8 tiles a warp, whole tap groups");
  // a chunk's copy, issued Stages - 1 stages ahead, must not land in the
  // buffer the chunk two back still reads: 9 / Taps stages a chunk
  static_assert(Stages <= 9 / Taps + 1, "the input chunks' double buffer");

  static __host__ __device__ int cpad(int C) { return (C + 7) / 8 * 8; }
  static __host__ __device__ int xbufs(int C) { return cpad(C) > KC ? 2 : 1; }
  // the ring, the input tile, ys, and b1, b2
  static size_t smem(int C) {
    return sizeof(float) * ((size_t)Stages * kSlot + (size_t)xbufs(C) * PX * SX +
                            (size_t)P1 * (cpad(C) + 4) + 2 * (size_t)cpad(C));
  }
};

// The tile plans by C_pad (C rounded up to 8), the W48 branches' widths 48,
// 96, 192 and 384: 96x72 maps in 16x8 tiles, 48x36 in 16x12, 24x18 in 12x9
// and 12x9 in 6x9 (two a 12x9 image).  tools/bench_block_variants.py
// --dtype float32 times them against other choices (at C = 48 one tap of all
// 48 channels a slot beat 16-channel chunks of three taps by 9%, at C = 192
// 96 output channels a chunk beat 64 by 15%, at C = 384 16-channel chunks of
// three taps beat 32 of one by 3%, on an H100).
// buctd_tpu_torch/ops/fused_block.py's TF32_PLANS states the same numbers
// for the CPU tests.
//                     CMax TH  TW  KC   NC WM WN Stages Taps Blocks
using Plan48 = Plan<    48, 16,  8, 48,  48, 4, 1, 2, 1, 2>;
using Plan96 = Plan<    96, 16, 12, 16,  48, 8, 1, 2, 3, 1>;
using Plan192 = Plan<  192, 12,  9, 16,  96, 4, 2, 2, 3, 1>;
using Plan384 = Plan<  384,  6,  9, 16, 128, 2, 4, 2, 3, 1>;

// acc += the products of one tap: k extent kc (<= KC, a multiple of 8) of the
// weight tile wt against the A rows src + (base[i][h] + toff) * ss, for the
// warp's m16 tiles below `mtiles`, each operand split as it is read
template <class P>
__device__ __forceinline__ void tap_mma(float (&acc)[P::MT][P::NT][4], const float* src,
                                        int ss, const int (&base)[P::MT][2], int toff,
                                        const float* wt, int kc, int wm, int wn, int lane,
                                        int mtiles) {
  const int gid = lane >> 2, tig = lane & 3;
  const float* bp = wt + tig * P::SW + wn * P::NT * 8 + gid;   // W[t][g] of n8 tile 0
#pragma unroll
  for (int k0 = 0; k0 < P::KC; k0 += 8) {
    if (k0 >= kc) break;
    // every fragment of the k8 step first, then the products
    uint32_t bh[P::NT][2], bl[P::NT][2], ah[P::MT][4], al[P::MT][4];
#pragma unroll
    for (int j = 0; j < P::NT; ++j) {
      tf32::split(bp[k0 * P::SW + j * 8], bh[j][0], bl[j][0]);
      tf32::split(bp[(k0 + 4) * P::SW + j * 8], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < P::MT; ++i) {
      if (wm + i * P::WM >= mtiles) continue;
      const float* r0 = src + (base[i][0] + toff) * ss + k0 + tig;   // row gid
      const float* r1 = src + (base[i][1] + toff) * ss + k0 + tig;   // row gid + 8
      tf32::split(r0[0], ah[i][0], al[i][0]);
      tf32::split(r1[0], ah[i][1], al[i][1]);
      tf32::split(r0[4], ah[i][2], al[i][2]);
      tf32::split(r1[4], ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int i = 0; i < P::MT; ++i) {
      if (wm + i * P::WM >= mtiles) continue;
#pragma unroll
      for (int j = 0; j < P::NT; ++j) tf32::mma3(acc[i][j], ah[i], al[i], bh[j], bl[j]);
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
fused_block_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                        const float* __restrict__ w2, const float* __restrict__ b1,
                        const float* __restrict__ b2, float* __restrict__ out, int H, int W,
                        int C, int tiles_w, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cp = P::cpad(C), sy = cp + 4;
  const int nx = (cp + P::KC - 1) / P::KC, nn = (cp + P::NC - 1) / P::NC;
  constexpr int G = 9 / P::Taps;                      // tap groups: stages a chunk
  const int per_n = G * nx, per_phase = nn * per_n, total = 2 * per_phase;
  float* ring = reinterpret_cast<float*>(smem);
  float* xbuf = ring + P::Stages * P::kSlot;
  float* ys = xbuf + P::xbufs(C) * P::PX * P::SX;
  float* bias = ys + P::P1 * sy;                      // b1, then b2; 0 past C
  for (int c = threadIdx.x; c < 2 * cp; c += P::kThreads) {
    const int k = c < cp ? c : c - cp;
    bias[c] = k < C ? (c < cp ? b1 : b2)[k] : 0.f;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % P::WM, wn = warp / P::WM;
  const int gid = lane >> 2, tig = lane & 3;
  const int ty0 = (blockIdx.x / tiles_w) * P::TH, tx0 = (blockIdx.x % tiles_w) * P::TW;
  const float* xb = x + (size_t)blockIdx.y * H * W * C;
  float* ob = out + (size_t)blockIdx.y * H * W * C;

  // a lane's A rows (gid, gid + 8) in each of its m16 tiles: phase 1 indexes
  // the input tile, phase 2 ys; a row past the tile reads pixel 0, computed
  // and never stored
  int base1[P::MT][2], base2[P::MT][2];
#pragma unroll
  for (int i = 0; i < P::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (wm + i * P::WM) * 16 + gid + 8 * h;
      const int p1 = p < P::P1 ? p : 0, p2 = p < P::P2 ? p : 0;
      base1[i][h] = (p1 / P::W1) * P::WX + p1 % P::W1;
      base2[i][h] = (p2 / P::TW) * P::W1 + p2 % P::TW;
    }

  auto issue = [&](int s) {
    if (s < total) {
      const int phase = s / per_phase, r = s - phase * per_phase;
      const int n = r / per_n, ci = (r - n * per_n) / G, g = r - n * per_n - ci * G;
      k5tc::load_w<P>(ring + (s % P::Stages) * P::kSlot, phase ? w2 : w1, g * P::Taps,
                      ci * P::KC, n * P::NC, C, vec);
      if (phase == 0 && g == 0 && (nx > 1 || n == 0))
        k5tc::load_x<P>(xbuf + ((n * nx + ci) & 1) * P::PX * P::SX, xb, ty0 - 2, tx0 - 2,
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
    const float* xs = xbuf + (nx > 1 ? ((n * nx + ci) & 1) * P::PX * P::SX : 0);
#pragma unroll
    for (int t = 0; t < P::Taps; ++t) {
      const float* wt = ring + (s % P::Stages) * P::kSlot + t * P::KC * P::SW;
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
          // y = relu(acc + b1) inside the image, 0 outside, into ys
          if (p >= P::P1) continue;
          const int gy = ty0 - 1 + p / P::W1, gx = tx0 - 1 + p % P::W1;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int j = 0; j < P::NT; ++j) {
            const int c = c0 + 8 * j;
            if (c >= cp) continue;
            float2 y = make_float2(0.f, 0.f);
            if (inside)
              y = make_float2(k5tc::relu(acc[i][j][2 * h] + bias[c]),
                              k5tc::relu(acc[i][j][2 * h + 1] + bias[c + 1]));
            *reinterpret_cast<float2*>(ys + p * sy + c) = y;
          }
        } else {
          // out = relu((acc + b2) + x)
          if (p >= P::P2) continue;
          const int gy = ty0 + p / P::TW, gx = tx0 + p % P::TW;
          if (gy >= H || gx >= W) continue;
          const size_t pix = ((size_t)gy * W + gx) * C;
#pragma unroll
          for (int j = 0; j < P::NT; ++j) {
            const int c = c0 + 8 * j;
            if (c >= C) continue;
            if (vec) {   // C a multiple of 4: c + 1 < C, 8-byte aligned pairs
              const float2 xr = *reinterpret_cast<const float2*>(xb + pix + c);
              const float z0 = (acc[i][j][2 * h] + bias[cp + c]) + xr.x;
              const float z1 = (acc[i][j][2 * h + 1] + bias[cp + c + 1]) + xr.y;
              *reinterpret_cast<float2*>(ob + pix + c) = make_float2(k5tc::relu(z0),
                                                                     k5tc::relu(z1));
            } else {
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (c + e < C) {
                  const float z = (acc[i][j][2 * h + e] + bias[cp + c + e]) + xb[pix + c + e];
                  ob[pix + c + e] = k5tc::relu(z);
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
  auto kern = fused_block_tf32_kernel<P, kFold>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies need C % 4 == 0 and 16-byte aligned tensors; else the
  // tiles go through registers
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1) |
                      reinterpret_cast<uintptr_t>(w2) | reinterpret_cast<uintptr_t>(out);
  const int vec = C % 4 == 0 && a % 16 == 0;
  const int tiles_w = (W + P::TW - 1) / P::TW, tiles_h = (H + P::TH - 1) / P::TH;
  kern<<<dim3(tiles_w * tiles_h, B), P::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(w2), static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<float*>(out), H, W, C, tiles_w, vec);
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

}  // namespace k5tf32
