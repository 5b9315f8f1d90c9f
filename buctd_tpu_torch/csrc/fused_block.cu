// Fused eval HRNet basic block for Hopper (sm_90a):
//   out = relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2 + x)
// with SAME padding and the block's BatchNorms folded into (w, b).  Both
// dtypes run on the tensor cores: f32 in 3xTF32 (fused_block_tf32_kernel,
// fused_block_tf32.cuh), bf16 in bf16 mma.sync (fused_block_tc_kernel,
// fused_block_tc.cuh).  This file holds their contract, the C entries, and
// the SIMT kernel that both dtypes ran before, kept for the A/B.
//
// Replaces buctd_tpu/ops/pallas_block.py::fused_basic_block (:106; kernel
// body _make_kernel :67, taps _conv9 :44).  What it reproduces of that kernel:
//   (a) taps are read in the operand dtype and products summed in f32;
//   (b) the intermediate is rounded to the operand dtype before the second
//       conv (:84): here it is STORED in shared memory in that dtype;
//   (c) the residual is added in f32, ((acc + b2) + x), and the output cast
//       to x's dtype;
//   (d) the second conv reads zeros outside the image: an intermediate
//       recomputed at a halo position outside the image is 0, not relu(b1)
//       (the TPU kernel's valid_w mask and jnp.pad of y);
//   (e) relu keeps a NaN (k5tc::relu), so a NaN in x or the weights reaches
//       the output as it does through jnp.maximum and the plain version.
// The TPU's _group batching and W8 width padding are layout devices of the
// TPU and are not carried over.
//
// Design of the SIMT kernel (the tensor-core kernels keep its tiling and
// its streaming of weights; their headers say what differs).  The point of
// the kernel is that the intermediate never goes to device memory.  A block
// owns a TH x TW output tile of one image and all C output channels.  Phase
// 1 recomputes conv1 on the tile plus a 1-pixel halo ((TH+2) x (TW+2)
// pixels, all C channels) into shared memory; phase 2 runs
// conv2 from there and adds the residual.  Neither the halo intermediate of a
// large tile nor the (9C, C) weights fit in shared memory at C = 384, so the
// tile is picked per C (see buctd_fused_block) and the weights, and phase 1's
// input tile, are streamed by input-channel chunks of KC, for output-channel
// chunks of CO = 4 * NCG.  A thread keeps a micro-tile of MP pixels x 4
// output channels in registers; per 4 input channels it reads 4 float4 of
// weights and one 4-channel vector per pixel from shared memory, and does
// 16 FMAs per pixel.  Phase 1 pays the halo recompute, (TH+2)(TW+2)/(TH TW)
// of conv1's work (1.36x-1.63x at the W48 branch tiles).
// What bounds it on this card: operations.  Two 3x3 convs are 36 C^2 flops a
// pixel against 2-4 C bytes moved (x in, out), hundreds of operations a byte;
// this SIMT kernel reaches at most the f32 CUDA-core rate (67 TFLOP/s).  No
// path runs it: both dtypes run on the tensor cores, and its f32 and bf16
// instantiations stay only for the A/B (buctd_fused_block_simt).
//
// C interface (bound with ctypes by buctd_tpu_torch/ops/fused_block.py):
//   int buctd_fused_block(x, w1, w2, b1, b2, out, B, H, W, C, dtype, stream)
//   int buctd_fused_block_simt(x, w1, w2, b1, b2, out, B, H, W, C, dtype, stream)
// x, out (B, H, W, C) NHWC; w1, w2 (3, 3, C, C) HWIO; b1, b2 (C,); all of
// one dtype (0 = f32, 1 = bf16), contiguous, on the device, allocated by the
// caller.  buctd_fused_block launches the tensor-core kernel of the dtype (C
// up to 384); buctd_fused_block_simt this SIMT kernel.  They launch on
// `stream`, do not synchronise and return the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_block_tc.cuh"
#include "fused_block_tf32.cuh"

namespace {

constexpr int kNPG = 16;                 // pixel groups of a block
constexpr size_t kMaxSmem = 232448;      // 227 KB, a block's dynamic limit

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// four consecutive values as f32 (16-byte aligned f32, 8-byte aligned bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  // bf16 -> f32 is the 16 bits shifted up; element 0 is the low half
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  // round to nearest even, as jnp's astype(bfloat16)
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T, int TH, int TW, int NCG, int KC>
struct Cfg {
  static constexpr int kThreads = NCG * kNPG;
  static constexpr int CO = 4 * NCG;               // output channels a chunk
  static constexpr int W1 = TW + 2, H1 = TH + 2;   // intermediate tile, with halo
  static constexpr int WX = TW + 4, HX = TH + 4;   // input tile of phase 1
  static constexpr int P1 = H1 * W1, P2 = TH * TW, PX = HX * WX;
  static constexpr int MP1 = (P1 + kNPG - 1) / kNPG, MP2 = (P2 + kNPG - 1) / kNPG;
  // input-tile row: KC channels + 4 floats, 16-byte aligned; distinct pixels
  // of a warp's loads land in distinct banks
  static constexpr int KS = KC + 4;
  static constexpr int kWsFloats = 9 * KC * CO;
  // intermediate row: the channels phase 1 writes + 16 bytes of padding
  static __host__ __device__ int cs(int C) {
    return (C + CO - 1) / CO * CO + 16 / (int)sizeof(T);
  }
  static size_t smem(int C) {
    return sizeof(float) * ((size_t)kWsFloats + (size_t)PX * KS) +
           sizeof(T) * (size_t)P1 * cs(C);
  }
};

// ws[tap][k][co] = w[tap, ci0 + k, co0 + co] as f32, 0 outside C
template <int KC, int CO, typename T>
__device__ __forceinline__ void load_weights(float* __restrict__ ws, const T* __restrict__ w,
                                             int C, int ci0, int co0, int tid, int nthreads) {
  for (int i = tid; i < 9 * KC * CO; i += nthreads) {
    const int co = i % CO, k = (i / CO) % KC, tap = i / (CO * KC);
    const int ci = ci0 + k, c = co0 + co;
    ws[i] = (ci < C && c < C) ? to_f(w[((size_t)tap * C + ci) * C + c]) : 0.f;
  }
}

// acc[m][j] += sum over taps and the chunk's KC channels of
// src[(base[m] + tap offset) * stride + k] * ws[tap][k][cg * 4 + j]
template <int MP, int SRC_W, int KC, int CO, typename S>
__device__ __forceinline__ void conv_chunk(float (&acc)[MP][4], const S* __restrict__ src,
                                           int stride, const int (&base)[MP],
                                           const float* __restrict__ ws, int cg) {
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int off = (tap / 3) * SRC_W + tap % 3;
#pragma unroll
    for (int k = 0; k < KC; k += 4) {
      const float* wp = ws + (tap * KC + k) * CO + cg * 4;
      const float4 wa = load4(wp), wb = load4(wp + CO), wc = load4(wp + 2 * CO),
                   wd = load4(wp + 3 * CO);
#pragma unroll
      for (int m = 0; m < MP; ++m) {
        const float4 v = load4(src + (base[m] + off) * stride + k);
        acc[m][0] = fmaf(v.w, wd.x, fmaf(v.z, wc.x, fmaf(v.y, wb.x, fmaf(v.x, wa.x, acc[m][0]))));
        acc[m][1] = fmaf(v.w, wd.y, fmaf(v.z, wc.y, fmaf(v.y, wb.y, fmaf(v.x, wa.y, acc[m][1]))));
        acc[m][2] = fmaf(v.w, wd.z, fmaf(v.z, wc.z, fmaf(v.y, wb.z, fmaf(v.x, wa.z, acc[m][2]))));
        acc[m][3] = fmaf(v.w, wd.w, fmaf(v.z, wc.w, fmaf(v.y, wb.w, fmaf(v.x, wa.w, acc[m][3]))));
      }
    }
  }
}

template <typename T, int TH, int TW, int NCG, int KC>
__global__ void __launch_bounds__(NCG * kNPG, 2)
fused_block_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                   const T* __restrict__ w2, const T* __restrict__ b1,
                   const T* __restrict__ b2, T* __restrict__ out, int H, int W, int C,
                   int tiles_w) {
  using K = Cfg<T, TH, TW, NCG, KC>;
  constexpr int CO = K::CO;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);
  float* xs = ws + K::kWsFloats;
  T* ys = reinterpret_cast<T*>(xs + K::PX * K::KS);
  const int CS = K::cs(C);

  const int tid = threadIdx.x;
  const int cg = tid % NCG, pg = tid / NCG;
  const int ty0 = (blockIdx.x / tiles_w) * TH, tx0 = (blockIdx.x % tiles_w) * TW;
  const T* xb = x + (size_t)blockIdx.y * H * W * C;
  T* ob = out + (size_t)blockIdx.y * H * W * C;

  // ---- phase 1: y = relu(conv1(x) + b1) on the halo tile, into ys (dtype T)
  int base1[K::MP1];
#pragma unroll
  for (int m = 0; m < K::MP1; ++m) {
    int p = pg + m * kNPG;
    if (p >= K::P1) p = 0;                    // idle slot: computed, never stored
    base1[m] = (p / K::W1) * K::WX + p % K::W1;
  }
  for (int co0 = 0; co0 < C; co0 += CO) {
    float acc[K::MP1][4];
#pragma unroll
    for (int m = 0; m < K::MP1; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
    for (int ci0 = 0; ci0 < C; ci0 += KC) {
      __syncthreads();                        // the last chunk's readers are done
      for (int i = tid; i < K::PX * KC; i += K::kThreads) {
        const int k = i % KC, px = i / KC;
        const int gy = ty0 - 2 + px / K::WX, gx = tx0 - 2 + px % K::WX, ci = ci0 + k;
        float v = 0.f;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W && ci < C)
          v = to_f(xb[((size_t)gy * W + gx) * C + ci]);
        xs[px * K::KS + k] = v;
      }
      load_weights<KC, CO>(ws, w1, C, ci0, co0, tid, K::kThreads);
      __syncthreads();
      conv_chunk<K::MP1, K::WX, KC, CO>(acc, xs, K::KS, base1, ws, cg);
    }
    float bias[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = co0 + cg * 4 + j;
      bias[j] = c < C ? to_f(b1[c]) : 0.f;
    }
#pragma unroll
    for (int m = 0; m < K::MP1; ++m) {
      const int p = pg + m * kNPG;
      if (p >= K::P1) continue;
      const int gy = ty0 - 1 + p / K::W1, gx = tx0 - 1 + p % K::W1;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = inside ? k5tc::relu(acc[m][j] + bias[j]) : 0.f;
      store4(ys + p * CS + co0 + cg * 4, v);
    }
  }

  // ---- phase 2: out = relu((conv2(y) + b2) + x) on the tile
  int base2[K::MP2];
#pragma unroll
  for (int m = 0; m < K::MP2; ++m) {
    int p = pg + m * kNPG;
    if (p >= K::P2) p = 0;
    base2[m] = (p / TW) * K::W1 + p % TW;
  }
  for (int co0 = 0; co0 < C; co0 += CO) {
    float acc[K::MP2][4];
#pragma unroll
    for (int m = 0; m < K::MP2; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
    for (int ci0 = 0; ci0 < C; ci0 += KC) {
      __syncthreads();                        // also orders phase 1's ys stores
      load_weights<KC, CO>(ws, w2, C, ci0, co0, tid, K::kThreads);
      __syncthreads();
      conv_chunk<K::MP2, K::W1, KC, CO>(acc, ys + ci0, CS, base2, ws, cg);
    }
#pragma unroll
    for (int m = 0; m < K::MP2; ++m) {
      const int p = pg + m * kNPG;
      if (p >= K::P2) continue;
      const int gy = ty0 + p / TW, gx = tx0 + p % TW;
      if (gy >= H || gx >= W) continue;
      const size_t pix = ((size_t)gy * W + gx) * C;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = co0 + cg * 4 + j;
        if (c < C) {
          const float z = (acc[m][j] + to_f(b2[c])) + to_f(xb[pix + c]);
          store1(ob + pix + c, k5tc::relu(z));
        }
      }
    }
  }
}

template <typename T, int TH, int TW, int NCG, int KC>
int launch(const void* x, const void* w1, const void* w2, const void* b1, const void* b2,
           void* out, int B, int H, int W, int C, void* stream) {
  using K = Cfg<T, TH, TW, NCG, KC>;
  const size_t smem = K::smem(C);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = fused_block_kernel<T, TH, TW, NCG, KC>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const dim3 grid(tiles_w * tiles_h, B);
  kern<<<grid, K::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<const T*>(b1), static_cast<const T*>(b2), static_cast<T*>(out), H, W, C,
      tiles_w);
  return (int)cudaGetLastError();
}

// The tile of each W48 branch width: C <= 48 (96x72 maps) 12x12, C <= 96
// (48x36) 8x12, C <= 192 (24x18) 8x6, else (12x9 at 384) 6x9 with 8-channel
// chunks, so that the bf16 block fits twice in an SM's shared memory.
template <typename T>
int run(const void* x, const void* w1, const void* w2, const void* b1, const void* b2,
        void* out, int B, int H, int W, int C, void* stream) {
  if (C <= 48) return launch<T, 12, 12, 12, 16>(x, w1, w2, b1, b2, out, B, H, W, C, stream);
  if (C <= 96) return launch<T, 8, 12, 12, 16>(x, w1, w2, b1, b2, out, B, H, W, C, stream);
  if (C <= 192) return launch<T, 8, 6, 16, 16>(x, w1, w2, b1, b2, out, B, H, W, C, stream);
  return launch<T, 6, 9, 16, 8>(x, w1, w2, b1, b2, out, B, H, W, C, stream);
}

}  // namespace

extern "C" int buctd_fused_block(const void* x, const void* w1, const void* w2,
                                 const void* b1, const void* b2, void* out, int B, int H,
                                 int W, int C, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return k5tf32::run(x, w1, w2, b1, b2, out, B, H, W, C, stream);
  if (dtype == 1) return k5tc::run(x, w1, w2, b1, b2, out, B, H, W, C, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int buctd_fused_block_simt(const void* x, const void* w1, const void* w2,
                                      const void* b1, const void* b2, void* out, int B,
                                      int H, int W, int C, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return run<float>(x, w1, w2, b1, b2, out, B, H, W, C, stream);
  if (dtype == 1) return run<__nv_bfloat16>(x, w1, w2, b1, b2, out, B, H, W, C, stream);
  return (int)cudaErrorInvalidValue;
}
