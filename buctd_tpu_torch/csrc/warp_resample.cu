// Two-pass rotated affine warp for Hopper (sm_90a): the training loader's
// crop (cv2 INTER_LINEAR semantics with a zero border, two-pass form).
//
// Replaces buctd_tpu/ops/pallas_warp.py::_resample_kernel (:30), reached via
// _resample_rows (:55), _two_pass_pallas (:86) and warp_affine_pallas (:108).
// Both passes are the per-row 1-D tent resample
//   out[r, o] = sum_w img[r, w] * relu(1 - |alpha * o + beta_c * r + beta_o - w|)
// pass 1 over source rows (alpha = a - b c / d, beta_c = b / d,
// beta_o = e - (b / d) f), pass 2 over output columns of the intermediate
// (alpha = d, beta_c = c, beta_o = f), for the output->source affine
// [[a, b, e], [c, d, f]].  Per sample, when |t11| < |t01| the source is read
// transposed and the affine's rows swapped (:120), with t11 guarded to 1e-6
// (:122).
//
// What the TPU kernel did and what this does instead: the TPU has a matrix
// unit and slow gathers, so it built the dense (W, 128) tent-weight tile in
// VMEM and contracted it on the MXU, ~W multiply-adds per output of which 2
// are non-zero.  The H100 gathers cheaply from L1/L2, so each output here is
// the 2-tap gather the tent describes: relu(1 - |u - w|) is non-zero only at
// w = floor(u) and floor(u) + 1, and a tap outside [0, W) reads 0 (the
// zero border).  The weights are computed as the tent formula writes them, so
// the result is the dense sum's up to the order of two additions.  One thread
// makes one output pixel (all channels); a launch covers the whole batch, and
// every sample's scalars and its transposed-or-not choice are computed on the
// card from the (B, 2, 3) affine tensor, so the host never reads them.
// What bounds it: memory.  Each pass reads its source about once through the
// caches and writes its output once, a few operations per byte.
//
// C interface (bound with ctypes by buctd_tpu_torch/ops/warp.py):
//   int buctd_warp_pass1(src, trans, tmp, B, H, W, C, ow, rows, stream)
//   int buctd_warp_pass2(tmp, trans, out, B, H, W, C, oh, ow, rows, stream)
// src (B, H, W, C) f32; trans (B, 2, 3) f32 output->source affines;
// tmp (B, rows, ow, C) f32 with rows = max(H, W); out (B, oh, ow, C) f32; all
// contiguous and allocated by the caller.  Each returns the cudaError_t of its
// launch; it launches on `stream` and does not synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// The sample's affine after the transposed-decomposition choice.  Returns
// whether the source is read transposed.  Products and quotients use the _rn
// intrinsics so the compiler contracts nothing into an FMA: the scalars round
// as the JAX expressions do.
struct Affine {
  float a, b, e, c, d, f;
  bool transposed;
};

__device__ __forceinline__ Affine sample_affine(const float* __restrict__ t) {
  Affine m;
  m.transposed = fabsf(t[4]) < fabsf(t[1]);   // |t11| < |t01|
  const float* r0 = m.transposed ? t + 3 : t;
  const float* r1 = m.transposed ? t : t + 3;
  m.a = r0[0]; m.b = r0[1]; m.e = r0[2];
  m.c = r1[0]; m.d = r1[1]; m.f = r1[2];
  if (fabsf(m.d) < 1e-6f) m.d = 1e-6f;
  return m;
}

// sum over the two taps w0 = floor(u), w0 + 1 of v[w] * relu(1 - |u - w|)
// for the C channels; reads outside [0, n) are 0
__device__ __forceinline__ void tent2(const float* __restrict__ base, size_t stride,
                                      int n, int C, float u, float* __restrict__ dst) {
  const float w0f = floorf(u);
  const int w0 = (int)w0f;
  const float t0 = fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(u, w0f))), 0.f);
  const float t1 = fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(u, __fadd_rn(w0f, 1.f)))), 0.f);
  const bool in0 = w0 >= 0 && w0 < n, in1 = w0 + 1 >= 0 && w0 + 1 < n;
  for (int ch = 0; ch < C; ++ch) {
    const float v0 = in0 ? base[(size_t)w0 * stride + ch] : 0.f;
    const float v1 = in1 ? base[(size_t)(w0 + 1) * stride + ch] : 0.f;
    dst[ch] = __fadd_rn(__fmul_rn(v0, t0), __fmul_rn(v1, t1));
  }
}

// pass 1: tmp[b, r, o, :] for source rows r < R (R = H, or W when transposed)
__global__ void __launch_bounds__(kThreads)
warp_pass1_kernel(const float* __restrict__ src, const float* __restrict__ trans,
                  float* __restrict__ tmp, int H, int W, int C, int ow, int rows) {
  const int b = blockIdx.z, r = blockIdx.y;
  const int o = blockIdx.x * kThreads + threadIdx.x;
  const Affine m = sample_affine(trans + 6 * b);
  const int R = m.transposed ? W : H;     // rows of the (possibly transposed) source
  const int n = m.transposed ? H : W;     // their length
  if (r >= R || o >= ow) return;
  const float bd = __fdiv_rn(m.b, m.d);
  const float alpha = __fsub_rn(m.a, __fdiv_rn(__fmul_rn(m.b, m.c), m.d));
  const float beta_o = __fsub_rn(m.e, __fmul_rn(bd, m.f));
  const float u = __fadd_rn(__fadd_rn(__fmul_rn(alpha, (float)o), __fmul_rn(bd, (float)r)),
                            beta_o);
  const float* img = src + (size_t)b * H * W * C;
  // element w of source row r: img[r, w] or, transposed, img[w, r]
  const float* base = m.transposed ? img + (size_t)r * C : img + (size_t)r * W * C;
  const size_t stride = m.transposed ? (size_t)W * C : (size_t)C;
  tent2(base, stride, n, C, u, tmp + (((size_t)b * rows + r) * ow + o) * C);
}

// pass 2: out[b, y, x, :] resampled along the R rows of tmp at column x
__global__ void __launch_bounds__(kThreads)
warp_pass2_kernel(const float* __restrict__ tmp, const float* __restrict__ trans,
                  float* __restrict__ out, int H, int W, int C, int oh, int ow,
                  int rows) {
  const int b = blockIdx.z, y = blockIdx.y;
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= ow) return;
  const Affine m = sample_affine(trans + 6 * b);
  const int R = m.transposed ? W : H;
  const float u = __fadd_rn(__fadd_rn(__fmul_rn(m.d, (float)y), __fmul_rn(m.c, (float)x)),
                            m.f);
  const float* base = tmp + ((size_t)b * rows * ow + x) * C;
  tent2(base, (size_t)ow * C, R, C, u, out + (((size_t)b * oh + y) * ow + x) * C);
}

}  // namespace

extern "C" int buctd_warp_pass1(const float* src, const float* trans, float* tmp, int B,
                                int H, int W, int C, int ow, int rows, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0 || ow <= 0 || rows < H ||
      rows < W || rows > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((ow + kThreads - 1) / kThreads, rows, B);
  warp_pass1_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, trans, tmp, H, W, C, ow, rows);
  return (int)cudaGetLastError();
}

extern "C" int buctd_warp_pass2(const float* tmp, const float* trans, float* out, int B,
                                int H, int W, int C, int oh, int ow, int rows,
                                void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0 || oh <= 0 || oh > 65535 ||
      ow <= 0 || rows < H || rows < W)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((ow + kThreads - 1) / kThreads, oh, B);
  warp_pass2_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tmp, trans, out, H, W, C, oh, ow, rows);
  return (int)cudaGetLastError();
}
