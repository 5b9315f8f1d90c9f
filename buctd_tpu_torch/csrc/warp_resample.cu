// Rotated affine warp for Hopper (sm_90a): the training and evaluation
// loaders' crop (cv2 INTER_LINEAR semantics with a zero border, two-pass form).
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
// are non-zero.  The H100 gathers cheaply from L1/L2, so each value here is
// the 2-tap gather the tent describes: relu(1 - |u - w|) is non-zero only at
// w = floor(u) and floor(u) + 1, and a tap outside [0, n) reads 0 (the zero
// border).  The weights are computed as the tent formula writes them (one
// `tent` function for every kernel), so the result is the dense sum's up to
// the order of two additions.
//
// What bounds it: memory, a few operations a byte.  The main path's kernel,
// warp_fused_kernel, is one launch per batch: one block per (sample, tile of
// kTileY output rows x kTileX output columns).  Output (y, x) reads the
// intermediate at rows floor(v), floor(v) + 1 of column x, v = d y + c x + f,
// so over the tile's rows column x needs a band of about kTileY |d| + 2
// intermediate rows.  The block computes pass 1 only at those (row, column)
// pairs, into shared memory ([kTileX][band][C]), then pass 2 out of shared
// memory, writing each output row of the tile as one contiguous run.  The
// (B, max(H, W), ow, C) intermediate of the two-pass form never reaches device
// memory, and the source is read only where the crops' footprints lie.  Source
// reads are coalesced in both decompositions: untransposed, a warp's lanes run
// along output columns at one band row (neighbouring pixels of one source
// row); transposed, along band rows at one column (neighbouring pixels of one
// image row, as floor(u) changes slowly along them).  A band longer than the
// shared memory holds (|d| large: crops of big images) is walked in chunks of
// output rows.  A tap outside its column's band (possible only for a NaN or
// infinite affine) is computed from the source in place, so the result never
// depends on the plan.  Warp 0 computes the sample's scalars and the bands
// once a chunk; pass 2 gives each lane one output pixel (the tent once for
// all channels) and stages the warp's row in shared memory, so the row goes
// out in contiguous stores.  The source is read through L1 where pass 1 needs
// it, not staged with cp.async or TMA: with no source reads at all the kernel
// ran 16% faster on an H100 (tools/bench_warp.py, ko_source), which bounds
// what staging could gain; 32-row tiles ran 15% faster than 16-row ones.
// The source is the loaders' uint8 bucket with each sample's mask rectangle
// [x, y, w, h]: a pixel loads as inside ? float(px) : 0, inside computed in
// f32 image coordinates as data/device_pipeline.py computed its mask, so it
// gives bit for bit the f32 warp of images.float() * inside.  An f32 source
// (the A/B against the two-pass form) takes no mask.  Each is built at C = 3
// and once with C given at run time.
//
// warp_pass1_kernel / warp_pass2_kernel, the port's first, two-pass form (one
// thread an output pixel, the intermediate in device memory), are kept only for the A/B
// against the fused kernel; both forms share Affine, the pass scalars and
// `tent`, so they agree bit for bit.
//
// C interface (bound with ctypes by buctd_tpu_torch/ops/warp.py):
//   int buctd_warp_fused(src, src_is_u8, trans, mask, out, B, H, W, C, oh, ow,
//                        stream)
//   int buctd_warp_pass1(src, trans, tmp, B, H, W, C, ow, rows, stream)
//   int buctd_warp_pass2(tmp, trans, out, B, H, W, C, oh, ow, rows, stream)
// src (B, H, W, C) f32, or uint8 where src_is_u8; trans (B, 2, 3) f32
// output->source affines; mask (B, 4) f32 [x, y, w, h] with a uint8 src, null
// with an f32 one (another pairing is refused); tmp
// (B, rows, ow, C) f32 with rows = max(H, W); out (B, oh, ow, C) f32; all
// contiguous and allocated by the caller.  Each returns the cudaError_t of its
// launch; it launches on `stream` and does not synchronise.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;        // the two-pass kernels
constexpr int kFusedThreads = 256;   // the fused kernel
constexpr int kTileX = 32;           // output columns of a fused tile: one warp's lanes
constexpr int kTileY = 32;           // output rows of a fused tile
constexpr int kColFloats = 192;      // shared floats a tile column may take (24 KB a block)

// Rows of intermediate a tile column holds in shared memory, and the column's
// stride in floats: a multiple of 32 plus C, so that the lanes of a warp that
// run along columns (pass 2, and pass 1 untransposed) meet distinct banks.
// ops/warp.py::fused_tile_plan mirrors both.
__host__ __device__ constexpr int band_max(int C) { return (kColFloats - 32 - C) / C; }
__host__ __device__ constexpr int col_stride(int C) {
  return (band_max(C) * C + 31) / 32 * 32 + C;
}

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

// pass 1's scalars: alpha = a - b c / d, beta_c = b / d, beta_o = e - (b / d) f
struct Pass1 {
  float alpha, beta_c, beta_o;
};

__device__ __forceinline__ Pass1 pass1_scalars(const Affine& m) {
  Pass1 p;
  p.beta_c = __fdiv_rn(m.b, m.d);
  p.alpha = __fsub_rn(m.a, __fdiv_rn(__fmul_rn(m.b, m.c), m.d));
  p.beta_o = __fsub_rn(m.e, __fmul_rn(p.beta_c, m.f));
  return p;
}

// pass 1's coordinate along source row r at output column o
__device__ __forceinline__ float pass1_u(const Pass1& p, int o, int r) {
  return __fadd_rn(__fadd_rn(__fmul_rn(p.alpha, (float)o), __fmul_rn(p.beta_c, (float)r)),
                   p.beta_o);
}

// pass 2's coordinate along intermediate column x at output row y
__device__ __forceinline__ float pass2_v(const Affine& m, int y, int x) {
  return __fadd_rn(__fadd_rn(__fmul_rn(m.d, (float)y), __fmul_rn(m.c, (float)x)), m.f);
}

// The two taps of relu(1 - |u - w|) over w in [0, n): w0 = floor(u) and
// w0 + 1, their weights, and whether each lies inside
struct Tent {
  int w0;
  float t0, t1;
  bool in0, in1;
};

__device__ __forceinline__ Tent tent(float u, int n) {
  Tent t;
  const float w0f = floorf(u);
  t.w0 = (int)w0f;
  t.t0 = fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(u, w0f))), 0.f);
  t.t1 = fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(u, __fadd_rn(w0f, 1.f)))), 0.f);
  t.in0 = t.w0 >= 0 && t.w0 < n;
  t.in1 = t.w0 + 1 >= 0 && t.w0 + 1 < n;
  return t;
}

// v0 t0 + v1 t1 with each product rounded: the two non-zero terms of the sum
__device__ __forceinline__ float tent_sum(const Tent& t, float v0, float v1) {
  return __fadd_rn(__fmul_rn(v0, t.t0), __fmul_rn(v1, t.t1));
}

// the tent sum for the C channels of elements base[w * stride + ch]
__device__ __forceinline__ void tent2(const float* __restrict__ base, size_t stride,
                                      int n, int C, float u, float* __restrict__ dst) {
  const Tent t = tent(u, n);
  for (int ch = 0; ch < C; ++ch) {
    const float v0 = t.in0 ? base[(size_t)t.w0 * stride + ch] : 0.f;
    const float v1 = t.in1 ? base[(size_t)(t.w0 + 1) * stride + ch] : 0.f;
    dst[ch] = tent_sum(t, v0, v1);
  }
}

// ------------------------------------------------------------ fused kernel --

constexpr int kWarps = kFusedThreads / 32;

// One sample's source as the rows of the two-pass form: element w of source
// row r is img[r, w] or, transposed, img[w, r]; a uint8 source is masked: a
// pixel outside its mask rectangle reads 0.  kC: the channels, 0 for C given
// at run time.
template <typename T, int kC>
struct Source {
  static constexpr bool kMasked = std::is_same<T, uint8_t>::value;
  const T* __restrict__ img;   // (H, W, C)
  int W, C, n;                 // n: the length of a source row
  bool transposed;
  float x0 = 0.f, x1 = 0.f, y0 = 0.f, y1 = 0.f;   // mask: [x0, x1) x [y0, y1), image coordinates

  __device__ __forceinline__ int channels() const { return kC ? kC : C; }

  // the pixel of tap w of source row r: its channels, or null outside the mask
  __device__ __forceinline__ const T* pixel(int r, int w) const {
    const int row = transposed ? w : r, col = transposed ? r : w;
    if (kMasked) {
      const float xf = (float)col, yf = (float)row;
      if (!(xf >= x0 && xf < x1 && yf >= y0 && yf < y1)) return nullptr;
    }
    return img + ((size_t)row * W + col) * channels();
  }

  // pass 1 at (source row r, output column o) for every channel, into dst[ch]
  // (ao = alpha o, rounded)
  __device__ __forceinline__ void pass1(const Pass1& p, int r, float ao, float* dst) const {
    const Tent t = tent(__fadd_rn(__fadd_rn(ao, __fmul_rn(p.beta_c, (float)r)), p.beta_o), n);
    const T* q0 = t.in0 ? pixel(r, t.w0) : nullptr;
    const T* q1 = t.in1 ? pixel(r, t.w0 + 1) : nullptr;
#pragma unroll
    for (int ch = 0; ch < channels(); ++ch)
      dst[ch] = tent_sum(t, q0 ? (float)q0[ch] : 0.f, q1 ? (float)q1[ch] : 0.f);
  }

  // pass 1 at (r, o), channel ch: a tap outside its column's band
  __device__ __forceinline__ float pass1_at(const Pass1& p, int r, int o, int ch) const {
    const Tent t = tent(pass1_u(p, o, r), n);
    const T* q0 = t.in0 ? pixel(r, t.w0) : nullptr;
    const T* q1 = t.in1 ? pixel(r, t.w0 + 1) : nullptr;
    return tent_sum(t, q0 ? (float)q0[ch] : 0.f, q1 ? (float)q1[ch] : 0.f);
  }
};

// Output rows a chunk of the tile takes so that its band fits bmax rows: the
// band of k rows spans about |d| (k - 1) + 2 rows, 2 more for the floors and
// the rounding of v.  A NaN or infinite d gives one row a chunk.
__device__ __forceinline__ int chunk_rows(float d, int bmax) {
  const float q = __fdiv_rn((float)(bmax - 4), fabsf(d));
  if (q >= (float)(kTileY - 1)) return kTileY;
  return q >= 1.f ? 1 + (int)q : 1;
}

// the sample's scalars, computed once a block by warp 0
struct Scalars {
  Affine m;
  Pass1 p;
  int step;
};

// warp 0, lane = tile column: the band of intermediate rows that output rows
// [ya, yb) read at the lane's column, from their first taps at ya and
// yb - 1 (floor(v) is monotone in y), clipped to [0, R) and to bmax rows;
// span: the first and one past the last row of the tile's bands
__device__ __forceinline__ void plan_bands(const Affine& m, int R, int bmax, int x0,
                                           int cols, int ya, int yb, int* band_lo,
                                           int* band_n, int* band_rows, int* span) {
  const int lane = threadIdx.x;
  int lo = 0, n = 0;
  if (lane < cols) {
    const int wa = tent(pass2_v(m, ya, x0 + lane), R).w0;
    const int wb = tent(pass2_v(m, yb - 1, x0 + lane), R).w0;
    const int first = max(0, min(wa, wb));
    const long long last = (long long)max(wa, wb) + 1 < R ? (long long)max(wa, wb) + 1
                                                          : (long long)R - 1;
    if (last >= first) {
      lo = first;
      n = (int)(last - first + 1 < bmax ? last - first + 1 : bmax);
    }
  }
  band_lo[lane] = lo;
  band_n[lane] = n;
  const int most = __reduce_max_sync(0xffffffffu, n);
  const int first = __reduce_min_sync(0xffffffffu, n > 0 ? lo : INT_MAX);
  const int end = __reduce_max_sync(0xffffffffu, n > 0 ? lo + n : 0);
  if (lane == 0) {
    *band_rows = most;
    span[0] = most > 0 ? first : 0;
    span[1] = end;
  }
}

template <typename T, int kC>
__global__ void __launch_bounds__(kFusedThreads)
warp_fused_kernel(const T* __restrict__ src, const float* __restrict__ trans,
                  const float* __restrict__ mask, float* __restrict__ out, int H, int W,
                  int C_rt, int oh, int ow) {
  // [kTileX][col_stride(C)] band values, then kWarps staging rows of kTileX * C
  extern __shared__ float smem[];
  __shared__ int band_lo[kTileX], band_n[kTileX], band_rows, span[2];
  __shared__ Scalars sc;
  const int C = kC ? kC : C_rt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY;
  const int cols = min(kTileX, ow - x0), yend = min(y0 + kTileY, oh);
  const int bmax = band_max(C), stride = col_stride(C);
  float* band = smem;
  float* stage = smem + kTileX * stride + warp * kTileX * C;
  int ya = y0;
  if (warp == 0) {
    const Affine m = sample_affine(trans + 6 * b);
    const int step = chunk_rows(m.d, bmax);
    if (lane == 0) sc = {m, pass1_scalars(m), step};
    plan_bands(m, m.transposed ? W : H, bmax, x0, cols, ya, min(ya + step, yend), band_lo,
               band_n, &band_rows, span);
  }
  __syncthreads();
  const Affine m = sc.m;
  const Pass1 p = sc.p;
  const int step = sc.step;
  const int R = m.transposed ? W : H;   // rows of the (possibly transposed) source
  Source<T, kC> s;
  s.img = src + (size_t)b * H * W * C;
  s.W = W; s.C = C; s.n = m.transposed ? H : W;
  s.transposed = m.transposed;
  if (s.kMasked) {
    const float* box = mask + 4 * b;
    s.x0 = box[0]; s.x1 = __fadd_rn(box[0], box[2]);
    s.y0 = box[1]; s.y1 = __fadd_rn(box[1], box[3]);
  }
  const int x = x0 + lane;
  const float cx = __fmul_rn(m.c, (float)x);
  while (true) {
    const int yb = min(ya + step, yend);
    // pass 1 into shared memory, every channel of a (column, band row) pair a
    // thread
    const int rows = band_rows;
    if (!m.transposed) {           // lanes along columns at one source row
      const int lo = band_lo[lane], n = band_n[lane];
      const float ao = __fmul_rn(p.alpha, (float)x);
      for (int r = span[0] + warp; r < span[1]; r += kWarps)
        if ((unsigned)(r - lo) < (unsigned)n)
          s.pass1(p, r, ao, band + lane * stride + (r - lo) * C);
    } else if (rows > 0) {         // lanes along band rows: one image row
      int col = threadIdx.x / rows, j = threadIdx.x - col * rows;
      const int dcol = kFusedThreads / rows, dj = kFusedThreads - dcol * rows;
      for (; col < kTileX; col += dcol, j += dj) {
        if (j >= rows) { j -= rows; ++col; if (col >= kTileX) break; }
        if (j < band_n[col])
          s.pass1(p, band_lo[col] + j, __fmul_rn(p.alpha, (float)(x0 + col)),
                  band + col * stride + j * C);
      }
    }
    __syncthreads();
    // pass 2 out of shared memory: lane = column, one output row a warp at a
    // time, staged so the warp writes the row's cols * C floats contiguously
    const int lo = band_lo[lane], n = band_n[lane];
    const float* column = band + lane * stride;
    for (int y = ya + warp; y < yb; y += kWarps) {
      if (lane < cols) {
        const Tent t = tent(__fadd_rn(__fadd_rn(__fmul_rn(m.d, (float)y), cx), m.f), R);
        const unsigned k0 = (unsigned)t.w0 - (unsigned)lo, k1 = k0 + 1u;
        const bool h0 = k0 < (unsigned)n, h1 = k1 < (unsigned)n;
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
          const float v0 = !t.in0 ? 0.f : h0 ? column[k0 * C + ch] : s.pass1_at(p, t.w0, x, ch);
          const float v1 =
              !t.in1 ? 0.f : h1 ? column[k1 * C + ch] : s.pass1_at(p, t.w0 + 1, x, ch);
          stage[lane * C + ch] = tent_sum(t, v0, v1);
        }
      }
      __syncwarp();
      float* dst = out + (((size_t)b * oh + y) * ow + x0) * C;
      for (int e = lane; e < cols * C; e += 32) dst[e] = stage[e];
      __syncwarp();
    }
    ya = yb;
    if (ya >= yend) break;
    __syncthreads();               // every warp is done with this chunk's band
    if (warp == 0)
      plan_bands(m, R, bmax, x0, cols, ya, min(ya + step, yend), band_lo, band_n, &band_rows,
                 span);
    __syncthreads();
  }
}

// shared memory of a fused block: the band and the staging rows
constexpr size_t fused_smem_bytes(int C) {
  return sizeof(float) * ((size_t)kTileX * col_stride(C) + (size_t)kWarps * kTileX * C);
}

template <typename T, int kC>
cudaError_t launch_fused(const void* src, const float* trans, const float* mask, float* out,
                         int B, int H, int W, int C, int oh, int ow, cudaStream_t stream) {
  const dim3 grid((ow + kTileX - 1) / kTileX, (oh + kTileY - 1) / kTileY, B);
  warp_fused_kernel<T, kC><<<grid, kFusedThreads, fused_smem_bytes(C), stream>>>(
      static_cast<const T*>(src), trans, mask, out, H, W, C, oh, ow);
  return cudaGetLastError();
}

// the loaders' C = 3, and any other C given at run time
template <typename T>
cudaError_t launch_fused_c(const void* src, const float* trans, const float* mask, float* out,
                           int B, int H, int W, int C, int oh, int ow, cudaStream_t stream) {
  if (C == 3) return launch_fused<T, 3>(src, trans, mask, out, B, H, W, C, oh, ow, stream);
  return launch_fused<T, 0>(src, trans, mask, out, B, H, W, C, oh, ow, stream);
}

// ------------------------------------------------------- two-pass kernels --

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
  const float u = pass1_u(pass1_scalars(m), o, r);
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
  const float* base = tmp + ((size_t)b * rows * ow + x) * C;
  tent2(base, (size_t)ow * C, R, C, pass2_v(m, y, x),
        out + (((size_t)b * oh + y) * ow + x) * C);
}

}  // namespace

extern "C" int buctd_warp_fused(const void* src, int src_is_u8, const float* trans,
                                const float* mask, float* out, int B, int H, int W, int C,
                                int oh, int ow, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0 || band_max(C) < 8 || oh <= 0 ||
      ow <= 0 || (oh + kTileY - 1) / kTileY > 65535)
    return (int)cudaErrorInvalidValue;
  if (fused_smem_bytes(C) > 48 * 1024 || (mask != nullptr) != (src_is_u8 != 0))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return (int)(src_is_u8 ? launch_fused_c<uint8_t>(src, trans, mask, out, B, H, W, C, oh, ow, s)
                         : launch_fused_c<float>(src, trans, mask, out, B, H, W, C, oh, ow, s));
}

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
