// Transcendental throughput micro-benchmark for Hopper (sm_90a): every element
// of an f32 tensor runs `inner` chained steps y = op(y * 0.03f), with
//   variant 0: expf(y)                 (the full-precision routine)
//   variant 1: exp2f(y)                (what the flash kernels use,
//                                       csrc/flash_fwd.cu's online softmax)
//   variant 2: exp2f(y * log2(e))      (exp written as pow2: the log2-domain
//                                       softmax)
//
// Replaces tools/bench_exp2.py::_kernel (:34, via make :47): the TPU kernel
// asked whether pow2 is cheaper than exp on the v5e's VPU.  The H100's
// question is the same one on its special-function units (SFU): MUFU.EX2
// is the one instruction under every variant; expf adds its range
// reduction in FMAs.
//
// Built WITHOUT --use_fast_math (buctd_tpu_torch/_build.py passes no such
// flag), so expf stays the full-precision library routine and is not
// replaced by __expf; the multiplies are not reassociated.
// What bounds it: operations on the SFUs, 16 MUFU.EX2 a clock on each SM.
// One thread carries one element through its chain; 512 x 1024 elements keep
// every SM's warp slots full, so the dependent chain's latency is hidden.
//
// C interface (bound with ctypes by buctd_tpu_torch/ops/exp_throughput.py):
//   int buctd_exp_chain(x, out, n, inner, variant, stream)
// x, out f32 (n,) contiguous on the device, out not x; launches on
// `stream`, does not synchronise, returns the cudaError_t of its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int V>
__device__ __forceinline__ float op(float y) {
  if (V == 0) return expf(y);
  if (V == 1) return exp2f(y);
  return exp2f(y * 1.4426950408889634f);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
exp_chain_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int inner) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float y = x[i];
  for (int s = 0; s < inner; ++s) y = op<V>(y * 0.03f);
  out[i] = y;
}

}  // namespace

extern "C" int buctd_exp_chain(const float* x, float* out, int n, int inner, int variant,
                               void* stream) {
  if (n <= 0 || inner < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: exp_chain_kernel<0><<<blocks, kThreads, 0, s>>>(x, out, n, inner); break;
    case 1: exp_chain_kernel<1><<<blocks, kThreads, 0, s>>>(x, out, n, inner); break;
    case 2: exp_chain_kernel<2><<<blocks, kThreads, 0, s>>>(x, out, n, inner); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
