// Counter-based dropout bits for the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu).
//
// The TPU kernels draw their masks from the TPU PRNG, seeded per
// (seed, bh, q-block, kv-block) tile (buctd_tpu/ops/flash_attention.py::
// _tile_seed), so a mask there depends on the tile shape.  Here every
// attention weight (bh, q_row, k_col) gets its own 32 random bits from a hash
// of (seed, bh, q_row, k_col): the mask does not depend on tiling, so the
// forward, both backward kernels and the plain PyTorch version
// (ops/flash_attention.py::dropout_bits) draw the same mask bit for bit.
//
//   row_key = fmix32(fmix32(seed + bh * 0x9E3779B9) ^ (q_row * 0x85EBCA77))
//   bits    = fmix32(row_key ^ (k_col * 0xC2B2AE3D))
//
// fmix32 is MurmurHash3's 32-bit finalizer (a bijection with full avalanche).
// An entry is kept when bits >= keep_thr (keep_thr = p * 2^32, the JAX rule)
// and then scaled by 1 / (1 - p).  All arithmetic is modulo 2^32.

#pragma once

#include <cstdint>

// The launch arguments of a mask: keep_thr == 0 means no dropout.
struct Dropout {
  uint32_t keep_thr;
  float keep_scale;
  uint32_t seed;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t dropout_row_key(uint32_t seed, uint32_t bh,
                                                    uint32_t q_row) {
  return fmix32(fmix32(seed + bh * 0x9E3779B9u) ^ (q_row * 0x85EBCA77u));
}

__device__ __forceinline__ uint32_t dropout_bits(uint32_t row_key, uint32_t k_col) {
  return fmix32(row_key ^ (k_col * 0xC2B2AE3Du));
}
