// Threefry-2x32 (20 rounds) exactly as jax.random computes it, for
// in-kernel draws that equal the JAX package's u-planes bit for bit.
//
// With jax_threefry_partitionable (JAX's default), element n of
// jax.random.uniform(key, shape) is
//   bits = y0 ^ y1,  (y0, y1) = threefry2x32(key, (n >> 32, n & 0xffffffff))
//   u    = bitcast<float>((bits >> 9) | 0x3f800000) - 1.0f
// with n the element's flat row-major index. All arithmetic is on unsigned
// 32-bit words, so every right shift is logical.
#pragma once

#include <cstdint>

namespace rt {

__host__ __device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// One threefry2x32 block: (x0, x1) in, (x0, x1) out.
__host__ __device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                                      uint32_t& x0,
                                                      uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// jax.random.fold_in: threefry2x32(key, (0, data)) is the new key.
__host__ __device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1,
                                                 uint32_t data) {
  uint32_t x0 = 0u, x1 = data;
  threefry2x32(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

// The key of direct mode's draw slot j for the pass key (k0, k1): the
// stage route's draw_key(key, LENS) for the lens (j = 0) and draw_key(key,
// LIGHT, 0, j - 1) for light j - 1 (core/rng LENS = 0, LIGHT = 1).
__host__ __device__ __forceinline__ void direct_slot_key(uint32_t& k0,
                                                         uint32_t& k1,
                                                         int j) {
  fold_in(k0, k1, j == 0 ? 0u : 1u);
  fold_in(k0, k1, 0u);
  fold_in(k0, k1, j == 0 ? 0u : static_cast<uint32_t>(j - 1));
}

// Uniform in [0, 1) of flat element `counter` (< 2^32, so the high word
// is 0) of jax.random.uniform(key, ...).
__device__ __forceinline__ float threefry_uniform(uint32_t k0, uint32_t k1,
                                                  uint32_t counter) {
  uint32_t x0 = 0u, x1 = counter;
  threefry2x32(k0, k1, x0, x1);
  const uint32_t bits = x0 ^ x1;
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

}  // namespace rt
