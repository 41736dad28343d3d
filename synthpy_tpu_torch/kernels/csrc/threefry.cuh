// JAX's threefry-2x32 random streams on the device (jax.random with
// jax_threefry_partitionable on, the default): one copy for every kernel
// that draws, so that K10 (random.cu), K2's dither (pack.cu) and K9's
// (fill.cu) give the same bits.
//
//   * threefry2x32(key, x): 20 rounds in five groups of four, rotations
//     13, 15, 26, 6 / 17, 29, 16, 24 (each one funnel shift), key schedule
//     k0, k1, k0^k1^0x1BD11BDA (jax/_src/prng.py, _threefry2x32_lowering),
//     which a kernel hashing many values under one key makes once
//     (Schedule);
//   * bits of flat index i of a draw: x0 ^ x1 of threefry(key, (hi32(i),
//     lo32(i))) (iota_2x32_shape and _threefry_random_bits_partitionable);
//   * fold_in(key, d) = threefry(key, (0, d)), split(key)[i] likewise;
//   * a uniform float: the top 23 bits as a mantissa of [1, 2), minus 1,
//     times (hi - lo), plus lo, at least lo (jax/_src/random.py _uniform);
//   * a normal: sqrt(2) * erf_inv(uniform(nextafter(-1, 0), 1)), with XLA's
//     single-precision erf_inv (Giles' polynomial in w = -log1p(-x^2)).
// The sources that include this are built with --fmad=false and without
// fast math: log1pf and sqrtf are the accurate library functions.

#pragma once

#include <stdint.h>

namespace threefry {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// a key's schedule: its first two words and each of the five injections'
// two words (the third key word, and the injection count added), made once
// where many values are hashed under one key
struct Schedule {
  uint32_t k0, k1, inj0[5], inj1[5];

  __device__ __forceinline__ explicit Schedule(uint2 key) {
    const uint32_t ks[3] = {key.x, key.y, key.x ^ key.y ^ 0x1BD11BDAu};
    k0 = ks[0];
    k1 = ks[1];
#pragma unroll
    for (int g = 0; g < 5; ++g) {
      inj0[g] = ks[(g + 1) % 3];
      inj1[g] = ks[(g + 2) % 3] + (uint32_t)(g + 1);
    }
  }
};

__device__ __forceinline__ uint2 hash(const Schedule& S, uint32_t x0,
                                      uint32_t x1) {
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += S.k0;
  x1 += S.k1;
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, rot[g & 1][r]);
      x1 ^= x0;
    }
    x0 += S.inj0[g];
    x1 += S.inj1[g];
  }
  return make_uint2(x0, x1);
}

__device__ __forceinline__ uint2 hash(uint2 key, uint32_t x0, uint32_t x1) {
  return hash(Schedule(key), x0, x1);
}

__device__ __forceinline__ uint2 fold_in(uint2 key, uint32_t d) {
  return hash(key, 0u, d);
}

// the 32 random bits of flat index i of a draw
__device__ __forceinline__ uint32_t bits(uint2 key, unsigned long long i) {
  const uint2 y = hash(key, (uint32_t)(i >> 32), (uint32_t)i);
  return y.x ^ y.y;
}

// a uniform float in [lo, hi) of 32 random bits
__device__ __forceinline__ float uniform_of(uint32_t bits, float lo,
                                            float hi) {
  const float f = __uint_as_float((bits >> 9) | 0x3f800000u) - 1.0f;
  return fmaxf(lo, f * (hi - lo) + lo);
}

__device__ __forceinline__ float uniform(uint2 key, unsigned long long i,
                                         float lo, float hi) {
  return uniform_of(bits(key, i), lo, hi);
}

// XLA's ErfInv for float32 (xla/hlo/builder/lib/math.cc)
__device__ __forceinline__ float erf_inv(float x) {
  const float lt5[9] = {2.81022636e-08f,  3.43273939e-07f, -3.5233877e-06f,
                        -4.39150654e-06f, 0.00021858087f,  -0.00125372503f,
                        -0.00417768164f,  0.246640727f,    1.50140941f};
  const float ge5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                        -0.00367342844f,  0.00573950773f,  -0.0076224613f,
                        0.00943887047f,   1.00167406f,     2.83297682f};
  float w = -log1pf(-x * x);
  const bool lt = w < 5.0f;
  w = lt ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = (lt ? lt5[i] : ge5[i]) + p * w;
  return fabsf(x) == 1.0f ? x * 3.402823466e38f : p * x;
}

__device__ __forceinline__ float normal(uint2 key, unsigned long long i) {
  // nextafter(-1, 0) in float32, and sqrt(2) rounded to float32
  const float lo = -0.99999994f;
  return 1.41421356f * erf_inv(uniform(key, i, lo, 1.0f));
}

}  // namespace threefry
