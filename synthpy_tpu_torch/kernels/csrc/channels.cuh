// The pack channels and their quantiser, shared by the segment-pack builder
// (K2, pack.cu) and the plane-batch fill (K9, fill.cu), so that a pack
// built either way holds the same numbers.
//
//   * kappa_of: synthpy_tpu/constants.py kappa / coulomb_log, in the same
//     operation order;
//   * grad1: one value of jnp.gradient along a transverse axis;
//   * scale_of / code_of / nibble_pair: the per-(plane, channel) int8 or
//     int4 quantiser of zscan.py:493 / :1852 / :2076, IEEE division and
//     round half to even;
//   * dithered_code: the same code with JAX's non-subtractive dither, a
//     uniform u ~ U[-0.5, 0.5) of fold_in(key, g) at index idx added to
//     value / scale before rounding where the value is not zero
//     (zscan.py:498-503, :1859-1865, :2080-2084).
// Built with --fmad=false, so that no multiply-add is contracted.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace channels {

constexpr float OMEGA_PE_COEFF = 5.64e4f;
constexpr float V_THE_COEFF = 4.19e5f;
constexpr float L_QUANTUM_COEFF = 2.760428269727312e-10f;
constexpr float KAPPA_COEFF = 3.1e-5f;
constexpr float E_CHARGE = 1.602176634e-19f;
constexpr float C_LIGHT = 2.99792458e8f;

enum Mode { F32 = 0, BF16 = 1, INT8 = 2, INT4 = 3 };

template <int IB, int PS, int BON>
struct Layout {
  static constexpr int C = 3 + IB + PS + 3 * BON;
  static constexpr int KI = 3;
  static constexpr int PI = 3 + IB;
  static constexpr int FI = 3 + IB + PS;
  static constexpr bool inv_brems = IB, phaseshift = PS, B_on = BON;
};

__device__ inline float kappa_of(float ne, float Te, float Z, float omega) {
  const float ne_cc = ne * 1e-6f;
  const float o_max = fmaxf(OMEGA_PE_COEFF * sqrtf(ne_cc), omega);
  const float L_classical = Z * E_CHARGE / Te;
  const float L_quantum = L_QUANTUM_COEFF / sqrtf(Te);
  const float L_max = fmaxf(L_classical, L_quantum);
  const float CL = fmaxf(2.0f, logf(V_THE_COEFF * sqrtf(Te) / (o_max * L_max)));
  const float r = ne_cc / omega;
  return KAPPA_COEFF * Z * C_LIGHT * (r * r) * CL * powf(Te, -1.5f);
}

// jnp.gradient along one transverse axis at index i of n, spacing h, from
// the values at the clamped neighbours i-1 and i+1
__device__ __forceinline__ float grad1(float lo, float hi, int i, int n,
                                       float h) {
  return (i == 0 || i == n - 1) ? (hi - lo) / h : (hi - lo) * 0.5f / h;
}

// amax * f32(1/qmax), as the JAX package's compiled amax / qmax computes it
// (XLA turns a division by a constant into a multiplication by its
// correctly rounded reciprocal)
__device__ __forceinline__ float scale_of(unsigned amax_bits, float qmax) {
  const float am = __uint_as_float(amax_bits);
  return am > 0.0f ? __fmul_rn(am, __frcp_rn(qmax)) : 1.0f;
}

__device__ __forceinline__ int code_of(float v, float scale, float qmax) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -qmax), qmax);
}

// code_of with the dither of absolute plane g (key already folded with g:
// pkey = fold_in(key, g)) at flat draw index idx
__device__ __forceinline__ int dithered_code(float v, float scale, float qmax,
                                             uint2 pkey,
                                             unsigned long long idx) {
  float x = __fdiv_rn(v, scale);
  if (v != 0.0f) x = __fadd_rn(x, threefry::uniform(pkey, idx, -0.5f, 0.5f));
  return (int)fminf(fmaxf(rintf(x), -qmax), qmax);
}

__device__ __forceinline__ uint8_t nibble_pair(int lo, int hi) {
  return (uint8_t)((lo & 15) | ((hi & 15) << 4));
}

}  // namespace channels
