// Device code shared by K5 (time_march.cu), K6 (adaptive.cu) and K18
// (sharded_rhs.cu): the trilinear gather of a channels-last (nx, ny, nz, C)
// f32 grid (synthpy_tpu/ops/interp.py:33 trilinear) and the time-domain
// right-hand side of the (9,) ray state (synthpy_tpu/tracer/
// propagator.py:56 _rhs), whose reassembly from the channel values
// (derivative) K18 also runs on its own.
//
// Arithmetic follows the JAX expressions operation for operation: the
// fractional index t = (pos - origin) * inv_spacing, the inside mask
// 0 <= t <= n - 1 on all three axes, the corner cell clip(floor(t), 0,
// n - 2), the fraction clip(t - i, 0, 1), the eight weights as
// ((g_x * g_y) * g_z) and the eight-corner sum in the JAX order
// (interp.py:79-88), contracted as XLA's CPU compiler contracts it in the
// compiled JAX tracers: fma(w0, c0, w1 * c1), then one fused multiply-add
// a corner. A point outside the box reads nothing and gives 0. The files
// that include this header are built with --fmad=false, so every other
// product and sum is rounded on its own, as the plain PyTorch version
// (ops/interp.trilinear(contract=True)) rounds it.

#pragma once

#include <cuda_runtime.h>

#include "layout.cuh"

namespace time_rhs {

using layouts::with_layout;

struct Grid {
  const float* values;  // (nx, ny, nz, C) channels-last
  int nx, ny, nz;
  float ox, oy, oz;     // coordinate of node (0, 0, 0)
  float ix, iy, iz;     // inverse spacings
};

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

// C channels of the grid at pos, 0 outside the box.
template <int C>
__device__ __forceinline__ void trilinear(const Grid& G, const float pos[3],
                                          float out[C]) {
  const float tx = (pos[0] - G.ox) * G.ix;
  const float ty = (pos[1] - G.oy) * G.iy;
  const float tz = (pos[2] - G.oz) * G.iz;
  const bool inside = tx >= 0.0f && tx <= (float)(G.nx - 1) && ty >= 0.0f &&
                      ty <= (float)(G.ny - 1) && tz >= 0.0f &&
                      tz <= (float)(G.nz - 1);
  if (!inside) {
#pragma unroll
    for (int c = 0; c < C; ++c) out[c] = 0.0f;
    return;
  }
  const float fx0 = fminf(floorf(tx), (float)(G.nx - 2));
  const float fy0 = fminf(floorf(ty), (float)(G.ny - 2));
  const float fz0 = fminf(floorf(tz), (float)(G.nz - 2));
  const float fx = clip01(tx - fx0), fy = clip01(ty - fy0),
              fz = clip01(tz - fz0);
  const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
  const long long sy = (long long)G.nz * C;
  const long long sx = (long long)G.ny * sy;
  const float* b = G.values + (long long)fx0 * sx + (long long)fy0 * sy +
                   (long long)fz0 * C;
  // corners (dx, dy, dz) in the JAX order 000, 001, 010, 011, 100, ...
  const float w[8] = {gx * gy * gz, gx * gy * fz, gx * fy * gz, gx * fy * fz,
                      fx * gy * gz, fx * gy * fz, fx * fy * gz, fx * fy * fz};
  const float* q[8] = {b,           b + C,           b + sy,
                       b + sy + C,  b + sx,          b + sx + C,
                       b + sx + sy, b + sx + sy + C};
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float acc = __fmaf_rn(w[0], __ldg(q[0] + c), w[1] * __ldg(q[1] + c));
#pragma unroll
    for (int k = 2; k < 8; ++k) acc = __fmaf_rn(w[k], __ldg(q[k] + c), acc);
    out[c] = acc;
  }
}

// ds/dt of the state s = (x, y, z, vx, vy, vz, amp, phase, pol) from the
// channel values v at its position (_rhs's reassembly).
template <class LY>
__device__ __forceinline__ void derivative(const float s[9],
                                           const float v[LY::C],
                                           float atten_sign, float d[9]) {
  d[0] = s[3];
  d[1] = s[4];
  d[2] = s[5];
  d[3] = v[0];
  d[4] = v[1];
  d[5] = v[2];
  d[6] = 0.0f;
  d[7] = 0.0f;
  d[8] = 0.0f;
  if constexpr (LY::inv_brems) d[6] = atten_sign * v[LY::KI] * s[6];
  if constexpr (LY::phaseshift) d[7] = v[LY::PI];
  if constexpr (LY::B_on)
    d[8] = v[LY::FI] * s[3] + v[LY::FI + 1] * s[4] + v[LY::FI + 2] * s[5];
}

// ds/dt of the state s, gathering its channel values from the grid.
template <class LY>
__device__ __forceinline__ void rhs(const Grid& G, const float s[9],
                                    float atten_sign, float d[9]) {
  float v[LY::C];
  trilinear<LY::C>(G, s, v);
  derivative<LY>(s, v, atten_sign, d);
}

}  // namespace time_rhs
