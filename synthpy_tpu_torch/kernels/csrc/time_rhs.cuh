// Device code shared by K5 (time_march.cu), K6 (adaptive.cu) and K18
// (sharded_rhs.cu): the trilinear gather of a channels-last (nx, ny, nz, C)
// f32 grid (synthpy_tpu/ops/interp.py:33 trilinear), the same gather with
// the corners carried from one call to the next (K5), and the time-domain
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

// Component q of an RK4 step's slope sum ((k1 + 2 k2) + 2 k3) + k4 from
// its first three terms acc, with k4's channel values v4 at its stage
// state t4. XLA's CPU compiler fuses k4's amplitude derivative (atten_sign
// kappa) amp into the sum's last add (the compiled trace_rk4's and
// grid-sharded tracer's final fusion: -kappa times amp, then added to
// (k1 + 2 k2) + 2 k3, one multiply-add); every other component adds k4.
template <class LY>
__device__ __forceinline__ float rk4_last_add(int q, float acc,
                                              const float k4[9],
                                              const float v4[LY::C],
                                              const float t4[9],
                                              float atten_sign) {
  if constexpr (LY::inv_brems) {
    if (q == 6) return __fmaf_rn(atten_sign * v4[LY::KI], t4[6], acc);
  }
  return acc + k4[q];
}

// ds/dt of the state s, gathering its channel values from the grid.
template <class LY>
__device__ __forceinline__ void rhs(const Grid& G, const float s[9],
                                    float atten_sign, float d[9]) {
  float v[LY::C];
  trilinear<LY::C>(G, s, v);
  derivative<LY>(s, v, atten_sign, d);
}

// K5's carried corners: the corner values of the last cell a thread
// gathered in, kept in registers from one gather to the next (K13's
// design, boris.cu). A gather computes t, the inside mask, the corner cell
// and the fractions exactly as trilinear does; when the cell is unchanged
// it reads nothing, when an axis moved by one it shifts the carried values
// (the upper face becomes the lower one, or back) and reads only the face
// that came in, and on a larger move (or at the first in-grid gather) it
// reads all 8 corners. A point outside the box gives 0, reads nothing and
// keeps the carry. The blend is trilinear's, in its order, on the same
// values.

template <int C>
struct Carry {
  float c[8][C];  // corner q = 4 dx + 2 dy + dz, the JAX order
  int i, j, k;    // their cell; -2 before the first in-grid gather

  __device__ __forceinline__ Carry() : i(-2), j(-2), k(-2) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int m = 0; m < C; ++m) c[q][m] = 0.0f;
  }
};

// Move the carried corners d cells along the axis of bit BIT of q (1: z,
// 2: y, 4: x); returns the corners (a bit mask of q) to read anew.
template <int BIT, int C>
__device__ __forceinline__ unsigned carry_shift(float c[8][C], int d) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if (q & BIT) continue;
#pragma unroll
    for (int m = 0; m < C; ++m) {
      const float lo = c[q][m], hi = c[q | BIT][m];
      c[q][m] = d == 1 ? hi : lo;
      c[q | BIT][m] = d == -1 ? lo : hi;
    }
  }
  constexpr unsigned upper = BIT == 1 ? 0xAAu : BIT == 2 ? 0xCCu : 0xF0u;
  return d == 1 ? upper : d == -1 ? (~upper & 0xFFu) : 0xFFu;
}

// C channels of the grid at pos, 0 outside the box: trilinear's result,
// reading only the corners that K does not carry.
template <int C>
__device__ __forceinline__ void trilinear_carried(const Grid& G,
                                                  Carry<C>& K,
                                                  const float pos[3],
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
  const int i = (int)fx0, j = (int)fy0, k = (int)fz0;
  // each axis shifts only where some lane of the warp moved along it
  unsigned need = 0;
  if (k != K.k) need |= carry_shift<1, C>(K.c, k - K.k);
  if (j != K.j) need |= carry_shift<2, C>(K.c, j - K.j);
  if (i != K.i) need |= carry_shift<4, C>(K.c, i - K.i);
  K.i = i;
  K.j = j;
  K.k = k;
  if (need != 0) {
    const long long sy = (long long)G.nz * C;
    const long long sx = (long long)G.ny * sy;
    // the four columns (i + a, j + b); a node's z and channel offsets are
    // immediates of its loads
    const float* col[4];
    col[0] = G.values + (long long)i * sx + (long long)j * sy +
             (long long)k * C;
    col[1] = col[0] + sy;
    col[2] = col[0] + sx;
    col[3] = col[2] + sy;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (need & (1u << q)) {
#pragma unroll
        for (int m = 0; m < C; ++m)
          K.c[q][m] = __ldg(col[q >> 1] + C * (q & 1) + m);
      }
  }
  const float w[8] = {gx * gy * gz, gx * gy * fz, gx * fy * gz, gx * fy * fz,
                      fx * gy * gz, fx * gy * fz, fx * fy * gz, fx * fy * fz};
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float acc = __fmaf_rn(w[0], K.c[0][c], w[1] * K.c[1][c]);
#pragma unroll
    for (int q = 2; q < 8; ++q) acc = __fmaf_rn(w[q], K.c[q][c], acc);
    out[c] = acc;
  }
}

// ds/dt of the state s, gathering through the carried corners K.
template <class LY>
__device__ __forceinline__ void rhs_carried(const Grid& G, Carry<LY::C>& K,
                                            const float s[9],
                                            float atten_sign, float d[9]) {
  float v[LY::C];
  trilinear_carried<LY::C>(G, K, s, v);
  derivative<LY>(s, v, atten_sign, d);
}

}  // namespace time_rhs
