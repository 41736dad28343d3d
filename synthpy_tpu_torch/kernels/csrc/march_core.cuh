// The device code of the segment march, shared by K1 (march.cu) and K17
// (march_sharded.cu): the per-ray march of one segment (march_segment)
// from the frozen corner rows a caller sets up in a Corners, and the
// dtypes, layouts, corner loads and right-hand side it runs on. The
// arithmetic and its order are described in march.cu; every file that
// includes this header is built with --fmad=false.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum Dtype { F32 = 0, BF16 = 1, I8 = 2, I4 = 3 };
enum Integrator { RK4 = 0, RK2 = 1, RK2S2 = 2, RK2S4 = 3 };

struct Params {
  const float* u_in;
  float* u_out;
  const long long* order;
  const unsigned char* table;
  const float* scales;
  long long N;
  int n_seg, cells, row_len, K;
  int integrator, slab_weights;
  int na, nb;
  float oa, ob, inva, invb, h, atten_sign;
};

template <int IB, int PS, int BON>
struct Layout {
  static constexpr int C = 3 + IB + PS + 3 * BON;
  static constexpr int KI = 3;
  static constexpr int PI = 3 + IB;
  static constexpr int FI = 3 + IB + PS;
  static constexpr bool inv_brems = IB, phaseshift = PS, B_on = BON;
};

template <int DT>
__host__ __device__ constexpr int elem_bytes() {
  return DT == F32 ? 4 : DT == BF16 ? 2 : 1;
}

// Byte offset of plane k within a corner row: int4 rows pair planes 2j and
// 2j+1 in the C bytes of block j.
template <int DT, int C>
__device__ __forceinline__ int plane_byte(int k) {
  if constexpr (DT == I4) return (k >> 1) * C;
  else return k * C * elem_bytes<DT>();
}

// Per-ray, per-segment constants: the frozen corner cell and its 4 corner
// rows in the table.
struct Corners {
  const unsigned char* row[4];  // rows 00, 01, 10, 11
  const float* sc;              // the segment's (K+1, C) scales, or null
  float ia0f, ib0f;
};

// Channel values of plane k at corner q, dequantised to f32.
template <int DT, int C>
__device__ __forceinline__ void load_plane(const Corners& X, int q, int k,
                                           float out[C]) {
  const unsigned char* t = X.row[q] + plane_byte<DT, C>(k);
  if constexpr (DT == I4) {
    // plane 2j is the low nibble of byte block j, plane 2j+1 the high one
    const float* sc = X.sc + k * C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const unsigned w = t[c];
      const unsigned n = (k & 1) ? (w >> 4) & 15u : w & 15u;
      out[c] = (float)((int)(n ^ 8u) - 8) * sc[c];
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float v;
      if constexpr (DT == F32) v = ((const float*)t)[c];
      else if constexpr (DT == BF16)
        v = __bfloat162float(((const __nv_bfloat16*)t)[c]);
      else v = (float)((const int8_t*)t)[c] * X.sc[k * C + c];
      out[c] = v;
    }
  }
}

template <int DT, int C>
__device__ __forceinline__ void load_corners(const Corners& X, int k,
                                             float v[4][C]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) load_plane<DT, C>(X, q, k, v[q]);
}

// Transverse fractions and inside-mask of position (a, b) for the frozen
// corner cell (_cols_bilinear / _cols_weights).
__device__ __forceinline__ bool fractions(const Params& P, const Corners& X,
                                          float a, float b, float& fa,
                                          float& fb) {
  const float ta = (a - P.oa) * P.inva;
  const float tb = (b - P.ob) * P.invb;
  fa = fminf(fmaxf(ta - X.ia0f, 0.0f), 1.0f);
  fb = fminf(fmaxf(tb - X.ib0f, 0.0f), 1.0f);
  return ta >= 0.0f && ta <= (float)(P.na - 1) && tb >= 0.0f &&
         tb <= (float)(P.nb - 1);
}

// weights='slab': corner weights with the inside-mask folded in
__device__ __forceinline__ void slab_weights(const Params& P, const Corners& X,
                                             const float s[8], float w[4]) {
  float fa, fb;
  const float m = fractions(P, X, s[0], s[1], fa, fb) ? 1.0f : 0.0f;
  w[0] = m * (1.0f - fa) * (1.0f - fb);
  w[1] = m * (1.0f - fa) * fb;
  w[2] = m * fa * (1.0f - fb);
  w[3] = m * fa * fb;
}

// du/dp at state s from the corner values wv (already z-blended): the
// bilinear blend (weights per stage, or the slab's ws) and _cols_rhs.
template <class LY>
__device__ __forceinline__ void stage(const Params& P, const Corners& X,
                                      const float s[8],
                                      const float wv[4][LY::C],
                                      const float ws[4], float d[8]) {
  constexpr int C = LY::C;
  float w[4];
  bool inside = true;
  if (P.slab_weights) {
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = ws[q];
  } else {
    float fa, fb;
    inside = fractions(P, X, s[0], s[1], fa, fb);
    w[0] = (1.0f - fa) * (1.0f - fb);
    w[1] = (1.0f - fa) * fb;
    w[2] = fa * (1.0f - fb);
    w[3] = fa * fb;
  }
  float v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float x = w[0] * wv[0][c] + w[1] * wv[1][c] + w[2] * wv[2][c] +
                    w[3] * wv[3][c];
    v[c] = inside ? x : 0.0f;
  }
  const float inv_vp = 1.0f / s[4];
  d[0] = s[2] * inv_vp;
  d[1] = s[3] * inv_vp;
  d[2] = v[0] * inv_vp;
  d[3] = v[1] * inv_vp;
  d[4] = v[2] * inv_vp;
  d[5] = 0.0f;
  d[6] = 0.0f;
  d[7] = 0.0f;
  if constexpr (LY::inv_brems) d[5] = P.atten_sign * v[LY::KI] * s[5] * inv_vp;
  if constexpr (LY::phaseshift) d[6] = v[LY::PI] * inv_vp;
  if constexpr (LY::B_on)
    d[7] = (v[LY::FI] * s[2] + v[LY::FI + 1] * s[3] + v[LY::FI + 2] * s[4]) *
           inv_vp;
}

__device__ __forceinline__ void axpy(const float s[8], const float k[8],
                                     float c, float out[8]) {
#pragma unroll
  for (int q = 0; q < 8; ++q) out[q] = s[q] + c * k[q];
}

// One slab k -> k+1 with rk2 (midpoint) or rk4 (zscan.py:892-939). w0
// holds plane k's corner values when ``have`` is set (carried from the
// previous slab) and plane k+1's on return.
template <int DT, class LY>
__device__ __forceinline__ void slab_step(const Params& P, const Corners& X,
                                          int k, bool rk4, float s[8],
                                          float w0[4][LY::C], bool& have) {
  constexpr int C = LY::C;
  float w1[4][C], wm[4][C];
  if (!have) load_corners<DT, C>(X, k, w0);
  load_corners<DT, C>(X, k + 1, w1);
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int c = 0; c < C; ++c) wm[q][c] = 0.5f * (w0[q][c] + w1[q][c]);
  float ws[4];
  if (P.slab_weights) slab_weights(P, X, s, ws);
  const float h = P.h;
  const float hh = 0.5f * h;
  float k1[8], k2[8], t[8];
  stage<LY>(P, X, s, w0, ws, k1);
  axpy(s, k1, hh, t);
  stage<LY>(P, X, t, wm, ws, k2);
  if (!rk4) {
#pragma unroll
    for (int q = 0; q < 8; ++q) s[q] = s[q] + h * k2[q];
  } else {
    float k3[8], k4[8];
    axpy(s, k2, hh, t);
    stage<LY>(P, X, t, wm, ws, k3);
    axpy(s, k3, h, t);
    stage<LY>(P, X, t, w1, ws, k4);
    const float h6 = h / 6.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      s[q] = s[q] + h6 * (k1[q] + 2.0f * k2[q] + 2.0f * k3[q] + k4[q]);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int c = 0; c < C; ++c) w0[q][c] = w1[q][c];
  have = true;
}

// One midpoint step over planes k0 -> k0 + 2*(km - k0) with the midpoint
// plane km read exactly: rk2s2 (km = k0+1, half = h, full = 2h) and rk2s4
// (km = k0+2, half = 2h, full = 4h) (zscan.py:967-1070).
template <int DT, class LY>
__device__ __forceinline__ void midpoint_step(const Params& P,
                                              const Corners& X, int k0,
                                              int km, float half, float full,
                                              float s[8]) {
  constexpr int C = LY::C;
  float w0[4][C], wm[4][C];
  load_corners<DT, C>(X, k0, w0);
  load_corners<DT, C>(X, km, wm);
  float ws[4];
  if (P.slab_weights) slab_weights(P, X, s, ws);
  float k1[8], k2[8], t[8];
  stage<LY>(P, X, s, w0, ws, k1);
  axpy(s, k1, half, t);
  stage<LY>(P, X, t, wm, ws, k2);
#pragma unroll
  for (int q = 0; q < 8; ++q) s[q] = s[q] + full * k2[q];
}

// March the segment's K slabs.
template <int DT, class LY>
__device__ __forceinline__ void march_segment(const Params& P,
                                              const Corners& X, float s[8]) {
  const int K = P.K;
  const float h = P.h;
  int k = 0;
  if (P.integrator == RK2S4) {
    for (; k + 4 <= K; k += 4)
      midpoint_step<DT, LY>(P, X, k, k + 2, 2.0f * h, 4.0f * h, s);
  } else if (P.integrator == RK2S2) {
    for (; k + 2 <= K; k += 2)
      midpoint_step<DT, LY>(P, X, k, k + 1, h, 2.0f * h, s);
  }
  const bool rk4 = P.integrator == RK4;
  float w0[4][LY::C];
  bool have = false;
  for (; k < K; ++k) slab_step<DT, LY>(P, X, k, rk4, s, w0, have);
}

}  // namespace
