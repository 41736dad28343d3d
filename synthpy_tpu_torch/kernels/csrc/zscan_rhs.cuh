// The right-hand side of the z-scan marches, shared by K4 (slab_march.cu)
// and K7 (analytic.cu): du/dp of the permuted state u = (a, b, va, vb, vp,
// amp, phase, pol) from the C channel values v of a layout
// (synthpy_tpu/tracer/zscan.py:636 _cols_rhs), operation for operation as
// the plain PyTorch version (kernels/slab_march.cols_rhs). The files that
// include this header are built with --fmad=false.

#pragma once

#include "layout.cuh"

namespace zscan_rhs {

template <class LY>
__device__ __forceinline__ void cols_rhs(const float v[LY::C],
                                         const float u[8], float atten_sign,
                                         float d[8]) {
  const float inv_vp = 1.0f / u[4];
  d[0] = u[2] * inv_vp;
  d[1] = u[3] * inv_vp;
  d[2] = v[0] * inv_vp;
  d[3] = v[1] * inv_vp;
  d[4] = v[2] * inv_vp;
  d[5] = 0.0f;
  d[6] = 0.0f;
  d[7] = 0.0f;
  if constexpr (LY::inv_brems) d[5] = atten_sign * v[LY::KI] * u[5] * inv_vp;
  if constexpr (LY::phaseshift) d[6] = v[LY::PI] * inv_vp;
  if constexpr (LY::B_on)
    d[7] = (v[LY::FI] * u[2] + v[LY::FI + 1] * u[3] + v[LY::FI + 2] * u[4]) *
           inv_vp;
}

}  // namespace zscan_rhs
