// K4: the plain slab march.
//
// Replaces the JAX device program trace_zscan (synthpy_tpu/tracer/zscan.py
// :189): RK4 with the probing coordinate as independent variable across
// n_slabs intervals of the (n_p, na, nb, C) plane stack (f32 or bf16), with
// `substeps` RK4 steps per interval; each stage is a 4-corner bilinear
// gather (_bilinear :135) from a plane and the 8-wide right-hand side
// (_deriv :159, its right-hand side shared with K7 in zscan_rhs.cuh).
//
// What bounds it on the H100: by count, operations. A ray and slab do four
// stages of ~45 + 11C float32 operations (weights, the per-corner plane
// blend of the midpoint stages, the 4-corner blend of C channels, the
// right-hand side) plus the 8-wide stage states and update; the planes are
// touched only around the rays' paths and the state is read and written
// once (PERF.md has the bound and the time). The first design read 24C
// plane values a ray-slab (4 corners of one plane for k1 and k4, of two
// planes for k2 and k3): 72 scalar loads at C = 3, most of them values the
// ray had just read, and ran at 23% of the bound.
//
// The design: one thread owns a ray and keeps its 8 columns in registers
// across all slabs. The JAX program blends whole planes (p_h = 0.5 (w0 +
// w1), or w0 + (j / substeps) (w1 - w0)); here each stage blends only the
// 4 corner values it reads, which are the same values elementwise, so no
// blended plane is ever written. The wrapper may hand the rays over in
// entry-cell order (kernels/march.ray_order) so that a warp's corner reads
// share sectors; each ray's result goes back to its own row. On K5's and
// K13's template (time_rhs.cuh, boris.cu), a thread carries corners:
// - Corners<C> holds one plane's 4 x C corner values at a transverse cell
//   (ia, ib). A thread keeps two: X, plane k's, and Y, plane k + 1's. At a
//   new slab X takes Y's values and cell (plane k is the last slab's plane
//   k + 1) and Y is empty. A stage computes ta, tb, the inside test and the
//   clamped cell exactly as before, then brings the planes it blends to its
//   cell: an unchanged cell reads nothing, a move (or an empty carry)
//   reads the plane's four corners. Outside the box a stage gives 0, reads
//   nothing and keeps the carry. A ray whose cell holds still reads plane
//   k + 1's 4C values once a slab: 12 loads at C = 3, against 72
//   (profiling.slab_walk_model counts them along the plain march's stage
//   points). A corner is C single loads at immediate offsets from one of
//   two row pointers; blocks are 128 threads.
// - In entry-cell order a warp's rays share their corners' sectors, so the
//   first design's loads mostly hit L1 and the march is held by its
//   instruction rate and latency, not by its loads. There, shifting the carried corners along
//   a and b to read only the two that came in (K5's and K13's carry) cost
//   more registers and selects than the loads it saved, and ran 16%
//   slower than the first design; reading all four on a move runs within
//   a few percent of it, and 3.5 times faster in the caller's order, where
//   the first design's loads miss (PERF.md; march_profile.py zscan
//   --variants keeps the shifting carry as its "shift" variant).
// The blend and the right-hand side are unchanged: the same values, in the
// same order (w00 c00 + w01 c01 + w10 c10 + w11 c11), so the rows are the
// first design's bit for bit.
//
// Rounding rules of the JAX program (zscan.py:219-231), kept here:
// - substeps == 1: p_h = 0.5 * (w0 + w1) is computed in the plane dtype, so
//   on a bf16 stack the sum and the half round to bf16 before the bilinear;
// - substeps > 1: w0 + (j / substeps) * dw promotes to f32 (j is an f32
//   arange), with dw = w1 - w0 in the plane dtype.
// Built with --fmad=false, operation for operation as the plain version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "zscan_rhs.cuh"

namespace {

enum Dtype { F32 = 0, BF16 = 1 };

constexpr int THREADS = 128;

struct Params {
  const float* u_in;
  float* u_out;
  const long long* order;  // null: ray i is marched i-th
  const void* planes;
  long long N;
  int n_slabs, substeps, na, nb;
  float oa, ob, inva, invb;
  float h, hh, h6, atten_sign;  // h = dp/substeps, 0.5*h, h/6 in float32
};

template <int DT>
__device__ __forceinline__ float load(const void* p, long long idx) {
  if constexpr (DT == F32) return __ldg((const float*)p + idx);
  else return __bfloat162float(((const __nv_bfloat16*)p)[idx]);
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// How a stage's plane values come from the slab's two planes.
enum Mode { PLANE0, PLANE1, MID, LERP };

// The stage plane's value from plane k's a and plane k + 1's b.
template <int DT>
__device__ __forceinline__ float stage_value(float a, float b, int mode,
                                             float frac) {
  if (mode == PLANE0) return a;
  if (mode == PLANE1) return b;
  if (mode == MID) {
    if constexpr (DT == BF16) return bf16r(0.5f * bf16r(a + b));
    else return 0.5f * (a + b);
  }
  float dw = b - a;
  if constexpr (DT == BF16) dw = bf16r(dw);
  return a + frac * dw;
}

// One plane's corner values at a carried transverse cell: corner q = 2 da +
// db is node (ia + da, ib + db); (-2, -2) carries nothing.
template <int C>
struct Corners {
  float c[4][C];
  int ia, ib;

  __device__ __forceinline__ Corners() : ia(-2), ib(-2) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int m = 0; m < C; ++m) c[q][m] = 0.0f;
  }
};

// Bring K to cell (ia, ib) of the plane at w: an unchanged cell reads
// nothing, a move reads the four corners anew.
template <int DT, int C>
__device__ __forceinline__ void corners_at(Corners<C>& K, const void* w,
                                           int ia, int ib, int nb) {
  if (ia == K.ia && ib == K.ib) return;
  K.ia = ia;
  K.ib = ib;
  // the rows ia and ia + 1; a node's channel offsets are immediates
  const long long r0 = ((long long)ia * nb + ib) * C;
  const long long r1 = r0 + (long long)nb * C;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int m = 0; m < C; ++m)
      K.c[q][m] = load<DT>(w, (q & 2 ? r1 : r0) + C * (q & 1) + m);
}

// du/dp at u from the stage plane (_bilinear, then _deriv), through the
// carried corners X (plane k at w0) and Y (plane k + 1 at w1).
template <int DT, class LY>
__device__ __forceinline__ void deriv(const Params& P, const void* w0,
                                      const void* w1, Corners<LY::C>& X,
                                      Corners<LY::C>& Y, int mode,
                                      float frac, const float u[8],
                                      float d[8]) {
  constexpr int C = LY::C;
  const float ta = (u[0] - P.oa) * P.inva;
  const float tb = (u[1] - P.ob) * P.invb;
  const bool inside = ta >= 0.0f && ta <= (float)(P.na - 1) && tb >= 0.0f &&
                      tb <= (float)(P.nb - 1);
  float v[C];
  if (inside) {
    const float ia = fminf(floorf(ta), (float)(P.na - 2));
    const float ib = fminf(floorf(tb), (float)(P.nb - 2));
    const float fa = fminf(fmaxf(ta - ia, 0.0f), 1.0f);
    const float fb = fminf(fmaxf(tb - ib, 0.0f), 1.0f);
    const float w00 = (1.0f - fa) * (1.0f - fb), w01 = (1.0f - fa) * fb,
                w10 = fa * (1.0f - fb), w11 = fa * fb;
    if (mode != PLANE1) corners_at<DT, C>(X, w0, (int)ia, (int)ib, P.nb);
    if (mode != PLANE0) corners_at<DT, C>(Y, w1, (int)ia, (int)ib, P.nb);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float c00 = stage_value<DT>(X.c[0][c], Y.c[0][c], mode, frac);
      const float c01 = stage_value<DT>(X.c[1][c], Y.c[1][c], mode, frac);
      const float c10 = stage_value<DT>(X.c[2][c], Y.c[2][c], mode, frac);
      const float c11 = stage_value<DT>(X.c[3][c], Y.c[3][c], mode, frac);
      v[c] = w00 * c00 + w01 * c01 + w10 * c10 + w11 * c11;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = 0.0f;
  }
  zscan_rhs::cols_rhs<LY>(v, u, P.atten_sign, d);
}

// One RK4 step between stage planes (m0, frac0), (mh, frach), (m1, frac1).
template <int DT, class LY>
__device__ __forceinline__ void rk4_step(const Params& P, const void* w0,
                                         const void* w1, Corners<LY::C>& X,
                                         Corners<LY::C>& Y, int m0, float f0,
                                         int mh, float fh, int m1, float f1,
                                         float u[8]) {
  float k1[8], k2[8], k3[8], k4[8], t[8];
  deriv<DT, LY>(P, w0, w1, X, Y, m0, f0, u, k1);
#pragma unroll
  for (int q = 0; q < 8; ++q) t[q] = u[q] + P.hh * k1[q];
  deriv<DT, LY>(P, w0, w1, X, Y, mh, fh, t, k2);
#pragma unroll
  for (int q = 0; q < 8; ++q) t[q] = u[q] + P.hh * k2[q];
  deriv<DT, LY>(P, w0, w1, X, Y, mh, fh, t, k3);
#pragma unroll
  for (int q = 0; q < 8; ++q) t[q] = u[q] + P.h * k3[q];
  deriv<DT, LY>(P, w0, w1, X, Y, m1, f1, t, k4);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    u[q] = u[q] + P.h6 * (k1[q] + 2.0f * k2[q] + 2.0f * k3[q] + k4[q]);
}

template <int DT, class LY>
__global__ void __launch_bounds__(THREADS) slab_kernel(Params P) {
  constexpr int C = LY::C;
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= P.N) return;
  const long long r = P.order ? P.order[i] : i;
  float u[8];
  {
    const float4* src = reinterpret_cast<const float4*>(P.u_in + r * 8);
    const float4 a = src[0], b = src[1];
    u[0] = a.x; u[1] = a.y; u[2] = a.z; u[3] = a.w;
    u[4] = b.x; u[5] = b.y; u[6] = b.z; u[7] = b.w;
  }
  const long long plane_bytes =
      (long long)P.na * P.nb * C * (DT == F32 ? 4 : 2);
  const float S = (float)P.substeps;
  Corners<C> X, Y;
  for (int k = 0; k < P.n_slabs; ++k) {
    const char* w0 = (const char*)P.planes + k * plane_bytes;
    const char* w1 = w0 + plane_bytes;
    // plane k's corners are the last slab's plane k + 1's
    X = Y;
    Y.ia = Y.ib = -2;
    if (P.substeps == 1) {
      rk4_step<DT, LY>(P, w0, w1, X, Y, PLANE0, 0.0f, MID, 0.0f, PLANE1,
                       0.0f, u);
    } else {
      for (int j = 0; j < P.substeps; ++j) {
        const float fj = (float)j;
        rk4_step<DT, LY>(P, w0, w1, X, Y, LERP, fj / S, LERP,
                         (fj + 0.5f) / S, LERP, (fj + 1.0f) / S, u);
      }
    }
  }
  float4* dst = reinterpret_cast<float4*>(P.u_out + r * 8);
  dst[0] = make_float4(u[0], u[1], u[2], u[3]);
  dst[1] = make_float4(u[4], u[5], u[6], u[7]);
}

template <int DT>
struct Plane {
  template <class LY>
  struct Launch {
    static void run(const Params& P, cudaStream_t st) {
      const unsigned blocks = (unsigned)((P.N + THREADS - 1) / THREADS);
      slab_kernel<DT, LY><<<blocks, THREADS, 0, st>>>(P);
    }
  };
};

}  // namespace

// u_in, u_out: (N, 8) f32 permuted states, 16-byte aligned; order: (N,)
// int64 or null; planes: (n_p, na, nb, C) f32 (dtype 0) or bf16 (dtype 1),
// n_p >= n_slabs + 1. Returns cudaGetLastError().
extern "C" int slab_march(const float* u_in, float* u_out,
                          const long long* order, const void* planes,
                          long long N, int dtype, int n_slabs, int substeps,
                          int na, int nb, float oa, float ob, float inva,
                          float invb, float h, float hh, float h6,
                          float atten_sign, int inv_brems, int phaseshift,
                          int B_on, void* stream) {
  if (N == 0) return 0;
  Params P;
  P.u_in = u_in; P.u_out = u_out; P.order = order; P.planes = planes;
  P.N = N; P.n_slabs = n_slabs; P.substeps = substeps; P.na = na; P.nb = nb;
  P.oa = oa; P.ob = ob; P.inva = inva; P.invb = invb;
  P.h = h; P.hh = hh; P.h6 = h6; P.atten_sign = atten_sign;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == BF16)
    layouts::with_layout<Plane<BF16>::Launch>(inv_brems, phaseshift, B_on, P,
                                              st);
  else
    layouts::with_layout<Plane<F32>::Launch>(inv_brems, phaseshift, B_on, P,
                                             st);
  return (int)cudaGetLastError();
}
