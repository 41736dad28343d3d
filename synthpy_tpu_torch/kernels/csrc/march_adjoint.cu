// K11: the adjoint of one segment of the segment march K1.
//
// Replaces the VJP of synthpy_tpu/tracer/zscan.py march_segment (:756) that
// jax.grad builds under trace_zscan_segments(remat=True) (the segment and
// slab jax.checkpoints of :1079 and :1176-1181), for what the differentiable
// renderer runs (synthpy_tpu/inverse.py:299-303): rk4, weights="stage",
// one substep, a float32 or bf16 table, every channel layout (C = 3-8).
// Per ray: the frozen corner cell ia0, ib0 and the clipped gather
// (:850-860) have zero derivative; per slab, the hoisted z-blend w0, wm =
// (w0 + w1) / 2, w1 (:893-915), four stages of the bilinear blend
// _cols_bilinear (:615-634: fractions clipped to [0, 1], whose derivative
// at exactly 0 or 1 is the 1/2 that jnp.clip's max/min pair gives, and an
// inside mask that zeroes everything outside) and the right-hand side
// _cols_rhs (:636-654: the 1/vp terms, attenuation, phase and Faraday
// channels), and the rk4 combination (:862-872), reversed.
//
// Given the segment-start states u (N, 8), the cotangent of the
// segment-end states and the segment's table, it writes the cotangent of
// u and adds the table's cotangent into a float32 (cells, (K+1) C) buffer
// (a bf16 table's cotangent is summed in float32 and rounded once by the
// caller, where JAX sums it in bf16).
//
// Each thread owns a ray (in march.ray_order, so that a warp's rays share
// corner rows, as in K1): it marches the segment forward with K1's
// arithmetic, storing the K slab-start states in a per-ray scratch (K, N,
// 8) float32, then steps back through the slabs: per slab it re-runs the
// four stages from the slab's start state and reverses them, holding the
// two planes' corner cotangents in registers across the four stages.
// Corner values of plane k + 1 are carried from the slab before, as K1
// carries them. Built with --fmad=false, so that the forward states are
// K1's bit for bit.
//
// What bounds it on the H100. By count, operations: at 1 M rays, K = 64
// and C = 4 the VJP needs ~63 G float32 operations a segment (the forward
// stages and their adjoints, ~2.8x K1's rk4 work a slab) and this design
// does ~91 G (it also re-runs three stages a slab and recomputes the
// forward values each stage adjoint uses; chip_smoke.py counts both); the
// bytes (states, the scratch, cotangents, the table's touched rows and
// their cotangents) are an order less. What held the first design at 7%
// of that bound (14.3 ms) was the table's cotangent: one scalar float
// atomic a corner, channel and plane for every ray, ~1.04 G a launch on
// ~22 M addresses, ~47 queued on each in L2. Timed variants on an H100
// (PERF.md section 6) set this design:
// - It adds a corner's C values of one plane as one of Hopper's vector
//   reductions (atomicAdd on float4 or float2 in global memory, compute
//   capability 9.x): they are contiguous, 16-byte aligned when C is a
//   multiple of 4 (the row is (K+1) C floats), 8-byte aligned when C is
//   even, so the width is 4, 2 or 1 by C at compile time; the wrapper
//   checks the buffer's alignment. A vector whose values are all zero
//   (outside the grid) is skipped. This alone took the launch to ~5 ms.
// - Before that, a plane's 4 C corner cotangents (complete after slab k:
//   plane k + 1; plane 0 at the end) are summed over the warp's runs of
//   equal corner cell. Rays in entry-cell order fall into runs (~12 rays a
//   cell at the inversion's 1 M rays); a warp finds them once a segment
//   (a ballot of the lanes whose cell differs from the lane before, so
//   any order is right and entry-cell order makes the runs long). A
//   segmented shuffle reduction of MAX_STEPS = 2 steps sums each run in
//   blocks of 4 lanes, whose first lanes add: ~76 M vector adds a launch
//   (march_adjoint.py atomics_per_launch counts them from the rays'
//   cells). Whole runs (5 steps, ~29 M adds) cost more in shuffles than
//   they save in adds; one step (~138 M adds) ran 0.6-6% faster and none
//   (~260 M) 20% slower at 4 blocks an SM.
// - Threads past N (the last block's tail) march ray 0 alongside, so that
//   every lane takes part in the shuffles, under a cell of their own that
//   adds nothing, and write nothing.
// - Registers: the midpoint plane is formed where it is read, and the
//   launch bounds ask for 4 blocks an SM up to C = 4 (128 registers, ~0.3
//   KB of spills): 12-20% faster than the 2 blocks 190 registers allow.
// - The scratch stays whole: keeping every 4th or 8th state and
//   re-marching each chunk into shared memory saved ~1.8 GB a launch but
//   ran 9-11% slower (its re-march adds ~20% of the operations).
// The per-ray arithmetic and its order are the first design's, so the
// cotangent of u is bit-equal to it; only the order in which the table's
// cotangent is summed changed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "layout.cuh"
#include "zscan_rhs.cuh"

namespace {

enum Dtype { F32 = 0, BF16 = 1 };

constexpr int THREADS = 128;
// shuffle steps a plane's flush takes at most: a lane sums up to
// 2^MAX_STEPS lanes of its run (march_adjoint.py MAX_STEPS)
constexpr int MAX_STEPS = 2;

// Blocks an SM that registers must allow: 4 (128 registers a thread, a
// few hundred bytes of spills) up to C = 4; 2 above, where 3 spilled
// 0.5-0.8 KB and ran 33% slower at C = 8
template <int C>
constexpr int min_blocks() {
  return C <= 4 ? 4 : 2;
}

struct Params {
  const float* u_in;       // (N, 8) segment-start states
  const float* du_out;     // (N, 8) cotangent of the segment-end states
  float* du_in;            // (N, 8) cotangent of the segment-start states
  const long long* order;  // ray order[i] is thread i's
  const unsigned char* table;  // (cells, row_len) f32 or bf16
  float* dtable;           // (cells, row_len) f32, added into; or null
  float* scratch;          // (K, N, 8) f32 slab-start states
  long long N;
  int row_len, K;
  int na, nb;
  float oa, ob, inva, invb, h, atten_sign;
};

// The corner values of one plane, wv(q, c)
template <int C>
struct Plane {
  const float (*v)[C];
  __device__ __forceinline__ float operator()(int q, int c) const {
    return v[q][c];
  }
};

// The midpoint plane wm = (w0 + w1) / 2 of the hoisted z-blend, formed
// where it is read (the same operations as holding it, in fewer
// registers)
template <int C>
struct Mid {
  const float (*a)[C];
  const float (*b)[C];
  __device__ __forceinline__ float operator()(int q, int c) const {
    return 0.5f * (a[q][c] + b[q][c]);
  }
};

template <int DT>
__host__ __device__ constexpr int elem_bytes() {
  return DT == F32 ? 4 : 2;
}

// The frozen corner cell of a ray for the segment: its 4 corner rows.
struct Corners {
  const unsigned char* row[4];  // rows 00, 01, 10, 11 of the table
  long long cell[4];            // their cell indices
  float ia0f, ib0f;
};

template <int DT, int C>
__device__ __forceinline__ void load_corners(const Corners& X, int k,
                                             float v[4][C]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned char* t = X.row[q] + k * C * elem_bytes<DT>();
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if constexpr (DT == F32) v[q][c] = ((const float*)t)[c];
      else v[q][c] = __bfloat162float(((const __nv_bfloat16*)t)[c]);
    }
  }
}

// K1's stage: du/dp at state s from z-blended corner values wv.
template <class LY, class WV>
__device__ __forceinline__ void stage(const Params& P, const Corners& X,
                                      const float s[8], const WV& wv,
                                      float d[8]) {
  constexpr int C = LY::C;
  const float ta = (s[0] - P.oa) * P.inva;
  const float tb = (s[1] - P.ob) * P.invb;
  const float fa = fminf(fmaxf(ta - X.ia0f, 0.0f), 1.0f);
  const float fb = fminf(fmaxf(tb - X.ib0f, 0.0f), 1.0f);
  const bool inside = ta >= 0.0f && ta <= (float)(P.na - 1) && tb >= 0.0f &&
                      tb <= (float)(P.nb - 1);
  const float w[4] = {(1.0f - fa) * (1.0f - fb), (1.0f - fa) * fb,
                      fa * (1.0f - fb), fa * fb};
  float v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float x = w[0] * wv(0, c) + w[1] * wv(1, c) + w[2] * wv(2, c) +
                    w[3] * wv(3, c);
    v[c] = inside ? x : 0.0f;
  }
  zscan_rhs::cols_rhs<LY>(v, s, P.atten_sign, d);
}

// d clip(r, 0, 1) / dr as jax.grad gives it for jnp.clip = min(max(r, 0),
// 1): lax.max and lax.min split the cotangent evenly at a tie
__device__ __forceinline__ float clip01_grad(float r) {
  if (r > 0.0f && r < 1.0f) return 1.0f;
  return (r == 0.0f || r == 1.0f) ? 0.5f : 0.0f;
}

// The cotangent of stage(s, wv) for the cotangent dd of its output:
// written to ds (8); the corner values' cotangent, times cA and cB, added
// into the two planes' accumulators dA (plane k) and dB (plane k + 1).
template <class LY, class WV>
__device__ __forceinline__ void stage_adjoint(
    const Params& P, const Corners& X, const float s[8], const WV& wv,
    const float dd[8], float ds[8],
    float dA[4][LY::C], float cA, float dB[4][LY::C], float cB) {
  constexpr int C = LY::C;
  const float ta = (s[0] - P.oa) * P.inva;
  const float tb = (s[1] - P.ob) * P.invb;
  const float ra = ta - X.ia0f, rb = tb - X.ib0f;
  const float fa = fminf(fmaxf(ra, 0.0f), 1.0f);
  const float fb = fminf(fmaxf(rb, 0.0f), 1.0f);
  const bool inside = ta >= 0.0f && ta <= (float)(P.na - 1) && tb >= 0.0f &&
                      tb <= (float)(P.nb - 1);
  const float w[4] = {(1.0f - fa) * (1.0f - fb), (1.0f - fa) * fb,
                      fa * (1.0f - fb), fa * fb};
  float v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float x = w[0] * wv(0, c) + w[1] * wv(1, c) + w[2] * wv(2, c) +
                    w[3] * wv(3, c);
    v[c] = inside ? x : 0.0f;
  }
  // the right-hand side (zscan_rhs.cuh), backwards
  const float inv = 1.0f / s[4];
  float dv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dv[c] = 0.0f;
#pragma unroll
  for (int q = 0; q < 8; ++q) ds[q] = 0.0f;
  float dinv = dd[0] * s[2] + dd[1] * s[3] + dd[2] * v[0] + dd[3] * v[1] +
               dd[4] * v[2];
  ds[2] = dd[0] * inv;
  ds[3] = dd[1] * inv;
  dv[0] = dd[2] * inv;
  dv[1] = dd[3] * inv;
  dv[2] = dd[4] * inv;
  if constexpr (LY::inv_brems) {
    // d5 = ((atten_sign * kappa) * amp) * inv
    const float ak = P.atten_sign * v[LY::KI];
    dinv = dinv + dd[5] * (ak * s[5]);
    const float t = dd[5] * inv;
    ds[5] = t * ak;
    dv[LY::KI] = (t * s[5]) * P.atten_sign;
  }
  if constexpr (LY::phaseshift) {
    dinv = dinv + dd[6] * v[LY::PI];
    dv[LY::PI] = dd[6] * inv;
  }
  if constexpr (LY::B_on) {
    const int F = LY::FI;
    const float p = v[F] * s[2] + v[F + 1] * s[3] + v[F + 2] * s[4];
    dinv = dinv + dd[7] * p;
    const float t = dd[7] * inv;
    dv[F] = t * s[2];
    dv[F + 1] = t * s[3];
    dv[F + 2] = t * s[4];
    ds[2] = ds[2] + t * v[F];
    ds[3] = ds[3] + t * v[F + 1];
    ds[4] = ds[4] + t * v[F + 2];
  }
  ds[4] = ds[4] - dinv * (inv * inv);
  if (!inside) return;
  // the blend: corner values and weights
  float dw[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc = acc + dv[c] * wv(q, c);
      const float g = w[q] * dv[c];
      if (cA != 0.0f) dA[q][c] = dA[q][c] + cA * g;
      if (cB != 0.0f) dB[q][c] = dB[q][c] + cB * g;
    }
    dw[q] = acc;
  }
  // the weights: fractions, then positions through the clip
  const float dfa = (dw[2] - dw[0]) * (1.0f - fb) + (dw[3] - dw[1]) * fb;
  const float dfb = (dw[1] - dw[0]) * (1.0f - fa) + (dw[3] - dw[2]) * fa;
  ds[0] = dfa * clip01_grad(ra) * P.inva;
  ds[1] = dfb * clip01_grad(rb) * P.invb;
}

__device__ __forceinline__ void axpy(const float s[8], const float k[8],
                                     float c, float out[8]) {
#pragma unroll
  for (int q = 0; q < 8; ++q) out[q] = s[q] + c * k[q];
}

// One rk4 slab forward, as K1's slab_step: s advanced in place from
// plane values w0 (plane k) and w1 (plane k + 1).
template <class LY>
__device__ __forceinline__ void slab_forward(const Params& P,
                                             const Corners& X, float s[8],
                                             const float w0[4][LY::C],
                                             const float w1[4][LY::C]) {
  constexpr int C = LY::C;
  const Plane<C> p0{w0}, p1{w1};
  const Mid<C> wm{w0, w1};
  const float h = P.h;
  const float hh = 0.5f * h;
  float k1[8], k2[8], k3[8], k4[8], t[8];
  stage<LY>(P, X, s, p0, k1);
  axpy(s, k1, hh, t);
  stage<LY>(P, X, t, wm, k2);
  axpy(s, k2, hh, t);
  stage<LY>(P, X, t, wm, k3);
  axpy(s, k3, h, t);
  stage<LY>(P, X, t, p1, k4);
  const float h6 = h / 6.0f;
#pragma unroll
  for (int q = 0; q < 8; ++q)
    s[q] = s[q] + h6 * (k1[q] + 2.0f * k2[q] + 2.0f * k3[q] + k4[q]);
}

// One rk4 slab backward: from the slab-start state s and the cotangent ds
// of the slab-end state, ds becomes the cotangent of s; the corner values'
// cotangents are added into d0 (plane k) and d1 (plane k + 1).
template <class LY>
__device__ __forceinline__ void slab_adjoint(const Params& P,
                                             const Corners& X,
                                             const float s[8], float ds[8],
                                             const float p0[4][LY::C],
                                             const float p1[4][LY::C],
                                             float d0[4][LY::C],
                                             float d1[4][LY::C]) {
  constexpr int C = LY::C;
  const Plane<C> w0{p0}, w1{p1};
  const Mid<C> wm{p0, p1};
  const float h = P.h;
  const float hh = 0.5f * h;
  const float h6 = h / 6.0f;
  // the stage states, re-run
  float kk[8], t2[8], t3[8], t4[8];
  stage<LY>(P, X, s, w0, kk);
  axpy(s, kk, hh, t2);
  stage<LY>(P, X, t2, wm, kk);
  axpy(s, kk, hh, t3);
  stage<LY>(P, X, t3, wm, kk);
  axpy(s, kk, h, t4);
  // s' = s + h6 (k1 + 2 k2 + 2 k3 + k4), reversed
  float cs[8], g[8], dd[8], dt[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    cs[q] = h6 * ds[q];
    g[q] = ds[q];
    dd[q] = cs[q];
  }
  stage_adjoint<LY>(P, X, t4, w1, dd, dt, d0, 0.0f, d1, 1.0f);  // k4
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    g[q] = g[q] + dt[q];
    dd[q] = 2.0f * cs[q] + h * dt[q];
  }
  stage_adjoint<LY>(P, X, t3, wm, dd, dt, d0, 0.5f, d1, 0.5f);  // k3
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    g[q] = g[q] + dt[q];
    dd[q] = 2.0f * cs[q] + hh * dt[q];
  }
  stage_adjoint<LY>(P, X, t2, wm, dd, dt, d0, 0.5f, d1, 0.5f);  // k2
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    g[q] = g[q] + dt[q];
    dd[q] = cs[q] + hh * dt[q];
  }
  stage_adjoint<LY>(P, X, s, w0, dd, dt, d0, 1.0f, d1, 0.0f);  // k1
#pragma unroll
  for (int q = 0; q < 8; ++q) ds[q] = g[q] + dt[q];
}

// -- the table's cotangent: a plane's corner cotangents, combined over the
// warp's runs of equal corner cell, added as vectors

constexpr unsigned FULL = 0xffffffffu;

// The values a vector reduction adds: a corner's C channels of one plane
// are contiguous, so 4 when C is a multiple of 4, 2 when C is even, else 1
// (march_adjoint.py vector_width repeats this rule)
template <int C>
__host__ __device__ constexpr int vec_width() {
  return C % 4 == 0 ? 4 : (C % 2 == 0 ? 2 : 1);
}

// Add W values at p (16-byte aligned for 4, 8-byte for 2) as one vector
// reduction, unless all are zero.
template <int W>
__device__ __forceinline__ void red_add(float* p, const float* v) {
  if constexpr (W == 4) {
    if (v[0] != 0.0f || v[1] != 0.0f || v[2] != 0.0f || v[3] != 0.0f)
      atomicAdd(reinterpret_cast<float4*>(p),
                make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (W == 2) {
    if (v[0] != 0.0f || v[1] != 0.0f)
      atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    if (v[0] != 0.0f) atomicAdd(p, v[0]);
  }
}

// A lane's run: the lanes from the run's first to ``end`` share its
// corner cell (key). ``steps``, the same on every lane, is the number of
// shuffle steps the warp's longest run needs, at most MAX_STEPS; the run
// falls into blocks of 2^steps lanes from its first, and ``adds``: this
// lane is a block's first and its ray is real.
struct Run {
  unsigned end;
  int steps;
  bool adds;
};

__device__ __forceinline__ Run warp_run(long long key, bool real) {
  const unsigned lane = threadIdx.x & 31u;
  const long long prev = __shfl_up_sync(FULL, key, 1);
  const bool first = lane == 0 || prev != key;
  const unsigned firsts = __ballot_sync(FULL, first);
  const unsigned later = lane == 31 ? 0u : firsts & (FULL << (lane + 1));
  const unsigned head = 31 - __clz(firsts & (FULL >> (31 - lane)));
  Run r;
  r.end = later ? (unsigned)(__ffs(later) - 2) : 31u;
  const unsigned len = first ? r.end - lane + 1 : 1u;
  const unsigned longest = __reduce_max_sync(FULL, len);
  r.steps = min(32 - __clz(longest - 1), MAX_STEPS);
  r.adds = real && ((lane - head) & ((1u << r.steps) - 1)) == 0;
  return r;
}

// Add plane k's corner cotangents d into the table's cotangent and zero
// them: summed over the lane's run by shuffles down the run (a lane adds
// the one ``off`` above it while that one is in its run, so a block's first
// lane ends with the block's sum), then added by the block's first lane.
template <int C>
__device__ __forceinline__ void flush(const Params& P, const Corners& X,
                                      const Run& R, int k, float d[4][C]) {
  constexpr int W = vec_width<C>();
  if (P.dtable != nullptr) {
    const unsigned lane = threadIdx.x & 31u;
    for (int st = 0; st < R.steps; ++st) {
      const unsigned off = 1u << st;
      const bool take = lane + off <= R.end;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float t = __shfl_down_sync(FULL, d[q][c], off);
          if (take) d[q][c] = d[q][c] + t;
        }
    }
    if (R.adds) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < C; c += W)
          red_add<W>(P.dtable + X.cell[q] * P.row_len + k * C + c,
                     &d[q][c]);
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int c = 0; c < C; ++c) d[q][c] = 0.0f;
}

__device__ __forceinline__ void load8(const float* p, float s[8]) {
  const float4* v = reinterpret_cast<const float4*>(p);
  const float4 a = v[0], b = v[1];
  s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
  s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float s[8]) {
  float4* v = reinterpret_cast<float4*>(p);
  v[0] = make_float4(s[0], s[1], s[2], s[3]);
  v[1] = make_float4(s[4], s[5], s[6], s[7]);
}

template <int DT, class LY>
__global__ void __launch_bounds__(THREADS, min_blocks<LY::C>())
    adjoint_kernel(Params P) {
  constexpr int C = LY::C;
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  // a tail thread (i >= N) marches ray 0 and writes nothing
  const bool real = i < P.N;
  const long long r = real ? P.order[i] : 0;
  float s[8];
  load8(P.u_in + r * 8, s);
  // K1's frozen corner cell (march.cu)
  const float ta = (s[0] - P.oa) * P.inva;
  const float tb = (s[1] - P.ob) * P.invb;
  const int ia0 = (int)fminf(fmaxf(floorf(ta), 0.0f), (float)(P.na - 2));
  const int ib0 = (int)fminf(fmaxf(floorf(tb), 0.0f), (float)(P.nb - 2));
  Corners X;
  X.ia0f = (float)ia0;
  X.ib0f = (float)ib0;
  X.cell[0] = (long long)ia0 * P.nb + ib0;
  X.cell[1] = X.cell[0] + 1;
  X.cell[2] = X.cell[0] + P.nb;
  X.cell[3] = X.cell[2] + 1;
  const long long row_bytes = (long long)P.row_len * elem_bytes<DT>();
#pragma unroll
  for (int q = 0; q < 4; ++q) X.row[q] = P.table + X.cell[q] * row_bytes;
  // the warp's runs of equal corner cell (tail threads: a key no cell has)
  const Run R = warp_run(real ? X.cell[0] : -1ll, real);

  // forward: the slab-start states into the scratch
  float w0[4][C], w1[4][C];
  load_corners<DT, C>(X, 0, w0);
  for (int k = 0; k < P.K; ++k) {
    if (real) store8(P.scratch + ((long long)k * P.N + i) * 8, s);
    load_corners<DT, C>(X, k + 1, w1);
    slab_forward<LY>(P, X, s, w0, w1);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < C; ++c) w0[q][c] = w1[q][c];
  }
  // backward: w0 holds plane K
  float ds[8], d0[4][C], d1[4][C];
  load8(P.du_out + r * 8, ds);
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      w1[q][c] = w0[q][c];
      d0[q][c] = 0.0f;
      d1[q][c] = 0.0f;
    }
  for (int k = P.K - 1; k >= 0; --k) {
    if (real) load8(P.scratch + ((long long)k * P.N + i) * 8, s);
    load_corners<DT, C>(X, k, w0);
    slab_adjoint<LY>(P, X, s, ds, w0, w1, d0, d1);
    flush<C>(P, X, R, k + 1, d1);  // plane k + 1 is complete
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        d1[q][c] = d0[q][c];
        d0[q][c] = 0.0f;
        w1[q][c] = w0[q][c];
      }
  }
  flush<C>(P, X, R, 0, d1);
  if (real) store8(P.du_in + r * 8, ds);
}

template <int DT>
struct Launch {
  template <class LY>
  struct With {
    static void run(const Params& P, cudaStream_t st) {
      const unsigned blocks = (unsigned)((P.N + THREADS - 1) / THREADS);
      adjoint_kernel<DT, LY><<<blocks, THREADS, 0, st>>>(P);
    }
  };
};

}  // namespace

// u_in, du_out, du_in: (N, 8) f32, 16-byte aligned; order: (N,) int64;
// table: (cells, row_len) f32 (dtype 0) or bf16 (dtype 1), row_len =
// (K+1) C; dtable: (cells, row_len) f32 the table's cotangent is added
// into, aligned to 4 * vec_width(C) bytes, or null; scratch: (K, N, 8)
// f32. Returns cudaGetLastError(), or cudaErrorInvalidValue for another
// dtype.
extern "C" int march_adjoint(const float* u_in, const float* du_out,
                             float* du_in, const long long* order,
                             const void* table, float* dtable, float* scratch,
                             long long N, int row_len, int K, int dtype,
                             int na, int nb, float oa, float ob, float inva,
                             float invb, float h, int inv_brems,
                             int phaseshift, int B_on, float atten_sign,
                             void* stream) {
  if (dtype != F32 && dtype != BF16) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  Params P;
  P.u_in = u_in; P.du_out = du_out; P.du_in = du_in; P.order = order;
  P.table = (const unsigned char*)table; P.dtable = dtable;
  P.scratch = scratch; P.N = N; P.row_len = row_len; P.K = K;
  P.na = na; P.nb = nb; P.oa = oa; P.ob = ob; P.inva = inva; P.invb = invb;
  P.h = h; P.atten_sign = atten_sign;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == F32)
    layouts::with_layout<Launch<F32>::With>(inv_brems, phaseshift, B_on, P,
                                            st);
  else
    layouts::with_layout<Launch<BF16>::With>(inv_brems, phaseshift, B_on, P,
                                             st);
  return (int)cudaGetLastError();
}
