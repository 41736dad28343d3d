// K1: the segment march.
//
// Replaces the JAX device program march_segment (synthpy_tpu/tracer/zscan.py
// :756), looped over segments by trace_zscan_segments (:1102): per ray and
// segment, freeze the corner cell ia0 = clip(floor(ta), 0, na-2) (:850-854),
// then march the segment's K slabs with rk4, rk2, rk2s2 (2-slab midpoint) or
// rk2s4 (4-slab midpoint), blending the 4 corner rows bilinearly with
// per-stage or per-slab weights (_cols_weights :700), dequantising int8 and
// int4 tables with the per-(segment, plane, channel) scales, and evaluating
// the 8-component right-hand side _cols_rhs (:636).
//
// What bounds it on the H100: the scattered corner reads. Every slab reads 4
// corner rows of 2 planes x C channels (12 bytes each in bf16 at C = 3) at
// data-dependent addresses, a 32-byte sector each; the arithmetic is ~100
// flops a stage, in registers. The design: one thread per ray holds the ray's
// state in registers across all segments and slabs of one launch, so the
// state never goes back to device memory between slabs. Corner values are
// read straight from the table at each slab: the JAX program's hoisted
// (N, (K+1)*C) corner buffer (zscan.py:857-859) exists for the TPU's gather
// engine and would cost 12 KB a ray at 512^3 bf16. Consecutive slabs read
// neighbouring bytes of the same four rows, so L1 and L2 serve most reads
// after the first.
//
// Arithmetic follows the JAX stage order (hoisted z-blend wm = 0.5*(w0+w1),
// weights, blend, right-hand side), operation for operation as the plain
// PyTorch version does it. This file is built with --fmad=false: contracted
// multiply-adds round differently, and over the 512 slabs of a 512^3 march
// that drifts a velocity column by ~1e-5 of its largest value away from the
// plain version. The 2- and 4-slab midpoint steps share one code path
// (midpoint_step), so rk2s2 on a stride-2 pack is bit-identical to rk2s4 on
// the full pack here as it is in the JAX package.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum Dtype { F32 = 0, BF16 = 1, I8 = 2, I4 = 3 };
enum Integrator { RK4 = 0, RK2 = 1, RK2S2 = 2, RK2S4 = 3 };

constexpr int THREADS = 128;

struct Params {
  const float* u_in;
  float* u_out;
  const void* table;
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

// Per-ray, per-segment constants: frozen corner cell and the 4 corner rows.
struct Corners {
  long long row[4];     // element (byte for int4) offsets of rows 00, 01, 10, 11
  const float* sc;      // this segment's (K+1, C) scales, or null
  float ia0f, ib0f;
};

// Channel values of plane k at one corner row, dequantised to f32.
template <int DT, int C>
__device__ __forceinline__ void load_plane(const Params& P, long long row,
                                           const float* sc, int k,
                                           float out[C]) {
  if constexpr (DT == I4) {
    // plane 2j is the low nibble of byte block j, plane 2j+1 the high one
    const uint8_t* t = (const uint8_t*)P.table + row + (long long)(k >> 1) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const unsigned w = t[c];
      const unsigned n = (k & 1) ? (w >> 4) & 15u : w & 15u;
      out[c] = (float)((int)(n ^ 8u) - 8) * sc[k * C + c];
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const long long i = row + (long long)k * C + c;
      float v;
      if constexpr (DT == F32) v = ((const float*)P.table)[i];
      else if constexpr (DT == BF16)
        v = __bfloat162float(((const __nv_bfloat16*)P.table)[i]);
      else v = (float)((const int8_t*)P.table)[i] * sc[k * C + c];
      out[c] = v;
    }
  }
}

template <int DT, int C>
__device__ __forceinline__ void load_corners(const Params& P, const Corners& X,
                                             int k, float v[4][C]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) load_plane<DT, C>(P, X.row[q], X.sc, k, v[q]);
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

// One slab k -> k+1 with rk2 (midpoint) or rk4 (zscan.py:892-939).
template <int DT, class LY>
__device__ void slab_step(const Params& P, const Corners& X, int k, bool rk4,
                          float s[8]) {
  constexpr int C = LY::C;
  float w0[4][C], w1[4][C], wm[4][C];
  load_corners<DT, C>(P, X, k, w0);
  load_corners<DT, C>(P, X, k + 1, w1);
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
    return;
  }
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

// One midpoint step over planes k0 -> k0 + 2*(km - k0) with the midpoint
// plane km read exactly: rk2s2 (km = k0+1, half = h, full = 2h) and rk2s4
// (km = k0+2, half = 2h, full = 4h) (zscan.py:967-1070).
template <int DT, class LY>
__device__ void midpoint_step(const Params& P, const Corners& X, int k0,
                              int km, float half, float full, float s[8]) {
  constexpr int C = LY::C;
  float w0[4][C], wm[4][C];
  load_corners<DT, C>(P, X, k0, w0);
  load_corners<DT, C>(P, X, km, wm);
  float ws[4];
  if (P.slab_weights) slab_weights(P, X, s, ws);
  float k1[8], k2[8], t[8];
  stage<LY>(P, X, s, w0, ws, k1);
  axpy(s, k1, half, t);
  stage<LY>(P, X, t, wm, ws, k2);
#pragma unroll
  for (int q = 0; q < 8; ++q) s[q] = s[q] + full * k2[q];
}

template <int DT, class LY>
__global__ void __launch_bounds__(THREADS) march_kernel(Params P) {
  constexpr int C = LY::C;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= P.N) return;
  float s[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) s[q] = P.u_in[i * 8 + q];
  const int K = P.K;
  const float h = P.h;
  for (int seg = 0; seg < P.n_seg; ++seg) {
    Corners X;
    const float ta = (s[0] - P.oa) * P.inva;
    const float tb = (s[1] - P.ob) * P.invb;
    const int ia0 = (int)fminf(fmaxf(floorf(ta), 0.0f), (float)(P.na - 2));
    const int ib0 = (int)fminf(fmaxf(floorf(tb), 0.0f), (float)(P.nb - 2));
    X.ia0f = (float)ia0;
    X.ib0f = (float)ib0;
    const long long base = (long long)seg * P.cells + (long long)ia0 * P.nb + ib0;
    X.row[0] = base * P.row_len;
    X.row[1] = (base + 1) * P.row_len;
    X.row[2] = (base + P.nb) * P.row_len;
    X.row[3] = (base + P.nb + 1) * P.row_len;
    X.sc = P.scales ? P.scales + (long long)seg * (K + 1) * C : nullptr;
    if (P.integrator == RK2S4) {
      for (int j = 0; j < K / 4; ++j)
        midpoint_step<DT, LY>(P, X, 4 * j, 4 * j + 2, 2.0f * h, 4.0f * h, s);
      for (int k = K - K % 4; k < K; ++k) slab_step<DT, LY>(P, X, k, false, s);
    } else if (P.integrator == RK2S2) {
      for (int j = 0; j < K / 2; ++j)
        midpoint_step<DT, LY>(P, X, 2 * j, 2 * j + 1, h, 2.0f * h, s);
      if (K % 2) slab_step<DT, LY>(P, X, K - 1, false, s);
    } else {
      const bool rk4 = P.integrator == RK4;
      for (int k = 0; k < K; ++k) slab_step<DT, LY>(P, X, k, rk4, s);
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) P.u_out[i * 8 + q] = s[q];
}

template <int DT>
void launch_dtype(const Params& P, int layout, cudaStream_t st) {
  const unsigned blocks = (unsigned)((P.N + THREADS - 1) / THREADS);
  switch (layout) {
    case 0: march_kernel<DT, Layout<0, 0, 0>><<<blocks, THREADS, 0, st>>>(P); break;
    case 1: march_kernel<DT, Layout<1, 0, 0>><<<blocks, THREADS, 0, st>>>(P); break;
    case 2: march_kernel<DT, Layout<0, 1, 0>><<<blocks, THREADS, 0, st>>>(P); break;
    case 3: march_kernel<DT, Layout<1, 1, 0>><<<blocks, THREADS, 0, st>>>(P); break;
    case 4: march_kernel<DT, Layout<0, 0, 1>><<<blocks, THREADS, 0, st>>>(P); break;
    case 5: march_kernel<DT, Layout<1, 0, 1>><<<blocks, THREADS, 0, st>>>(P); break;
    case 6: march_kernel<DT, Layout<0, 1, 1>><<<blocks, THREADS, 0, st>>>(P); break;
    default: march_kernel<DT, Layout<1, 1, 1>><<<blocks, THREADS, 0, st>>>(P); break;
  }
}

}  // namespace

// u_in, u_out: (N, 8) f32 permuted states. table: (n_seg, cells, row_len)
// of f32 / bf16 / int8 values or int4 nibble-pair bytes; scales: (n_seg, K+1,
// C) f32 for the quantised tables, else null. Returns cudaGetLastError().
extern "C" int march_segments(const float* u_in, float* u_out,
                              const void* table, const float* scales,
                              long long N, int n_seg, int cells, int row_len,
                              int K, int dtype, int integrator,
                              int slab_weights, int na, int nb, float oa,
                              float ob, float inva, float invb, float h,
                              int inv_brems, int phaseshift, int B_on,
                              float atten_sign, void* stream) {
  if (N == 0) return 0;
  Params P;
  P.u_in = u_in; P.u_out = u_out; P.table = table; P.scales = scales;
  P.N = N; P.n_seg = n_seg; P.cells = cells; P.row_len = row_len; P.K = K;
  P.integrator = integrator; P.slab_weights = slab_weights;
  P.na = na; P.nb = nb; P.oa = oa; P.ob = ob; P.inva = inva; P.invb = invb;
  P.h = h; P.atten_sign = atten_sign;
  const int layout = inv_brems | (phaseshift << 1) | (B_on << 2);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case F32: launch_dtype<F32>(P, layout, st); break;
    case BF16: launch_dtype<BF16>(P, layout, st); break;
    case I8: launch_dtype<I8>(P, layout, st); break;
    default: launch_dtype<I4>(P, layout, st); break;
  }
  return (int)cudaGetLastError();
}
