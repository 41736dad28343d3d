// K7: the pack-free analytic march.
//
// Replaces the JAX device program _trace_analytic_jit (synthpy_tpu/tracer/
// analytic.py:110) and its channel values _analytic_vals (:51): the permuted
// (N, 8) ray state marched n_steps steps of h along the probing axis from p0
// with rk2 (midpoint) or rk4, the field evaluated in closed form at every
// stage instead of read from a pack. The JAX program differentiates the
// field's closure with jax.grad; a kernel cannot run a closure, so each
// closed form of the test_* fields (fields/forms.py: null, slab, linear_cos,
// exponential_cos, lens, liner, and test_B's linear Bz) is written out here
// with its gradient, in the operation order of its plain PyTorch version
// (kernels/analytic.march_plain, on the same forms.ClosedForm constants).
// The channels are the pack's (fields/domain.py TracePack): the three
// accelerations scale * d(ne)/dx_i permuted to (a, b, p), then omega (n - 1)
// and Verdet ne B (permuted) when the layout has them, all zero outside the
// domain box; the right-hand side is K4's (zscan_rhs.cuh). Inverse
// bremsstrahlung needs Te and Z closures, which no closed form carries: the
// wrapper refuses it.
//
// What bounds it on the H100: instruction issue. A ray reads and writes its
// 32-byte state once; each stage does ~40-110 float32 operations (the form,
// one exp, pow or sin/cos pair; the channels; the right-hand side with its
// IEEE division 1 / vp) for 2 (rk2) or 4 (rk4) stages a step, and only the
// stage updates issue two operations (a fused multiply-add) in one
// instruction, so the 67 TFLOP/s bound (PERF.md) is out of reach; the
// issue floor is the SASS instructions a step over one a lane a clock.
// The design: one thread owns a ray and keeps its 8 columns in registers for
// all n_steps, so the state goes to memory once each way; there are no
// gathers, so the rays need no order. Each form, layout and probing axis p
// is a template instance, with (a, b) the other two axes in order (the
// wrapper permutes the columns of another order), so the position and the
// accelerations need no selects. The probing coordinate is the same for
// every ray of a step: its box test at p, p + h/2 and p + h is made once a
// step, not once a stage.
//
// Dead columns: in a layout without inverse bremsstrahlung (every K7
// layout), phase shift or B, the slope of column 5, 6 or 7 is the constant
// +0.0, and no other column reads it. Each step then sets it to
// fma(c, +0.0, u) = u + z, z = c * 0 exact: +-0.0 with c's sign for finite
// c (c = h for rk2, h * f32(1/6) for rk4, of h's sign), NaN for infinite
// or NaN c; the stage states of the column are never read. Adding z is
// idempotent: x + z = x for x not a zero or NaN; +-0.0 + z is z's zero
// (+0.0 + -0.0 = +0.0), which z leaves; NaN stays NaN (one canonical NaN on
// the card). So after n_steps >= 1 steps the column is fma(c, +0.0, u0), and
// the kernel makes that one update after the loop (u0 after 0 steps); the
// card test holds it on -0.0, +0.0, NaN and inf start values and negative
// h against march_plain's step-by-step update.
//
// Rounding follows the compiled JAX step, as found on the CPU: XLA contracts
// each stage state and update u + c k into a fused multiply-add, folds h / 6
// into h * f32(1/6) (the wrapper passes h6), and computes the probing
// coordinate p = p0 + i h of step i as fma(i, h, p0), so the box test of the
// last rk4 stage at p + h rounds as in JAX. Built with --fmad=false: every
// other product and sum is rounded on its own, as in the plain version.

#include <cuda_runtime.h>

#include "zscan_rhs.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int N_FORM_PARAMS = 7;

enum Form { NUL = 0, SLAB, LINEAR_COS, EXP_COS, LENS, LINER, N_FORMS };

struct Params {
  const float* u_in;
  float* u_out;
  long long N;
  int n_steps, rk4;
  float p0, h, hh, h6;  // h, 0.5 h and h * f32(1/6) in float32
  float atten_sign, scale, omega, coef, verdet;
  float lo[3], hi[3];
  float c[N_FORM_PARAMS];  // the ne form's constants (forms.ClosedForm)
  float bm, br;            // test_B: Bz = (Bmax x) / ext as Bmax, 1 / ext
};

// The transverse axes (a, b) of probing axis p, in order.
template <int PA>
struct Axes {
  static constexpr int A = PA == 0 ? 1 : 0;
  static constexpr int B = PA == 2 ? 1 : 2;
};

// Whether column q of the state has a slope that is not constantly +0.0.
template <class LY>
__device__ __forceinline__ constexpr bool live(int q) {
  return q < 5 || (q == 6 && LY::phaseshift) || (q == 7 && LY::B_on);
}

// ne and its gradient at (x, y, z) (forms.ClosedForm.__call__ and .grad).
template <int F>
__device__ __forceinline__ void form(const float* c, float x, float y,
                                     float z, float& ne, float& gx,
                                     float& gy, float& gz) {
  gx = 0.0f;
  gy = 0.0f;
  gz = 0.0f;
  if constexpr (F == NUL) {
    ne = 0.0f;
  } else if constexpr (F == SLAB) {  // c: ne_0, s, 1/ext, d/dx
    ne = c[0] * (1.0f + (c[1] * x) * c[2]);
    gx = c[3];
  } else if constexpr (F == LINEAR_COS) {  // ne_0, s1, 1/ext, s2, 2pi, 1/Ly
    const float w = (c[4] * y) * c[5];
    const float X = 1.0f + (c[1] * x) * c[2];
    const float Y = 1.0f + c[3] * cosf(w);
    ne = (c[0] * X) * Y;
    gx = ((Y * c[0]) * c[2]) * c[1];
    gy = ((((c[0] * X) * c[3]) * -sinf(w)) * c[5]) * c[4];
  } else if constexpr (F == EXP_COS) {  // ne_0, 1/s, 2pi, 1/Ly, ln 10
    const float P = powf(10.0f, x * c[1]);
    const float w = (c[2] * y) * c[3];
    const float Y = 1.0f + cosf(w);
    ne = (c[0] * P) * Y;
    gx = ((Y * c[0]) * (P * c[4])) * c[1];
    gy = (((c[0] * P) * -sinf(w)) * c[3]) * c[2];
  } else {  // LENS (x, y) and LINER (x, z); c: ne_0, 1/LR^2
    const float t = F == LINER ? z : y;
    ne = c[0] * expf(-(x * x + t * t) * c[1]);
    const float gq = -(ne * c[1]);
    gx = gq * (2.0f * x);
    if constexpr (F == LINER) gz = gq * (2.0f * t);
    else gy = gq * (2.0f * t);
  }
}

// du/dp at (u, p): the closed-form channel values, then _cols_rhs. p_in:
// the probing coordinate's box test, made once a step.
template <int F, class LY, int PA>
__device__ __forceinline__ void deriv(const Params& P, const float u[8],
                                      float p, bool p_in, float d[8]) {
  constexpr int A = Axes<PA>::A, B = Axes<PA>::B;
  float xyz[3];
  xyz[A] = u[0];
  xyz[B] = u[1];
  xyz[PA] = p;
  float v[LY::C];
  const bool inside = p_in && u[0] >= P.lo[A] && u[0] <= P.hi[A] &&
                      u[1] >= P.lo[B] && u[1] <= P.hi[B];
  if (inside) {
    float ne, g[3];
    form<F>(P.c, xyz[0], xyz[1], xyz[2], ne, g[0], g[1], g[2]);
    v[0] = P.scale * g[A];
    v[1] = P.scale * g[B];
    v[2] = P.scale * g[PA];
    if constexpr (LY::phaseshift) {  // constants.n_refrac, double where
      const float arg = 1.0f - P.coef * ne;
      const float n = arg > 0.0f ? sqrtf(arg) : 0.0f;
      v[LY::PI] = P.omega * (n - 1.0f);
    }
    if constexpr (LY::B_on) {  // Verdet ne (0, 0, Bz), permuted
      const float w = P.verdet * ne;
      const float bz = (P.bm * xyz[0]) * P.br;
      const float W[3] = {w * 0.0f, w * 0.0f, w * bz};
      v[LY::FI] = W[A];
      v[LY::FI + 1] = W[B];
      v[LY::FI + 2] = W[PA];
    }
  } else {
#pragma unroll
    for (int q = 0; q < LY::C; ++q) v[q] = 0.0f;
  }
  zscan_rhs::cols_rhs<LY>(v, u, P.atten_sign, d);
}

__device__ __forceinline__ bool in_box(const Params& P, int ax, float p) {
  return p >= P.lo[ax] && p <= P.hi[ax];
}

template <int F, class LY, int PA>
__global__ void __launch_bounds__(THREADS) analytic_kernel(Params P) {
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= P.N) return;
  float u[8];
  {
    const float4* src = reinterpret_cast<const float4*>(P.u_in + i * 8);
    const float4 a = src[0], b = src[1];
    u[0] = a.x; u[1] = a.y; u[2] = a.z; u[3] = a.w;
    u[4] = b.x; u[5] = b.y; u[6] = b.z; u[7] = b.w;
  }
  for (int step = 0; step < P.n_steps; ++step) {
    // the probing coordinate and its box tests: uniform over the rays
    const float p = __fmaf_rn((float)step, P.h, P.p0);
    const float ph = p + P.hh;
    const bool in0 = in_box(P, PA, p), inh = in_box(P, PA, ph);
    float k1[8], k2[8], t[8];
    deriv<F, LY, PA>(P, u, p, in0, k1);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (live<LY>(q)) t[q] = __fmaf_rn(P.hh, k1[q], u[q]);
    deriv<F, LY, PA>(P, t, ph, inh, k2);
    if (!P.rk4) {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (live<LY>(q)) u[q] = __fmaf_rn(P.h, k2[q], u[q]);
      continue;
    }
    const float p1 = p + P.h;
    float k3[8], k4[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (live<LY>(q)) t[q] = __fmaf_rn(P.hh, k2[q], u[q]);
    deriv<F, LY, PA>(P, t, ph, inh, k3);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (live<LY>(q)) t[q] = __fmaf_rn(P.h, k3[q], u[q]);
    deriv<F, LY, PA>(P, t, p1, in_box(P, PA, p1), k4);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (live<LY>(q))
        u[q] = __fmaf_rn(P.h6, k1[q] + 2.0f * k2[q] + 2.0f * k3[q] + k4[q],
                         u[q]);
  }
  // the dead columns' n_steps updates, made once (see the header)
  if (P.n_steps > 0) {
    const float c = P.rk4 ? P.h6 : P.h;
#pragma unroll
    for (int q = 5; q < 8; ++q)
      if (!live<LY>(q)) u[q] = __fmaf_rn(c, 0.0f, u[q]);
  }
  float4* dst = reinterpret_cast<float4*>(P.u_out + i * 8);
  dst[0] = make_float4(u[0], u[1], u[2], u[3]);
  dst[1] = make_float4(u[4], u[5], u[6], u[7]);
}

template <int F, int PA>
struct ByForm {
  template <class LY>
  struct Launch {
    static void run(const Params& P, cudaStream_t st) {
      // the wrapper refuses inverse bremsstrahlung: no instance for it
      if constexpr (!LY::inv_brems) {
        const unsigned blocks = (unsigned)((P.N + THREADS - 1) / THREADS);
        analytic_kernel<F, LY, PA><<<blocks, THREADS, 0, st>>>(P);
      }
    }
  };
};

template <int F, int PA>
void launch_axis(const Params& P, int phaseshift, int B_on, cudaStream_t st) {
  layouts::with_layout<ByForm<F, PA>::template Launch>(0, phaseshift, B_on,
                                                       P, st);
}

template <int F>
void launch(const Params& P, int p_ax, int phaseshift, int B_on,
            cudaStream_t st) {
  switch (p_ax) {
    case 0: launch_axis<F, 0>(P, phaseshift, B_on, st); break;
    case 1: launch_axis<F, 1>(P, phaseshift, B_on, st); break;
    default: launch_axis<F, 2>(P, phaseshift, B_on, st); break;
  }
}

}  // namespace

// u_in, u_out: (N, 8) f32 permuted states, 16-byte aligned, their (a, b)
// columns the transverse axes of p_ax in order; f: the float constants in
// the order p0, h, hh, h6, atten_sign, scale, omega, coef, verdet, lo[3],
// hi[3], the form's 7, Bmax, 1/ext (host memory). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unknown form or axis.
extern "C" int analytic_march(const float* u_in, float* u_out, long long N,
                              int form, int n_steps, int rk4, int p_ax,
                              int phaseshift, int B_on, const float* f,
                              void* stream) {
  if (form < 0 || form >= N_FORMS || p_ax < 0 || p_ax > 2)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  Params P;
  P.u_in = u_in; P.u_out = u_out; P.N = N; P.n_steps = n_steps;
  P.rk4 = rk4;
  P.p0 = f[0]; P.h = f[1]; P.hh = f[2]; P.h6 = f[3];
  P.atten_sign = f[4]; P.scale = f[5]; P.omega = f[6]; P.coef = f[7];
  P.verdet = f[8];
  for (int q = 0; q < 3; ++q) {
    P.lo[q] = f[9 + q];
    P.hi[q] = f[12 + q];
  }
  for (int q = 0; q < N_FORM_PARAMS; ++q) P.c[q] = f[15 + q];
  P.bm = f[22]; P.br = f[23];
  cudaStream_t st = (cudaStream_t)stream;
  switch (form) {
    case NUL: launch<NUL>(P, p_ax, phaseshift, B_on, st); break;
    case SLAB: launch<SLAB>(P, p_ax, phaseshift, B_on, st); break;
    case LINEAR_COS: launch<LINEAR_COS>(P, p_ax, phaseshift, B_on, st); break;
    case EXP_COS: launch<EXP_COS>(P, p_ax, phaseshift, B_on, st); break;
    case LENS: launch<LENS>(P, p_ax, phaseshift, B_on, st); break;
    default: launch<LINER>(P, p_ax, phaseshift, B_on, st); break;
  }
  return (int)cudaGetLastError();
}
