// K5: the time-domain march.
//
// Replaces the JAX device program trace_rk4 (synthpy_tpu/tracer/
// propagator.py:87): fixed-step RK4 of the (N, 9) ray state over n_steps
// steps of dt, each stage one trilinear gather of the C channels of the
// channels-last (nx, ny, nz, C) f32 grid (_rhs :56 on ops/interp.py:33).
//
// What bounds it on the H100: by count, operations. A ray and step do four
// stages of ~60 + 15C float32 operations (the weights, the 8-corner blend of
// C channels, the right-hand side) and three 9-wide stage states and the
// 9-wide update, and read 8C values from the grid, which it touches along
// the rays' paths only; the state is read and written once. Over the 723
// steps of the 512^3 main path that is ~1.3e12 operations for 4 M rays
// (PERF.md has the bound and the measured time).
// The design: one thread owns a ray and keeps its 9 columns in registers for
// all n_steps, so no state goes to memory between steps; the grid is read
// through the read-only cache. The wrapper may hand the rays over in an
// order (kernels/time_march.ray_order: by entry cell), so that the rays of
// a warp gather neighbouring grid rows; ray i of the launch is ray order[i]
// of the caller and its result goes back to row order[i]. The order moves
// only where a ray's result is computed, never its arithmetic.
// Arithmetic follows the JAX step (k1, s + (0.5 dt) k1, ..., then
// s + (dt/6)(((k1 + 2 k2) + 2 k3) + k4)), operation for operation as the
// plain PyTorch version does it; built with --fmad=false, with a fused
// multiply-add exactly where XLA's CPU compiler fuses one in the JAX step
// (each s + c k, and the corner sum of time_rhs.cuh), so the plain version
// on the CPU is bit-equal to the JAX program and the kernel to the plain
// version.

#include "time_rhs.cuh"

namespace {

using time_rhs::Grid;

constexpr int THREADS = 128;

struct Params {
  const float* s_in;
  float* s_out;
  const long long* order;  // null: ray i is marched i-th
  long long N;
  Grid G;
  int n_steps;
  float dt, hh, h6, atten_sign;  // dt, 0.5*dt and dt/6 in float32
};

template <class LY>
__global__ void __launch_bounds__(THREADS) rk4_kernel(Params P) {
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= P.N) return;
  const long long r = P.order ? P.order[i] : i;
  float s[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) s[q] = P.s_in[r * 9 + q];
  for (int step = 0; step < P.n_steps; ++step) {
    float k1[9], k2[9], k3[9], k4[9], t[9];
    time_rhs::rhs<LY>(P.G, s, P.atten_sign, k1);
#pragma unroll
    for (int q = 0; q < 9; ++q) t[q] = __fmaf_rn(P.hh, k1[q], s[q]);
    time_rhs::rhs<LY>(P.G, t, P.atten_sign, k2);
#pragma unroll
    for (int q = 0; q < 9; ++q) t[q] = __fmaf_rn(P.hh, k2[q], s[q]);
    time_rhs::rhs<LY>(P.G, t, P.atten_sign, k3);
#pragma unroll
    for (int q = 0; q < 9; ++q) t[q] = __fmaf_rn(P.dt, k3[q], s[q]);
    time_rhs::rhs<LY>(P.G, t, P.atten_sign, k4);
#pragma unroll
    for (int q = 0; q < 9; ++q)
      s[q] = __fmaf_rn(P.h6, k1[q] + 2.0f * k2[q] + 2.0f * k3[q] + k4[q],
                       s[q]);
  }
#pragma unroll
  for (int q = 0; q < 9; ++q) P.s_out[r * 9 + q] = s[q];
}

template <class LY>
struct Launch {
  static void run(const Params& P, cudaStream_t st) {
    const unsigned blocks = (unsigned)((P.N + THREADS - 1) / THREADS);
    rk4_kernel<LY><<<blocks, THREADS, 0, st>>>(P);
  }
};

}  // namespace

// s_in, s_out: (N, 9) f32 ray rows; order: (N,) int64 or null; values:
// (nx, ny, nz, C) f32. Returns cudaGetLastError().
extern "C" int time_march(const float* s_in, float* s_out,
                          const long long* order, long long N,
                          const float* values, int nx, int ny, int nz,
                          float ox, float oy, float oz, float ix, float iy,
                          float iz, int n_steps, float dt, float hh, float h6,
                          float atten_sign, int inv_brems, int phaseshift,
                          int B_on, void* stream) {
  if (N == 0) return 0;
  Params P;
  P.s_in = s_in; P.s_out = s_out; P.order = order; P.N = N;
  P.G = Grid{values, nx, ny, nz, ox, oy, oz, ix, iy, iz};
  P.n_steps = n_steps; P.dt = dt; P.hh = hh; P.h6 = h6;
  P.atten_sign = atten_sign;
  time_rhs::with_layout<Launch>(inv_brems, phaseshift, B_on, P,
                                (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
