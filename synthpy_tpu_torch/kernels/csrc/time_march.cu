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
// (PERF.md has the bound and the measured time). In practice the corner
// reads held the first design at 21% of that: 8C scalar loads a stage, 96
// a ray-step at C = 3, most of them of the cell the ray has just read.
//
// The design: one thread owns a ray and keeps its 9 columns in registers for
// all n_steps, so no state goes to memory between steps; the grid is read
// through the read-only cache. The wrapper may hand the rays over in an
// order (kernels/time_march.ray_order: by entry cell), so that the rays of
// a warp gather neighbouring grid rows; ray i of the launch is ray order[i]
// of the caller and its result goes back to row order[i]. The order moves
// only where a ray's result is computed, never its arithmetic. Then, on
// K13's template (boris.cu):
//
// - Carried corners (time_rhs::trilinear_carried). A thread keeps the 8 x C
//   corner values of its last cell in registers across stages and steps.
//   The 723 steps cross the 512 z-cells, so a ray changes its z-cell about
//   every 5-6 stages and rarely its x- or y-cell: an unchanged cell reads
//   nothing, a move of one along an axis shifts the carried values and
//   reads the 4 nodes that came in, a jump or the first in-grid stage all
//   8 (profiling.time_walk_model counts them along the plain march).
// - Issue slots, as K13 measured them: each axis shifts under its own
//   test, a node is C single loads at immediate offsets from one of four
//   column pointers, reads are predicated per lane, blocks are 128 threads.
// - Every layout carries: at C = 8, with 143 registers against the first
//   design's 64, the carried march ran in a third of the first design's
//   time on the H100 (PERF.md).
//
// Arithmetic follows the JAX step (k1, s + (0.5 dt) k1, ..., then
// s + (dt/6)(((k1 + 2 k2) + 2 k3) + k4)), operation for operation as the
// plain PyTorch version does it; built with --fmad=false, with a fused
// multiply-add exactly where XLA's CPU compiler fuses one in the JAX step
// (each s + c k, the corner sum of time_rhs.cuh and k4's amplitude term in
// the slope sum, time_rhs::rk4_last_add), so the plain version
// on the CPU is bit-equal to the JAX program and the kernel to the plain
// version. The carried gather blends the same values in the same order.

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
  time_rhs::Carry<LY::C> K;
  for (int step = 0; step < P.n_steps; ++step) {
    float k1[9], k2[9], k3[9], k4[9], t[9];
    time_rhs::rhs_carried<LY>(P.G, K, s, P.atten_sign, k1);
#pragma unroll
    for (int q = 0; q < 9; ++q) t[q] = __fmaf_rn(P.hh, k1[q], s[q]);
    time_rhs::rhs_carried<LY>(P.G, K, t, P.atten_sign, k2);
#pragma unroll
    for (int q = 0; q < 9; ++q) t[q] = __fmaf_rn(P.hh, k2[q], s[q]);
    time_rhs::rhs_carried<LY>(P.G, K, t, P.atten_sign, k3);
#pragma unroll
    for (int q = 0; q < 9; ++q) t[q] = __fmaf_rn(P.dt, k3[q], s[q]);
    float v4[LY::C];
    time_rhs::trilinear_carried<LY::C>(P.G, K, t, v4);
    time_rhs::derivative<LY>(t, v4, P.atten_sign, k4);
#pragma unroll
    for (int q = 0; q < 9; ++q)
      s[q] = __fmaf_rn(P.h6,
                       time_rhs::rk4_last_add<LY>(
                           q, k1[q] + 2.0f * k2[q] + 2.0f * k3[q], k4, v4, t,
                           P.atten_sign),
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
