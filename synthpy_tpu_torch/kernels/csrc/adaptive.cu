// K6: one Dormand-Prince 5(4) step of the adaptive tracer.
//
// Replaces the body of the JAX device program trace_rk45 (synthpy_tpu/
// tracer/adaptive.py:144-176, under the while_loop of :181): one shared
// step dt for the whole bundle, six new stages per ray (the first comes
// from the previous step's seventh, FSAL), the fifth-order candidate s5,
// the embedded error, and the step-size controller; plus the initial FSAL
// stage k1 = f(s0) (:180).
//
// What bounds it on the H100: by count, bytes (a step reads and writes two
// 9-wide rows a ray, state and FSAL stage), but in practice the latency of
// six dependent trilinear gathers a ray (time_rhs.cuh: 8 corners x C
// channels, each stage's position from the last stage's values) at the
// occupancy the step's registers allow, and the controller between steps.
// PERF.md has the bound and the time. The design:
// - step_kernel: one thread a ray, all seven stages in registers; it reads
//   state and FSAL stage from buffer `cur` and writes the candidate s5 and
//   its k7 to buffer 1 - cur, so an accepted step costs no copy: the
//   controller flips `cur`. A block stages its rows through shared memory,
//   so that a warp reads and writes 32 consecutive floats: a thread's own
//   9-wide row is 36 bytes from its neighbour's, so each of its 18 direct
//   stores touched 32 sectors a warp, partial sectors that L2 had to merge
//   (staging took a step from 0.21 to 0.11 ms; PERF.md). Each block writes
//   its partial sum of (err / scale)^2, summed in float64 in a fixed tree
//   order, and folds the min / max of its candidates' probing coordinate
//   into the controller's state by atomics on order-preserving keys (exact
//   in any order; a NaN is flagged).
// - controller_kernel, one block: sums the partials in float64 (never
//   atomics: a sum that varies from run to run could flip an accept) in one
//   fixed order, SUM_LANES strided runs, each loading SUM_UNROLL partials at
//   once and adding them in order, then a tree over the runs; then applies
//   the JAX controller: err_norm = sqrt(mean) rounded to float32, accept =
//   err_norm <= 1, the clipped 0.9 err^-0.2 factor with its isfinite rule,
//   t, the counts, and the next step's dt = min(dt_next, local cap, t_end -
//   t), the local cap from the per-plane peak acceleration over the planes
//   the bundle can reach (:121-130), from the kept min / max of the
//   accepted state. It sets `done` when t reaches t_end or the step budget
//   is spent; later step launches then return at once, so the host may
//   launch steps in batches and read the flag between batches. (Running the
//   controller in the step's last block, found by an atomic ticket after a
//   fence in every block, measured 17% slower a step than this second
//   kernel; PERF.md.)
// - The wrapper keeps the rows in entry-cell order for the whole trace (it
//   permutes the state once before and once after), so a warp's rays share
//   grid rows and its state rows are neighbours in every step. (Reading
//   the rows through the order instead, scattered, made a step at 1 M rays
//   11x its 65,536-ray time; PERF.md.)
// Built with --fmad=false: the stage arithmetic repeats the plain PyTorch
// version's operation for operation, with a fused multiply-add exactly
// where XLA's CPU compiler fuses one in the JAX step (each x + c k of the
// stage states, candidate and error, the scale, and the corner sum of
// time_rhs.cuh).

#include "time_rhs.cuh"

#include <math.h>

namespace {

using time_rhs::Grid;

constexpr int THREADS = 128;
// The controller sums the blocks' partials as SUM_LANES strided runs, then
// by a tree over the runs: the order of the one-block controller kernel of
// 256 threads that the step launched before, kept so that every sum, and
// so every accept and step size, is the same bit for bit.
constexpr int SUM_LANES = 256;
constexpr int SUM_UNROLL = 8;   // partials a run loads at once

struct Ctrl {
  float t, dt_carry, dt_step, pmin, pmax, err_norm;
  int n_acc, n_rej, cur, done, accepted;
  // the min / max of the last launch's rays' probing coordinate as ordered
  // keys (0: none yet) and whether one was NaN; the controller resets them
  unsigned lo_key, hi_key;
  int any_nan, pad[2];
};

struct Params {
  float* S;              // (2, N, 9): state, buffers cur and 1 - cur
  float* K1;             // (2, N, 9): FSAL stage
  long long N;
  Grid G;
  float atten_sign;
  double* part_err;      // (n_blocks,) the blocks' error sums
  int n_blocks;
  Ctrl* ctrl;
  const float* plane_amax;  // (n_p,) or null for the global cap
  int n_p, p_axis, max_steps;
  float plane_o, cell_p, c_light, t_end, cell_cap, cap_num, dt_max;
  float rtol;
  float atol_col[9];     // atol * column scale
  float a[21];           // tableau rows 1..6, row-major lower triangle
  float b5[7], e[7];     // fifth-order weights, b5 - b4
};

// A block's shared scratch for its partials and, in the controller, the
// reductions.
struct Scratch {
  float rows[THREADS * 9];  // the block's state or FSAL rows
  double sum[SUM_LANES];
  float m[THREADS];
  unsigned lo[THREADS / 32], hi[THREADS / 32];
  int nan[THREADS / 32];
  Ctrl c;
};

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// s[ax] for ax = 0, 1 or 2, by selects
__device__ __forceinline__ float axis_of(const float s[9], int ax) {
  return ax == 0 ? s[0] : ax == 1 ? s[1] : s[2];
}

// An unsigned key of a float that orders as the float does (-0 below +0),
// above 0 for every float, and back.
__device__ __forceinline__ unsigned key_of(float x) {
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : b | 0x80000000u;
}
__device__ __forceinline__ float float_of(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? k & 0x7fffffffu : ~k);
}

// The warp's span of the probing coordinate p (has: the thread holds a
// ray) into shared memory: the min as the max of inverted keys, the max,
// whether one was NaN.
__device__ __forceinline__ void span_of(Scratch& sh, bool has, float p) {
  const bool nan = has && p != p;
  const bool use = has && !nan;
  const unsigned lo = __reduce_max_sync(0xffffffffu, use ? ~key_of(p) : 0u);
  const unsigned hi = __reduce_max_sync(0xffffffffu, use ? key_of(p) : 0u);
  const bool any = __any_sync(0xffffffffu, nan);
  if ((threadIdx.x & 31) == 0) {
    sh.lo[threadIdx.x >> 5] = lo;
    sh.hi[threadIdx.x >> 5] = hi;
    sh.nan[threadIdx.x >> 5] = any;
  }
}

// Block reduction of the error sum in a fixed tree order; thread 0 writes
// the block's partial and folds the warps' spans into the launch's by
// atomics (exact in any order).
__device__ __forceinline__ void block_partials(const Params& P, Scratch& sh,
                                               double sum) {
  const int t = threadIdx.x;
  sh.sum[t] = sum;
  __syncthreads();
  for (int w = THREADS / 2; w > 0; w >>= 1) {
    if (t < w) sh.sum[t] = sh.sum[t] + sh.sum[t + w];
    __syncthreads();
  }
  if (t == 0) {
    P.part_err[blockIdx.x] = sh.sum[0];
    unsigned lo = 0u, hi = 0u;
    int nan = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      lo = max(lo, sh.lo[w]);
      hi = max(hi, sh.hi[w]);
      nan |= sh.nan[w];
    }
    if (lo) atomicMax(&P.ctrl->lo_key, lo);
    if (hi) atomicMax(&P.ctrl->hi_key, hi);
    if (nan) atomicOr(&P.ctrl->any_nan, 1);
  }
}

// The controller state into shared memory.
__device__ __forceinline__ void load_ctrl(const Params& P, Scratch& sh) {
  if (threadIdx.x == 0) sh.c = *P.ctrl;
  __syncthreads();
}

// The partials' float64 sum in the controller's fixed order. A run loads
// SUM_UNROLL partials at once and adds them in order.
__device__ double sum_partials(const Params& P, Scratch& sh) {
  const int t = threadIdx.x;
  for (int v = t; v < SUM_LANES; v += THREADS) {
    double acc = 0.0;
    for (int j0 = v; j0 < P.n_blocks; j0 += SUM_LANES * SUM_UNROLL) {
      double x[SUM_UNROLL];
#pragma unroll
      for (int u = 0; u < SUM_UNROLL; ++u) {
        const int j = j0 + u * SUM_LANES;
        x[u] = j < P.n_blocks ? P.part_err[j] : 0.0;
      }
#pragma unroll
      for (int u = 0; u < SUM_UNROLL; ++u)
        if (j0 + u * SUM_LANES < P.n_blocks) acc = acc + x[u];
    }
    sh.sum[v] = acc;
  }
  __syncthreads();
  for (int w = SUM_LANES / 2; w > 0; w >>= 1) {
    for (int v = t; v < w; v += THREADS) sh.sum[v] = sh.sum[v] + sh.sum[v + w];
    __syncthreads();
  }
  return sh.sum[0];
}

// The launch's span into (pmin, pmax) of the controller state.
__device__ __forceinline__ void take_span(Ctrl& c) {
  const float nan = __int_as_float(0x7fc00000);
  c.pmin = c.any_nan ? nan : float_of(~c.lo_key);
  c.pmax = c.any_nan ? nan : float_of(c.hi_key);
}

// min(min(dt_carry, local cap), t_end - t) for the step about to start, or
// done (the while_loop's cond, adaptive.py:140-142). The plane maximum is
// exact in any order. Then the state is written back, the span's keys
// reset.
__device__ void prepare_step(const Params& P, Scratch& sh) {
  Ctrl& c = sh.c;
  const int t = threadIdx.x;
  const bool done = !(c.t < P.t_end && c.n_acc + c.n_rej < P.max_steps);
  float cap = P.dt_max;
  if (!done && P.plane_amax) {
    const float lo = c.pmin - P.cell_p - P.c_light * c.dt_carry;
    const float hi = c.pmax + P.cell_p + P.c_light * c.dt_carry;
    float m = 0.0f;
    for (int j = t; j < P.n_p; j += THREADS) {
      const float pp = P.plane_o + (float)j * P.cell_p;
      m = fmaxf(m, (pp >= lo && pp <= hi) ? P.plane_amax[j] : 0.0f);
    }
    sh.m[t] = m;
    __syncthreads();
    for (int w = THREADS / 2; w > 0; w >>= 1) {
      if (t < w) sh.m[t] = fmaxf(sh.m[t], sh.m[t + w]);
      __syncthreads();
    }
    const float a = sh.m[0];
    const float inf = __int_as_float(0x7f800000);
    cap = fmaxf(P.cell_cap, a > 0.0f ? P.cap_num / (a * P.t_end) : inf);
  }
  if (t == 0) {
    c.done = done;
    if (!done) c.dt_step = fminf(fminf(c.dt_carry, cap), P.t_end - c.t);
    c.lo_key = c.hi_key = 0u;
    c.any_nan = 0;
    *P.ctrl = c;
  }
}

// After init_kernel: the span of s0's probing coordinate and the first
// step's dt from dt0 (one block).
__global__ void __launch_bounds__(THREADS) init_controller(Params P,
                                                           float dt0) {
  __shared__ Scratch sh;
  load_ctrl(P, sh);
  if (threadIdx.x == 0) {
    Ctrl& c = sh.c;
    take_span(c);
    c.t = 0.0f;
    c.dt_carry = dt0;
  }
  __syncthreads();
  prepare_step(P, sh);
}

// After step_kernel (one block): the error norm, accept or reject, the
// next step's dt.
__global__ void __launch_bounds__(THREADS) controller_kernel(Params P) {
  __shared__ Scratch sh;
  if (P.ctrl->done) return;
  load_ctrl(P, sh);
  const double total = sum_partials(P, sh);
  if (threadIdx.x == 0) {
    Ctrl& c = sh.c;
    const float err_norm = (float)sqrt(total / (double)(P.N * 9));
    const bool accept = err_norm <= 1.0f;
    const float f = 0.9f * powf(err_norm, -0.2f);
    const float factor = f != f ? 0.2f : fminf(fmaxf(f, 0.2f), 5.0f);
    const float dt = c.dt_step;
    c.err_norm = err_norm;
    c.accepted = accept;
    if (accept) {
      take_span(c);
      c.t = c.t + dt;
      c.cur = 1 - c.cur;
      c.n_acc += 1;
    } else {
      c.n_rej += 1;
    }
    c.dt_carry = dt * factor;
  }
  __syncthreads();
  prepare_step(P, sh);
}

// k1 = f(s0) into K1[0] and the span of s0's probing coordinate (S[0]
// holds s0).
template <class LY>
__global__ void __launch_bounds__(THREADS) init_kernel(Params P) {
  __shared__ Scratch sh;
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  float p = 0.0f;
  if (i < P.N) {
    float s[9], k[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) s[q] = P.S[i * 9 + q];
    time_rhs::rhs<LY>(P.G, s, P.atten_sign, k);
#pragma unroll
    for (int q = 0; q < 9; ++q) P.K1[i * 9 + q] = k[q];
    p = axis_of(s, P.p_axis);
  }
  span_of(sh, i < P.N, p);
  block_partials(P, sh, 0.0);
}

// The block's n <= THREADS rows of 9 floats from src into sh.rows (a warp
// reads 32 consecutive floats), or from sh.rows to dst (likewise written),
// each between two barriers.
__device__ __forceinline__ void load_rows(Scratch& sh, const float* src,
                                          int n) {
  __syncthreads();
  for (int e = threadIdx.x; e < n * 9; e += THREADS) sh.rows[e] = src[e];
  __syncthreads();
}
__device__ __forceinline__ void store_rows(float* dst, const Scratch& sh,
                                           int n) {
  __syncthreads();
  for (int e = threadIdx.x; e < n * 9; e += THREADS) dst[e] = sh.rows[e];
}

template <class LY>
__global__ void __launch_bounds__(THREADS) step_kernel(Params P) {
  __shared__ Scratch sh;
  const Ctrl* ctrl = P.ctrl;
  if (ctrl->done) return;
  const int cur = ctrl->cur;
  const float dt = ctrl->dt_step;
  const int t = threadIdx.x;
  const long long b0 = blockIdx.x * (long long)THREADS;
  const int n = (int)min((long long)THREADS, P.N - b0);
  const bool has = t < n;
  const long long in = ((long long)cur * P.N + b0) * 9;
  const long long out = ((long long)(1 - cur) * P.N + b0) * 9;
  float s[9], k[7][9];
  load_rows(sh, P.S + in, n);
#pragma unroll
  for (int q = 0; q < 9; ++q) s[q] = has ? sh.rows[t * 9 + q] : 0.0f;
  load_rows(sh, P.K1 + in, n);
#pragma unroll
  for (int q = 0; q < 9; ++q) k[0][q] = has ? sh.rows[t * 9 + q] : 0.0f;
  double sum = 0.0;
  float p = 0.0f;
  float s5[9];
  if (has) {
    int ai = 0;
#pragma unroll
    for (int st = 1; st < 7; ++st) {
      float si[9];
#pragma unroll
      for (int q = 0; q < 9; ++q) si[q] = s[q];
#pragma unroll
      for (int j = 0; j < st; ++j) {
        const float c = dt * P.a[ai + j];
#pragma unroll
        for (int q = 0; q < 9; ++q) si[q] = __fmaf_rn(c, k[j][q], si[q]);
      }
      ai += st;
      time_rhs::rhs<LY>(P.G, si, P.atten_sign, k[st]);
    }
    float err[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      s5[q] = s[q];
      err[q] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      const float cb = dt * P.b5[j], ce = dt * P.e[j];
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        s5[q] = __fmaf_rn(cb, k[j][q], s5[q]);
        err[q] = __fmaf_rn(ce, k[j][q], err[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const float scale = __fmaf_rn(
          P.rtol, nan_max(fabsf(s[q]), fabsf(s5[q])), P.atol_col[q]);
      const float x = err[q] / scale;
      sum = sum + (double)(x * x);
    }
    p = axis_of(s5, P.p_axis);
  }
  // the candidate and its k7 out through shared memory (a warp writes 32
  // consecutive floats)
  __syncthreads();
  if (has) {
#pragma unroll
    for (int q = 0; q < 9; ++q) sh.rows[t * 9 + q] = s5[q];
  }
  store_rows(P.S + out, sh, n);
  __syncthreads();
  if (has) {
#pragma unroll
    for (int q = 0; q < 9; ++q) sh.rows[t * 9 + q] = k[6][q];
  }
  store_rows(P.K1 + out, sh, n);
  span_of(sh, has, p);
  block_partials(P, sh, sum);
}

template <class LY>
struct InitLaunch {
  static void run(const Params& P, float dt0, cudaStream_t st) {
    init_kernel<LY><<<P.n_blocks, THREADS, 0, st>>>(P);
    init_controller<<<1, THREADS, 0, st>>>(P, dt0);
  }
};

template <class LY>
struct StepLaunch {
  static void run(const Params& P, cudaStream_t st) {
    step_kernel<LY><<<P.n_blocks, THREADS, 0, st>>>(P);
    controller_kernel<<<1, THREADS, 0, st>>>(P);
  }
};

// The launch parameters, copied by value into every launch.
Params make_params(float* S, float* K1, long long N,
                   const float* values, const int* dims, const float* geo,
                   double* part_err, void* ctrl,
                   const float* plane_amax, const int* ints,
                   const float* consts) {
  Params P;
  P.S = S; P.K1 = K1; P.N = N;
  P.G = Grid{values, dims[0], dims[1], dims[2], geo[0], geo[1], geo[2],
             geo[3], geo[4], geo[5]};
  P.part_err = part_err;
  P.n_blocks = (int)((N + THREADS - 1) / THREADS);
  P.ctrl = (Ctrl*)ctrl;
  P.plane_amax = plane_amax;
  P.n_p = ints[0]; P.p_axis = ints[1]; P.max_steps = ints[2];
  // consts: atten_sign, plane_o, cell_p, c_light, t_end, cell_cap, cap_num,
  // dt_max, rtol, atol_col[9], a[21], b5[7], e[7]
  int k = 0;
  P.atten_sign = consts[k++]; P.plane_o = consts[k++];
  P.cell_p = consts[k++]; P.c_light = consts[k++]; P.t_end = consts[k++];
  P.cell_cap = consts[k++]; P.cap_num = consts[k++]; P.dt_max = consts[k++];
  P.rtol = consts[k++];
  for (int q = 0; q < 9; ++q) P.atol_col[q] = consts[k++];
  for (int q = 0; q < 21; ++q) P.a[q] = consts[k++];
  for (int q = 0; q < 7; ++q) P.b5[q] = consts[k++];
  for (int q = 0; q < 7; ++q) P.e[q] = consts[k++];
  return P;
}

}  // namespace

// Shared arguments of both entry points. S, K1: (2, N, 9) f32, S[0] = s0;
// values: (nx, ny, nz, C) f32; dims: {nx, ny, nz} and geo: {origin,
// inverse spacing} in host memory; part_err: (n,) f64 scratch, n >=
// ceil(N / THREADS); ctrl: 64 bytes of device memory (Ctrl), zero before
// rk45_init; plane_amax:
// (n_p,) f32 or null; ints: {n_p, p_axis, max_steps}; consts: the float
// table of make_params; layout: the three physics switches.
#define RK45_ARGS                                                           \
  float *S, float *K1, long long N,                                         \
      const float *values, const int *dims, const float *geo,               \
      double *part_err, void *ctrl, const float *plane_amax,                \
      const int *ints, const float *consts, int inv_brems, int phaseshift,  \
      int B_on
#define RK45_PARAMS                                                   \
  make_params(S, K1, N, values, dims, geo, part_err, ctrl,                \
              plane_amax, ints, consts)

// k1 = f(s0), the span of s0's probing coordinate, and the first step's dt
// from dt0: two device kernels. Returns cudaGetLastError().
extern "C" int rk45_init(RK45_ARGS, float dt0, void* stream) {
  if (N == 0) return (int)cudaErrorInvalidValue;
  const Params P = RK45_PARAMS;
  time_rhs::with_layout<InitLaunch>(inv_brems, phaseshift, B_on, P, dt0,
                                    (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// One adaptive step: the step and its controller, two device kernels (no-ops
// once ctrl is done). Returns cudaGetLastError().
extern "C" int rk45_step(RK45_ARGS, void* stream) {
  if (N == 0) return (int)cudaErrorInvalidValue;
  const Params P = RK45_PARAMS;
  time_rhs::with_layout<StepLaunch>(inv_brems, phaseshift, B_on, P,
                                    (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
