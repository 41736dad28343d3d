// K6: one Dormand-Prince 5(4) step of the adaptive tracer.
//
// Replaces the body of the JAX device program trace_rk45 (synthpy_tpu/
// tracer/adaptive.py:144-176, under the while_loop of :181): one shared
// step dt for the whole bundle, six new stages per ray (the first comes
// from the previous step's seventh, FSAL), the fifth-order candidate s5,
// the embedded error, and the step-size controller; plus the initial FSAL
// stage k1 = f(s0) (:180).
//
// What bounds it on the H100: by count, operations. A ray and step evaluate
// the time-domain right-hand side six times (the trilinear gather of C
// channels, time_rhs.cuh) and ~250 float32 operations of stage states,
// candidate and error, and read and write two 9-wide rows (state and FSAL
// stage); the controller is one block. PERF.md has the bound and the time.
// The design:
// - step_kernel: one thread a ray, all seven stages in registers; it reads
//   state and FSAL stage from buffer `cur` and writes the candidate s5 and
//   its k7 to buffer 1 - cur, so an accepted step costs no copy: the
//   controller flips `cur`. Each block writes its partial sum of
//   (err / scale)^2, summed in float64 in a fixed tree order, and the
//   min / max of the candidates' probing coordinate (exact in any order).
// - finalize_kernel: one block sums the partials in a fixed order in
//   float64 (never atomics: a sum that varies from run to run could flip an
//   accept), then applies the JAX controller: err_norm = sqrt(mean) rounded
//   to float32, accept = err_norm <= 1, the clipped 0.9 err^-0.2 factor
//   with its isfinite rule, t, the counts, and the next step's dt = min(
//   dt_next, local cap, t_end - t), the local cap from the per-plane peak
//   acceleration over the planes the bundle can reach (:121-130), read from
//   the kept min / max of the accepted state. It sets `done` when t reaches
//   t_end or the step budget is spent; later step launches then return at
//   once, so the host may launch steps in batches and read the flag
//   between batches.
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
constexpr int FIN_THREADS = 256;

struct Ctrl {
  float t, dt_carry, dt_step, pmin, pmax, err_norm;
  int n_acc, n_rej, cur, done, accepted, pad;
};

struct Params {
  float* S;              // (2, N, 9): state, buffers cur and 1 - cur
  float* K1;             // (2, N, 9): FSAL stage
  long long N;
  Grid G;
  float atten_sign;
  double* part_err;      // (n_blocks,)
  float* part_p;         // (n_blocks, 2): min, max of the probing coordinate
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

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// Block reduction of (sum, min, max) in a fixed tree order; thread 0 writes
// the block's partials.
template <int NT>
__device__ __forceinline__ void block_partials(const Params& P, double sum,
                                               float lo, float hi) {
  __shared__ double ssum[NT];
  __shared__ float slo[NT], shi[NT];
  const int t = threadIdx.x;
  ssum[t] = sum;
  slo[t] = lo;
  shi[t] = hi;
  __syncthreads();
  for (int w = NT / 2; w > 0; w >>= 1) {
    if (t < w) {
      ssum[t] = ssum[t] + ssum[t + w];
      slo[t] = nan_min(slo[t], slo[t + w]);
      shi[t] = nan_max(shi[t], shi[t + w]);
    }
    __syncthreads();
  }
  if (t == 0) {
    P.part_err[blockIdx.x] = ssum[0];
    P.part_p[2 * blockIdx.x] = slo[0];
    P.part_p[2 * blockIdx.x + 1] = shi[0];
  }
}

// k1 = f(s0) into K1[0], and the partial min / max of s0's probing
// coordinate (S[0] holds s0).
template <class LY>
__global__ void __launch_bounds__(THREADS) init_kernel(Params P) {
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  float lo = __int_as_float(0x7f800000), hi = -lo;
  if (i < P.N) {
    float s[9], k[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) s[q] = P.S[i * 9 + q];
    time_rhs::rhs<LY>(P.G, s, P.atten_sign, k);
#pragma unroll
    for (int q = 0; q < 9; ++q) P.K1[i * 9 + q] = k[q];
    lo = hi = s[P.p_axis];
  }
  block_partials<THREADS>(P, 0.0, lo, hi);
}

template <class LY>
__global__ void __launch_bounds__(THREADS) step_kernel(Params P) {
  const Ctrl* ctrl = P.ctrl;
  if (ctrl->done) return;
  const int cur = ctrl->cur;
  const float dt = ctrl->dt_step;
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  double sum = 0.0;
  float lo = __int_as_float(0x7f800000), hi = -lo;
  if (i < P.N) {
    const long long in = ((long long)cur * P.N + i) * 9;
    const long long out = ((long long)(1 - cur) * P.N + i) * 9;
    float s[9], k[7][9];
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      s[q] = P.S[in + q];
      k[0][q] = P.K1[in + q];
    }
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
    float s5[9], err[9];
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
      P.S[out + q] = s5[q];
      P.K1[out + q] = k[6][q];
    }
    lo = hi = s5[P.p_axis];
  }
  block_partials<THREADS>(P, sum, lo, hi);
}

// min(min(dt_carry, local cap), t_end - t) for the step about to start, or
// done (the while_loop's cond, adaptive.py:140-142).
__device__ void prepare_step(const Params& P, Ctrl& c, float* sa) {
  const int t = threadIdx.x;
  const bool done = !(c.t < P.t_end && c.n_acc + c.n_rej < P.max_steps);
  float cap = P.dt_max;
  if (!done && P.plane_amax) {
    const float lo = c.pmin - P.cell_p - P.c_light * c.dt_carry;
    const float hi = c.pmax + P.cell_p + P.c_light * c.dt_carry;
    float m = 0.0f;
    for (int j = t; j < P.n_p; j += FIN_THREADS) {
      const float pp = P.plane_o + (float)j * P.cell_p;
      m = fmaxf(m, (pp >= lo && pp <= hi) ? P.plane_amax[j] : 0.0f);
    }
    sa[t] = m;
    __syncthreads();
    for (int w = FIN_THREADS / 2; w > 0; w >>= 1) {
      if (t < w) sa[t] = fmaxf(sa[t], sa[t + w]);
      __syncthreads();
    }
    const float a = sa[0];
    const float inf = __int_as_float(0x7f800000);
    cap = fmaxf(P.cell_cap, a > 0.0f ? P.cap_num / (a * P.t_end) : inf);
  }
  if (t == 0) {
    c.done = done;
    if (!done) c.dt_step = fminf(fminf(c.dt_carry, cap), P.t_end - c.t);
  }
}

// One block: min / max of the partials into (pmin, pmax) of c.
__device__ void reduce_p(const Params& P, Ctrl& c, float* sa, float* sb) {
  const int t = threadIdx.x;
  float lo = __int_as_float(0x7f800000), hi = -lo;
  for (int j = t; j < P.n_blocks; j += FIN_THREADS) {
    lo = nan_min(lo, P.part_p[2 * j]);
    hi = nan_max(hi, P.part_p[2 * j + 1]);
  }
  sa[t] = lo;
  sb[t] = hi;
  __syncthreads();
  for (int w = FIN_THREADS / 2; w > 0; w >>= 1) {
    if (t < w) {
      sa[t] = nan_min(sa[t], sa[t + w]);
      sb[t] = nan_max(sb[t], sb[t + w]);
    }
    __syncthreads();
  }
  if (t == 0) {
    c.pmin = sa[0];
    c.pmax = sb[0];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(FIN_THREADS) init_finalize(Params P,
                                                             float dt0) {
  __shared__ float sa[FIN_THREADS], sb[FIN_THREADS];
  __shared__ Ctrl c;
  if (threadIdx.x == 0) {
    c = Ctrl{};
    c.t = 0.0f;
    c.dt_carry = dt0;
  }
  __syncthreads();
  reduce_p(P, c, sa, sb);
  prepare_step(P, c, sa);
  __syncthreads();
  if (threadIdx.x == 0) *P.ctrl = c;
}

__global__ void __launch_bounds__(FIN_THREADS) finalize_kernel(Params P) {
  __shared__ double ssum[FIN_THREADS];
  __shared__ float sa[FIN_THREADS], sb[FIN_THREADS];
  __shared__ Ctrl c;
  if (P.ctrl->done) return;
  const int t = threadIdx.x;
  if (t == 0) c = *P.ctrl;
  double acc = 0.0;
  for (int j = t; j < P.n_blocks; j += FIN_THREADS) acc = acc + P.part_err[j];
  ssum[t] = acc;
  __syncthreads();
  for (int w = FIN_THREADS / 2; w > 0; w >>= 1) {
    if (t < w) ssum[t] = ssum[t] + ssum[t + w];
    __syncthreads();
  }
  const float err_norm = (float)sqrt(ssum[0] / (double)(P.N * 9));
  const bool accept = err_norm <= 1.0f;
  if (accept) reduce_p(P, c, sa, sb);
  if (t == 0) {
    const float f = 0.9f * powf(err_norm, -0.2f);
    const float factor = f != f ? 0.2f : fminf(fmaxf(f, 0.2f), 5.0f);
    const float dt = c.dt_step;
    c.err_norm = err_norm;
    c.accepted = accept;
    if (accept) {
      c.t = c.t + dt;
      c.cur = 1 - c.cur;
      c.n_acc += 1;
    } else {
      c.n_rej += 1;
    }
    c.dt_carry = dt * factor;
  }
  __syncthreads();
  prepare_step(P, c, sa);
  __syncthreads();
  if (t == 0) *P.ctrl = c;
}

template <class LY>
struct InitLaunch {
  static void run(const Params& P, float dt0, cudaStream_t st) {
    init_kernel<LY><<<P.n_blocks, THREADS, 0, st>>>(P);
    init_finalize<<<1, FIN_THREADS, 0, st>>>(P, dt0);
  }
};

template <class LY>
struct StepLaunch {
  static void run(const Params& P, cudaStream_t st) {
    step_kernel<LY><<<P.n_blocks, THREADS, 0, st>>>(P);
    finalize_kernel<<<1, FIN_THREADS, 0, st>>>(P);
  }
};

// The launch parameters, copied by value into every launch.
Params make_params(float* S, float* K1, long long N,
                   const float* values, const int* dims, const float* geo,
                   double* part_err, float* part_p, void* ctrl,
                   const float* plane_amax, const int* ints,
                   const float* consts) {
  Params P;
  P.S = S; P.K1 = K1; P.N = N;
  P.G = Grid{values, dims[0], dims[1], dims[2], geo[0], geo[1], geo[2],
             geo[3], geo[4], geo[5]};
  P.part_err = part_err; P.part_p = part_p;
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
// inverse spacing} in host memory; part_err:
// (ceil(N/128),) f64 and part_p: (ceil(N/128), 2) f32 scratch; ctrl: 48
// bytes of device memory; plane_amax: (n_p,) f32 or null; ints: {n_p,
// p_axis, max_steps}; consts: the float table of make_params; layout: the
// three physics switches.
#define RK45_ARGS                                                           \
  float *S, float *K1, long long N,                                         \
      const float *values, const int *dims, const float *geo,               \
      double *part_err, float *part_p, void *ctrl, const float *plane_amax, \
      const int *ints, const float *consts, int inv_brems, int phaseshift,  \
      int B_on
#define RK45_PARAMS                                                   \
  make_params(S, K1, N, values, dims, geo, part_err, part_p, ctrl,        \
              plane_amax, ints, consts)

// k1 = f(s0), the span of s0's probing coordinate, and the first step's dt
// from dt0. Returns cudaGetLastError().
extern "C" int rk45_init(RK45_ARGS, float dt0, void* stream) {
  if (N == 0) return (int)cudaErrorInvalidValue;
  const Params P = RK45_PARAMS;
  time_rhs::with_layout<InitLaunch>(inv_brems, phaseshift, B_on, P, dt0,
                                    (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// One adaptive step (a no-op once ctrl is done). Returns cudaGetLastError().
extern "C" int rk45_step(RK45_ARGS, void* stream) {
  if (N == 0) return (int)cudaErrorInvalidValue;
  const Params P = RK45_PARAMS;
  time_rhs::with_layout<StepLaunch>(inv_brems, phaseshift, B_on, P,
                                    (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
