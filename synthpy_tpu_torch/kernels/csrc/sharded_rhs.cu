// K18: the RK4 stage of the grid-sharded time tracer.
//
// Replaces the per-device program of the JAX package's grid-sharded time
// tracer, the local_fn of make_gridsharded_tracer (synthpy_tpu/parallel/
// mesh.py:178-196) over _rhs_gridsharded (:123-163). Shard g holds the
// x-rows [lo, lo + nloc) of the channels-last (nx, ny, nz, C) f32 grid,
// lo = g * nloc, and the first x-row of its right neighbour (the halo). A
// stage of the JAX program gathers each shard's owned queries, adds the
// shards' values over the grid axis (psum) and makes the derivative and
// the stage's update from the sum.
//
// One entry point, stage_gather, runs on each device once a stage. A
// thread owns a ray and
// 1. finishes stage j from the summed channel values of stage j: the
//    9-component derivative (time_rhs::derivative, _rhs's reassembly), the
//    running sum ((k1 + 2 k2) + 2 k3) + k4, the next stage state s + c k
//    and, after the fourth stage, s + (dt / 6) sum;
// 2. at the new stage state, finds the owner of its query among the
//    shards this device holds and writes the owner's trilinear value (the
//    local grid: x-rows plus the halo, its x origin moved to origin_x +
//    lo / inv_x as mesh.py:144 moves it) as the device's (C, N) partial.
// A query is owned when its global fractional x-index tx = (x - origin_x)
// * inv_x lies in [lo, lo + nloc), the last shard's interval closed at
// nx - 1 (mesh.py:137-142), so it has at most one owner. The first launch
// of a trace only gathers (at s), the last only updates: 4 n_steps + 1
// launches a device. Between two launches the caller adds the devices'
// partials over the grid line in shard order (parallel/mesh.py line_sum);
// when one device holds the whole line there is nothing to add.
//
// The psum's rounding: the JAX sum over G shards is the owner's value
// plus G - 1 zeros (+0.0), which turns -0.0 into +0.0 and leaves every
// other value, NaN included, as it is; a query without an owner sums to
// +0.0. A device holding more than one shard adds +0.0 to its partial, so
// that the partial carries what the shard-order sum of its shards gives.
//
// Arithmetic follows the compiled JAX program as K5 does (time_rhs.cuh):
// the corner sum and each s + c k contracted to fused multiply-adds, every
// other operation rounded on its own (--fmad=false). Emulating the JAX
// program on the CPU with these contractions reproduces it bit for bit.
//
// What bounds it on the H100: by count, bytes. A step's four stages read
// the step's start state four times, the stage state three times and the
// running sum three times, write the stage state three times, the sum
// three times and the start state once (the step's result, which is also
// the next stage state), and write the partial and read it back summed
// once a stage (C floats each): 4 (153 + 8C) bytes a ray, 153 + 8C a stage,
// beside the grid nodes the queries touch, against ~60 + 15C operations.
// The kernel moves no more: stage 0 takes its stage state from s (the
// last stage left them equal) and stage 3 writes s alone. The design: one
// launch a stage and device (the first design's five launches on one card,
// four gathers and the update, and the psum's three adds, wrote and read
// G partials of N x C floats and strided 9-wide rows: 0.289 ms of device
// time a stage on the 1 M-ray check trace on an H100, 0.065 ms since,
// PERF.md); the shard table (each shard's pointers, origin, interval) is a
// kernel parameter (constant memory), filled once a trace by
// sharded_trace_fill and selected by unrolled compares, so one build
// serves 1 to MAX_SHARDS shards a device; the state, stage state, sum and
// partial are columns (9, N) and (C, N), so a warp's loads and stores are
// coalesced; the caller hands the rays over ordered by entry cell, so that
// a warp's gathers share grid rows.

#include "time_rhs.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAX_SHARDS = 8;

// A trace's launch constants on one device, filled once a trace on the
// host by sharded_trace_fill, its one writer.
struct Trace {
  const float* values[MAX_SHARDS];  // shard g's (nloc, ny, nz, C) x-rows
  const float* halo[MAX_SHARDS];    // its (ny, nz, C) halo row
  float* s;      // (9, N) the step's start state (the result at the end)
  float* t;      // (9, N) the stage state
  float* acc;    // (9, N) the running sum of the k's
  float* part;   // (C, N) the device's partial at the stage state
  long long N;
  float ox[MAX_SHARDS];   // shard g's local x origin
  float lo[MAX_SHARDS];   // its interval [lo, hi) of global x-index
  float hi[MAX_SHARDS];
  int last[MAX_SHARDS];   // the interval closed at nx - 1
  float oy, oz;           // the y and z origin
  float ix, iy, iz;       // inverse spacings
  float gox;              // the global x origin, for ownership
  float nx_last;          // nx - 1
  float dt, hh, h6, atten_sign;
  int n_shards, nloc, ny, nz;
  int inv_brems, phaseshift, B_on;
};

// C channels of shard (values, halo, ox)'s grid at pos (0 outside the local
// box), in time_rhs::trilinear's arithmetic with x-row nloc read from the
// halo.
template <int C>
__device__ __forceinline__ void trilinear_halo(const Trace& T,
                                               const float* values,
                                               const float* halo, float ox,
                                               const float pos[3],
                                               float out[C]) {
  const float tx = (pos[0] - ox) * T.ix;
  const float ty = (pos[1] - T.oy) * T.iy;
  const float tz = (pos[2] - T.oz) * T.iz;
  const bool inside = tx >= 0.0f && tx <= (float)T.nloc && ty >= 0.0f &&
                      ty <= (float)(T.ny - 1) && tz >= 0.0f &&
                      tz <= (float)(T.nz - 1);
  if (!inside) {
#pragma unroll
    for (int c = 0; c < C; ++c) out[c] = 0.0f;
    return;
  }
  const float fx0 = fminf(floorf(tx), (float)(T.nloc - 1));
  const float fy0 = fminf(floorf(ty), (float)(T.ny - 2));
  const float fz0 = fminf(floorf(tz), (float)(T.nz - 2));
  const float fx = time_rhs::clip01(tx - fx0),
              fy = time_rhs::clip01(ty - fy0),
              fz = time_rhs::clip01(tz - fz0);
  const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
  const long long sy = (long long)T.nz * C;
  const long long sx = (long long)T.ny * sy;
  const long long yz = (long long)fy0 * sy + (long long)fz0 * C;
  const float* b = values + (long long)fx0 * sx + yz;
  const float* b1 = (int)fx0 + 1 < T.nloc ? b + sx : halo + yz;
  const float w[8] = {gx * gy * gz, gx * gy * fz, gx * fy * gz, gx * fy * fz,
                      fx * gy * gz, fx * gy * fz, fx * fy * gz, fx * fy * fz};
  const float* q[8] = {b,       b + C,       b + sy,       b + sy + C,
                       b1,      b1 + C,      b1 + sy,      b1 + sy + C};
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float acc = __fmaf_rn(w[0], __ldg(q[0] + c), w[1] * __ldg(q[1] + c));
#pragma unroll
    for (int k = 2; k < 8; ++k) acc = __fmaf_rn(w[k], __ldg(q[k] + c), acc);
    out[c] = acc;
  }
}

// stage: 0-3 finishes that stage from the summed values vin, -1 nothing;
// gather: write the partial at the (new) stage state.
template <class LY>
__global__ void __launch_bounds__(THREADS)
    stage_gather_kernel(const Trace T, const float* vin, int stage,
                        int gather) {
  constexpr int C = LY::C;
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= T.N) return;
  const long long N = T.N;
  // stage 0 and the trace's first gather start from s: the stage state
  // equals it there, and stage 3 writes s alone
  const float* tin = stage > 0 ? T.t : T.s;
  float t[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) t[q] = tin[q * N + i];
  if (stage >= 0) {
    float s[9], v[C], k[9], a[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) s[q] = stage > 0 ? T.s[q * N + i] : t[q];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = vin[c * N + i];
    time_rhs::derivative<LY>(t, v, T.atten_sign, k);
    if (stage == 0) {
#pragma unroll
      for (int q = 0; q < 9; ++q) a[q] = k[q];
    } else {
#pragma unroll
      for (int q = 0; q < 9; ++q)
        a[q] = stage == 3 ? time_rhs::rk4_last_add<LY>(q, T.acc[q * N + i],
                                                       k, v, t, T.atten_sign)
                          : T.acc[q * N + i] + 2.0f * k[q];
    }
    if (stage == 3) {
      // the step's result; the sum is not read again
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        t[q] = __fmaf_rn(T.h6, a[q], s[q]);
        T.s[q * N + i] = t[q];
      }
    } else {
      const float c = stage == 2 ? T.dt : T.hh;
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        T.acc[q * N + i] = a[q];
        t[q] = __fmaf_rn(c, k[q], s[q]);
        T.t[q * N + i] = t[q];
      }
    }
  }
  if (!gather) return;
  // the owner among this device's shards (at most one), by unrolled
  // compares on the parameter table
  const float txg = (t[0] - T.gox) * T.ix;
  const float* values = nullptr;
  const float* halo = nullptr;
  float ox = 0.0f;
#pragma unroll
  for (int g = 0; g < MAX_SHARDS; ++g) {
    if (g < T.n_shards && txg >= T.lo[g] &&
        (txg < T.hi[g] || (T.last[g] && txg <= T.nx_last))) {
      values = T.values[g];
      halo = T.halo[g];
      ox = T.ox[g];
    }
  }
  float v[C];
  if (values != nullptr) {
    trilinear_halo<C>(T, values, halo, ox, t, v);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = 0.0f;
  }
  if (T.n_shards > 1) {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = __fadd_rn(v[c], 0.0f);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) T.part[c * N + i] = v[c];
}

template <class LY>
struct Launch {
  static void run(const Trace& T, const float* vin, int stage, int gather,
                  cudaStream_t st) {
    const unsigned blocks = (unsigned)((T.N + THREADS - 1) / THREADS);
    stage_gather_kernel<LY><<<blocks, THREADS, 0, st>>>(T, vin, stage,
                                                        gather);
  }
};

}  // namespace

// The bytes of a Trace, and the shards a device may hold on one line.
extern "C" int sharded_trace_bytes() { return (int)sizeof(Trace); }
extern "C" int sharded_max_shards() { return MAX_SHARDS; }

// Fill the host Trace at out (sharded_trace_bytes() bytes) for a trace of
// N rays over the device's n_shards shards, in shard order: values[g] and
// halo[g] the shard's (nloc, ny, nz, C) x-rows and (ny, nz, C) halo row,
// ox[g] its local x origin, lo[g] its first global x-row, last[g] 1 for
// the line's last shard; s, t, acc the (9, N) columns, part the (C, N)
// partial; origin, inv_spacing the global grid's (3 floats each), nx its
// x-rows; dt, hh, h6 the step constants. Returns 0, or
// cudaErrorInvalidValue when n_shards is not 1 to MAX_SHARDS.
extern "C" int sharded_trace_fill(void* out, int n_shards,
                                  const void* const* values,
                                  const void* const* halo, const float* ox,
                                  const int* lo, const int* last, void* s,
                                  void* t, void* acc, void* part,
                                  long long N, int nloc, int ny, int nz,
                                  int nx, const float* origin,
                                  const float* inv_spacing, float dt,
                                  float hh, float h6, float atten_sign,
                                  int inv_brems, int phaseshift, int B_on) {
  if (n_shards < 1 || n_shards > MAX_SHARDS)
    return (int)cudaErrorInvalidValue;
  Trace T = {};
  for (int g = 0; g < n_shards; ++g) {
    T.values[g] = static_cast<const float*>(values[g]);
    T.halo[g] = static_cast<const float*>(halo[g]);
    T.ox[g] = ox[g];
    T.lo[g] = (float)lo[g];
    T.hi[g] = (float)(lo[g] + nloc);
    T.last[g] = last[g];
  }
  T.s = static_cast<float*>(s);
  T.t = static_cast<float*>(t);
  T.acc = static_cast<float*>(acc);
  T.part = static_cast<float*>(part);
  T.N = N;
  T.oy = origin[1];
  T.oz = origin[2];
  T.ix = inv_spacing[0];
  T.iy = inv_spacing[1];
  T.iz = inv_spacing[2];
  T.gox = origin[0];
  T.nx_last = (float)(nx - 1);
  T.dt = dt;
  T.hh = hh;
  T.h6 = h6;
  T.atten_sign = atten_sign;
  T.n_shards = n_shards;
  T.nloc = nloc;
  T.ny = ny;
  T.nz = nz;
  T.inv_brems = inv_brems;
  T.phaseshift = phaseshift;
  T.B_on = B_on;
  *static_cast<Trace*>(out) = T;
  return 0;
}

// trace: a host Trace filled by sharded_trace_fill; vin: the (C, N) f32 summed values at the stage
// state (read when stage >= 0; it may be the trace's own partial); stage:
// 0-3, or -1 to gather only; gather: 0 for the trace's last launch.
// Returns cudaGetLastError().
extern "C" int stage_gather(const void* trace, const float* vin, int stage,
                            int gather, void* stream) {
  const Trace& T = *static_cast<const Trace*>(trace);
  if (T.N == 0) return 0;
  if (T.n_shards < 1 || T.n_shards > MAX_SHARDS || stage < -1 || stage > 3)
    return (int)cudaErrorInvalidValue;
  layouts::with_layout<Launch>(T.inv_brems, T.phaseshift, T.B_on, T, vin,
                               stage, gather, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
