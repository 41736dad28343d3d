// K18: the RK4 stage of the grid-sharded time tracer.
//
// Replaces the per-device program of the JAX package's grid-sharded time
// tracer, the local_fn of make_gridsharded_tracer (synthpy_tpu/parallel/
// mesh.py:178-196) over _rhs_gridsharded (:123-163). Shard g holds the
// x-rows [lo, lo + nloc) of the channels-last (nx, ny, nz, C) f32 grid,
// lo = g * nloc, and the first x-row of its right neighbour (the halo). At
// every RK4 stage:
// - gather_owned (this shard): a query is owned when its global fractional
//   x-index tx = (x - origin_x) * inv_x lies in [lo, lo + nloc), the last
//   shard's interval closed at nx - 1 (mesh.py:137-142); an owned query
//   gets the trilinear value of the local grid (x-rows plus the halo, its
//   x origin moved to origin_x + lo / inv_x, as mesh.py:144 moves it), an
//   unowned one zeros;
// - the caller adds the shards' values in shard order (the psum over the
//   grid axis; a query has at most one owner, so the sum is its value);
// - rk4_stage (once per ray block): the 9-component derivative from the
//   summed values (_rhs's reassembly) and the stage's part of the update,
//   k1 .. k4 into a running sum ((k1 + 2 k2) + 2 k3) + k4, the next stage
//   state s + c k and, after the fourth stage, s + (dt / 6) sum.
// Arithmetic follows the compiled JAX program as K5 does (time_rhs.cuh):
// the corner sum and each s + c k contracted to fused multiply-adds, every
// other operation rounded on its own (--fmad=false). Emulating the JAX
// program on the CPU with these contractions reproduces it bit for bit.
//
// What bounds it on the H100: by count, bytes. gather_owned reads a
// query's position and writes C values, and an owned query reads 8C grid
// values; rk4_stage reads and writes the 9-column state, stage state and
// running sum once a stage. A stage of G shards moves about
// (12 + 4C) G + 8C (G - 1) (the psum) + 120 + 4C bytes a ray, against
// ~60 + 15C operations for the one owned gather. On the 512^3 mesh path
// (1 M rays, 4 shards on one H100 80GB HBM3, 700 W; chip_smoke's
// mesh_path) a stage's five launches took 0.25 ms, 30% of that bound.
// The design: one thread a ray in each entry point, the trilinear of
// time_rhs.cuh with the halo in place of x-row nloc, and derivative() of
// time_rhs.cuh for the reassembly. The wrapper hands the rays over ordered
// by entry cell, so that a warp's gathers share grid rows.

#include "time_rhs.cuh"

namespace {

constexpr int THREADS = 128;

struct Slab {
  const float* values;  // (nloc, ny, nz, C) the shard's x-rows
  const float* halo;    // (ny, nz, C) x-row lo + nloc (cyclic)
  int nloc, ny, nz;
  float ox, oy, oz;     // the local grid's origin
  float ix, iy, iz;     // inverse spacings
  float gox;            // the global x origin, for ownership
  int lo, nx_global, last;
};

// C channels of the shard's grid at pos (0 outside the local box), in
// time_rhs::trilinear's arithmetic with x-row nloc read from the halo.
template <int C>
__device__ __forceinline__ void trilinear_halo(const Slab& S,
                                               const float pos[3],
                                               float out[C]) {
  const float tx = (pos[0] - S.ox) * S.ix;
  const float ty = (pos[1] - S.oy) * S.iy;
  const float tz = (pos[2] - S.oz) * S.iz;
  const bool inside = tx >= 0.0f && tx <= (float)S.nloc && ty >= 0.0f &&
                      ty <= (float)(S.ny - 1) && tz >= 0.0f &&
                      tz <= (float)(S.nz - 1);
  if (!inside) {
#pragma unroll
    for (int c = 0; c < C; ++c) out[c] = 0.0f;
    return;
  }
  const float fx0 = fminf(floorf(tx), (float)(S.nloc - 1));
  const float fy0 = fminf(floorf(ty), (float)(S.ny - 2));
  const float fz0 = fminf(floorf(tz), (float)(S.nz - 2));
  const float fx = time_rhs::clip01(tx - fx0),
              fy = time_rhs::clip01(ty - fy0),
              fz = time_rhs::clip01(tz - fz0);
  const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
  const long long sy = (long long)S.nz * C;
  const long long sx = (long long)S.ny * sy;
  const long long yz = (long long)fy0 * sy + (long long)fz0 * C;
  const float* b = S.values + (long long)fx0 * sx + yz;
  const float* b1 = (int)fx0 + 1 < S.nloc ? b + sx : S.halo + yz;
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

template <class LY>
__global__ void __launch_bounds__(THREADS)
    gather_kernel(const float* t, float* vals, long long N, Slab S) {
  constexpr int C = LY::C;
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= N) return;
  const float pos[3] = {t[i * 9], t[i * 9 + 1], t[i * 9 + 2]};
  const float txg = (pos[0] - S.gox) * S.ix;
  const bool owned =
      txg >= (float)S.lo &&
      (txg < (float)(S.lo + S.nloc) ||
       (S.last && txg <= (float)(S.nx_global - 1)));
  float v[C];
  if (owned) {
    trilinear_halo<C>(S, pos, v);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = 0.0f;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) vals[i * C + c] = v[c];
}

struct Stage {
  float* s;            // (N, 9) the step's start state (the result at 3)
  float* t;            // (N, 9) the stage state: in, then the next one
  float* acc;          // (N, 9) the running sum of the k's
  const float* vals;   // (N, C) the summed channel values at t
  long long N;
  int stage;           // 0 .. 3
  float dt, hh, h6, atten_sign;
};

template <class LY>
__global__ void __launch_bounds__(THREADS) stage_kernel(Stage P) {
  constexpr int C = LY::C;
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= P.N) return;
  float s[9], t[9], v[C], k[9], a[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    s[q] = P.s[i * 9 + q];
    t[q] = P.t[i * 9 + q];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = P.vals[i * C + c];
  time_rhs::derivative<LY>(t, v, P.atten_sign, k);
  if (P.stage == 0) {
#pragma unroll
    for (int q = 0; q < 9; ++q) a[q] = k[q];
  } else {
#pragma unroll
    for (int q = 0; q < 9; ++q)
      a[q] = P.stage == 3 ? P.acc[i * 9 + q] + k[q]
                          : P.acc[i * 9 + q] + 2.0f * k[q];
  }
#pragma unroll
  for (int q = 0; q < 9; ++q) P.acc[i * 9 + q] = a[q];
  if (P.stage == 3) {
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const float x = __fmaf_rn(P.h6, a[q], s[q]);
      P.s[i * 9 + q] = x;
      P.t[i * 9 + q] = x;
    }
    return;
  }
  const float c = P.stage == 2 ? P.dt : P.hh;
#pragma unroll
  for (int q = 0; q < 9; ++q) P.t[i * 9 + q] = __fmaf_rn(c, k[q], s[q]);
}

template <class LY>
struct LaunchGather {
  static void run(const float* t, float* vals, long long N, const Slab& S,
                  cudaStream_t st) {
    const unsigned blocks = (unsigned)((N + THREADS - 1) / THREADS);
    gather_kernel<LY><<<blocks, THREADS, 0, st>>>(t, vals, N, S);
  }
};

template <class LY>
struct LaunchStage {
  static void run(const Stage& P, cudaStream_t st) {
    const unsigned blocks = (unsigned)((P.N + THREADS - 1) / THREADS);
    stage_kernel<LY><<<blocks, THREADS, 0, st>>>(P);
  }
};

}  // namespace

// t: (N, 9) f32 stage states; vals: (N, C) f32 out; values: the shard's
// (nloc, ny, nz, C) f32 x-rows, halo: the (ny, nz, C) x-row lo + nloc
// (the first row of shard 0 for the last shard, as JAX's cyclic ppermute
// gives it; a query at the last shard's edge reads it with weight 0).
// Returns cudaGetLastError().
extern "C" int gather_owned(const float* t, float* vals, long long N,
                            const float* values, const float* halo,
                            int nloc, int ny, int nz, float ox, float oy,
                            float oz, float ix, float iy, float iz,
                            float gox, int lo, int nx_global, int last,
                            int inv_brems, int phaseshift, int B_on,
                            void* stream) {
  if (N == 0) return 0;
  const Slab S{values, halo, nloc, ny, nz, ox, oy, oz, ix, iy, iz, gox,
               lo, nx_global, last};
  layouts::with_layout<LaunchGather>(inv_brems, phaseshift, B_on, t, vals,
                                     N, S, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// s, t, acc: (N, 9) f32, updated in place; vals: (N, C) f32. Every stage
// writes the running sum; stages 0-2 the next stage state, stage 3 the
// step's result into s and t. Returns cudaGetLastError().
extern "C" int rk4_stage(float* s, float* t, float* acc, const float* vals,
                         long long N, int stage, float dt, float hh,
                         float h6, float atten_sign, int inv_brems,
                         int phaseshift, int B_on, void* stream) {
  if (N == 0) return 0;
  const Stage P{s, t, acc, vals, N, stage, dt, hh, h6, atten_sign};
  layouts::with_layout<LaunchStage>(inv_brems, phaseshift, B_on, P,
                                    (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
