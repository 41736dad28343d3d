// K3: the detector, in two forms that share the state read, the
// back-projection and the stage loop.
//
// Replaces two JAX device programs. detect_image, the incoherent form,
// replaces the one that turns the exit state into an image:
// reassemble_state (synthpy_tpu/tracer/zscan.py:64), ray_to_Jonesvector's
// back-projection and arctan angles (tracer/propagator.py:138-160),
// m_to_mm (optics/rtm.py:18), apply_stages' folded 4x4 ABCD stages with
// aperture, stop, rectangle and knife-edge NaN kills (optics/compose.py
// :78), and histogram2d's numpy-rule binning and scatter-add
// (ops/histogram.py:26-66).
// detect_field, the coherent form, replaces the coherent branch of
// synthpy_tpu/pipeline.py:115-123: the Jones vector from amp, phase and pol
// (propagator.py:161-167), the interferometer's tilted reference beam
// (compose.py:123), the stage list with its ("phase",) and ("mark",)
// checkpoints (compose.py:92-104: E times exp(i k |transverse path|)), and
// complex_histogram's field sums (ops/histogram.py:69: x_edges_n - 1
// pixels, digitize - 1, the right edge dropped) into an (ny, nx, C) f32
// accumulator, C = 2 (legacy: Re Jx, Re Jy) or 4 (intensity: Re and Im of
// both); finalize_complex stays in PyTorch.
// The exit states of the z-scan marches share one exit plane p_end; those of
// the time tracer (pipeline.py:140 synth_image) each sit at their own
// probing coordinate, which the kernel then reads per ray (p_ray) in place
// of p_end, as ray_to_Jonesvector reads row p of the (9, N) state.
//
// What bounds it on the H100: by count, bytes. Each ray reads its 32-byte
// (N, 8) exit state (and 4 bytes of weight) and does ~60 flops and 2
// arctans (the coherent form adds 2-5 sin/cos pairs and a square root),
// then adds into a (ny, nx) f32 image (or C of them) that fits in L2.
// Measured at the main path's shapes (4 M rays of a beam that lands on
// ~7,600 bins) the incoherent form runs at about a quarter of the bytes
// bound, and the atomics hold it: without them it takes two fifths of the
// time, as adds to a few thousand hot addresses queue in L2 (PERF.md). The
// design fuses the whole chain into one pass, one thread per ray in the
// caller's order, so no (9, N) or (4, N) intermediate is written; the stage
// list comes in as a kernel parameter (no copy to the device per call) and
// sits in shared memory, and the state row comes in as two 16-byte loads.
// Each kept ray adds once (C times for the field). In the caller's order a
// warp's rays land on ~32 distinct bins, so adding once per (warp, bin)
// (__match_any_sync) saves nothing; it saves a third of the time on states
// stored in the march's entry-cell order (~2 bins a warp), but the march
// writes each ray back to its own row, and reading the states through that
// order, or copying them into it, costs more than the atomics it saves.
// The stage table of up to MAX_OPS stages comes by value and sits in a
// static shared array; a longer one (a user's stage list, which compose
// cannot fold) comes as a device copy (dops), chosen by the wrapper by
// length alone, and is read where it is: every thread reads the same stage
// row, which L1 serves as a broadcast. One template instance of each kernel
// for each, so that the by-value path compiles as it did before long tables
// existed.
// bin_image and bin_field bin bare (N,) rays, the diagnostic classes' and
// ops.histogram's entry points (histogram.py:26-66 histogram2d with
// optional weights, :69 complex_histogram's field sums): the same bin_of /
// pixel_of rules and atomics, without the state read and the stages.
// Built with --fmad=false: every product and sum is rounded as the plain
// PyTorch version rounds it (its complex products written out in real
// arithmetic), so a ray near a bin edge lands in the same bin, counts match
// exactly, and a ray's field is the plain version's; field sums then differ
// only by the order of the atomic adds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int OP_WIDTH = 17;  // kind, then 16 parameters
constexpr int MAX_OPS = 16;   // stages passed by value

struct Ops {
  float v[MAX_OPS * OP_WIDTH];
};

enum Op {
  MATRIX = 0, APERTURE = 1, STOP = 2, RECT = 3, KNIFE = 4, PHASE = 5,
  MARK = 6
};

// numpy-rule bin of v in [lo, hi]: v == hi goes to the last bin; false for
// NaN and out-of-range values
__device__ __forceinline__ bool bin_of(float v, float lo, float hi,
                                       float scale, int n, int& idx) {
  const float f = floorf((v - lo) * scale);
  idx = v == hi ? n - 1 : (int)fminf(fmaxf(f, 0.0f), (float)(n - 1));
  return isfinite(v) && v >= lo && v <= hi;
}

// complex_histogram's pixel of v: floor((v + L/2) / (L/n)) in [0, n), false
// for NaN and out-of-range values
__device__ __forceinline__ bool pixel_of(float v, float half, float d, int n,
                                         int& idx) {
  const float f = floorf((v + half) / d);
  idx = (int)fminf(fmaxf(f, 0.0f), (float)(n - 1));
  return isfinite(v) && f >= 0.0f && f < (float)n;
}

// The RTM ray [x, theta, y, phi] (mm, rad) of one permuted exit state (lo =
// a, b, va, vb; vp) back-projected from p_end to the plane at depth; rows
// 0/2 are (a, b), or (b, a) when probing along y.
__device__ __forceinline__ void exit_ray(float4 lo, float vp, int swap,
                                         float p_end, float depth,
                                         float r[4]) {
  const float pa = swap ? lo.y : lo.x, va = swap ? lo.w : lo.z;
  const float pb = swap ? lo.x : lo.y, vb = swap ? lo.z : lo.w;
  const float t_bp = (p_end - depth) / vp;
  r[0] = (pa - va * t_bp) * 1000.0f;
  r[1] = atanf(va / vp);
  r[2] = (pb - vb * t_bp) * 1000.0f;
  r[3] = atanf(vb / vp);
}

// E (Jx, Jy as re, im pairs) times exp(i k |transverse path|) from the
// checkpoint (m0, m2) to r (compose.advance_phase).
__device__ __forceinline__ void advance_phase(float E[4], const float r[4],
                                              float m0, float m2, float k) {
  const float dx = (r[0] - m0) * 1e-3f, dy = (r[2] - m2) * 1e-3f;
  const float d2 = dx * dx + dy * dy;
  const float kp = k * (d2 > 0.0f ? sqrtf(d2) : 0.0f);
  const float c = cosf(kp), s = sinf(kp);
#pragma unroll
  for (int j = 0; j < 4; j += 2) {
    const float re = E[j], im = E[j + 1];
    E[j] = re * c - im * s;
    E[j + 1] = re * s + im * c;
  }
}

// Run the stage list on r (and, for FIELD, on E with wavenumber k); false
// when a filter stops the ray, which then reaches no bin.
template <bool FIELD>
__device__ __forceinline__ bool run_stages(float r[4], float E[4],
                                           const float* sops, int n_ops,
                                           float k) {
  float m0 = r[0], m2 = r[2];
  for (int o = 0; o < n_ops; ++o) {
    const float* op = sops + o * OP_WIDTH;
    const int kind = (int)op[0];
    const float* p = op + 1;
    if (kind == MATRIX) {
      float out[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        out[q] = p[4 * q] * r[0] + p[4 * q + 1] * r[1] + p[4 * q + 2] * r[2] +
                 p[4 * q + 3] * r[3];
#pragma unroll
      for (int q = 0; q < 4; ++q) r[q] = out[q];
    } else if (kind == APERTURE) {
      if (r[0] * r[0] + r[2] * r[2] > p[0]) return false;
    } else if (kind == STOP) {
      if (r[0] * r[0] + r[2] * r[2] < p[0]) return false;
    } else if (kind == RECT) {
      if (r[0] * r[0] > p[0] && r[2] * r[2] > p[1]) return false;
    } else if (kind == KNIFE) {  // row p[0], direction p[1], offset p[2]
      const float v = r[(int)p[0]];
      if (p[1] > 0.0f ? v > p[2] : v < p[2]) return false;
    } else if constexpr (FIELD) {
      if (kind == PHASE) advance_phase(E, r, m0, m2, k);
      m0 = r[0];  // PHASE and MARK move the checkpoint
      m2 = r[2];
    }
  }
  return true;
}

// A kept ray's field into its pixel: (Re Jx, Re Jy) for n_ch 2, all four
// parts for n_ch 4.
__device__ __forceinline__ void add_field(float* cell, const float E[4],
                                          int n_ch) {
  if (n_ch == 2) {
    atomicAdd(cell, E[0]);
    atomicAdd(cell + 1, E[2]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) atomicAdd(cell + c, E[c]);
  }
}

// A block's stage table: with IN_PLACE the device table where it is, else
// the by-value kernel parameter copied into a static shared array.
template <bool IN_PLACE>
__device__ __forceinline__ const float* stage_table(const Ops& ops,
                                                    const float* dops,
                                                    int n_ops) {
  if constexpr (IN_PLACE) {
    return dops;
  } else {
    __shared__ float sops[MAX_OPS * OP_WIDTH];
    for (int j = threadIdx.x; j < n_ops * OP_WIDTH; j += blockDim.x)
      sops[j] = ops.v[j];
    __syncthreads();
    return sops;
  }
}

// Thread i bins ray i. With p_ray, ray i sits at its own probing
// coordinate p_ray[i] (the time tracer's exit states), else at p_end.
template <bool IN_PLACE>
__global__ void detect_kernel(const float* uf, const float* p_ray,
                              const float* weights, float* H, long long N,
                              int swap, float p_end, float depth,
                              const Ops ops, const float* dops, int n_ops,
                              int nx, int ny, float xlo, float xhi, float xs,
                              float ylo, float yhi, float ys) {
  const float* sops = stage_table<IN_PLACE>(ops, dops, n_ops);
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= N) return;
  const float4* u = reinterpret_cast<const float4*>(uf + i * 8);
  float r[4];
  exit_ray(u[0], u[1].x, swap, p_ray ? p_ray[i] : p_end, depth, r);
  if (!run_stages<false>(r, nullptr, sops, n_ops, 0.0f)) return;
  int ix, iy;
  if (bin_of(r[0], xlo, xhi, xs, nx, ix) && bin_of(r[2], ylo, yhi, ys, ny, iy))
    atomicAdd(H + iy * nx + ix, weights ? weights[i] : 1.0f);
}

// The coherent form: thread i adds ray i's field to its pixel's n_ch sums.
template <bool IN_PLACE>
__global__ void field_kernel(const float* uf, const float* p_ray, float* H,
                             long long N, int swap, float p_end, float depth,
                             const Ops ops, const float* dops, int n_ops,
                             float k, int npx, int npy, float xhalf, float dx,
                             float yhalf, float dy, int n_ch, int ref,
                             float fr, float cr, float sr) {
  const float* sops = stage_table<IN_PLACE>(ops, dops, n_ops);
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= N) return;
  const float4* u = reinterpret_cast<const float4*>(uf + i * 8);
  const float4 hi = u[1];  // vp, amp, phase, pol
  float r[4];
  exit_ray(u[0], hi.x, swap, p_ray ? p_ray[i] : p_end, depth, r);
  // amp e^(i phase) times the polarisation R(pol) y-hat = (-sin, cos)
  const float er = hi.y * cosf(hi.z), ei = hi.y * sinf(hi.z);
  const float sp = -sinf(hi.w), cp = cosf(hi.w);
  float E[4] = {er * sp, ei * sp, er * cp, ei * cp};
  if (ref) {
    const float a = fr * (cr * r[0] + sr * r[2]);
    E[2] = E[2] + cosf(a);
    E[3] = E[3] + sinf(a);
  }
  if (!run_stages<true>(r, E, sops, n_ops, k)) return;
  int ix, iy;
  if (!pixel_of(r[0], xhalf, dx, npx, ix) ||
      !pixel_of(r[2], yhalf, dy, npy, iy))
    return;
  add_field(H + ((long long)iy * npx + ix) * n_ch, E, n_ch);
}

// Bare rays: thread i adds ray i (weight w[i], or 1) to its numpy-rule bin.
__global__ void bin_image_kernel(const float* x, const float* y,
                                 const float* w, float* H, long long N,
                                 int nx, int ny, float xlo, float xhi,
                                 float xs, float ylo, float yhi, float ys) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= N) return;
  int ix, iy;
  if (bin_of(x[i], xlo, xhi, xs, nx, ix) && bin_of(y[i], ylo, yhi, ys, ny, iy))
    atomicAdd(H + iy * nx + ix, w ? w[i] : 1.0f);
}

// Bare rays with their Jones vectors (Ex, Ey interleaved re, im): thread i
// adds ray i's field to its pixel's n_ch sums, as field_kernel does.
__global__ void bin_field_kernel(const float* x, const float* y,
                                 const float2* Ex, const float2* Ey, float* H,
                                 long long N, int npx, int npy, float xhalf,
                                 float dx, float yhalf, float dy, int n_ch) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= N) return;
  int ix, iy;
  if (!pixel_of(x[i], xhalf, dx, npx, ix) ||
      !pixel_of(y[i], yhalf, dy, npy, iy))
    return;
  const float2 ex = Ex[i], ey = Ey[i];
  const float E[4] = {ex.x, ex.y, ey.x, ey.y};
  add_field(H + ((long long)iy * npx + ix) * n_ch, E, n_ch);
}

}  // namespace

// uf: (N, 8) f32 exit states, 16-byte aligned; weights: (N,) f32 or null;
// H: (ny, nx) f32, zeroed; ops: (n_ops, 17) f32 stage table in host
// memory, taken by value when dops is null (n_ops <= MAX_OPS); dops: the
// same table in device memory, or null; p_ray: (N,) f32 probing coordinate of
// each exit state, or null when every ray sits at p_end. Returns
// cudaGetLastError(), or cudaErrorInvalidValue.
extern "C" int detect_image(const float* uf, const float* weights, float* H,
                            long long N, int swap, float p_end, float depth,
                            const float* ops, const float* dops, int n_ops,
                            int nx, int ny, float xlo, float xhi, float xs,
                            float ylo, float yhi, float ys,
                            const float* p_ray, void* stream) {
  if (n_ops < 0 || (n_ops > MAX_OPS && !dops))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  Ops table;
  if (!dops)
    for (int j = 0; j < n_ops * OP_WIDTH; ++j) table.v[j] = ops[j];
  const unsigned blocks = (unsigned)((N + THREADS - 1) / THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (dops)
    detect_kernel<true><<<blocks, THREADS, 0, s>>>(
        uf, p_ray, weights, H, N, swap, p_end, depth, table, dops, n_ops, nx,
        ny, xlo, xhi, xs, ylo, yhi, ys);
  else
    detect_kernel<false><<<blocks, THREADS, 0, s>>>(
        uf, p_ray, weights, H, N, swap, p_end, depth, table, dops, n_ops, nx,
        ny, xlo, xhi, xs, ylo, yhi, ys);
  return (int)cudaGetLastError();
}

// The coherent form: H (npy, npx, n_ch) f32, zeroed; n_ch 2 (legacy) or 4
// (intensity); k = 2 pi / wavelength in f32; (xhalf, dx) = (Lx / 2, Lx /
// npx) in f32, likewise y; ref: add the reference beam fr (cr x + sr y).
// Other arguments as detect_image's.
extern "C" int detect_field(const float* uf, float* H, long long N, int swap,
                            float p_end, float depth, const float* ops,
                            const float* dops, int n_ops, float k, int npx,
                            int npy, float xhalf, float dx, float yhalf,
                            float dy, int n_ch, int ref, float fr, float cr,
                            float sr, const float* p_ray, void* stream) {
  if (n_ops < 0 || (n_ops > MAX_OPS && !dops) || (n_ch != 2 && n_ch != 4))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  Ops table;
  if (!dops)
    for (int j = 0; j < n_ops * OP_WIDTH; ++j) table.v[j] = ops[j];
  const unsigned blocks = (unsigned)((N + THREADS - 1) / THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (dops)
    field_kernel<true><<<blocks, THREADS, 0, s>>>(
        uf, p_ray, H, N, swap, p_end, depth, table, dops, n_ops, k, npx, npy,
        xhalf, dx, yhalf, dy, n_ch, ref, fr, cr, sr);
  else
    field_kernel<false><<<blocks, THREADS, 0, s>>>(
        uf, p_ray, H, N, swap, p_end, depth, table, dops, n_ops, k, npx, npy,
        xhalf, dx, yhalf, dy, n_ch, ref, fr, cr, sr);
  return (int)cudaGetLastError();
}

// Bare rays: x, y (N,) f32; w (N,) f32 or null; H (ny, nx) f32, zeroed;
// (lo, hi, bins per unit) of each axis as bin_params gives them.
extern "C" int bin_image(const float* x, const float* y, const float* w,
                         float* H, long long N, int nx, int ny, float xlo,
                         float xhi, float xs, float ylo, float yhi, float ys,
                         void* stream) {
  if (N == 0) return 0;
  const unsigned blocks = (unsigned)((N + THREADS - 1) / THREADS);
  bin_image_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, y, w, H, N, nx, ny, xlo, xhi, xs, ylo, yhi, ys);
  return (int)cudaGetLastError();
}

// Bare rays with their fields: x, y (N,) f32; Ex, Ey (N,) complex64 as
// (re, im) pairs; H (npy, npx, n_ch) f32, zeroed; (xhalf, dx) as for
// detect_field.
extern "C" int bin_field(const float* x, const float* y, const float* Ex,
                         const float* Ey, float* H, long long N, int npx,
                         int npy, float xhalf, float dx, float yhalf, float dy,
                         int n_ch, void* stream) {
  if (n_ch != 2 && n_ch != 4) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const unsigned blocks = (unsigned)((N + THREADS - 1) / THREADS);
  bin_field_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, y, reinterpret_cast<const float2*>(Ex),
      reinterpret_cast<const float2*>(Ey), H, N, npx, npy, xhalf, dx, yhalf,
      dy, n_ch);
  return (int)cudaGetLastError();
}
