// K3: the detector.
//
// Replaces the JAX device program that turns the exit state into an image:
// reassemble_state (synthpy_tpu/tracer/zscan.py:64), ray_to_Jonesvector's
// back-projection and arctan angles (tracer/propagator.py:138-160), m_to_mm
// (optics/rtm.py:18), apply_stages' folded 4x4 ABCD stages with aperture,
// stop, rectangle and knife-edge NaN kills (optics/compose.py:78), and
// histogram2d's numpy-rule binning and scatter-add (ops/histogram.py:26-66).
//
// What bounds it on the H100: by count, bytes. Each ray reads its 32-byte
// (N, 8) exit state (and 4 bytes of weight) and does ~60 flops and 2
// arctans, then adds into a (ny, nx) f32 image that fits in L2. Measured at
// the main path's shapes (4 M rays of a beam that lands on ~7,600 bins) it
// runs at about a quarter of the bytes bound, and the atomics hold it:
// without them it takes two fifths of the time, as adds to a few thousand
// hot addresses queue in L2 (PERF.md). The design fuses the whole chain into
// one pass, one thread per ray in the caller's order, so no (9, N) or
// (4, N) intermediate is written; the stage list comes in as a kernel
// parameter (no copy to the device per call) and sits in shared memory, and
// the state row comes in as two 16-byte loads. Each kept ray adds once. In
// the caller's order a warp's rays land on ~32 distinct bins, so adding
// once per (warp, bin) (__match_any_sync) saves nothing; it saves a third
// of the time on states stored in the march's entry-cell order (~2 bins a
// warp), but the march writes each ray back to its own row, and reading
// the states through that order, or copying them into it, costs more than
// the atomics it saves.
// Built with --fmad=false: every product and sum is rounded as the plain
// PyTorch version rounds it, so a ray near a bin edge lands in the same bin
// and counts match exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int OP_WIDTH = 17;  // kind, then 16 parameters
constexpr int MAX_OPS = 16;

struct Ops {
  float v[MAX_OPS * OP_WIDTH];
};

enum Op { MATRIX = 0, APERTURE = 1, STOP = 2, RECT = 3, KNIFE = 4 };

__device__ __forceinline__ void kill(float r[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) r[q] = __int_as_float(0x7fc00000);
}

// numpy-rule bin of v in [lo, hi]: v == hi goes to the last bin; false for
// NaN and out-of-range values
__device__ __forceinline__ bool bin_of(float v, float lo, float hi,
                                       float scale, int n, int& idx) {
  const float f = floorf((v - lo) * scale);
  idx = v == hi ? n - 1 : (int)fminf(fmaxf(f, 0.0f), (float)(n - 1));
  return isfinite(v) && v >= lo && v <= hi;
}

// Flat bin of one ray from its permuted exit state (lo = a, b, va, vb and
// vp), or -1 when the optics or the detector drop it.
__device__ __forceinline__ int ray_bin(float4 lo, float vp, int swap,
                                       float p_end, float depth,
                                       const float* sops, int n_ops, int nx,
                                       int ny, float xlo, float xhi, float xs,
                                       float ylo, float yhi, float ys) {
  // rows 0/2 of the RTM ray are (a, b), or (b, a) when probing along y
  const float pa = swap ? lo.y : lo.x, va = swap ? lo.w : lo.z;
  const float pb = swap ? lo.x : lo.y, vb = swap ? lo.z : lo.w;
  const float t_bp = (p_end - depth) / vp;
  float r[4];
  r[0] = (pa - va * t_bp) * 1000.0f;
  r[1] = atanf(va / vp);
  r[2] = (pb - vb * t_bp) * 1000.0f;
  r[3] = atanf(vb / vp);
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
      if (r[0] * r[0] + r[2] * r[2] > p[0]) kill(r);
    } else if (kind == STOP) {
      if (r[0] * r[0] + r[2] * r[2] < p[0]) kill(r);
    } else if (kind == RECT) {
      if (r[0] * r[0] > p[0] && r[2] * r[2] > p[1]) kill(r);
    } else {  // KNIFE: row p[0], direction p[1], offset p[2]
      const float v = r[(int)p[0]];
      if (p[1] > 0.0f ? v > p[2] : v < p[2]) kill(r);
    }
  }
  int ix, iy;
  const bool vx = bin_of(r[0], xlo, xhi, xs, nx, ix);
  const bool vy = bin_of(r[2], ylo, yhi, ys, ny, iy);
  return vx && vy ? iy * nx + ix : -1;
}

// Thread i bins ray i.
__global__ void detect_kernel(const float* uf, const float* weights, float* H,
                              long long N, int swap, float p_end, float depth,
                              const Ops ops, int n_ops, int nx, int ny,
                              float xlo, float xhi, float xs, float ylo,
                              float yhi, float ys) {
  __shared__ float sops[MAX_OPS * OP_WIDTH];
  for (int j = threadIdx.x; j < n_ops * OP_WIDTH; j += blockDim.x)
    sops[j] = ops.v[j];
  __syncthreads();
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= N) return;
  const float4* u = reinterpret_cast<const float4*>(uf + i * 8);
  const int key = ray_bin(u[0], u[1].x, swap, p_end, depth, sops, n_ops, nx,
                          ny, xlo, xhi, xs, ylo, yhi, ys);
  if (key >= 0) atomicAdd(H + key, weights ? weights[i] : 1.0f);
}

}  // namespace

// uf: (N, 8) f32 exit states, 16-byte aligned; weights: (N,) f32 or null;
// H: (ny, nx) f32, zeroed; ops: (n_ops, 17) f32 stage table in host
// memory, n_ops <= MAX_OPS. Returns cudaGetLastError(), or
// cudaErrorInvalidValue.
extern "C" int detect_image(const float* uf, const float* weights, float* H,
                            long long N, int swap, float p_end, float depth,
                            const float* ops, int n_ops, int nx, int ny,
                            float xlo, float xhi, float xs, float ylo,
                            float yhi, float ys, void* stream) {
  if (n_ops < 0 || n_ops > MAX_OPS) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  Ops table;
  for (int j = 0; j < n_ops * OP_WIDTH; ++j) table.v[j] = ops[j];
  const unsigned blocks = (unsigned)((N + THREADS - 1) / THREADS);
  detect_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      uf, weights, H, N, swap, p_end, depth, table, n_ops, nx, ny, xlo, xhi,
      xs, ylo, yhi, ys);
  return (int)cudaGetLastError();
}
