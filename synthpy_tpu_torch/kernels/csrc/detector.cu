// K3: the detector.
//
// Replaces the JAX device program that turns the exit state into an image:
// reassemble_state (synthpy_tpu/tracer/zscan.py:64), ray_to_Jonesvector's
// back-projection and arctan angles (tracer/propagator.py:138-160), m_to_mm
// (optics/rtm.py:18), apply_stages' folded 4x4 ABCD stages with aperture,
// stop, rectangle and knife-edge NaN kills (optics/compose.py:78), and
// histogram2d's numpy-rule binning and scatter-add (ops/histogram.py:26-66).
//
// What bounds it on the H100: bytes. Each ray reads its 32-byte (N, 8) exit
// state (and 4 bytes of weight) and does ~60 flops and 2 arctans, then one
// atomicAdd into a (ny, nx) f32 image that fits in L2. The design fuses the
// whole chain into one pass, one thread per ray, so no (9, N) or (4, N)
// intermediate is written; the stage list sits in shared memory. The image is
// zeroed by the caller. Built with --fmad=false: every product and sum is
// rounded as the plain PyTorch version rounds it, so a ray near a bin edge
// lands in the same bin and counts match exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int OP_WIDTH = 17;  // kind, then 16 parameters

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

__global__ void detect_kernel(const float* uf, const float* weights,
                              float* H, long long N, int swap, float p_end,
                              float depth, const float* ops, int n_ops,
                              int nx, int ny, float xlo, float xhi, float xs,
                              float ylo, float yhi, float ys) {
  extern __shared__ float sops[];
  for (int j = threadIdx.x; j < n_ops * OP_WIDTH; j += blockDim.x)
    sops[j] = ops[j];
  __syncthreads();
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= N) return;
  const float* u = uf + i * 8;
  // permuted state (a, b, va, vb, vp, ...): rows 0/2 of the RTM ray are
  // (a, b), or (b, a) when probing along y
  const float pa = swap ? u[1] : u[0], va = swap ? u[3] : u[2];
  const float pb = swap ? u[0] : u[1], vb = swap ? u[2] : u[3];
  const float vp = u[4];
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
  if (vx && vy)
    atomicAdd(H + (long long)iy * nx + ix, weights ? weights[i] : 1.0f);
}

}  // namespace

// uf: (N, 8) f32 exit states; weights: (N,) f32 or null; H: (ny, nx) f32,
// zeroed; ops: (n_ops, 17) f32 stage table. Returns cudaGetLastError().
extern "C" int detect_image(const float* uf, const float* weights, float* H,
                            long long N, int swap, float p_end, float depth,
                            const float* ops, int n_ops, int nx, int ny,
                            float xlo, float xhi, float xs, float ylo,
                            float yhi, float ys, void* stream) {
  if (N == 0) return 0;
  const unsigned blocks = (unsigned)((N + THREADS - 1) / THREADS);
  const size_t smem = sizeof(float) * (size_t)(n_ops > 0 ? n_ops : 1) * OP_WIDTH;
  detect_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      uf, weights, H, N, swap, p_end, depth, ops, n_ops, nx, ny, xlo, xhi, xs,
      ylo, yhi, ys);
  return (int)cudaGetLastError();
}
