// K8: cloud-in-cell deposit of per-ray values onto a regular 2-D grid.
//
// Replaces the JAX device program of deposit_cic
// (synthpy_tpu/ops/histogram.py:158-216), which the Fresnel hybrid
// (ops/fresnel.py:113-114, Refractometry.fresnel_solve) runs on the exit
// rays' amplitude and phase: t = (pos - c0) / d with d = c[1] - c[0] (both
// read from the coordinate arrays, a true division); a ray is inside when
// t is finite and in [0, n - 1]; its corner is clip(floor(t), 0, n - 2) and
// its fractions are clipped to [0, 1]; it adds value * w and w (the bilinear
// weight) to the V value channels and the weight channel of its four
// corners; then every node is divided by max(weight, 1e-12). A ray outside
// adds 0 * w, which is nothing unless a fraction is NaN (a NaN position):
// then, as in the JAX program, NaN goes to all channels of its corners.
// V = 1 deposits a real value, V = 2 a complex one (re, im) or two real
// values sharing one weight channel (the Fresnel hybrid's amplitude and
// phase at the same positions: one pass instead of two).
//
// What bounds it on the H100: by count, bytes. Each ray reads 4 (2 + V)
// bytes and the grid is written once, ~0.02 ms at 4 M rays; but each ray
// issues 4 (V + 1) float atomics into a (nx, ny, V + 1) accumulator that
// fits in L2, and a beam concentrated on a few thousand nodes queues them
// there. The design is the simple first one: one thread per ray in the
// caller's order, atomicAdd of float32, and a second device kernel, in the
// same call, that divides by the weight. Built with --fmad=false so that
// each product is rounded as the plain version rounds it; the sums then
// differ from it only by the order of the atomic adds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "deposit.cuh"

namespace {

constexpr int THREADS = 256;

// clip(floor(t), 0, n - 2) as the JAX program computes it (NaN -> 0)
__device__ __forceinline__ int corner(float t, int n) {
  float f = floorf(t);
  if (isnan(f)) f = 0.0f;
  return (int)fminf(fmaxf(f, 0.0f), (float)(n - 2));
}

// clip(v, 0, 1), keeping a NaN
__device__ __forceinline__ float clip01(float v) {
  return v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
}

// one instance per channel count (1 or 2), so that a ray's values sit in
// registers
template <int V>
__global__ void deposit_kernel(const float* x, const float* y,
                               const float* vals, const float* xc,
                               const float* yc, int nx, int ny, float* acc,
                               long long N) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= N) return;
  const float x0 = xc[0], y0 = yc[0];
  const float dx = xc[1] - x0, dy = yc[1] - y0;
  const float tx = (x[i] - x0) / dx, ty = (y[i] - y0) / dy;
  const bool inside = isfinite(tx) && isfinite(ty) && tx >= 0.0f &&
                      tx <= (float)(nx - 1) && ty >= 0.0f &&
                      ty <= (float)(ny - 1);
  const int ix = corner(tx, nx), iy = corner(ty, ny);
  const float fx = clip01(tx - (float)ix), fy = clip01(ty - (float)iy);
  const float gx[2] = {1.0f - fx, fx}, gy[2] = {1.0f - fy, fy};
  float v[V];
#pragma unroll
  for (int c = 0; c < V; ++c) v[c] = inside ? vals[i * V + c] : 0.0f;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float w = gx[a] * gy[b];
      float* node = acc + ((long long)(ix + a) * ny + iy + b) * (V + 1);
      if (inside) {
        deposit::add_weighted<V>(node, v, w);
        atomicAdd(node + V, w);
      } else if (isnan(w)) {
#pragma unroll
        for (int c = 0; c <= V; ++c) atomicAdd(node + c, w);
      }
    }
  }
}

// out[j, c] = acc[j, c] / max(acc[j, V], 1e-12) (a NaN weight stays NaN)
__global__ void normalise_kernel(const float* acc, float* out, int V,
                                 long long nodes) {
  const long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (j >= nodes) return;
  const float den = acc[j * (V + 1) + V];
  const float d = den < 1e-12f ? 1e-12f : den;
  for (int c = 0; c < V; ++c) out[j * V + c] = acc[j * (V + 1) + c] / d;
}

}  // namespace

// x, y: (N,) f32 positions; vals: (N, V) f32, V = 1 or 2; xc (nx,), yc
// (ny,) f32 node coordinates in device memory, nx, ny >= 2; acc: (nx, ny,
// V + 1) f32 scratch, zeroed; out: (nx, ny, V) f32. Two device kernels:
// the deposit, then the division by the weight. Returns cudaGetLastError(),
// or cudaErrorInvalidValue.
extern "C" int deposit_cic(const float* x, const float* y, const float* vals,
                           int V, const float* xc, const float* yc, int nx,
                           int ny, float* acc, float* out, long long N,
                           void* stream) {
  if (V < 1 || V > 2 || nx < 2 || ny < 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (N > 0) {
    const unsigned blocks = (unsigned)((N + THREADS - 1) / THREADS);
    if (V == 1)
      deposit_kernel<1><<<blocks, THREADS, 0, s>>>(x, y, vals, xc, yc, nx, ny,
                                                   acc, N);
    else
      deposit_kernel<2><<<blocks, THREADS, 0, s>>>(x, y, vals, xc, yc, nx, ny,
                                                   acc, N);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
  }
  const long long nodes = (long long)nx * ny;
  const unsigned blocks = (unsigned)((nodes + THREADS - 1) / THREADS);
  normalise_kernel<<<blocks, THREADS, 0, s>>>(acc, out, V, nodes);
  return (int)cudaGetLastError();
}
