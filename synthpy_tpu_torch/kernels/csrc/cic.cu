// K12: the cloud-in-cell detector image of the differentiable renderer, and
// its adjoint.
//
// Replaces the JAX device programs of synthpy_tpu/inverse.py cic_image
// (:139) and cic_intensity_image (:162), forward and their VJPs under
// jax.grad: each ray deposits V values (V = 1: a weight; 2: weight * phase
// and weight, the phase map's numerator and denominator; 4: the weighted
// real and imaginary parts of both Jones components) onto the four pixel
// centres around it with bilinear fractions, by _cic_coords' rule
// (:119-136): t = (x + L/2) (n/L) - 0.5, an unclipped floor, a non-finite
// ray parked at -10 with value 0, corners at index < 0 masked (:156) and
// corners at index >= n dropped (the scatter's mode="drop"). The masks are
// decided on the float corner before it becomes an int, so a ray that
// diverged far off the detector cannot overflow an index. This is not
// K8's rule (deposit.cu clips the corner to n - 2 and tests inside).
//
// The adjoint (cic_adjoint) is a gather, one thread a ray, no atomics: the
// four corners' cotangents g give dv_c = sum g_c w, and through the
// weights d fx = sum_b gy_b (dw_1b - dw_0b) with dw = sum_c g_c v_c, then
// dx = d fx * (n / L). A parked ray gets exactly 0 for dx, dy and its
// values, as JAX's where-VJP selects rather than multiplies.
//
// What bounds it on the H100. By count, bytes: at the inversion's 1 M
// rays and 96 x 96 pixels the forward reads (8 + 4 V) bytes a ray and
// writes a 147 KB image, the adjoint reads the same plus the image and
// writes (8 + 4 V) bytes a ray, each ~0.01 ms. But the forward issues 4 V
// float atomics a ray into an image that sits in L2, ~100 rays a pixel
// on the beam, and queues there as K8 does. The design is the simple first
// one: one thread a ray in the caller's order, the channel loop of K8
// (deposit.cuh), one template instance per V. Built with --fmad=false:
// each product is rounded as the plain version rounds it, so the forward
// differs from it only by the order of the atomic adds and the adjoint is
// its arithmetic in another summation order.

#include <cuda_runtime.h>
#include <math.h>

#include "deposit.cuh"

namespace {

constexpr int THREADS = 256;

struct Geometry {
  int nx, ny;
  float hx, sx, hy, sy;  // L/2 and n/L of each axis, as float32
};

// One ray's pixel-centre coordinate on both axes: the corner floor(t) and
// fraction, and which of the two corners of each axis lie on the detector.
// Returns false for a non-finite ray (parked: nothing lands).
struct Cloud {
  float fx, fy;     // fractions
  int ix, iy;       // lower corners (valid only where ok)
  bool okx[2], oky[2];
};

__device__ __forceinline__ bool cloud_of(const Geometry& G, float x, float y,
                                         Cloud& c) {
  const float tx = (x + G.hx) * G.sx - 0.5f;
  const float ty = (y + G.hy) * G.sy - 0.5f;
  if (!(isfinite(tx) && isfinite(ty))) return false;
  const float ax = floorf(tx), ay = floorf(ty);
  c.fx = tx - ax;
  c.fy = ty - ay;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    c.okx[a] = ax + (float)a >= 0.0f && ax + (float)a <= (float)(G.nx - 1);
    c.oky[a] = ay + (float)a >= 0.0f && ay + (float)a <= (float)(G.ny - 1);
  }
  // the int corner is formed only where a corner is on the detector
  c.ix = (c.okx[0] || c.okx[1]) ? (int)ax : 0;
  c.iy = (c.oky[0] || c.oky[1]) ? (int)ay : 0;
  return true;
}

template <int V>
__global__ void __launch_bounds__(THREADS)
    cic_forward(const float* x, const float* y, const float* vals,
                long long N, Geometry G, float* acc) {
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= N) return;
  Cloud c;
  if (!cloud_of(G, x[i], y[i], c)) return;
  float v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = vals[i * V + k];
  const float gx[2] = {1.0f - c.fx, c.fx}, gy[2] = {1.0f - c.fy, c.fy};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (!c.okx[a]) continue;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if (!c.oky[b]) continue;
      float* node = acc + ((long long)(c.ix + a) * G.ny + c.iy + b) * V;
      deposit::add_weighted<V>(node, v, gx[a] * gy[b]);
    }
  }
}

template <int V>
__global__ void __launch_bounds__(THREADS)
    cic_backward(const float* x, const float* y, const float* vals,
                 long long N, Geometry G, const float* dacc, float* dx,
                 float* dy, float* dvals) {
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= N) return;
  Cloud c;
  float dv[V];
#pragma unroll
  for (int k = 0; k < V; ++k) dv[k] = 0.0f;
  if (!cloud_of(G, x[i], y[i], c)) {
    dx[i] = 0.0f;
    dy[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < V; ++k) dvals[i * V + k] = 0.0f;
    return;
  }
  float v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = vals[i * V + k];
  const float gx[2] = {1.0f - c.fx, c.fx}, gy[2] = {1.0f - c.fy, c.fy};
  float dw[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      dw[a][b] = 0.0f;
      if (!(c.okx[a] && c.oky[b])) continue;
      const float* g =
          dacc + ((long long)(c.ix + a) * G.ny + c.iy + b) * V;
      const float w = gx[a] * gy[b];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float gk = g[k];
        dv[k] = dv[k] + gk * w;
        dw[a][b] = dw[a][b] + gk * v[k];
      }
    }
  }
  const float dfx = gy[0] * (dw[1][0] - dw[0][0]) +
                    gy[1] * (dw[1][1] - dw[0][1]);
  const float dfy = gx[0] * (dw[0][1] - dw[0][0]) +
                    gx[1] * (dw[1][1] - dw[1][0]);
  dx[i] = dfx * G.sx;
  dy[i] = dfy * G.sy;
#pragma unroll
  for (int k = 0; k < V; ++k) dvals[i * V + k] = dv[k];
}

Geometry geometry(int nx, int ny, float hx, float sx, float hy, float sy) {
  Geometry G;
  G.nx = nx; G.ny = ny; G.hx = hx; G.sx = sx; G.hy = hy; G.sy = sy;
  return G;
}

unsigned blocks_of(long long N) {
  return (unsigned)((N + THREADS - 1) / THREADS);
}

}  // namespace

// x, y: (N,) f32 positions [mm]; vals: (N, V) f32, V = 1, 2 or 4; hx, hy
// = L/2 and sx, sy = n/L of each axis as float32; acc: (nx, ny, V) f32,
// zeroed. Returns cudaGetLastError(), or cudaErrorInvalidValue.
extern "C" int cic_deposit(const float* x, const float* y, const float* vals,
                           int V, long long N, int nx, int ny, float hx,
                           float sx, float hy, float sy, float* acc,
                           void* stream) {
  if ((V != 1 && V != 2 && V != 4) || nx < 1 || ny < 1)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const Geometry G = geometry(nx, ny, hx, sx, hy, sy);
  const unsigned b = blocks_of(N);
  if (V == 1)
    cic_forward<1><<<b, THREADS, 0, s>>>(x, y, vals, N, G, acc);
  else if (V == 2)
    cic_forward<2><<<b, THREADS, 0, s>>>(x, y, vals, N, G, acc);
  else
    cic_forward<4><<<b, THREADS, 0, s>>>(x, y, vals, N, G, acc);
  return (int)cudaGetLastError();
}

// The adjoint of cic_deposit at the same inputs: dacc (nx, ny, V) f32 in;
// dx, dy (N,) and dvals (N, V) f32 out, every element written. Returns
// cudaGetLastError(), or cudaErrorInvalidValue.
extern "C" int cic_adjoint(const float* x, const float* y, const float* vals,
                           int V, long long N, int nx, int ny, float hx,
                           float sx, float hy, float sy, const float* dacc,
                           float* dx, float* dy, float* dvals,
                           void* stream) {
  if ((V != 1 && V != 2 && V != 4) || nx < 1 || ny < 1)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const Geometry G = geometry(nx, ny, hx, sx, hy, sy);
  const unsigned b = blocks_of(N);
  if (V == 1)
    cic_backward<1><<<b, THREADS, 0, s>>>(x, y, vals, N, G, dacc, dx, dy,
                                          dvals);
  else if (V == 2)
    cic_backward<2><<<b, THREADS, 0, s>>>(x, y, vals, N, G, dacc, dx, dy,
                                          dvals);
  else
    cic_backward<4><<<b, THREADS, 0, s>>>(x, y, vals, N, G, dacc, dx, dy,
                                          dvals);
  return (int)cudaGetLastError();
}
