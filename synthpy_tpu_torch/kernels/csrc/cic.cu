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
// writes a 37-147 KB image, the adjoint reads the same plus the image and
// writes (8 + 4 V) bytes a ray, each ~0.004-0.01 ms. The first design (one
// thread a ray, 4 V float atomics a ray into an image that sits in L2,
// ~100 rays a pixel on the beam) queued on the L2's atomics at 3-4% of
// that. So the image is built where atomics are cheap:
//
//   * The forward's shared form (an image of at most SMEM_MAX bytes): a
//     persistent block takes a contiguous range of rays and adds each into
//     a private copy of the image in shared memory, a plane a channel
//     (shared-memory atomicAdd, a compare-and-swap loop on this card; each
//     ray's V values one vector load, RAYS rays' loads in flight), one
//     block an SM, and writes its copy to scratch as a partial image; a
//     second kernel adds the partials in a fixed order. The order across
//     blocks is fixed, so the partials' sum is repeatable given the
//     partials; the shared-memory atomics inside a block are not, so a
//     block's copy, and the image, can differ by the order of its adds
//     from run to run.
//   * The adjoint's staged form: persistent blocks stage the cotangent
//     image in shared memory once and gather each ray's four corners from
//     it; each ray's arithmetic is the first kernel's, operation by
//     operation, so its results are bit-equal to it.
//   * Images too large for shared memory keep the first design (the global
//     form: atomics into the image in device memory, corners gathered from
//     it). cic_grid chooses the form and the grid from the image's bytes
//     and the card's attributes.
//
// Built with --fmad=false: each product is rounded as the plain version
// rounds it, so the forward differs from it only by the order of the adds
// and the adjoint is its arithmetic in another summation order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// V values of one ray, each times its corner weight, added atomically into
// the V channels of one node of the image in device memory (the global
// form); each product is rounded before its add (--fmad=false)
template <int V>
__device__ __forceinline__ void add_weighted(float* node, const float v[V],
                                             float w) {
#pragma unroll
  for (int c = 0; c < V; ++c) atomicAdd(node + c, v[c] * w);
}

constexpr int THREADS = 256;
// the shared forms' blocks
constexpr int SM_THREADS = 1024;
// the fewest rays a shared-form block is given
constexpr int RAYS_A_BLOCK = 4096;
// the shared forms' blocks an SM, at most (the forward's one: two ran
// slower)
constexpr int FORWARD_PER_SM = 1;
constexpr int ADJOINT_PER_SM = 2;
// rays a shared-form thread has in flight a trip
constexpr int RAYS = 4;
// runs of partials the sum kernel adds apart (one warp each)
constexpr int SUM_SPLIT = THREADS / 32;

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

// ray i's V values, one vector load for V = 2 and 4 (the wrapper passes
// vals 4 V-byte aligned)
template <int V>
__device__ __forceinline__ void load_vals(const float* vals, long long i,
                                          float v[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(vals) + i);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(vals) + i);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = __ldg(vals + i);
  }
}

template <int V>
__device__ __forceinline__ void store_vals(float* out, long long i,
                                           const float v[V]) {
  if constexpr (V == 4)
    reinterpret_cast<float4*>(out)[i] = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (V == 2)
    reinterpret_cast<float2*>(out)[i] = make_float2(v[0], v[1]);
  else
    out[i] = v[0];
}

// the shared image's layout: one plane a channel, each of plane_of floats
// (the pixels to a 16-byte boundary), so that a warp's adds to one channel
// spread over the banks whatever V is (a float atomicAdd to shared memory
// is a compare-and-swap loop, and a conflict repeats its load and swap)
__host__ __device__ inline int plane_of(int npix) {
  return (npix + 3) / 4 * 4;
}

template <int V>
__device__ __forceinline__ void add_shared(float* img, int plane, int pix,
                                           const float v[V], float w) {
#pragma unroll
  for (int c = 0; c < V; ++c) atomicAdd(img + c * plane + pix, v[c] * w);
}

// output chunk k (floats 4k .. 4k + 3 of the (nx, ny, V) image) of a
// shared image
template <int V>
__device__ __forceinline__ float4 chunk_of(const float* img, int plane,
                                           int k) {
  if constexpr (V == 4) {
    return make_float4(img[k], img[plane + k], img[2 * plane + k],
                       img[3 * plane + k]);
  } else if constexpr (V == 2) {
    const float2 a = reinterpret_cast<const float2*>(img)[k];
    const float2 b = reinterpret_cast<const float2*>(img + plane)[k];
    return make_float4(a.x, b.x, a.y, b.y);
  } else {
    return reinterpret_cast<const float4*>(img)[k];
  }
}

// ray i's deposit (position x, y; values from values(v), asked for only
// where the ray lands) into the image at img: device memory (the global
// form, as large as the caller's: 64-bit node offsets) or a block's shared
// copy (SHARED)
template <int V, bool SHARED, typename VALUES>
__device__ __forceinline__ void deposit_ray(const Geometry& G, float x,
                                            float y, VALUES values,
                                            float* img) {
  Cloud c;
  if (!cloud_of(G, x, y, c)) return;
  float v[V];
  values(v);
  const float gx[2] = {1.0f - c.fx, c.fx}, gy[2] = {1.0f - c.fy, c.fy};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (!c.okx[a]) continue;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if (!c.oky[b]) continue;
      if constexpr (SHARED) {
        add_shared<V>(img, plane_of(G.nx * G.ny), (c.ix + a) * G.ny + c.iy + b,
                      v, gx[a] * gy[b]);
      } else {
        float* node = img + ((long long)(c.ix + a) * G.ny + c.iy + b) * V;
        add_weighted<V>(node, v, gx[a] * gy[b]);
      }
    }
  }
}

// the global form: one thread a ray in the caller's order, atomics into
// the image in device memory
template <int V>
__global__ void __launch_bounds__(THREADS)
    cic_forward(const float* x, const float* y, const float* vals,
                long long N, Geometry G, float* acc) {
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= N) return;
  deposit_ray<V, false>(G, x[i], y[i],
                        [&](float v[V]) { load_vals<V>(vals, i, v); }, acc);
}

// the shared form's image: pitch floats (V planes)
__host__ __device__ inline int pitch_of(const Geometry& G, int V) {
  return V * plane_of(G.nx * G.ny);
}

// the shared form: a block's contiguous range of rays into its copy of
// the image, written to its partial image (partials + blockIdx.x pitch)
template <int V>
__global__ void __launch_bounds__(SM_THREADS)
    cic_forward_shared(const float* x, const float* y, const float* vals,
                       long long N, Geometry G, float* partials) {
  extern __shared__ __align__(16) float img[];
  const int pitch = pitch_of(G, V);
  float4* img4 = reinterpret_cast<float4*>(img);
  for (int k = threadIdx.x; k < pitch / 4; k += SM_THREADS)
    img4[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  const long long per = (N + gridDim.x - 1) / gridDim.x;
  const long long r0 = blockIdx.x * per;
  const long long r1 = min(N, r0 + per);
  // RAYS rays a thread a trip, their loads issued before their adds
  for (long long i0 = r0 + threadIdx.x; i0 < r1;
       i0 += (long long)RAYS * SM_THREADS) {
    float px[RAYS], py[RAYS], v[RAYS][V];
#pragma unroll
    for (int r = 0; r < RAYS; ++r) {
      const long long i = i0 + (long long)r * SM_THREADS;
      if (i < r1) {
        px[r] = __ldg(x + i);
        py[r] = __ldg(y + i);
        load_vals<V>(vals, i, v[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RAYS; ++r)
      if (i0 + (long long)r * SM_THREADS < r1)
        deposit_ray<V, true>(G, px[r], py[r], [&](float u[V]) {
#pragma unroll
          for (int k = 0; k < V; ++k) u[k] = v[r][k];
        }, img);
  }
  __syncthreads();
  float4* out = reinterpret_cast<float4*>(
      partials + (long long)blockIdx.x * pitch);
  const int plane = plane_of(G.nx * G.ny);
  for (int k = threadIdx.x; k < pitch / 4; k += SM_THREADS)
    out[k] = chunk_of<V>(img, plane, k);
}

// acc[k], the sum of the partial images' element k in a fixed order:
// SUM_SPLIT runs of consecutive partials, each summed in partial order by
// one warp's lane, then the runs' sums in run order
__global__ void __launch_bounds__(THREADS)
    cic_sum(const float* partials, int n_partials, int pitch, int n,
            float* acc) {
  __shared__ float run[SUM_SPLIT][32];
  const int lane = threadIdx.x % 32, r = threadIdx.x / 32;
  const int k = blockIdx.x * 32 + lane;
  const int per = (n_partials + SUM_SPLIT - 1) / SUM_SPLIT;
  const int p0 = r * per, p1 = min(n_partials, p0 + per);
  if (k < n && p0 < p1) {
    float s = partials[(long long)p0 * pitch + k];
#pragma unroll 4
    for (int p = p0 + 1; p < p1; ++p)
      s = s + partials[(long long)p * pitch + k];
    run[r][lane] = s;
  }
  __syncthreads();
  if (r == 0 && k < n) {
    float s = run[0][lane];
    for (int q = 1; q < SUM_SPLIT && q * per < n_partials; ++q)
      s = s + run[q][lane];
    acc[k] = s;
  }
}

// ray i's adjoint (position px, py; values from values(v), asked for only
// where the ray lands) against the cotangent image at img (device memory:
// 64-bit node offsets; or shared: int)
template <int V, typename IDX, typename VALUES>
__device__ __forceinline__ void adjoint_ray(const Geometry& G, float px,
                                            float py, VALUES values,
                                            long long i, const float* img,
                                            float* dx, float* dy,
                                            float* dvals) {
  Cloud c;
  float dv[V];
#pragma unroll
  for (int k = 0; k < V; ++k) dv[k] = 0.0f;
  if (!cloud_of(G, px, py, c)) {
    dx[i] = 0.0f;
    dy[i] = 0.0f;
    store_vals<V>(dvals, i, dv);
    return;
  }
  float v[V];
  values(v);
  const float gx[2] = {1.0f - c.fx, c.fx}, gy[2] = {1.0f - c.fy, c.fy};
  float dw[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      dw[a][b] = 0.0f;
      if (!(c.okx[a] && c.oky[b])) continue;
      const float* g = img + ((IDX)(c.ix + a) * G.ny + c.iy + b) * V;
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
  store_vals<V>(dvals, i, dv);
}

// the global form: one thread a ray, corners gathered from device memory
template <int V>
__global__ void __launch_bounds__(THREADS)
    cic_backward(const float* x, const float* y, const float* vals,
                 long long N, Geometry G, const float* dacc, float* dx,
                 float* dy, float* dvals) {
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= N) return;
  adjoint_ray<V, long long>(
      G, x[i], y[i], [&](float v[V]) { load_vals<V>(vals, i, v); }, i, dacc,
      dx, dy, dvals);
}

// the staged form: persistent blocks, the cotangent image copied to shared
// memory once a block, RAYS rays a thread a trip with their loads issued
// first
template <int V>
__global__ void __launch_bounds__(SM_THREADS)
    cic_backward_staged(const float* __restrict__ x,
                        const float* __restrict__ y,
                        const float* __restrict__ vals, long long N,
                        Geometry G, const float* __restrict__ dacc,
                        float* __restrict__ dx, float* __restrict__ dy,
                        float* __restrict__ dvals) {
  extern __shared__ __align__(16) float img[];
  const int n = G.nx * G.ny * V;
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(dacc) % 16 == 0) {
    for (int k = threadIdx.x; k < n / 4; k += SM_THREADS)
      reinterpret_cast<float4*>(img)[k] =
          __ldg(reinterpret_cast<const float4*>(dacc) + k);
  } else {
    for (int k = threadIdx.x; k < n; k += SM_THREADS) img[k] = dacc[k];
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * SM_THREADS;
  for (long long i0 = blockIdx.x * (long long)SM_THREADS + threadIdx.x;
       i0 < N; i0 += RAYS * stride) {
    float px[RAYS], py[RAYS], v[RAYS][V];
#pragma unroll
    for (int r = 0; r < RAYS; ++r) {
      const long long i = i0 + r * stride;
      if (i < N) {
        px[r] = __ldg(x + i);
        py[r] = __ldg(y + i);
        load_vals<V>(vals, i, v[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RAYS; ++r)
      if (i0 + r * stride < N)
        adjoint_ray<V, int>(G, px[r], py[r], [&](float u[V]) {
#pragma unroll
          for (int k = 0; k < V; ++k) u[k] = v[r][k];
        }, i0 + r * stride, img, dx, dy, dvals);
  }
}

Geometry geometry(int nx, int ny, float hx, float sx, float hy, float sy) {
  Geometry G;
  G.nx = nx; G.ny = ny; G.hx = hx; G.sx = sx; G.hy = hy; G.sy = sy;
  return G;
}

unsigned blocks_of(long long N) {
  return (unsigned)((N + THREADS - 1) / THREADS);
}

// a kernel's dynamic shared bytes allowed where they pass the default
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int V>
int forward_shared(const float* x, const float* y, const float* vals,
                   long long N, const Geometry& G, int grid, float* scratch,
                   float* acc, cudaStream_t s) {
  const size_t smem = (size_t)pitch_of(G, V) * sizeof(float);
  const cudaError_t rc = allow_smem(cic_forward_shared<V>, smem);
  if (rc != cudaSuccess) return (int)rc;
  cic_forward_shared<V><<<(unsigned)grid, SM_THREADS, smem, s>>>(
      x, y, vals, N, G, scratch);
  const int n = G.nx * G.ny * V;
  cic_sum<<<(n + 31) / 32, THREADS, 0, s>>>(scratch, grid, pitch_of(G, V),
                                             n, acc);
  return (int)cudaGetLastError();
}

template <int V>
int adjoint_staged(const float* x, const float* y, const float* vals,
                   long long N, const Geometry& G, int grid, const float* dacc,
                   float* dx, float* dy, float* dvals, cudaStream_t s) {
  const size_t smem = (size_t)G.nx * G.ny * V * sizeof(float);
  const cudaError_t rc = allow_smem(cic_backward_staged<V>, smem);
  if (rc != cudaSuccess) return (int)rc;
  cic_backward_staged<V><<<(unsigned)grid, SM_THREADS, smem, s>>>(
      x, y, vals, N, G, dacc, dx, dy, dvals);
  return (int)cudaGetLastError();
}

// The shared forms' persistent blocks for N rays onto an nx x ny x V image
// on card dev: 0 (the global form) where the image (V planes, each to a
// 16-byte boundary) passes a block's shared memory; else one block for
// each RAYS_A_BLOCK rays, at most as many as the card holds at once
// (FORWARD_PER_SM or ADJOINT_PER_SM an SM, fewer where the SM's shared
// memory takes fewer images), at least one. -1 where the card's
// attributes cannot be read.
int grid_of(int dev, bool adjoint, int V, int nx, int ny, long long N) {
  int sms = 0, block = 0, sm = 0, reserved = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&block, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                             dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&reserved,
                             cudaDevAttrReservedSharedMemoryPerBlock,
                             dev) != cudaSuccess)
    return -1;
  const long long img = (long long)V * ((nx * (long long)ny + 3) / 4) * 16;
  if (img > block || (long long)nx * ny * V >= 0x7fffffffLL) return 0;
  long long per = adjoint ? ADJOINT_PER_SM : FORWARD_PER_SM;
  per = per < sm / (img + reserved) ? per : sm / (img + reserved);
  if (per < 1) per = 1;
  long long grid = (N + RAYS_A_BLOCK - 1) / RAYS_A_BLOCK;
  if (grid > per * sms) grid = per * sms;
  return grid < 1 ? 1 : (int)grid;
}

// whether a shared form of grid blocks takes this image on the current
// card: at most the blocks grid_of gives N rays' worth of the card
bool shared_ok(bool adjoint, int V, int nx, int ny, int grid) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  const int most = grid_of(dev, adjoint, V, nx, ny, 0x7fffffffffffLL);
  return most > 0 && grid <= most;
}

}  // namespace

// The shared forward's scratch: the floats of one partial image (V planes
// of nx ny floats, each to a 16-byte boundary).
extern "C" int cic_pitch(int V, int nx, int ny) {
  Geometry G;
  G.nx = nx; G.ny = ny;
  return pitch_of(G, V);
}

// The launch plan of cic_deposit (adjoint 0; its partial images) or
// cic_adjoint (1) for N rays onto an nx x ny x V image on card dev: the
// shared form's grid, or 0 for the global form (grid_of); -1 where the
// card's attributes cannot be read.
extern "C" int cic_grid(int dev, int adjoint, int V, int nx, int ny,
                        long long N) {
  if ((V != 1 && V != 2 && V != 4) || nx < 1 || ny < 1 || N < 0) return -1;
  return grid_of(dev, adjoint != 0, V, nx, ny, N);
}

// x, y: (N,) f32 positions [mm]; vals: (N, V) f32, V = 1, 2 or 4, 4 V-byte
// aligned; hx, hy = L/2 and sx, sy = n/L of each axis as float32. grid 0:
// the global form, acc (nx, ny, V) f32 zeroed. grid > 0 (cic_grid's, or
// fewer blocks): the shared form, scratch grid partial images of
// cic_pitch floats, acc written. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for what the form does not take.
extern "C" int cic_deposit(const float* x, const float* y, const float* vals,
                           int V, long long N, int nx, int ny, float hx,
                           float sx, float hy, float sy, int grid,
                           float* scratch, float* acc, void* stream) {
  if ((V != 1 && V != 2 && V != 4) || nx < 1 || ny < 1 || grid < 0)
    return (int)cudaErrorInvalidValue;
  if (grid > 0 && !shared_ok(false, V, nx, ny, grid))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Geometry G = geometry(nx, ny, hx, sx, hy, sy);
  if (grid > 0) {
    if (V == 1)
      return forward_shared<1>(x, y, vals, N, G, grid, scratch, acc, s);
    if (V == 2)
      return forward_shared<2>(x, y, vals, N, G, grid, scratch, acc, s);
    return forward_shared<4>(x, y, vals, N, G, grid, scratch, acc, s);
  }
  if (N == 0) return 0;
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
// dx, dy (N,) and dvals (N, V) f32 out (4 V-byte aligned), every element
// written. grid 0: the global form; grid > 0 (cic_grid's, or fewer): the
// staged form, grid persistent blocks. Returns cudaGetLastError(), or
// cudaErrorInvalidValue.
extern "C" int cic_adjoint(const float* x, const float* y, const float* vals,
                           int V, long long N, int nx, int ny, float hx,
                           float sx, float hy, float sy, int grid,
                           const float* dacc, float* dx, float* dy,
                           float* dvals, void* stream) {
  if ((V != 1 && V != 2 && V != 4) || nx < 1 || ny < 1 || grid < 0)
    return (int)cudaErrorInvalidValue;
  if (grid > 0 && !shared_ok(true, V, nx, ny, grid))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const Geometry G = geometry(nx, ny, hx, sx, hy, sy);
  if (grid > 0) {
    if (V == 1)
      return adjoint_staged<1>(x, y, vals, N, G, grid, dacc, dx, dy, dvals, s);
    if (V == 2)
      return adjoint_staged<2>(x, y, vals, N, G, grid, dacc, dx, dy, dvals, s);
    return adjoint_staged<4>(x, y, vals, N, G, grid, dacc, dx, dy, dvals, s);
  }
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
