// K13: the relativistic Boris push of proton radiography.
//
// Replaces synthpy_tpu/tracer/particles.py:218 _push_boris (the scan body
// :237-249): n_steps fixed drift-kick-drift steps of (N, 6) rows [x, y, z,
// vx, vy, vz] through a gridded (nx, ny, nz, 3) B table stored as float32,
// bfloat16 or int8 (with (3,) dequantisation scales). A step: half position
// drift, the trilinear gather of the three B components at the midpoint
// (synthpy_tpu/ops/interp.py:33-90: inside mask, clipped corner cell,
// clipped fractions, zero outside), the int8 scale applied after the blend,
// the rotation t = (w dt / 2) B, sfac = 2 / (1 + |t|^2), v' = v + v x t,
// v += sfac (v' x t), and the second half drift.
//
// The arithmetic is the one XLA's CPU compiler emits for the JAX scan body,
// found by emulation on the CPU (the plain version in kernels/boris.py
// repeats it): the corner sum fma(w0, c0, w1 * c1) and then a fused
// multiply-add a corner; each cross-product component fma(p, q, -(r * s));
// v + sfac * c as fma(sfac, c, v); the new x and y as fma(h, v', fma(h, v,
// x)) and z as fma(h, v', z + h * v); everything else rounded operation by
// operation (--fmad=false). h = dt / 2 and the rotation factor (w / 2) dt
// are folded on the host as JAX folds them.
//
// What bounds it on the H100: operations (about 170 a step: the gather's
// weights and 24 corner terms, the rotation's two cross products and the
// division) against the table's bytes read once; in practice the latency
// of the scattered corner reads. The design: one thread owns a proton for
// all n_steps with its six floats in registers (no state traffic between
// steps); the caller passes the protons in entry-cell order (a stable sort
// of the cell each starts in), so a warp's protons read neighbouring corner
// rows and share cache lines through most of the march; each thread writes
// its result back to its own row. One template instance per table dtype;
// the corners are converted to float32 where they are read.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Grid {
  const void* tab;      // (nx, ny, nz, 3)
  const float* scale;   // (3,) int8 dequantisation scales, or null
  int nx, ny, nz;
  float ox, oy, oz;     // origin
  float ix, iy, iz;     // reciprocal spacing
};

template <class T>
__device__ __forceinline__ float as_f32(T v);
template <>
__device__ __forceinline__ float as_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float as_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float as_f32<int8_t>(int8_t v) {
  return (float)v;
}

// clip(floor(t), 0, n - 2) as JAX's int32 conversion gives it (a NaN
// coordinate lands on 0; its value is masked)
__device__ __forceinline__ int cell_of(float t, int n) {
  const float f = floorf(t);
  if (!(f == f)) return 0;
  return (int)fminf(fmaxf(f, 0.0f), (float)(n - 2));
}

template <class T>
__device__ __forceinline__ void gather(const Grid& G, float px, float py,
                                       float pz, float B[3]) {
  const float tx = __fmul_rn(__fsub_rn(px, G.ox), G.ix);
  const float ty = __fmul_rn(__fsub_rn(py, G.oy), G.iy);
  const float tz = __fmul_rn(__fsub_rn(pz, G.oz), G.iz);
  const bool inside = tx >= 0.0f && tx <= (float)(G.nx - 1) && ty >= 0.0f &&
                      ty <= (float)(G.ny - 1) && tz >= 0.0f &&
                      tz <= (float)(G.nz - 1);
  if (!inside) {
    B[0] = B[1] = B[2] = 0.0f;
    return;
  }
  const int i = cell_of(tx, G.nx), j = cell_of(ty, G.ny),
            k = cell_of(tz, G.nz);
  const float fx = fminf(fmaxf(__fsub_rn(tx, (float)i), 0.0f), 1.0f);
  const float fy = fminf(fmaxf(__fsub_rn(ty, (float)j), 0.0f), 1.0f);
  const float fz = fminf(fmaxf(__fsub_rn(tz, (float)k), 0.0f), 1.0f);
  const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy),
              gz = __fsub_rn(1.0f, fz);
  const float gxy = __fmul_rn(gx, gy), gxf = __fmul_rn(gx, fy),
              fxg = __fmul_rn(fx, gy), fxy = __fmul_rn(fx, fy);
  const float w[8] = {__fmul_rn(gxy, gz), __fmul_rn(gxy, fz),
                      __fmul_rn(gxf, gz), __fmul_rn(gxf, fz),
                      __fmul_rn(fxg, gz), __fmul_rn(fxg, fz),
                      __fmul_rn(fxy, gz), __fmul_rn(fxy, fz)};
  const T* tab = reinterpret_cast<const T*>(G.tab);
  const long long sy = (long long)G.nz, sx = (long long)G.ny * G.nz;
  const long long base = ((long long)i * G.ny + j) * G.nz + k;
  const long long off[8] = {0, 1, sy, sy + 1, sx, sx + 1, sx + sy,
                            sx + sy + 1};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float c0 = as_f32<T>(tab[(base + off[0]) * 3 + c]);
    const float c1 = as_f32<T>(tab[(base + off[1]) * 3 + c]);
    float acc = __fmaf_rn(w[0], c0, __fmul_rn(w[1], c1));
#pragma unroll
    for (int q = 2; q < 8; ++q)
      acc = __fmaf_rn(w[q], as_f32<T>(tab[(base + off[q]) * 3 + c]), acc);
    B[c] = acc;
  }
  if (G.scale != nullptr) {
    B[0] = __fmul_rn(B[0], G.scale[0]);
    B[1] = __fmul_rn(B[1], G.scale[1]);
    B[2] = __fmul_rn(B[2], G.scale[2]);
  }
}

// one component of a x b: p q - r s as fma(p, q, -(r s))
__device__ __forceinline__ float xc(float p, float q, float r, float s) {
  return __fmaf_rn(p, q, -__fmul_rn(r, s));
}

template <class T>
__global__ void __launch_bounds__(THREADS)
    boris(float* rows, const long long* order, long long n, Grid G, float h,
          float wdt, int n_steps) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n) return;
  const long long r = order != nullptr ? order[t] : t;
  float* row = rows + r * 6;
  float x = row[0], y = row[1], z = row[2];
  float vx = row[3], vy = row[4], vz = row[5];
  for (int s = 0; s < n_steps; ++s) {
    const float px = __fadd_rn(x, __fmul_rn(h, vx));
    const float py = __fadd_rn(y, __fmul_rn(h, vy));
    const float pz = __fadd_rn(z, __fmul_rn(h, vz));
    float B[3];
    gather<T>(G, px, py, pz, B);
    const float tx = __fmul_rn(wdt, B[0]), ty = __fmul_rn(wdt, B[1]),
                tz = __fmul_rn(wdt, B[2]);
    const float t2 = __fadd_rn(__fadd_rn(__fmul_rn(tx, tx), __fmul_rn(ty, ty)),
                               __fmul_rn(tz, tz));
    const float sfac = __fdiv_rn(2.0f, __fadd_rn(1.0f, t2));
    const float ux = __fadd_rn(vx, xc(vy, tz, vz, ty));
    const float uy = __fadd_rn(vy, xc(vz, tx, vx, tz));
    const float uz = __fadd_rn(vz, xc(vx, ty, vy, tx));
    const float nvx = __fmaf_rn(sfac, xc(uy, tz, uz, ty), vx);
    const float nvy = __fmaf_rn(sfac, xc(uz, tx, ux, tz), vy);
    const float nvz = __fmaf_rn(sfac, xc(ux, ty, uy, tx), vz);
    x = __fmaf_rn(h, nvx, __fmaf_rn(h, vx, x));
    y = __fmaf_rn(h, nvy, __fmaf_rn(h, vy, y));
    z = __fmaf_rn(h, nvz, pz);
    vx = nvx;
    vy = nvy;
    vz = nvz;
  }
  row[0] = x;
  row[1] = y;
  row[2] = z;
  row[3] = vx;
  row[4] = vy;
  row[5] = vz;
}

}  // namespace

// rows: (N, 6) float32, updated in place; order: (N,) int64 proton of each
// thread, or null for the rows' own order; dtype 0 float32, 1 bfloat16, 2
// int8 (scale: (3,) float32 on the card); h = dt / 2, wdt = (w / 2) dt.
extern "C" int boris_push(float* rows, const long long* order, long long n,
                          const void* tab, int dtype, const float* scale,
                          int nx, int ny, int nz, float ox, float oy,
                          float oz, float ix, float iy, float iz, float h,
                          float wdt, int n_steps, void* stream) {
  if (n <= 0) return 0;
  Grid G;
  G.tab = tab;
  G.scale = dtype == 2 ? scale : nullptr;
  G.nx = nx; G.ny = ny; G.nz = nz;
  G.ox = ox; G.oy = oy; G.oz = oz;
  G.ix = ix; G.iy = iy; G.iz = iz;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  if (dtype == 0)
    boris<float><<<blocks, THREADS, 0, st>>>(rows, order, n, G, h, wdt,
                                             n_steps);
  else if (dtype == 1)
    boris<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(rows, order, n, G, h,
                                                     wdt, n_steps);
  else
    boris<int8_t><<<blocks, THREADS, 0, st>>>(rows, order, n, G, h, wdt,
                                              n_steps);
  return (int)cudaGetLastError();
}
