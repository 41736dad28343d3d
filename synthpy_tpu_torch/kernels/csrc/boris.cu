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
// What bounds it on the H100: operations (about 125 an in-grid step: the
// gather's weights and 24 corner terms, the rotation's two cross products
// and the division; 62 outside) against the table's bytes read once. In
// practice the corner reads held the first design at 7.5% of that: 24
// scalar loads every in-grid step, each touching ~5.6 distinct 32-byte
// sectors a warp even in entry-cell order, whatever the table's width.
//
// The design: one thread owns a proton for all n_steps with its six floats
// in registers; the caller passes the protons in entry-cell order (a stable
// sort of the cell each starts in), so a warp's protons read neighbouring
// nodes; each thread writes its result back to its own row. Then:
//
// - Carried corners. A thread keeps the 8 x 3 corner values of its last
//   cell (ci, cj, ck) in registers as float32 (converted as the first
//   design converted them: the same bytes, so the blend is bit-equal). On a
//   new cell each axis whose index moved by one shifts the carried values
//   (the upper corners become the lower ones), and only the nodes that lie
//   outside the old cell are read: none while the cell holds (about every
//   other step), the 4 upper nodes when k advances, the new columns when i
//   or j moves, all 8 on a jump or on the first in-grid step. The reads are
//   predicated per lane: in most warp-steps some lane changes its (i, j).
//   About 2.2 nodes (6.6 loads) an in-grid step instead of 8 (24) on the
//   proton path (boris.walk_model).
// - Issue slots. With the corners carried the kernel is bound by the
//   instructions it issues, not by memory (a prefetch of the next plane
//   made it slower), and a warp runs a shift or a read when any of its
//   lanes needs it. So each axis shifts under its own test, a node is
//   three single loads at immediate offsets from one of four column
//   pointers (a 64-bit pointer to the cell's first node plus 32-bit
//   strides; the wrapper refuses a plane of nodes too wide for them), and
//   blocks are 128 threads (64-70 registers leave 28-32 warps an SM, 24-32
//   in blocks of 256). Measured slower on the H100 (PERF.md): a node read
//   as an aligned pair and a single value (12-36%: its selects and second
//   address), raw carried values, register caps, shifting along z alone.
// - Steps outside the grid. A midpoint outside the grid (or NaN) has B = 0
//   (the first design assigned +0 before the int8 scale, so the scale never
//   enters). The rotation then changes nothing, and the step is the two
//   drifts alone: x' = fma(h, vx, fma(h, vx, x)), y' likewise, z' = fma(h,
//   vz, z + h vz). Proof, for finite vx, vy, vz and a finite wdt of either
//   sign: t = wdt (+0) is +0 or -0 in each component, so every product in
//   t2 and the cross products is a signed zero, t2 = +0 and sfac = 2 / 1 =
//   2 exactly, and each cross component fma(p, +-0, -(r (+-0))) is a
//   signed zero. v' = v + (+-0) equals v, and v_new = fma(2, +-0, v)
//   equals v, in value; a component that is itself zero may change its
//   sign (-0 + +0 = +0), and a zero sign reaches no later value other than
//   a zero's sign (no division by a velocity, no comparison that tells the
//   zeros apart), so the rows are equal under IEEE comparison. With v_new
//   = v the two drifts are the first design's x' = fma(h, v_new, fma(h, v,
//   x)) and z' = fma(h, v_new, pz) exactly. A lane with a non-finite
//   velocity component (inf * 0 is NaN) or a non-finite wdt takes the full
//   step, so NaN and inf propagate as before. The steps stay one by one:
//   each drift is rounded, as in JAX.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

struct Grid {
  const void* tab;      // (nx, ny, nz, 3)
  const float* scale;   // (3,) int8 dequantisation scales, or null
  int nx, ny, nz;
  int sx, sy;           // elements from a node to its x and y neighbours
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

// node n's three values from p = tab + 3n
template <class T>
__device__ __forceinline__ void load_node(const T* p, float v[3]) {
#pragma unroll
  for (int m = 0; m < 3; ++m) v[m] = as_f32<T>(__ldg(p + m));
}

// move the carried corners (q = 4 dx + 2 dy + dz) d cells along the axis
// of bit BIT of q; returns the corners that must be read anew
template <int BIT>
__device__ __forceinline__ unsigned shift(float c[8][3], int d) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if (q & BIT) continue;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const float lo = c[q][m], hi = c[q | BIT][m];
      c[q][m] = d == 1 ? hi : lo;
      c[q | BIT][m] = d == -1 ? lo : hi;
    }
  }
  constexpr unsigned upper = BIT == 1 ? 0xAAu : BIT == 2 ? 0xCCu : 0xF0u;
  return d == 0 ? 0u : d == 1 ? upper : d == -1 ? (~upper & 0xFFu) : 0xFFu;
}

// clip(floor(t), 0, n - 2) as JAX's int32 conversion gives it (a NaN
// coordinate lands on 0; its value is masked)
__device__ __forceinline__ int cell_of(float t, int n) {
  const float f = floorf(t);
  if (!(f == f)) return 0;
  return (int)fminf(fmaxf(f, 0.0f), (float)(n - 2));
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
  const T* tab = reinterpret_cast<const T*>(G.tab);
  float sc[3] = {1.0f, 1.0f, 1.0f};
  if (G.scale != nullptr) {
#pragma unroll
    for (int m = 0; m < 3; ++m) sc[m] = G.scale[m];
  }
  const bool drift_ok = isfinite(wdt);
  // the carried corners of cell (ci, cj, ck); none carried at first
  float c[8][3];
#pragma unroll
  for (int q = 0; q < 8; ++q) c[q][0] = c[q][1] = c[q][2] = 0.0f;
  int ci = -2, cj = -2, ck = -2;
  for (int s = 0; s < n_steps; ++s) {
    const float px = __fadd_rn(x, __fmul_rn(h, vx));
    const float py = __fadd_rn(y, __fmul_rn(h, vy));
    const float pz = __fadd_rn(z, __fmul_rn(h, vz));
    const float tx = __fmul_rn(__fsub_rn(px, G.ox), G.ix);
    const float ty = __fmul_rn(__fsub_rn(py, G.oy), G.iy);
    const float tz = __fmul_rn(__fsub_rn(pz, G.oz), G.iz);
    const bool inside = tx >= 0.0f && tx <= (float)(G.nx - 1) &&
                        ty >= 0.0f && ty <= (float)(G.ny - 1) &&
                        tz >= 0.0f && tz <= (float)(G.nz - 1);
    float B[3];
    if (!inside) {
      if (drift_ok && isfinite(vx) && isfinite(vy) && isfinite(vz)) {
        // B = 0: the rotation changes nothing (see the header)
        x = __fmaf_rn(h, vx, __fmaf_rn(h, vx, x));
        y = __fmaf_rn(h, vy, __fmaf_rn(h, vy, y));
        z = __fmaf_rn(h, vz, pz);
        continue;
      }
      B[0] = B[1] = B[2] = 0.0f;
    } else {
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
      // each axis shifts only where some lane of the warp moved along it
      unsigned need = 0;
      if (k != ck) need |= shift<1>(c, k - ck);
      if (j != cj) need |= shift<2>(c, j - cj);
      if (i != ci) need |= shift<4>(c, i - ci);
      ci = i;
      cj = j;
      ck = k;
      if (need != 0) {
        const long long node = ((long long)i * G.ny + j) * G.nz + k;
        // the four columns (i + a, j + b); a node's z and component
        // offsets are immediates of its loads
        const T* col[4];
        col[0] = tab + 3 * node;
        col[1] = col[0] + G.sy;
        col[2] = col[0] + G.sx;
        col[3] = col[2] + G.sy;
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (need & (1u << q)) load_node<T>(col[q >> 1] + 3 * (q & 1), c[q]);
      }
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        float acc = __fmaf_rn(w[0], c[0][m], __fmul_rn(w[1], c[1][m]));
#pragma unroll
        for (int q = 2; q < 8; ++q) acc = __fmaf_rn(w[q], c[q][m], acc);
        B[m] = G.scale != nullptr ? __fmul_rn(acc, sc[m]) : acc;
      }
    }
    const float tx_ = __fmul_rn(wdt, B[0]), ty_ = __fmul_rn(wdt, B[1]),
                tz_ = __fmul_rn(wdt, B[2]);
    const float t2 = __fadd_rn(
        __fadd_rn(__fmul_rn(tx_, tx_), __fmul_rn(ty_, ty_)),
        __fmul_rn(tz_, tz_));
    const float sfac = __fdiv_rn(2.0f, __fadd_rn(1.0f, t2));
    const float ux = __fadd_rn(vx, xc(vy, tz_, vz, ty_));
    const float uy = __fadd_rn(vy, xc(vz, tx_, vx, tz_));
    const float uz = __fadd_rn(vz, xc(vx, ty_, vy, tx_));
    const float nvx = __fmaf_rn(sfac, xc(uy, tz_, uz, ty_), vx);
    const float nvy = __fmaf_rn(sfac, xc(uz, tx_, ux, tz_), vy);
    const float nvz = __fmaf_rn(sfac, xc(ux, ty_, uy, tx_), vz);
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
// 3 ny nz + 3 nz + 3 must fit in an int.
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
  G.sx = 3 * ny * nz; G.sy = 3 * nz;
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
