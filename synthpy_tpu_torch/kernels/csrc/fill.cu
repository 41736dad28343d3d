// K9: the plane-batch fill of the scale pack builders.
//
// Replaces synthpy_tpu/tracer/zscan.py:2041 _channel_batch_writer.write
// (:2055), run by the fill closures of build_segment_pack_upload (:2254)
// and build_segment_pack_synth (:2464): from a (pb+2, na, nb) float32 ne
// slab (body planes g0 .. g0+pb-1 with one stencil plane on each side) and
// the pointwise volumes of the same planes (Te, Z, then B along a, b, p),
// compute the C pack channels, quantise each (plane, channel) with its own
// scale (optionally dithered by fold_in(key, absolute plane)), and write the
// planes straight into the pack at (segment, :, col0) of a (n_seg, na*nb,
// blocks*C) table, and the scales at (segment, k0, :). Float tiers are one
// pass; int8/int4 two: pass 1 reduces |value| per (plane, channel) (a block
// reduction over its cells, then one atomicMax on the float's bits, which
// order as unsigned integers for |v| >= 0), pass 2 recomputes the values
// and writes codes, int4 as nibble pairs (plane 2j low, 2j+1 high; the lone
// final plane of a segment takes a zero high nibble and writes only its
// own scale row).
//
// The channel arithmetic is K2's (channels.cuh, the same operations in the
// same order), with JAX's boundary rules: the first absolute plane doubles
// its probe-axis difference, the last real one (n_p - 1) takes 2 Gp +
// pref ne / dp, and planes past n_p - 1 are zero before the amax. So a pack
// filled batch by batch equals K2's build of the same volumes bit for bit.
//
// What bounds it on the H100: bytes. Each output value reads its ne
// stencil (five values of three planes, mostly from L1) and the pointwise
// volumes once, and writes 1-4 bytes; the quantised tiers read the inputs
// twice. A simple design: one thread per (cell, output block), consecutive
// threads on consecutive cells of one plane (coalesced reads of the slab;
// the table rows are written strided).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "channels.cuh"

namespace {

using namespace channels;

constexpr int THREADS = 256;

struct Batch {
  const float* slab;      // (pb+2, na, nb)
  const float* ex;        // element (e, j, a, b) at j*ex_sp + e*ex_se + cell
  long long ex_sp, ex_se;
  int g0, pb, n_p, na, nb, cells;
  float pref, da, db, two_dp, dp, omega, n_coef, verdet;
};

// channel values of body plane j (absolute plane g0 + j) at cell (a, b)
template <class LY>
__device__ __forceinline__ void values(const Batch& B, int j, int cell,
                                       float v[LY::C]) {
  const int g = B.g0 + j;
  if (g > B.n_p - 1) {
#pragma unroll
    for (int c = 0; c < LY::C; ++c) v[c] = 0.0f;
    return;
  }
  const int a = cell / B.nb, b = cell - a * B.nb;
  const long long page = (long long)B.cells;
  const float* mid = B.slab + (j + 1) * page;
  const float body = mid[cell];
  const float alo = a == 0 ? body : mid[cell - B.nb];
  const float ahi = a == B.na - 1 ? body : mid[cell + B.nb];
  v[0] = B.pref * grad1(alo, ahi, a, B.na, B.da);
  const float blo = b == 0 ? body : mid[cell - 1];
  const float bhi = b == B.nb - 1 ? body : mid[cell + 1];
  v[1] = B.pref * grad1(blo, bhi, b, B.nb, B.db);
  const float up = mid[page + cell], dn = mid[cell - page];
  float gp = B.pref * (up - dn) / B.two_dp;
  if (g == 0) gp = 2.0f * gp;
  if (g == B.n_p - 1) gp = 2.0f * gp + B.pref * body / B.dp;
  v[2] = gp;
  const float* ex = B.ex + j * B.ex_sp + cell;
  if constexpr (LY::inv_brems)
    v[LY::KI] = kappa_of(body, ex[0], ex[B.ex_se], B.omega);
  if constexpr (LY::phaseshift) {
    const float arg = 1.0f - B.n_coef * body;
    v[LY::PI] = B.omega * ((arg > 0.0f ? sqrtf(arg) : 0.0f) - 1.0f);
  }
  if constexpr (LY::B_on) {
    const long long e0 = (LY::inv_brems ? 2 : 0) * B.ex_se;
    v[LY::FI + 0] = B.verdet * body * ex[e0];
    v[LY::FI + 1] = B.verdet * body * ex[e0 + B.ex_se];
    v[LY::FI + 2] = B.verdet * body * ex[e0 + 2 * B.ex_se];
  }
}

// pass 1: block (x, plane j) folds |v| over a grid-stride run of cells
template <class LY>
__global__ void __launch_bounds__(THREADS)
    amax_pass(Batch B, unsigned* amax) {
  constexpr int C = LY::C;
  __shared__ float red[THREADS / 32][C];
  const int j = blockIdx.y;
  float m[C];
#pragma unroll
  for (int c = 0; c < C; ++c) m[c] = 0.0f;
  for (int cell = blockIdx.x * THREADS + threadIdx.x; cell < B.cells;
       cell += gridDim.x * THREADS) {
    float v[C];
    values<LY>(B, j, cell, v);
#pragma unroll
    for (int c = 0; c < C; ++c) m[c] = fmaxf(m[c], fabsf(v[c]));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float x = m[c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      x = fmaxf(x, __shfl_down_sync(0xffffffffu, x, o));
    if (lane == 0) red[warp][c] = x;
  }
  __syncthreads();
  if (threadIdx.x < C) {
    float x = 0.0f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) x = fmaxf(x, red[w][threadIdx.x]);
    atomicMax(amax + j * C + threadIdx.x, __float_as_uint(x));
  }
}

// pass 2 (or the only pass of a float tier): thread (cell, block q) writes
// output block q of the batch (plane q, or int4 planes 2q and 2q + 1);
// block (x, q). Cell 0's thread writes the scales.
template <class LY, int MODE, bool DITHER>
__global__ void __launch_bounds__(THREADS)
    write_pass(Batch B, void* out, long long row_elems, const unsigned* amax,
               float* scl, int lone, uint2 dkey) {
  constexpr int C = LY::C;
  constexpr int ES = MODE == F32 ? 4 : MODE == BF16 ? 2 : 1;
  constexpr float QMAX = MODE == INT4 ? 7.0f : 127.0f;
  const int cell = blockIdx.x * THREADS + threadIdx.x;
  if (cell >= B.cells) return;
  const int q = blockIdx.y;
  uint8_t* o = reinterpret_cast<uint8_t*>(out) +
               ((long long)cell * row_elems + (long long)q * C) * ES;
  if constexpr (MODE == F32 || MODE == BF16) {
    float v[C];
    values<LY>(B, q, cell, v);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if constexpr (MODE == F32)
        reinterpret_cast<float*>(o)[c] = v[c];
      else
        reinterpret_cast<__nv_bfloat16*>(o)[c] = __float2bfloat16_rn(v[c]);
    }
  } else {
    const int j = MODE == INT4 ? 2 * q : q;
    const bool has_hi = MODE == INT4 && !lone;
    float sc0[C], sc1[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      sc0[c] = scale_of(amax[j * C + c], QMAX);
      sc1[c] = has_hi ? scale_of(amax[(j + 1) * C + c], QMAX) : 1.0f;
    }
    float v[C], w[C];
    values<LY>(B, j, cell, v);
    if (has_hi) values<LY>(B, j + 1, cell, w);
    const unsigned long long d0 = (unsigned long long)cell * C;
    uint2 pk0 = dkey, pk1 = dkey;
    if constexpr (DITHER) {
      pk0 = threefry::fold_in(dkey, (uint32_t)(B.g0 + j));
      pk1 = threefry::fold_in(dkey, (uint32_t)(B.g0 + j + 1));
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      int lo, hi = 0;
      if constexpr (DITHER) {
        lo = dithered_code(v[c], sc0[c], QMAX, pk0, d0 + c);
        if (has_hi) hi = dithered_code(w[c], sc1[c], QMAX, pk1, d0 + c);
      } else {
        lo = code_of(v[c], sc0[c], QMAX);
        if (has_hi) hi = code_of(w[c], sc1[c], QMAX);
      }
      o[c] = MODE == INT4 ? nibble_pair(lo, hi) : (uint8_t)(int8_t)lo;
    }
    if (cell == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        scl[j * C + c] = sc0[c];
        if (has_hi) scl[(j + 1) * C + c] = sc1[c];
      }
    }
  }
}

template <class LY>
int fill_layout(const Batch& B, int mode, void* out, long long row_elems,
                unsigned* amax, float* scl, int lone, int dither, uint2 dkey,
                cudaStream_t st) {
  const unsigned cblocks = (unsigned)((B.cells + THREADS - 1) / THREADS);
  if (mode == INT8 || mode == INT4) {
    const unsigned ax = cblocks < 64 ? cblocks : 64;
    amax_pass<LY><<<dim3(ax, B.pb), THREADS, 0, st>>>(B, amax);
  }
  const int nq = mode == INT4 ? (B.pb + 1) / 2 : B.pb;
  void (*k)(Batch, void*, long long, const unsigned*, float*, int, uint2) =
      mode == F32    ? write_pass<LY, F32, false>
      : mode == BF16 ? write_pass<LY, BF16, false>
      : mode == INT8 ? (dither ? write_pass<LY, INT8, true>
                               : write_pass<LY, INT8, false>)
                     : (dither ? write_pass<LY, INT4, true>
                               : write_pass<LY, INT4, false>);
  k<<<dim3(cblocks, nq), THREADS, 0, st>>>(B, out, row_elems, amax, scl,
                                           lone, dkey);
  return 0;
}

}  // namespace

// out: the pack's first element of (segment, cell 0, column col0); scl:
// the scale row (segment, k0) (quantised modes); amax: (pb, C) unsigned
// zeroed by the caller. mode 0 f32, 1 bf16, 2 int8, 3 int4. lone: one int4
// plane, high nibble zero.
extern "C" int pack_fill(void* out, int mode, long long row_elems,
                         float* scl, unsigned* amax, const float* slab,
                         const float* ex, long long ex_sp, long long ex_se,
                         int g0, int pb, int lone, int n_p, int na, int nb,
                         float pref, float da, float db, float two_dp,
                         float dp, float omega, float n_coef, float verdet,
                         int inv_brems, int phaseshift, int B_on, int dither,
                         long long key0, long long key1, void* stream) {
  Batch B;
  B.slab = slab; B.ex = ex; B.ex_sp = ex_sp; B.ex_se = ex_se;
  B.g0 = g0; B.pb = pb; B.n_p = n_p; B.na = na; B.nb = nb;
  B.cells = na * nb;
  B.pref = pref; B.da = da; B.db = db; B.two_dp = two_dp; B.dp = dp;
  B.omega = omega; B.n_coef = n_coef; B.verdet = verdet;
  cudaStream_t st = (cudaStream_t)stream;
  const uint2 dk = make_uint2((uint32_t)key0, (uint32_t)key1);
  int rc;
  switch (inv_brems | (phaseshift << 1) | (B_on << 2)) {
    case 0: rc = fill_layout<Layout<0, 0, 0>>(B, mode, out, row_elems, amax, scl, lone, dither, dk, st); break;
    case 1: rc = fill_layout<Layout<1, 0, 0>>(B, mode, out, row_elems, amax, scl, lone, dither, dk, st); break;
    case 2: rc = fill_layout<Layout<0, 1, 0>>(B, mode, out, row_elems, amax, scl, lone, dither, dk, st); break;
    case 3: rc = fill_layout<Layout<1, 1, 0>>(B, mode, out, row_elems, amax, scl, lone, dither, dk, st); break;
    case 4: rc = fill_layout<Layout<0, 0, 1>>(B, mode, out, row_elems, amax, scl, lone, dither, dk, st); break;
    case 5: rc = fill_layout<Layout<1, 0, 1>>(B, mode, out, row_elems, amax, scl, lone, dither, dk, st); break;
    case 6: rc = fill_layout<Layout<0, 1, 1>>(B, mode, out, row_elems, amax, scl, lone, dither, dk, st); break;
    default: rc = fill_layout<Layout<1, 1, 1>>(B, mode, out, row_elems, amax, scl, lone, dither, dk, st); break;
  }
  return rc ? rc : (int)cudaGetLastError();
}
