// K1: the segment march.
//
// Replaces the JAX device program march_segment (synthpy_tpu/tracer/zscan.py
// :756), looped over segments by trace_zscan_segments (:1106): per ray and
// segment, freeze the corner cell ia0 = clip(floor(ta), 0, na-2) (:849-854),
// then march the segment's K slabs with rk4, rk2, rk2s2 (2-slab midpoint) or
// rk2s4 (4-slab midpoint), blending the 4 corner rows bilinearly with
// per-stage or per-slab weights (_cols_weights :700), dequantising int8 and
// int4 tables with the per-(segment, plane, channel) scales, and evaluating
// the 8-component right-hand side _cols_rhs (:636).
//
// What bounds it on the H100. Read in the caller's order, the 32 rays of
// a warp sit in up to 32 cells of a random beam, and each scalar corner
// load of a warp touched ~32 sectors for 2 useful bytes each (a model from
// the rays' addresses): 80 ms at the 512^3 bf16 rk2 main path (4 M rays,
// H100 80GB HBM3, 700 W). In entry-cell order a warp load touches ~1.3
// sectors and the march takes ~17 ms, 4x its float32 operations bound.
// What bounds it now is inferred from timed variants, not measured: no
// hardware counter (issue slots, stalls, hit rates) could be read there.
// No variant moved it by more than ~7%: staging each block's corner rows
// in shared memory by cp.async (5-7% on bf16, none on int4, at the cost of
// a second read path), more warps an SM or 256-thread blocks (under 3%),
// the contracted build with far fewer instructions (6%). So neither the
// corner reads nor the instruction count alone hold it; by elimination it
// is the chain of ~200 dependent instructions a ray and slab at 28 warps
// an SM, and whether issue or latency dominates there is not known.
// The design:
// - The wrapper orders the rays by entry cell (march.ray_order, a stable
//   argsort); ray i of the launch is ray order[i] of the caller, and its
//   result goes back to row order[i]. A warp's rays then share a few
//   neighbouring cells and their corner reads share sectors in L1, in
//   later segments too, since rays drift little.
// - Corner rows are read straight from the table. Rows are row_len * elem
//   bytes apart (3,078 B at 512^3 bf16 C = 3), so only 2-byte aligned, and
//   a corner's C values are scalar loads.
// - rk2 and rk4 slabs carry plane k+1's corner values in registers into
//   the next slab as its plane k, which halves the corner reads; the state
//   is read and written as two 16-byte vectors.
// The arithmetic per ray is a 4-weight blend of C values and an 8-term
// update with no operand shared across rays, so there is no matrix product
// for the tensor cores.
//
// Arithmetic follows the JAX stage order (hoisted z-blend wm = 0.5*(w0+w1),
// weights, blend, right-hand side), operation for operation as the plain
// PyTorch version does it. This file is built with --fmad=false: contracted
// multiply-adds round differently, and over the 512 slabs of a 512^3 march
// that drifts a velocity column by ~1e-5 of its largest value away from the
// plain version; the contracted build is only ~6% faster at the main path
// (and __frcp_rn in place of the division ~2%), too little to give up
// bit-equality with the plain version. The 2- and 4-slab midpoint
// steps share one code path (midpoint_step), so rk2s2 on a stride-2 pack
// is bit-identical to rk2s4 on the full pack here as it is in the JAX
// package. The order moves only where a ray's result is computed, never
// its arithmetic, so every ray's result is bit-identical in any order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// The per-segment device code (march_segment, the corner loads and the
// right-hand side) is in march_core.cuh, shared with K17
// (march_sharded.cu, the grid-sharded march).
#include "march_core.cuh"

namespace {

constexpr int THREADS = 128;

template <int DT, class LY>
__global__ void __launch_bounds__(THREADS) march_kernel(Params P) {
  constexpr int C = LY::C;
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= P.N) return;
  const long long r = P.order[i];
  float s[8];
  {
    const float4* u = reinterpret_cast<const float4*>(P.u_in + r * 8);
    const float4 a = u[0], b = u[1];
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
  }
  const long long row_bytes = (long long)P.row_len * elem_bytes<DT>();
  for (int seg = 0; seg < P.n_seg; ++seg) {
    const float ta = (s[0] - P.oa) * P.inva;
    const float tb = (s[1] - P.ob) * P.invb;
    const int ia0 = (int)fminf(fmaxf(floorf(ta), 0.0f), (float)(P.na - 2));
    const int ib0 = (int)fminf(fmaxf(floorf(tb), 0.0f), (float)(P.nb - 2));
    Corners X;
    X.ia0f = (float)ia0;
    X.ib0f = (float)ib0;
    const unsigned char* r00 =
        P.table +
        ((long long)seg * P.cells + (long long)ia0 * P.nb + ib0) * row_bytes;
    X.row[0] = r00;
    X.row[1] = r00 + row_bytes;
    X.row[2] = r00 + P.nb * row_bytes;
    X.row[3] = X.row[2] + row_bytes;
    X.sc = P.scales ? P.scales + (long long)seg * (P.K + 1) * C : nullptr;
    march_segment<DT, LY>(P, X, s);
  }
  float4* u = reinterpret_cast<float4*>(P.u_out + r * 8);
  u[0] = make_float4(s[0], s[1], s[2], s[3]);
  u[1] = make_float4(s[4], s[5], s[6], s[7]);
}

template <int DT, class LY>
void launch(const Params& P, cudaStream_t st) {
  const unsigned blocks = (unsigned)((P.N + THREADS - 1) / THREADS);
  march_kernel<DT, LY><<<blocks, THREADS, 0, st>>>(P);
}

template <int DT>
void launch_dtype(const Params& P, int layout, cudaStream_t st) {
  switch (layout) {
    case 0: launch<DT, Layout<0, 0, 0>>(P, st); break;
    case 1: launch<DT, Layout<1, 0, 0>>(P, st); break;
    case 2: launch<DT, Layout<0, 1, 0>>(P, st); break;
    case 3: launch<DT, Layout<1, 1, 0>>(P, st); break;
    case 4: launch<DT, Layout<0, 0, 1>>(P, st); break;
    case 5: launch<DT, Layout<1, 0, 1>>(P, st); break;
    case 6: launch<DT, Layout<0, 1, 1>>(P, st); break;
    default: launch<DT, Layout<1, 1, 1>>(P, st); break;
  }
}

}  // namespace

// u_in, u_out: (N, 8) f32 permuted states, 16-byte aligned. order: (N,)
// int64, ray order[i] is marched i-th. table: (n_seg, cells, row_len) of
// f32 / bf16 / int8 values or int4 nibble-pair bytes; scales: (n_seg, K+1, C) f32 for the quantised tables, else null. Returns
// cudaGetLastError().
extern "C" int march_segments(const float* u_in, float* u_out,
                              const long long* order, const void* table,
                              const float* scales, long long N, int n_seg,
                              int cells,
                              int row_len, int K, int dtype, int integrator,
                              int slab_weights, int na, int nb, float oa,
                              float ob, float inva, float invb, float h,
                              int inv_brems, int phaseshift, int B_on,
                              float atten_sign, void* stream) {
  if (N == 0) return 0;
  Params P;
  P.u_in = u_in; P.u_out = u_out; P.order = order;
  P.table = (const unsigned char*)table; P.scales = scales;
  P.N = N;
  P.n_seg = n_seg; P.cells = cells; P.row_len = row_len; P.K = K;
  P.integrator = integrator; P.slab_weights = slab_weights;
  P.na = na; P.nb = nb; P.oa = oa; P.ob = ob; P.inva = inva; P.invb = invb;
  P.h = h; P.atten_sign = atten_sign;
  const int layout = inv_brems | (phaseshift << 1) | (B_on << 2);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case F32: launch_dtype<F32>(P, layout, st); break;
    case BF16: launch_dtype<BF16>(P, layout, st); break;
    case I8: launch_dtype<I8>(P, layout, st); break;
    default: launch_dtype<I4>(P, layout, st); break;
  }
  return (int)cudaGetLastError();
}
