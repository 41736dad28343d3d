// K17: one segment of the grid-sharded segment march, on one shard.
//
// Replaces the per-device program of the JAX package's grid-sharded march,
// the local_fn of make_gridsharded_segment_tracer (synthpy_tpu/parallel/
// mesh.py:277-308): march_segment(a_offset=lo) (synthpy_tpu/tracer/
// zscan.py:756) on the shard's a-rows of one segment's corner table plus
// a one-row halo, then where(owned, out, 0) before the psum over the grid
// axis. Shard g holds a-rows [lo, lo + naloc) of the table, lo = g * naloc,
// and the first a-row of its right neighbour (the halo). A ray belongs to
// the shard whose rows hold its frozen corner cell, ia0 = clip(floor(ta),
// 0, na - 2) with lo <= ia0 < lo + naloc (mesh.py:292-297). Indices,
// fractions and the inside-mask stay global and are clipped to the real
// na; only the corner rows' addresses are offset into the local table, so
// an owned ray's result is bit-identical to K1's on the whole table. An
// unowned ray skips the march and writes zeros, which is what JAX's
// masked result holds.
//
// What bounds it on the H100: the march of the owned rays, as K1 (see
// march.cu); an unowned ray costs a read of its two transverse columns and
// a 32-byte write of zeros. The wrapper hands the rays over in entry-cell
// order (march.ray_order), which is a-row major, so a shard's owned rays
// are nearly contiguous in the launch and whole warps of unowned rays exit
// at once. Per segment and shard the bound is the owned rays' operations
// and the table rows they touch, plus N x 64 bytes for the states. On the
// 512^3 f32 rk2 mesh path (4 M rays, 4 shards on one H100 80GB HBM3, 700 W;
// chip_smoke's mesh_path) a segment's four launches took 2.75 ms against
// K1's 2.47 ms for the same segment, 19% of the operations bound.
// The design: one thread a ray, the corner-row set-up of march.cu's kernel
// with the halo in place of row naloc, and march_segment of
// march_core.cuh, the device code K1 runs. Built with --fmad=false, as K1.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "march_core.cuh"

namespace {

constexpr int OWNED_THREADS = 128;

struct Owned {
  Params P;                    // P.table: the shard's (naloc*nb, row_len)
  const unsigned char* halo;   // the right neighbour's first a-row (nb rows)
  int lo, naloc;
};

template <int DT, class LY>
__global__ void __launch_bounds__(OWNED_THREADS) owned_kernel(Owned Q) {
  const Params& P = Q.P;
  const long long i = blockIdx.x * (long long)OWNED_THREADS + threadIdx.x;
  if (i >= P.N) return;
  const long long r = P.order ? P.order[i] : i;
  float s[8];
  {
    const float4* u = reinterpret_cast<const float4*>(P.u_in + r * 8);
    const float4 a = u[0], b = u[1];
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
  }
  float4* out = reinterpret_cast<float4*>(P.u_out + r * 8);
  const float ta = (s[0] - P.oa) * P.inva;
  const float tb = (s[1] - P.ob) * P.invb;
  const int ia0 = (int)fminf(fmaxf(floorf(ta), 0.0f), (float)(P.na - 2));
  const int ib0 = (int)fminf(fmaxf(floorf(tb), 0.0f), (float)(P.nb - 2));
  if (ia0 < Q.lo || ia0 >= Q.lo + Q.naloc) {
    out[0] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    out[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  const long long row_bytes = (long long)P.row_len * elem_bytes<DT>();
  const int la = ia0 - Q.lo;
  Corners X;
  X.ia0f = (float)ia0;
  X.ib0f = (float)ib0;
  const unsigned char* r00 =
      P.table + ((long long)la * P.nb + ib0) * row_bytes;
  X.row[0] = r00;
  X.row[1] = r00 + row_bytes;
  // a-row la + 1 is the halo when the cell is the shard's last row
  X.row[2] = la + 1 < Q.naloc ? r00 + P.nb * row_bytes
                              : Q.halo + (long long)ib0 * row_bytes;
  X.row[3] = X.row[2] + row_bytes;
  X.sc = P.scales;
  march_segment<DT, LY>(P, X, s);
  out[0] = make_float4(s[0], s[1], s[2], s[3]);
  out[1] = make_float4(s[4], s[5], s[6], s[7]);
}

template <int DT, class LY>
void launch(const Owned& Q, cudaStream_t st) {
  const unsigned blocks =
      (unsigned)((Q.P.N + OWNED_THREADS - 1) / OWNED_THREADS);
  owned_kernel<DT, LY><<<blocks, OWNED_THREADS, 0, st>>>(Q);
}

template <int DT>
void launch_dtype(const Owned& Q, int layout, cudaStream_t st) {
  switch (layout) {
    case 0: launch<DT, Layout<0, 0, 0>>(Q, st); break;
    case 1: launch<DT, Layout<1, 0, 0>>(Q, st); break;
    case 2: launch<DT, Layout<0, 1, 0>>(Q, st); break;
    case 3: launch<DT, Layout<1, 1, 0>>(Q, st); break;
    case 4: launch<DT, Layout<0, 0, 1>>(Q, st); break;
    case 5: launch<DT, Layout<1, 0, 1>>(Q, st); break;
    case 6: launch<DT, Layout<0, 1, 1>>(Q, st); break;
    default: launch<DT, Layout<1, 1, 1>>(Q, st); break;
  }
}

}  // namespace

// u_in, u_out: (N, 8) f32 permuted states, 16-byte aligned. order: (N,)
// int64 or null. table: the shard's (naloc*nb, row_len) rows of one
// segment, halo: the (nb, row_len) rows of a-row lo + naloc (null when no
// owned cell reaches it), in f32 / bf16 / int8 values or int4 nibble-pair
// bytes; scales: the segment's (K+1, C) f32 for the quantised tables, else
// null. Unowned rays get zeros. Returns cudaGetLastError().
extern "C" int march_owned(const float* u_in, float* u_out,
                           const long long* order, const void* table,
                           const void* halo, const float* scales,
                           long long N, int lo, int naloc, int row_len,
                           int K, int dtype, int integrator,
                           int slab_weights, int na, int nb, float oa,
                           float ob, float inva, float invb, float h,
                           int inv_brems, int phaseshift, int B_on,
                           float atten_sign, void* stream) {
  if (N == 0) return 0;
  Owned Q;
  Params& P = Q.P;
  P.u_in = u_in; P.u_out = u_out; P.order = order;
  P.table = (const unsigned char*)table; P.scales = scales;
  P.N = N;
  P.n_seg = 1; P.cells = naloc * nb; P.row_len = row_len; P.K = K;
  P.integrator = integrator; P.slab_weights = slab_weights;
  P.na = na; P.nb = nb; P.oa = oa; P.ob = ob; P.inva = inva; P.invb = invb;
  P.h = h; P.atten_sign = atten_sign;
  Q.halo = (const unsigned char*)halo;
  Q.lo = lo;
  Q.naloc = naloc;
  const int layout = inv_brems | (phaseshift << 1) | (B_on << 2);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case F32: launch_dtype<F32>(Q, layout, st); break;
    case BF16: launch_dtype<BF16>(Q, layout, st); break;
    case I8: launch_dtype<I8>(Q, layout, st); break;
    default: launch_dtype<I4>(Q, layout, st); break;
  }
  return (int)cudaGetLastError();
}
