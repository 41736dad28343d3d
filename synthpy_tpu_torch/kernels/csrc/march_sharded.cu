// K17: one segment of the grid-sharded segment march, on one device.
//
// Replaces the per-device program of the JAX package's grid-sharded march,
// the local_fn of make_gridsharded_segment_tracer (synthpy_tpu/parallel/
// mesh.py:277-308): march_segment(a_offset=lo) (synthpy_tpu/tracer/
// zscan.py:756) on each shard's a-rows of one segment's corner table plus
// a one-row halo, then where(owned, out, 0) and the psum over the grid
// axis. Shard g of a G-shard line holds a-rows [lo, lo + naloc) of the
// table, lo = g * naloc, and the first a-row of its right neighbour (the
// halo). A ray belongs to the shard whose rows hold its frozen corner cell,
// ia0 = clip(floor(ta), 0, na - 2) with lo <= ia0 < lo + naloc
// (mesh.py:292-297), so it has exactly one owner. Indices, fractions and
// the inside-mask stay global and are clipped to the real na; only the
// corner rows' addresses are offset into the owner's table, so an owned
// ray's result is bit-identical to K1's on the whole table.
//
// One launch a segment and device. The device's shards (each one's table,
// halo and lo, up to MAX_SHARDS) are a kernel parameter, filled by the
// entry point from host arrays. A thread finds its ray's corner cell once,
// then the owner among the device's shards by unrolled compares (K18's
// shard table, sharded_rhs.cu). An owned ray is marched with its owner's
// rows (march_core.cuh, K1's device code) and written once; a ray whose
// owner is on another device gets zeros. So one card holding the whole
// line runs one launch a segment and no psum at all.
//
// Across devices, exchange_rows replaces the psum: each device reads the
// rows the line's other devices own straight from their results, by peer
// loads over NVLink (peer access enabled by the entry point), and writes
// them into its own. Every device holds the segment's start state, so it
// finds each ray's owner itself, as shards_kernel does: no indices travel,
// nothing is added (the owner's + 0.0 is already in its row), and a device
// receives the (D - 1) / D of the rows it lacks, 32 bytes each, where the
// psum copied D - 1 whole (N, 8) results and added them. The wrapper
// orders the launch after each peer's march, and each device's later work
// after every peer's launch (stream events), so a result's memory is not
// reused while a peer reads it; there is no host sync.
//
// The psum's rounding: JAX's psum over G > 1 shards adds G - 1 zeros
// (+0.0) to the owner's value, which turns -0.0 into +0.0 and leaves every
// other value as it is; over G = 1 it leaves the value alone. The kernel
// writes owner_value + 0.0f when the line has G > 1 shards (add_zero), as
// K18 does; --fmad=false keeps the add.
//
// What bounds it on the H100: the march of every ray once, as K1 (see
// march.cu): the rays' operations, the table rows they touch and each
// ray's 32-byte state read and written once. The parent's design launched
// once a shard over every ray (four launches a segment on one card, three
// of every four threads reading a state to write 32 bytes of zeros) and
// summed the shards' (N, 8) outputs; on the 512^3 f32 rk2 mesh path (4 M
// rays, 4 shards on one H100 80GB HBM3, 700 W; chip_smoke's mesh_path) its
// four launches took 2.770 ms a segment against K1's 2.496 ms.
// The wrapper hands the rays over in entry-cell order (march.ray_order),
// which keeps a warp's rays on neighbouring corner rows. Built with
// --fmad=false, as K1.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "march_core.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAX_SHARDS = 8;

// The frozen corner row of coordinate x on an axis of n nodes, clip(floor(
// (x - o) * inv), 0, n - 2) as mesh.py:292-297 computes it (a NaN gives 0):
// a-rows pick the owning shard, in shards_kernel and exchange_kernel alike.
__device__ __forceinline__ int corner_row(float x, float o, float inv,
                                          int n) {
  return (int)fminf(fmaxf(floorf((x - o) * inv), 0.0f), (float)(n - 2));
}

// The device's shards of one segment, in shard order.
struct Shards {
  const unsigned char* table[MAX_SHARDS];  // shard g's (naloc*nb, row_len)
  const unsigned char* halo[MAX_SHARDS];   // its right neighbour's a-row
  int lo[MAX_SHARDS];
  int n, naloc, add_zero;
};

template <int DT, class LY>
__global__ void __launch_bounds__(THREADS) shards_kernel(const Params P,
                                                         const Shards S) {
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
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
  const int ia0 = corner_row(s[0], P.oa, P.inva, P.na);
  const int ib0 = corner_row(s[1], P.ob, P.invb, P.nb);
  // the owner among this device's shards (at most one)
  const unsigned char* table = nullptr;
  const unsigned char* halo = nullptr;
  int lo = 0;
#pragma unroll
  for (int g = 0; g < MAX_SHARDS; ++g) {
    if (g < S.n && ia0 >= S.lo[g] && ia0 < S.lo[g] + S.naloc) {
      table = S.table[g];
      halo = S.halo[g];
      lo = S.lo[g];
    }
  }
  if (table == nullptr) {
    out[0] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    out[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  const long long row_bytes = (long long)P.row_len * elem_bytes<DT>();
  const int la = ia0 - lo;
  Corners X;
  X.ia0f = (float)ia0;
  X.ib0f = (float)ib0;
  const unsigned char* r00 = table + ((long long)la * P.nb + ib0) * row_bytes;
  X.row[0] = r00;
  X.row[1] = r00 + row_bytes;
  // a-row la + 1 is the halo when the cell is the shard's last row
  X.row[2] = la + 1 < S.naloc ? r00 + P.nb * row_bytes
                              : halo + (long long)ib0 * row_bytes;
  X.row[3] = X.row[2] + row_bytes;
  X.sc = P.scales;
  march_segment<DT, LY>(P, X, s);
  if (S.add_zero) {
#pragma unroll
    for (int q = 0; q < 8; ++q) s[q] = __fadd_rn(s[q], 0.0f);
  }
  out[0] = make_float4(s[0], s[1], s[2], s[3]);
  out[1] = make_float4(s[4], s[5], s[6], s[7]);
}

template <int DT, class LY>
void launch(const Params& P, const Shards& S, cudaStream_t st) {
  const unsigned blocks = (unsigned)((P.N + THREADS - 1) / THREADS);
  shards_kernel<DT, LY><<<blocks, THREADS, 0, st>>>(P, S);
}

template <int DT>
void launch_dtype(const Params& P, const Shards& S, int layout,
                  cudaStream_t st) {
  switch (layout) {
    case 0: launch<DT, Layout<0, 0, 0>>(P, S, st); break;
    case 1: launch<DT, Layout<1, 0, 0>>(P, S, st); break;
    case 2: launch<DT, Layout<0, 1, 0>>(P, S, st); break;
    case 3: launch<DT, Layout<1, 1, 0>>(P, S, st); break;
    case 4: launch<DT, Layout<0, 0, 1>>(P, S, st); break;
    case 5: launch<DT, Layout<1, 0, 1>>(P, S, st); break;
    case 6: launch<DT, Layout<0, 1, 1>>(P, S, st); break;
    default: launch<DT, Layout<1, 1, 1>>(P, S, st); break;
  }
}

constexpr int MAX_DEVICES = 8;
constexpr int MAX_LINE_SHARDS = 64;

// One device's part of a line's exchange.
struct Exchange {
  const float* u;                  // (N, 8) the segment's start states
  float* out;                      // (N, 8) this device's result
  const float* peer[MAX_DEVICES];  // each device's result, in line order
  int block_of[MAX_LINE_SHARDS];   // each shard's device, in line order
  long long N;
  int self, naloc, na;
  float oa, inva;
};

__global__ void __launch_bounds__(THREADS) exchange_kernel(const Exchange E) {
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= E.N) return;
  // the owner of the ray's frozen corner a-row, as shards_kernel finds it
  const int d =
      E.block_of[corner_row(E.u[i * 8], E.oa, E.inva, E.na) / E.naloc];
  if (d == E.self) return;
  const float4* src = reinterpret_cast<const float4*>(E.peer[d] + i * 8);
  float4* dst = reinterpret_cast<float4*>(E.out + i * 8);
  dst[0] = src[0];
  dst[1] = src[1];
}

}  // namespace

// The exchange of one segment's rows on device self of a line of n_devices
// devices: out (this device's (N, 8) result) receives every row whose
// owner is another device, read from that device's result (peers[d], the
// line's results in line order, as device pointers; peer_ordinals[d] their
// CUDA ordinals). u: this device's (N, 8) start states; block_of[g]: the
// line index of shard g's device, for the line_shards shards of naloc
// a-rows. Enables peer access to the other devices' memory first. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for too many devices or
// shards.
extern "C" int exchange_rows(const float* u, float* out,
                             const void* const* peers,
                             const int* peer_ordinals, int n_devices,
                             int self, const int* block_of, int line_shards,
                             long long N, int naloc, int na, float oa,
                             float inva, void* stream) {
  if (n_devices < 1 || n_devices > MAX_DEVICES || line_shards < 1 ||
      line_shards > MAX_LINE_SHARDS || self < 0 || self >= n_devices)
    return (int)cudaErrorInvalidValue;
  const int here = peer_ordinals[self];
  for (int d = 0; d < n_devices; ++d) {
    if (peer_ordinals[d] == here) continue;
    int can = 0;
    cudaDeviceCanAccessPeer(&can, here, peer_ordinals[d]);
    if (!can) return (int)cudaErrorPeerAccessUnsupported;
    const cudaError_t e = cudaDeviceEnablePeerAccess(peer_ordinals[d], 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) cudaGetLastError();
    else if (e != cudaSuccess) return (int)e;
  }
  if (N == 0) return 0;
  Exchange E = {};
  E.u = u;
  E.out = out;
  for (int d = 0; d < n_devices; ++d)
    E.peer[d] = static_cast<const float*>(peers[d]);
  for (int g = 0; g < line_shards; ++g) E.block_of[g] = block_of[g];
  E.N = N;
  E.self = self;
  E.naloc = naloc;
  E.na = na;
  E.oa = oa;
  E.inva = inva;
  const unsigned blocks = (unsigned)((N + THREADS - 1) / THREADS);
  exchange_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(E);
  return (int)cudaGetLastError();
}

// u_in, u_out: (N, 8) f32 permuted states, 16-byte aligned. order: (N,)
// int64 or null. n_shards shards of this device, in shard order: tables[g]
// the shard's (naloc*nb, row_len) rows of one segment, halos[g] the
// (nb, row_len) rows of a-row lo[g] + naloc (null when no owned cell
// reaches it), in f32 / bf16 / int8 values or int4 nibble-pair bytes (host
// arrays); scales: the segment's (K+1, C) f32 for the quantised tables,
// else null. line_shards: G, the shards of the whole line (the owner's
// value gets + 0.0f when G > 1). Rays owned on another device get zeros.
// Returns cudaGetLastError(), or cudaErrorInvalidValue when n_shards is not
// 1 to MAX_SHARDS.
extern "C" int march_shards(const float* u_in, float* u_out,
                            const long long* order,
                            const void* const* tables,
                            const void* const* halos, const int* lo,
                            int n_shards, const float* scales, long long N,
                            int naloc, int line_shards, int row_len, int K,
                            int dtype, int integrator, int slab_weights,
                            int na, int nb, float oa, float ob, float inva,
                            float invb, float h, int inv_brems,
                            int phaseshift, int B_on, float atten_sign,
                            void* stream) {
  if (n_shards < 1 || n_shards > MAX_SHARDS)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  Params P;
  P.u_in = u_in; P.u_out = u_out; P.order = order;
  P.table = nullptr; P.scales = scales;
  P.N = N;
  P.n_seg = 1; P.cells = naloc * nb; P.row_len = row_len; P.K = K;
  P.integrator = integrator; P.slab_weights = slab_weights;
  P.na = na; P.nb = nb; P.oa = oa; P.ob = ob; P.inva = inva; P.invb = invb;
  P.h = h; P.atten_sign = atten_sign;
  Shards S = {};
  for (int g = 0; g < n_shards; ++g) {
    S.table[g] = static_cast<const unsigned char*>(tables[g]);
    S.halo[g] = static_cast<const unsigned char*>(halos[g]);
    S.lo[g] = lo[g];
  }
  S.n = n_shards;
  S.naloc = naloc;
  S.add_zero = line_shards > 1;
  const int layout = inv_brems | (phaseshift << 1) | (B_on << 2);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case F32: launch_dtype<F32>(P, S, layout, st); break;
    case BF16: launch_dtype<BF16>(P, S, layout, st); break;
    case I8: launch_dtype<I8>(P, S, layout, st); break;
    default: launch_dtype<I4>(P, S, layout, st); break;
  }
  return (int)cudaGetLastError();
}
