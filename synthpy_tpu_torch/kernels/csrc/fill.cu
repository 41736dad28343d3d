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
// pass; int8/int4 two: pass 1 reduces |value| per (plane, channel), pass 2
// recomputes the values and writes codes, int4 as nibble pairs (plane 2j
// low, 2j+1 high; the lone final plane of a segment takes a zero high
// nibble and writes only its own scale row).
//
// The channel arithmetic is K2's (channels.cuh, the same operations in the
// same order), with JAX's boundary rules: the first absolute plane doubles
// its probe-axis difference, the last real one (n_p - 1) takes 2 Gp +
// pref ne / dp, and planes past n_p - 1 are zero before the amax. So a pack
// filled batch by batch equals K2's build of the same volumes bit for bit.
//
// What bounds it on the H100: the dither's hashes where there is one (a
// threefry-2x32 hash a value, ~43 operations only the INT32 units take),
// else bytes (each value reads its ne stencil and the pointwise volumes
// once and writes 1-4 bytes; the quantised tiers read the inputs twice, as
// a plane's scale depends on all its cells). The design is K2's
// (pack.cu rows_pass) on the batch's cell-contiguous slab:
//   * A block of pass 2 owns a tile of CB consecutive cells, whole table
//     rows, and every plane of the batch, in chunks of PC planes
//     (plan_of sets CB, PC, the tile's pitch, the store width and pass 1's
//     runs from the batch's shape and table). Per chunk it stages in
//     shared memory, transposed (a row of the tile holds one cell's
//     planes), the ne rows
//     of its cells and their b-1 / b+1 neighbours from plane g-1 to g+1,
//     the a-1 / a+1 neighbour rows and the pointwise volumes, a warp
//     reading consecutive cells of one plane, by asynchronous copies
//     (cp.async: every copy of a thread in flight at once, none through
//     its registers; plain loads measured 13% slower a batch). Each (cell,
//     plane) is then computed once a pass from the tile. (A second tile
//     buffer, filled while the block computes on the first, measured 8%
//     slower: the 75 KB a block leaves three blocks an SM, not five.)
//   * Consecutive threads take consecutive output blocks of one cell's row,
//     so a warp's stores cover contiguous runs of the table; a thread
//     stores its block's C values as the widest words (up to 16 bytes) that
//     the pointer, the row pitch and the block's size all allow. (The first
//     design wrote one byte a thread at a time across 32 rows, each warp
//     store touching 32 sectors, and ran at 6% of its bytes bound; PERF.md.)
//   * The dither keys fold_in(key, g0 + j) are hashed once a block and
//     chunk into shared memory, not once a value; the draw index stays
//     cell * C + c.
//   * Pass 1 runs over a run of CR cells a block with the same tiles; a
//     thread keeps one plane's |v| maxima in registers, a block folds them
//     with shared atomics, then one atomicMax a block per (plane, channel)
//     on the float's bits, which order as unsigned integers for |v| >= 0.
// Built with --fmad=false, so that no multiply-add is contracted.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "channels.cuh"

namespace {

using namespace channels;

constexpr int THREADS = 256;
constexpr int CELLS_A_TILE = 32;       // table rows a tile holds (a warp
                                       // stages them)
constexpr int PLANES_A_CHUNK = 32;     // planes a tile holds at once (the
                                       // path's batch)
constexpr int SMEM_LIMIT = 48 * 1024;  // shared bytes a block may take
                                       // without opting in
constexpr int AMAX_BLOCKS = 132 * 64;  // pass 1's blocks over all chunks

struct Batch {
  const float* slab;      // (pb+2, na, nb)
  const float* ex;        // element (e, j, a, b) at j*ex_sp + e*ex_se + cell
  long long ex_sp, ex_se;
  int g0, pb, n_p, na, nb, cells;
  float pref, da, db, two_dp, dp, omega, n_coef, verdet;
};

// The launch plan (plan_of): CB cells a tile, PC planes a chunk, the
// tile's row pitch in floats (odd: a warp's transposed writes and strided
// reads spread over the banks), the bytes of shared memory, the store
// width in bytes, CR cells (whole tiles) a run of pass 1.
struct Plan {
  int cb, pc, pitch, smem, vec, cr;
};

// The tile, for the cells c0 .. c0+CB-1 of a block and the chunk's planes
// j0 .. j0+n-1 (body planes, batch-relative):
//   rows 0 .. CB+1            ne of cells c0-1 .. c0+CB, columns slab
//                             planes j0 .. j0+n+1 (body plane j is slab
//                             plane j+1)
//   rows CB+2 .. 2CB+1        ne of cell c0+i-nb (the a-1 neighbour),
//                             columns body planes j0 .. j0+n-1
//   rows 2CB+2 .. 3CB+1       ne of cell c0+i+nb (the a+1 neighbour)
//   rows 3CB+2 + e CB + i     pointwise volume e of cell c0+i
// Cells past the grid are clamped (their values are never used: the
// boundary rules take the cell itself there, and cells past the last are
// not written). After the tile: the chunk's dither keys (PC), scales and
// amax words (PC x C each), and the cells' (a, b) (CB).
template <int NE>
__host__ __device__ inline int tile_rows(int cb) {
  return 3 * cb + 2 + NE * cb;
}

template <int C, int NE>
__host__ __device__ inline int smem_bytes(const Plan& L) {
  return (tile_rows<NE>(L.cb) * L.pitch * 4 + 15) / 16 * 16 + L.pc * 8 +
         2 * L.pc * C * 4 + L.cb * 8;
}

template <int C, int NE>
struct Smem {
  float* tile;
  uint2* keys;
  float* scales;
  unsigned* amax;
  int2* ab;
  __device__ Smem(uint8_t* p, const Plan& L) {
    tile = reinterpret_cast<float*>(p);
    keys = reinterpret_cast<uint2*>(
        p + (tile_rows<NE>(L.cb) * L.pitch * 4 + 15) / 16 * 16);
    scales = reinterpret_cast<float*>(keys + L.pc);
    amax = reinterpret_cast<unsigned*>(scales + L.pc * C);
    ab = reinterpret_cast<int2*>(amax + L.pc * C);
  }
};

// Copy planes [0, np) of nr consecutive cells from `first` (clamped to
// [0, cells)) of a plane-major source (plane stride sp) into tile rows
// row0 .. row0+nr-1, column k = plane, by asynchronous 4-byte copies (a
// thread issues all of its copies before any lands; the caller waits for
// them); a warp reads consecutive cells of one plane. nr <= THREADS.
__device__ __forceinline__ void stage(float* tile, int pitch, int row0,
                                      const float* src, long long sp, int np,
                                      int nr, int first, int cells) {
  const int dk = THREADS / nr, dr = THREADS - dk * nr;
  int k = threadIdx.x / nr, r = threadIdx.x - k * nr;
  while (k < np) {
    const int c = min(max(first + r, 0), cells - 1);
    __pipeline_memcpy_async(tile + (row0 + r) * pitch + k, src + k * sp + c,
                            4);
    r += dr;
    k += dk;
    if (r >= nr) {
      r -= nr;
      ++k;
    }
  }
}

// Stage the tile of cells c0 .. c0+CB-1 and body planes j0 .. j0+n-1, with
// the cells' (a, b). Ends with __syncthreads.
template <class LY>
__device__ void stage_tile(const Batch& B, const Plan& L, float* tile,
                           int2* ab, int c0, int j0, int n) {
  constexpr int NE = 2 * LY::inv_brems + 3 * LY::B_on;
  const int cb = L.cb, P = L.pitch;
  for (int i = threadIdx.x; i < cb; i += THREADS) {
    const int cell = min(c0 + i, B.cells - 1), a = cell / B.nb;
    ab[i] = make_int2(a, cell - a * B.nb);
  }
  const long long page = (long long)B.cells;
  const float* body0 = B.slab + (long long)j0 * page;
  stage(tile, P, 0, body0, page, n + 2, cb + 2, c0 - 1, B.cells);
  stage(tile, P, cb + 2, body0 + page, page, n, cb, c0 - B.nb, B.cells);
  stage(tile, P, 2 * cb + 2, body0 + page, page, n, cb, c0 + B.nb, B.cells);
#pragma unroll
  for (int e = 0; e < NE; ++e)
    stage(tile, P, 3 * cb + 2 + e * cb, B.ex + j0 * B.ex_sp + e * B.ex_se,
          B.ex_sp, n, cb, c0, B.cells);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// channel values of body plane j0 + jj (absolute plane g0 + j0 + jj) at
// cell i of the tile: fill.cu's first design's values(), operation for
// operation, reading the tile
template <class LY>
__device__ __forceinline__ void values(const Batch& B, const Plan& L,
                                       const float* tile, const int2* ab,
                                       int j0, int i, int jj,
                                       float v[LY::C]) {
  const int g = B.g0 + j0 + jj;
  if (g > B.n_p - 1) {
#pragma unroll
    for (int c = 0; c < LY::C; ++c) v[c] = 0.0f;
    return;
  }
  const int cb = L.cb, P = L.pitch;
  const int a = ab[i].x, b = ab[i].y;
  const float* mid = tile + (1 + i) * P + jj + 1;  // body plane's column
  const float body = mid[0];
  const float alo = a == 0 ? body : tile[(cb + 2 + i) * P + jj];
  const float ahi = a == B.na - 1 ? body : tile[(2 * cb + 2 + i) * P + jj];
  v[0] = B.pref * grad1(alo, ahi, a, B.na, B.da);
  const float blo = b == 0 ? body : mid[-P];
  const float bhi = b == B.nb - 1 ? body : mid[P];
  v[1] = B.pref * grad1(blo, bhi, b, B.nb, B.db);
  const float up = mid[1], dn = mid[-1];
  float gp = B.pref * (up - dn) / B.two_dp;
  if (g == 0) gp = 2.0f * gp;
  if (g == B.n_p - 1) gp = 2.0f * gp + B.pref * body / B.dp;
  v[2] = gp;
  const float* ex = tile + (3 * cb + 2 + i) * P + jj;  // volume e at e*cb*P
  if constexpr (LY::inv_brems)
    v[LY::KI] = kappa_of(body, ex[0], ex[cb * P], B.omega);
  if constexpr (LY::phaseshift) {
    const float arg = 1.0f - B.n_coef * body;
    v[LY::PI] = B.omega * ((arg > 0.0f ? sqrtf(arg) : 0.0f) - 1.0f);
  }
  if constexpr (LY::B_on) {
    const int e0 = (LY::inv_brems ? 2 : 0) * cb * P;
    v[LY::FI + 0] = B.verdet * body * ex[e0];
    v[LY::FI + 1] = B.verdet * body * ex[e0 + cb * P];
    v[LY::FI + 2] = B.verdet * body * ex[e0 + 2 * cb * P];
  }
}

// Store NW little-endian words (NB bytes) at o as the widest of 16, 8, 4,
// 2 or 1 bytes that `vec` allows (vec divides o's address and NB).
template <int NB>
__device__ __forceinline__ void store_run(uint8_t* o, const uint32_t* w,
                                          int vec) {
  if constexpr (NB % 16 == 0) {
    if (vec >= 16) {
#pragma unroll
      for (int k = 0; k < NB / 16; ++k)
        reinterpret_cast<uint4*>(o)[k] =
            make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
      return;
    }
  }
  if constexpr (NB % 8 == 0) {
    if (vec >= 8) {
#pragma unroll
      for (int k = 0; k < NB / 8; ++k)
        reinterpret_cast<uint2*>(o)[k] = make_uint2(w[2 * k], w[2 * k + 1]);
      return;
    }
  }
  if constexpr (NB % 4 == 0) {
    if (vec >= 4) {
#pragma unroll
      for (int k = 0; k < NB / 4; ++k)
        reinterpret_cast<uint32_t*>(o)[k] = w[k];
      return;
    }
  }
  if constexpr (NB % 2 == 0) {
    if (vec >= 2) {
#pragma unroll
      for (int k = 0; k < NB / 2; ++k)
        reinterpret_cast<uint16_t*>(o)[k] =
            (uint16_t)(w[k / 2] >> (16 * (k % 2)));
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < NB; ++k) o[k] = (uint8_t)(w[k / 4] >> (8 * (k % 4)));
}

// pass 1: block (run x, chunk y) folds |v| of its chunk's planes over the
// cells [x CR, x CR + CR); thread t owns plane t % n of the chunk and the
// cells t / n + m (THREADS / n) of each tile
template <class LY>
__global__ void __launch_bounds__(THREADS)
    amax_pass(Batch B, Plan L, unsigned* amax) {
  constexpr int C = LY::C;
  constexpr int NE = 2 * LY::inv_brems + 3 * LY::B_on;
  extern __shared__ uint4 smem_u4[];
  Smem<C, NE> S(reinterpret_cast<uint8_t*>(smem_u4), L);
  const int j0 = (int)blockIdx.y * L.pc, n = min(L.pc, B.pb - j0);
  const int jj = threadIdx.x % n, r0 = threadIdx.x / n, R = THREADS / n;
  for (int t = threadIdx.x; t < n * C; t += THREADS) S.amax[t] = 0u;
  float m[C];
#pragma unroll
  for (int c = 0; c < C; ++c) m[c] = 0.0f;
  const int cend = min((int)(blockIdx.x + 1) * L.cr, B.cells);
  for (int c0 = (int)blockIdx.x * L.cr; c0 < cend; c0 += L.cb) {
    stage_tile<LY>(B, L, S.tile, S.ab, c0, j0, n);
    const int ncell = min(L.cb, cend - c0);
    if (r0 < R) {
      for (int i = r0; i < ncell; i += R) {
        float v[C];
        values<LY>(B, L, S.tile, S.ab, j0, i, jj, v);
#pragma unroll
        for (int c = 0; c < C; ++c) m[c] = fmaxf(m[c], fabsf(v[c]));
      }
    }
    __syncthreads();  // the tile is restaged next
  }
  if (r0 < R) {
#pragma unroll
    for (int c = 0; c < C; ++c) atomicMax(S.amax + jj * C + c,
                                          __float_as_uint(m[c]));
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n * C; t += THREADS)
    atomicMax(amax + j0 * C + t, S.amax[t]);
}

// pass 2 (or the only pass of a float tier): block x writes the rows of
// cells [x CB, x CB + CB). Item (i, q) is cell i's output block q of the
// chunk (plane q, or int4 planes 2q and 2q + 1); consecutive threads take
// consecutive q. Block 0 writes the scales.
template <class LY, int MODE, bool DITHER>
__global__ void __launch_bounds__(THREADS)
    write_pass(Batch B, Plan L, uint8_t* out, long long row_bytes,
               const unsigned* amax, float* scl, int lone, uint2 dkey) {
  constexpr int C = LY::C;
  constexpr int NE = 2 * LY::inv_brems + 3 * LY::B_on;
  constexpr int ES = MODE == F32 ? 4 : MODE == BF16 ? 2 : 1;
  constexpr int NB = C * ES;                 // bytes of an output block
  constexpr int NW = (NB + 3) / 4;
  constexpr float QMAX = MODE == INT4 ? 7.0f : 127.0f;
  extern __shared__ uint4 smem_u4[];
  Smem<C, NE> S(reinterpret_cast<uint8_t*>(smem_u4), L);
  const int c0 = (int)blockIdx.x * L.cb;
  const int ncell = min(L.cb, B.cells - c0);
  for (int j0 = 0; j0 < B.pb; j0 += L.pc) {
    const int n = min(L.pc, B.pb - j0);
    if constexpr (MODE == INT8 || MODE == INT4) {
      // the chunk's scales (block 0 writes them out) and dither keys
      const int rows = lone ? 1 : n;
      for (int t = threadIdx.x; t < n * C; t += THREADS) {
        S.scales[t] = scale_of(amax[j0 * C + t], QMAX);
        if (blockIdx.x == 0 && t < rows * C) scl[j0 * C + t] = S.scales[t];
      }
      if constexpr (DITHER) {
        for (int t = threadIdx.x; t < n; t += THREADS)
          S.keys[t] = threefry::fold_in(dkey, (uint32_t)(B.g0 + j0 + t));
      }
    }
    stage_tile<LY>(B, L, S.tile, S.ab, c0, j0, n);
    const int nq = MODE == INT4 ? (n + 1) / 2 : n;
    const int q0 = MODE == INT4 ? j0 / 2 : j0;
    const int di = THREADS / nq, dq = THREADS - di * nq;
    int i = threadIdx.x / nq, q = threadIdx.x - i * nq;
    while (i < ncell) {
      uint32_t w[NW];
#pragma unroll
      for (int k = 0; k < NW; ++k) w[k] = 0u;
      const int cell = c0 + i;
      if constexpr (MODE == F32 || MODE == BF16) {
        float v[C];
        values<LY>(B, L, S.tile, S.ab, j0, i, q, v);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if constexpr (MODE == F32) {
            w[c] = __float_as_uint(v[c]);
          } else {
            const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(v[c]));
            w[c / 2] |= h << (16 * (c % 2));
          }
        }
      } else {
        const int jj = MODE == INT4 ? 2 * q : q;
        const bool has_hi = MODE == INT4 && !lone;
        const float* sc0 = S.scales + jj * C;
        const float* sc1 = sc0 + C;
        float v[C], u[C];
        values<LY>(B, L, S.tile, S.ab, j0, i, jj, v);
        if (has_hi) values<LY>(B, L, S.tile, S.ab, j0, i, jj + 1, u);
        const unsigned long long d0 = (unsigned long long)cell * C;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          int lo, hi = 0;
          if constexpr (DITHER) {
            lo = dithered_code(v[c], sc0[c], QMAX, S.keys[jj], d0 + c);
            if (has_hi)
              hi = dithered_code(u[c], sc1[c], QMAX, S.keys[jj + 1], d0 + c);
          } else {
            lo = code_of(v[c], sc0[c], QMAX);
            if (has_hi) hi = code_of(u[c], sc1[c], QMAX);
          }
          const uint32_t byte =
              MODE == INT4 ? nibble_pair(lo, hi) : (uint8_t)(int8_t)lo;
          w[c / 4] |= byte << (8 * (c % 4));
        }
      }
      store_run<NB>(out + (long long)cell * row_bytes +
                        (long long)(q0 + q) * NB,
                    w, L.vec);
      i += di;
      q += dq;
      if (q >= nq) {
        q -= nq;
        ++i;
      }
    }
    __syncthreads();  // the tile is restaged next chunk
  }
}

// The plan of a batch whose output blocks of C values of es bytes start
// at `out` in rows of row_bytes: tiles of CELLS_A_TILE cells, chunks of up
// to PLANES_A_CHUNK planes (fewer, and even, where the tile would not fit
// SMEM_LIMIT; an int4 batch of plane pairs keeps them whole), about
// AMAX_BLOCKS blocks of pass 1 in runs of whole tiles, and the widest
// store (16, 8, 4, 2 or 1 bytes) that divides the first block's address,
// the row pitch and the block's size.
template <int C, int NE>
Plan plan_of(int cells, int pb, int es, uintptr_t out, long long row_bytes) {
  Plan L;
  L.cb = CELLS_A_TILE;
  L.pc = pb < PLANES_A_CHUNK ? pb : PLANES_A_CHUNK;
  for (;;) {
    L.pitch = (L.pc + 2) | 1;
    L.smem = smem_bytes<C, NE>(L);
    if (L.smem <= SMEM_LIMIT || L.pc <= 2) break;
    L.pc -= 2;
  }
  const int n_chunks = (pb + L.pc - 1) / L.pc;
  const int per = (AMAX_BLOCKS + n_chunks - 1) / n_chunks;
  const int runs = per > 1 ? per : 1;
  L.cr = ((cells + runs - 1) / runs + L.cb - 1) / L.cb * L.cb;
  L.vec = 16;
  while (L.vec > 1 && (out % L.vec || row_bytes % L.vec || (C * es) % L.vec))
    L.vec /= 2;
  return L;
}

template <class LY>
int fill_layout(const Batch& B, int mode, uint8_t* out, long long row_elems,
                unsigned* amax, float* scl, int lone, int dither, uint2 dkey,
                cudaStream_t st) {
  constexpr int C = LY::C;
  constexpr int NE = 2 * LY::inv_brems + 3 * LY::B_on;
  const int es = mode == F32 ? 4 : mode == BF16 ? 2 : 1;
  const long long row_bytes = row_elems * es;
  const Plan L =
      plan_of<C, NE>(B.cells, B.pb, es, (uintptr_t)out, row_bytes);
  if (L.smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int n_chunk = (B.pb + L.pc - 1) / L.pc;
  if (mode == INT8 || mode == INT4) {
    const unsigned runs = (unsigned)((B.cells + L.cr - 1) / L.cr);
    amax_pass<LY><<<dim3(runs, n_chunk), THREADS, L.smem, st>>>(B, L, amax);
  }
  void (*k)(Batch, Plan, uint8_t*, long long, const unsigned*, float*, int,
            uint2) =
      mode == F32    ? write_pass<LY, F32, false>
      : mode == BF16 ? write_pass<LY, BF16, false>
      : mode == INT8 ? (dither ? write_pass<LY, INT8, true>
                               : write_pass<LY, INT8, false>)
                     : (dither ? write_pass<LY, INT4, true>
                               : write_pass<LY, INT4, false>);
  const unsigned blocks = (unsigned)((B.cells + L.cb - 1) / L.cb);
  k<<<blocks, THREADS, L.smem, st>>>(B, L, out, row_bytes, amax, scl, lone,
                                     dkey);
  return 0;
}

}  // namespace

// out: the pack's first element of (segment, cell 0, column col0); scl:
// the scale row (segment, k0) (quantised modes); amax: (pb, C) unsigned
// zeroed by the caller. mode 0 f32, 1 bf16, 2 int8, 3 int4 (pb even, or
// lone: one plane, high nibble zero).
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
  uint8_t* o = reinterpret_cast<uint8_t*>(out);
  int rc;
  switch (inv_brems | (phaseshift << 1) | (B_on << 2)) {
    case 0: rc = fill_layout<Layout<0, 0, 0>>(B, mode, o, row_elems, amax, scl, lone, dither, dk, st); break;
    case 1: rc = fill_layout<Layout<1, 0, 0>>(B, mode, o, row_elems, amax, scl, lone, dither, dk, st); break;
    case 2: rc = fill_layout<Layout<0, 1, 0>>(B, mode, o, row_elems, amax, scl, lone, dither, dk, st); break;
    case 3: rc = fill_layout<Layout<1, 1, 0>>(B, mode, o, row_elems, amax, scl, lone, dither, dk, st); break;
    case 4: rc = fill_layout<Layout<0, 0, 1>>(B, mode, o, row_elems, amax, scl, lone, dither, dk, st); break;
    case 5: rc = fill_layout<Layout<1, 0, 1>>(B, mode, o, row_elems, amax, scl, lone, dither, dk, st); break;
    case 6: rc = fill_layout<Layout<0, 1, 1>>(B, mode, o, row_elems, amax, scl, lone, dither, dk, st); break;
    default: rc = fill_layout<Layout<1, 1, 1>>(B, mode, o, row_elems, amax, scl, lone, dither, dk, st); break;
  }
  return rc ? rc : (int)cudaGetLastError();
}
