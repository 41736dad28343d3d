// K2: segment-pack builder, quantiser and decimator.
//
// Replaces the JAX device programs of synthpy_tpu/tracer/zscan.py:
//   * build_segment_pack_device's seg_fn (zscan.py:1812), float and fused
//     quantised (:1852-1883), with plane_stride kept planes (:1821-1827):
//     per K-slab segment, the transverse gradients pref*jnp.gradient(ne), the
//     probe-axis central difference with the first-plane x2 and last-plane
//     2*G + pref*ne/dp rules (zscan.py:1832-1838), the kappa, omega(n-1) and
//     Verdet*ne*B channels, zeroed pad planes, stored as [seg, cell, k*C + c];
//   * quantize_segment_pack.quant (zscan.py:493): per-(segment, plane,
//     channel) amax over cells, scale = amax/qmax, round half to even, int8
//     codes or int4 nibble pairs (plane 2j low, 2j+1 high);
//   * decimate_segment_pack.dec (zscan.py:576, :597): keep every stride-th
//     plane, repacking nibble pairs (its design is at decimate_kernel).
//
// What bounds it on the H100: bytes by count (each output value costs a few
// flops against 1-4 bytes written and 4 bytes of ne read), but in practice
// the instructions per output value: three IEEE divisions (kept, so that
// the tables equal the plain version's bit for bit), the stencil's reads
// and the loop around them. The design keeps that count low and reads ne
// from device memory once:
//   * A block stages CB consecutive cells of one segment (whole table rows)
//     and walks the kept planes in chunks as long as its tile holds (one
//     chunk at the main path's shapes). Per chunk it stages in shared memory
//     the ne rows of its cells and their b-1/b+1 neighbours, from plane g-1
//     to g+1, then computes every (cell, kept plane) from there. The launch
//     plan (kernels/pack.py build_plan, passed in, checked here against
//     this file's layout) sizes CB from pack.TILE_BUDGET and the pitch: 8
//     cells at K = 512, where 8 rows fill the tile, up to ~80 at K = 64
//     (z-probing), so that a barrier and a block's set-up (the row
//     pointers, the chunk's scales) cover ten times the cells. Consecutive
//     threads take consecutive planes of a row, so a warp's table stores
//     cover one contiguous run of it (staging the block's table span in
//     shared memory and writing it as 16-byte vectors measured 8% slower;
//     copying the next cells' rows by cp.async into a second tile while
//     computing, 19% slower).
//   * z-probing (ne[x, y, z], planes contiguous) stages rows with 16-byte
//     loads and reads the a-1/a+1 neighbour rows straight from device
//     memory (other blocks' own rows, held in L2; coalesced along planes);
//     x- and y-probing (cells contiguous) stage all five stencil rows in a
//     tile transposed through shared memory, a warp reading consecutive
//     cells of one plane.
//   * No division by a runtime integer per value: loop indices advance by
//     addition, cell coordinates come from shared memory; index arithmetic
//     is 32-bit inside a block, from a 64-bit base per row.
//   * plane_stride S: output plane k of segment s is absolute plane
//     s*K + k*S, and the probe-axis difference still reads planes g +- 1, so
//     a strided pack is the decimation of the full one, built directly.
//   * Quantised tiers never hold a float table: pass A recomputes the
//     channel values on the same tiles and reduces |v| per (segment, kept
//     plane, channel) in registers over a long run of cells, with one
//     atomicMax per block and column. A thread is a (plane slot, cell lane)
//     pair: with KB < 256 kept planes a chunk (K = 64: 65) the block's
//     threads form 256 / KB lanes of KB slots (195 threads at work, 65
//     before the plan), each lane taking every lanes-th staged cell, and
//     the lanes' maxima meet in shared memory at the block's end (fmaxf of
//     |v| is exact in any order); with KB >= 256 there is one lane and a
//     thread owns up to three planes over every cell. Pass B recomputes the
//     same values and writes codes, with each chunk's scales computed once
//     a block. The values are the same f32 numbers by the same operations,
//     so the codes and scales are those of quantize_tables of the f32
//     build, bit for bit.
//   * Dither (zscan.py:498-503, :1859-1865): the quantised tiers may add
//     JAX's uniform dither of fold_in(key, absolute plane) to value / scale
//     before rounding (channels.cuh dithered_code); the dithered kernels are
//     separate template instances, so the undithered ones are unchanged.
// IEEE division (__fdiv_rn) and rintf keep the codes those of
// jnp.round(v / scale). This file is built with --fmad=false so that no
// multiply-add is contracted and the plain PyTorch version can match it.
// Te, Z and B (full-physics layouts) are read straight from device memory.
//
// The row window (build_segment_pack_device(mesh=), zscan.py:1780-1797, the
// pack of a field split along the transverse a-axis over a grid axis): a
// shard's volumes hold the field's a-rows [a0, a0 + na), and two halo rows,
// a0 - 1 and a0 + na, come from its neighbours (absent at the field's
// edges). The a-gradient stays jnp.gradient of the whole field: one-sided
// only at the field's rows 0 and na_total - 1, central at a window edge,
// where it reads the halo row; the dither is indexed by the field's cell
// (a0 + a) * nb + b. The quantised tiers split at their two passes
// (phase 1: pass A only; phase 2: pass B with an amax given), so that the
// caller can max-reduce the amax over the shards between them; phase 0
// runs both, the single-device build, which is the window a0 = 0,
// na = na_total with no halo.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "channels.cuh"

namespace {

using namespace channels;

// THREADS and AMAX_COLS are also kernels/pack.py's BUILD_THREADS and
// AMAX_COLS (its build_plan sizes the tiles; a test reads both files)
constexpr int THREADS = 256;
constexpr int AMAX_CHUNK = 64;
constexpr int DEFAULT_SMEM = 48 * 1024;

struct Vol {
  const float* p;
  long long sp, sa, sb;
  __device__ __forceinline__ float at(int g, int a, int b) const {
    return p[g * sp + a * sa + b * sb];
  }
};

struct Field {
  Vol ne, te, z, ba, bb, bp;
  Vol hlo, hhi;  // halo rows a0 - 1 and a0 + na (p and b strides only)
  int n_seg, K, S, Ko, n_p, na, nb, cells;  // na, cells: the window's
  int a0, na_total;                         // the window in the field
  long long cell0;                          // the field's cell a0 * nb
  int vec_ok;  // ne rows start 16-byte aligned (z-probing)
  float pref, da, db, two_dp, dp, omega, n_coef, verdet;
};

// ---- the staged tile ------------------------------------------------------
//
// Rows of the tile, for the CB cells c0..c0+CB-1 of a block:
//   0 .. CB+1         cells c0-1 .. c0+CB (the b-1 / b+1 neighbours)
//   CB+2 .. 2CB+1     the a-1 neighbour of cell c0+i (clamped at a = 0)
//   2CB+2 .. 3CB+1    the a+1 neighbour (clamped at a = na-1)
// Column j holds absolute plane P0 + j. Cells past the grid are clamped;
// an a-1 / a+1 neighbour past the window is the halo row.
// z-probing stages only the first CB+2 rows: a warp reads the a-1 / a+1
// neighbours of consecutive planes straight from device memory (L2 holds
// them: they are other blocks' own rows), so the tile can hold whole rows.

__host__ __device__ inline int offset_rows(int CB) { return 3 * CB + 2; }
__host__ __device__ inline int tile_rows(int CB, int pc) {
  return pc ? CB + 2 : 3 * CB + 2;
}

// planes g-1 .. g+1 of KB kept planes S apart, plus the 16-byte alignment
// of the first staged plane (z-probing) or an odd pitch (bank spread)
__host__ __device__ inline int tile_pitch(int KB, int S, int pc) {
  const int span = (KB - 1) * S + 3;
  return pc ? 4 * ((span + 6) / 4) : (span | 1);
}

__host__ __device__ inline int tile_bytes(int CB, int pitch, int pc) {
  return (tile_rows(CB, pc) * pitch * 4 + 15) / 16 * 16;
}

// bytes after the tile: each row's pointer to its plane 0, each cell's
// (a, b) in the field, each row's plane stride (x-, y-probing)
__host__ __device__ inline int meta_bytes(int CB) {
  return (offset_rows(CB) * 12 + CB * 8 + 15) / 16 * 16;
}

struct Tile {
  float* sm;
  int pitch, P0, CB;
  const float** rowptr;
  int2* ab;
  int* rowsp;
  __device__ __forceinline__ float at(int r, int g) const {
    return sm[r * pitch + (g - P0)];
  }
};

// A tile and its row offsets and cell coordinates, from shared memory at p.
template <int PC>
__device__ __forceinline__ Tile tile_at(uint8_t* p, int CB, int pitch) {
  Tile T;
  T.sm = reinterpret_cast<float*>(p);
  T.pitch = pitch;
  T.P0 = 0;
  T.CB = CB;
  T.rowptr = reinterpret_cast<const float**>(p + tile_bytes(CB, pitch, PC));
  T.ab = reinterpret_cast<int2*>(T.rowptr + offset_rows(CB));
  T.rowsp = reinterpret_cast<int*>(T.ab + CB);
  return T;
}

// Tile row r's ne row (plane 0) and its plane stride: a cell of the window,
// or for the a-1 / a+1 rows the neighbour, which is the cell itself at the
// field's edge rows (jnp.gradient's one-sided difference) and a halo row
// past a window edge.
__device__ __forceinline__ const float* row_ptr(const Field& F, int c0,
                                                int CB, int r, int& sp) {
  sp = (int)F.ne.sp;
  int c;
  if (r < CB + 2) {
    c = min(max(c0 - 1 + r, 0), F.cells - 1);
    const int a = c / F.nb;
    return F.ne.p + a * F.ne.sa + (c - a * F.nb) * F.ne.sb;
  }
  const bool hi = r >= 2 * CB + 2;
  c = min(c0 + (r - CB - 2) % CB, F.cells - 1);
  int a = c / F.nb;
  const int b = c - a * F.nb;
  const int ag = F.a0 + a;
  if (hi ? ag != F.na_total - 1 : ag != 0) {
    if (hi ? a == F.na - 1 : a == 0) {
      // both halo rows have the same strides
      sp = (int)F.hlo.sp;
      return (hi ? F.hhi.p : F.hlo.p) + b * F.hlo.sb;
    }
    a += hi ? 1 : -1;
  }
  return F.ne.p + a * F.ne.sa + b * F.ne.sb;
}

// Stage planes [P0, P1] of every tile row for the cells c0 .. c0+CB-1.
// Ends with __syncthreads. Loop indices advance without division.
template <int PC>
__device__ void stage(const Field& F, Tile& T, int c0, int glo, int ghi) {
  const int R = tile_rows(T.CB, PC);
  const float** rowptr = T.rowptr;
  for (int r = threadIdx.x; r < offset_rows(T.CB); r += THREADS) {
    int sp;
    rowptr[r] = row_ptr(F, c0, T.CB, r, sp);
    // z-probing reads planes at stride 1 on every row (and storing the
    // strides anyway measured 3% on the bf16 build)
    if constexpr (!PC) T.rowsp[r] = sp;
  }
  for (int i = threadIdx.x; i < T.CB; i += THREADS) {
    const int cell = min(c0 + i, F.cells - 1), a = cell / F.nb;
    T.ab[i] = make_int2(F.a0 + a, cell - a * F.nb);
  }
  int P0 = max(glo - 1, 0);
  const int P1 = min(ghi + 1, F.n_p - 1);
  if (PC) P0 &= ~3;
  T.P0 = P0;
  __syncthreads();
  if (P1 < P0) return;  // only pad planes: nothing to read
  if (PC) {
    // planes contiguous: 16-byte loads along each row
    const int NV = (P1 - P0 + 4) / 4;
    const int dr = THREADS / NV, dv = THREADS - dr * NV;
    int r = threadIdx.x / NV, v = threadIdx.x - r * NV;
    for (; r < R; r += dr, v += dv) {
      if (v >= NV) {
        v -= NV;
        ++r;
        if (r >= R) break;
      }
      const int p = P0 + 4 * v;
      const float* src = rowptr[r] + p;
      float4 x;
      if (F.vec_ok && p + 3 <= F.n_p - 1) {
        x = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        x.x = p <= F.n_p - 1 ? __ldg(src) : 0.0f;
        x.y = p + 1 <= F.n_p - 1 ? __ldg(src + 1) : 0.0f;
        x.z = p + 2 <= F.n_p - 1 ? __ldg(src + 2) : 0.0f;
        x.w = p + 3 <= F.n_p - 1 ? __ldg(src + 3) : 0.0f;
      }
      *reinterpret_cast<float4*>(T.sm + r * T.pitch + 4 * v) = x;
    }
  } else {
    // cells contiguous: a warp reads consecutive cells of one plane
    const int NP = P1 - P0 + 1;
    const int dj = THREADS / R, dr = THREADS - dj * R;
    int j = threadIdx.x / R, r = threadIdx.x - j * R;
    for (; j < NP; j += dj, r += dr) {
      if (r >= R) {
        r -= R;
        ++j;
        if (j >= NP) break;
      }
      T.sm[r * T.pitch + j] =
          __ldg(rowptr[r] + (long long)(P0 + j) * T.rowsp[r]);
    }
  }
  __syncthreads();
}

// Channel values of absolute plane g at cell i of the tile (the field's
// cell (a, b), the window's row a - a0); exactly zero on the pad planes
// g > n_p - 1.
template <class LY, int PC>
__device__ __forceinline__ void channel_values(const Field& F, const Tile& T,
                                               int i, int g, float v[LY::C]) {
  if (g > F.n_p - 1) {
#pragma unroll
    for (int c = 0; c < LY::C; ++c) v[c] = 0.0f;
    return;
  }
  const int CB = T.CB;
  const int2 ab = T.ab[i];
  const int a = ab.x, b = ab.y;
  const float body = T.at(1 + i, g);
  // one-sided at the field's edges, central inside (jnp.gradient); the a
  // rows hold the clamped neighbours or the halo rows already
  const float alo = PC ? __ldg(T.rowptr[CB + 2 + i] + g)
                       : T.at(CB + 2 + i, g);
  const float ahi = PC ? __ldg(T.rowptr[2 * CB + 2 + i] + g)
                       : T.at(2 * CB + 2 + i, g);
  v[0] = F.pref * grad1(alo, ahi, a, F.na_total, F.da);
  const int rb0 = b == 0 ? 1 + i : i, rb1 = b == F.nb - 1 ? 1 + i : 2 + i;
  v[1] = F.pref * grad1(T.at(rb0, g), T.at(rb1, g), b, F.nb, F.db);
  // padded volume: a duplicate of plane 0 in front, zeros behind
  const float up = g + 1 <= F.n_p - 1 ? T.at(1 + i, g + 1) : 0.0f;
  const float dn = T.at(1 + i, g >= 1 ? g - 1 : 0);
  float gp = F.pref * (up - dn) / F.two_dp;
  if (g == 0) gp = 2.0f * gp;
  if (g == F.n_p - 1) gp = 2.0f * gp + F.pref * body / F.dp;
  v[2] = gp;
  if constexpr (LY::inv_brems)
    v[LY::KI] = kappa_of(body, F.te.at(g, a - F.a0, b),
                         F.z.at(g, a - F.a0, b), F.omega);
  if constexpr (LY::phaseshift) {
    const float arg = 1.0f - F.n_coef * body;
    v[LY::PI] = F.omega * ((arg > 0.0f ? sqrtf(arg) : 0.0f) - 1.0f);
  }
  if constexpr (LY::B_on) {
    v[LY::FI + 0] = F.verdet * body * F.ba.at(g, a - F.a0, b);
    v[LY::FI + 1] = F.verdet * body * F.bb.at(g, a - F.a0, b);
    v[LY::FI + 2] = F.verdet * body * F.bp.at(g, a - F.a0, b);
  }
}

// output blocks a row holds: planes, or plane pairs for int4
__host__ __device__ inline int out_blocks(int mode, int Ko) {
  return mode == INT4 ? Ko / 2 + 1 : Ko + 1;
}

// ---- pass A: amax over cells ----------------------------------------------
//
// Block (run, chunk, segment): kept planes [k0, k0+KB) over the cells
// [run*CR, run*CR + CR), staged CB cells at a time with the row pass's
// tile. Thread t is plane slot t % slots of cell lane t / slots (lanes x
// slots <= THREADS; the rest only stage): it owns the planes k0 + slot +
// j*slots and, of each staged run of cells, those of index lane, lane +
// lanes, ..., and keeps its planes' running |v| maxima in registers.
// Consecutive threads take consecutive planes of one cell, so their tile
// reads are consecutive words. At the end lanes 1.. leave their maxima in
// shared memory (after the tile) and lane 0 folds them in and sends one
// atomicMax per owned (plane, channel) (|v| >= 0 orders as an unsigned
// integer). With one lane (LANES false: KB above half a block, the plan's
// slots are THREADS) a thread owns planes k0 + t + j*THREADS over every
// cell, with no fold, as before the plan.
constexpr int AMAX_COLS = 3;  // planes a slot owns: KB <= 3 * slots

template <class LY, int PC, bool LANES>
__global__ void __launch_bounds__(THREADS)
    amax_pass(Field F, unsigned* amax, int KB, int CB, int CR, int pitch,
              int slots, int lanes) {
  constexpr int C = LY::C;
  extern __shared__ uint4 smem_u4[];
  const int s = blockIdx.z, k0 = (int)blockIdx.y * KB;
  const int k1 = min(k0 + KB, F.Ko + 1);
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem_u4);
  Tile T = tile_at<PC>(sm, CB, pitch);
  const int slot = LANES ? (int)threadIdx.x % slots : (int)threadIdx.x;
  const int lane = LANES ? (int)threadIdx.x / slots : 0;
  const int pstep = LANES ? slots : THREADS, cstep = LANES ? lanes : 1;
  float m[AMAX_COLS][C];
#pragma unroll
  for (int j = 0; j < AMAX_COLS; ++j)
#pragma unroll
    for (int c = 0; c < C; ++c) m[j][c] = 0.0f;
  const int cend = min((int)(blockIdx.x + 1) * CR, F.cells);
  for (int c0 = (int)blockIdx.x * CR; c0 < cend; c0 += CB) {
    stage<PC>(F, T, c0, s * F.K + k0 * F.S, s * F.K + (k1 - 1) * F.S);
    const int ncell = min(CB, cend - c0);
    if (!LANES || lane < lanes) {
#pragma unroll
      for (int j = 0; j < AMAX_COLS; ++j) {
        const int ko = k0 + slot + j * pstep;
        if (ko < k1) {
          for (int i = lane; i < ncell; i += cstep) {
            float v[C];
            channel_values<LY, PC>(F, T, i, s * F.K + ko * F.S, v);
#pragma unroll
            for (int c = 0; c < C; ++c)
              m[j][c] = fmaxf(m[j][c], fabsf(v[c]));
          }
        }
      }
    }
    __syncthreads();  // the tile is restaged next
  }
  if constexpr (LANES) {
    // one plane a slot here (KB <= slots)
    float* red = reinterpret_cast<float*>(sm + tile_bytes(CB, pitch, PC) +
                                          meta_bytes(CB));
    if (lane >= 1 && lane < lanes)
#pragma unroll
      for (int c = 0; c < C; ++c)
        red[((lane - 1) * slots + slot) * C + c] = m[0][c];
    __syncthreads();
    if (lane != 0) return;
    for (int l = 0; l < lanes - 1; ++l)
#pragma unroll
      for (int c = 0; c < C; ++c)
        m[0][c] = fmaxf(m[0][c], red[(l * slots + slot) * C + c]);
  }
#pragma unroll
  for (int j = 0; j < AMAX_COLS; ++j) {
    const int ko = k0 + slot + j * pstep;
    if (ko < k1)
#pragma unroll
      for (int c = 0; c < C; ++c)
        atomicMax(amax + ((long long)s * (F.Ko + 1) + ko) * C + c,
                  __float_as_uint(m[j][c]));
  }
}

// ---- the table rows: float values, or pass B's codes ----------------------
//
// Block (cells, segment): the whole rows of cells [c0, c0 + CB), kept planes
// in chunks of KB. Item (i, q) is cell i's output block q of the chunk: one
// plane (C values or int8 codes) or, for int4, the plane pair 2q, 2q+1 (C
// nibble-pair bytes). Consecutive threads take consecutive items, so a
// warp's stores cover one contiguous run of the row. The chunk's scales are
// computed once into shared memory; the first block of each segment writes
// them out. DITHER adds the dither of key dkey (quantised modes).
template <class LY, int PC, int MODE, bool DITHER>
__global__ void __launch_bounds__(THREADS)
    rows_pass(Field F, void* out, const unsigned* amax, float* scales,
              int KB, int CB, int pitch, uint2 dkey) {
  constexpr int C = LY::C;
  constexpr int ES = MODE == F32 ? 4 : MODE == BF16 ? 2 : 1;
  constexpr float QMAX = MODE == INT4 ? 7.0f : 127.0f;
  extern __shared__ uint4 smem_u4[];
  const int s = blockIdx.y, c0 = (int)blockIdx.x * CB;
  const int ncell = min(CB, F.cells - c0);
  const int nblk = out_blocks(MODE, F.Ko);
  const long long row_bytes = (long long)nblk * C * ES;
  uint8_t* tb = reinterpret_cast<uint8_t*>(smem_u4);
  Tile T = tile_at<PC>(tb, CB, pitch);
  // the chunk's scales (quantised modes)
  float* ssc = reinterpret_cast<float*>(tb + tile_bytes(CB, pitch, PC) +
                                        meta_bytes(CB));
  uint8_t* g0 = reinterpret_cast<uint8_t*>(out) +
                ((long long)s * F.cells + c0) * row_bytes;
  for (int k0 = 0; k0 <= F.Ko; k0 += KB) {
    const int k1 = min(k0 + KB, F.Ko + 1);
    if constexpr (MODE == INT8 || MODE == INT4) {
      const long long col0 = ((long long)s * (F.Ko + 1) + k0) * C;
      for (int t = threadIdx.x; t < (k1 - k0) * C; t += THREADS) {
        ssc[t] = scale_of(amax[col0 + t], QMAX);
        if (blockIdx.x == 0) scales[col0 + t] = ssc[t];
      }
    }
    stage<PC>(F, T, c0, s * F.K + k0 * F.S, s * F.K + (k1 - 1) * F.S);
    const int q0 = MODE == INT4 ? k0 / 2 : k0;
    const int nq = MODE == INT4 ? (k1 - k0 + 1) / 2 : k1 - k0;
    // item (i, q - q0) = threadIdx.x + n * THREADS, advanced without division
    const int di = THREADS / nq, dq = THREADS - di * nq;
    int i = threadIdx.x / nq, q = q0 + threadIdx.x - i * nq;
    for (; i < ncell; i += di, q += dq) {
      if (q >= q0 + nq) {
        q -= nq;
        ++i;
        if (i >= ncell) break;
      }
      uint8_t* o = g0 + (i * nblk + q) * C * ES;
      if constexpr (MODE == F32 || MODE == BF16) {
        float v[C];
        channel_values<LY, PC>(F, T, i, s * F.K + q * F.S, v);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if constexpr (MODE == F32)
            reinterpret_cast<float*>(o)[c] = v[c];
          else
            reinterpret_cast<__nv_bfloat16*>(o)[c] = __float2bfloat16_rn(v[c]);
        }
      } else {
        const int k = MODE == INT4 ? 2 * q : q;
        const float* sc = ssc + (k - k0) * C;
        float v[C];
        channel_values<LY, PC>(F, T, i, s * F.K + k * F.S, v);
        if constexpr (DITHER) {
          // keyed by the absolute plane, drawn over the field's (na, nb,
          // C): index cell * C + c
          const unsigned long long d0 =
              (unsigned long long)(F.cell0 + c0 + i) * C;
          const uint2 pk0 =
              threefry::fold_in(dkey, (uint32_t)(s * F.K + k * F.S));
          if constexpr (MODE == INT8) {
#pragma unroll
            for (int c = 0; c < C; ++c)
              o[c] = (uint8_t)(int8_t)dithered_code(v[c], sc[c], QMAX, pk0,
                                                    d0 + c);
          } else {
            const bool has_hi = k + 1 <= F.Ko;
            float w[C];
            uint2 pk1 = pk0;
            if (has_hi) {
              channel_values<LY, PC>(F, T, i, s * F.K + (k + 1) * F.S, w);
              pk1 = threefry::fold_in(dkey,
                                      (uint32_t)(s * F.K + (k + 1) * F.S));
            }
#pragma unroll
            for (int c = 0; c < C; ++c) {
              const int lo = dithered_code(v[c], sc[c], QMAX, pk0, d0 + c);
              const int hi = has_hi ? dithered_code(w[c], sc[C + c], QMAX,
                                                    pk1, d0 + c)
                                    : 0;
              o[c] = nibble_pair(lo, hi);
            }
          }
        } else if constexpr (MODE == INT8) {
#pragma unroll
          for (int c = 0; c < C; ++c)
            o[c] = (uint8_t)(int8_t)code_of(v[c], sc[c], QMAX);
        } else {
          const bool has_hi = k + 1 <= F.Ko;
          float w[C];
          if (has_hi)
            channel_values<LY, PC>(F, T, i, s * F.K + (k + 1) * F.S, w);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int lo = code_of(v[c], sc[c], QMAX);
            const int hi = has_hi ? code_of(w[c], sc[C + c], QMAX) : 0;
            o[c] = nibble_pair(lo, hi);
          }
        }
      }
    }
    __syncthreads();  // the tile is restaged next chunk
  }
}

// The launch plan of pack.py build_plan: KB kept planes a chunk (n_chunk
// chunks) and the tile's pitch; pass A's CB_a cells a barrier, plane
// slots and cell lanes, its CR cells a block and blocks_a blocks a chunk
// and segment; pass B's CB_b cells a block (and barrier) and blocks_b
// blocks a segment; each pass's shared bytes.
struct Plan {
  int CB_a, CB_b, KB, n_chunk, pitch, slots, lanes, CR, blocks_a, smem_a,
      blocks_b, smem_b;
};

// The plan is this file's layout and covers every (cell, kept plane):
// pass A's shared memory is the tile, its metadata and lanes 1..'s maxima,
// pass B's the tile, its metadata and a chunk's scales.
bool plan_ok(const Plan& L, const Field& F, int pc, int C) {
  const long long tile_a =
      (long long)tile_bytes(L.CB_a, L.pitch, pc) + meta_bytes(L.CB_a);
  const long long tile_b =
      (long long)tile_bytes(L.CB_b, L.pitch, pc) + meta_bytes(L.CB_b);
  return L.CB_a >= 1 && L.CB_b >= 1 && L.KB >= 1 && L.slots >= 1 &&
         L.lanes >= 1 && L.CR % L.CB_a == 0 &&
         L.pitch == tile_pitch(L.KB, F.S, pc) &&
         (long long)L.n_chunk * L.KB >= F.Ko + 1 &&
         (long long)(L.n_chunk - 1) * L.KB < F.Ko + 1 &&
         L.slots * L.lanes <= THREADS && L.KB <= AMAX_COLS * L.slots &&
         (L.lanes == 1 ? L.slots == THREADS : L.KB <= L.slots) &&
         (long long)L.blocks_a * L.CR >= F.cells &&
         (long long)L.blocks_b * L.CB_b >= F.cells &&
         L.smem_a == tile_a + 4LL * (L.lanes - 1) * L.slots * C &&
         L.smem_b == tile_b + 4LL * L.KB * C;
}

// raise a kernel's dynamic shared memory limit where it needs more than
// the default 48 KB
template <typename KernelT>
int allow_smem(KernelT kernel, size_t smem) {
  if (smem <= DEFAULT_SMEM) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <class LY, int PC>
int build_layout(const Field& F, const Plan& L, int mode, int phase,
                 void* out, unsigned* amax, float* scales, int dither,
                 uint2 dkey, cudaStream_t st) {
  constexpr int C = LY::C;
  if (!plan_ok(L, F, PC, C)) return (int)cudaErrorInvalidValue;
  if ((mode == INT8 || mode == INT4) && phase != 2) {
    const dim3 grid(L.blocks_a, L.n_chunk, F.n_seg);
    auto k = L.lanes > 1 ? amax_pass<LY, PC, true> : amax_pass<LY, PC, false>;
    if (const int e = allow_smem(k, L.smem_a)) return e;
    k<<<grid, THREADS, L.smem_a, st>>>(F, amax, L.KB, L.CB_a, L.CR,
                                       L.pitch, L.slots, L.lanes);
  }
  if (phase == 1) return 0;
  const dim3 grid(L.blocks_b, F.n_seg);
  const int KB = L.KB, CB = L.CB_b, pitch = L.pitch;
  const size_t smem = L.smem_b;
  void (*k)(Field, void*, const unsigned*, float*, int, int, int, uint2) =
      mode == F32    ? rows_pass<LY, PC, F32, false>
      : mode == BF16 ? rows_pass<LY, PC, BF16, false>
      : mode == INT8 ? (dither ? rows_pass<LY, PC, INT8, true>
                               : rows_pass<LY, PC, INT8, false>)
                     : (dither ? rows_pass<LY, PC, INT4, true>
                               : rows_pass<LY, PC, INT4, false>);
  if (const int e = allow_smem(k, smem)) return e;
  k<<<grid, THREADS, smem, st>>>(F, out, amax, scales, KB, CB, pitch, dkey);
  return 0;
}

template <class LY>
int build_probe(const Field& F, const Plan& L, int mode, int phase,
                void* out, unsigned* amax, float* scales, int dither,
                uint2 dkey, cudaStream_t st) {
  return F.ne.sp == 1
             ? build_layout<LY, 1>(F, L, mode, phase, out, amax, scales,
                                   dither, dkey, st)
             : build_layout<LY, 0>(F, L, mode, phase, out, amax, scales,
                                   dither, dkey, st);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Quantiser of a carried float table. amax over cells of every (segment,
// column = k*C + c): a thread folds a chunk of cells, then one atomicMax on
// the float's bits. Columns are fastest, so reads are coalesced.
template <typename IN>
__global__ void amax_kernel(const IN* tab, unsigned* amax, int n_seg,
                            int cells, int ncol) {
  const int nchunk = (cells + AMAX_CHUNK - 1) / AMAX_CHUNK;
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= (long long)n_seg * nchunk * ncol) return;
  const int col = (int)(t % ncol);
  const long long rest = t / ncol;
  const int ch = (int)(rest % nchunk);
  const int s = (int)(rest / nchunk);
  const int c0 = ch * AMAX_CHUNK;
  const int c1 = min(c0 + AMAX_CHUNK, cells);
  float m = 0.0f;
  for (int cell = c0; cell < c1; ++cell)
    m = fmaxf(m, fabsf(to_float(tab[((long long)s * cells + cell) * ncol + col])));
  atomicMax(amax + (long long)s * ncol + col, __float_as_uint(m));
}

// Codes: one thread per (segment, cell, output column), columns fastest.
// int8: column k*C + c. int4: column j*C + c holds planes 2j (low nibble)
// and 2j + 1 (high nibble; zero past plane K). Cell-0 threads write scales.
// DITHER: plane k of segment s is dithered by fold_in(dkey, s*K + k) at
// index cell * C + c (quantize_segment_pack, zscan.py:498-503).
template <typename IN, bool DITHER>
__global__ void quant_kernel(const IN* tab, const unsigned* amax,
                             uint8_t* codes, float* scales, int n_seg,
                             int cells, int K, int C, int bits, uint2 dkey) {
  const int ncol_in = (K + 1) * C;
  const int ncol_out = (bits == 4 ? K / 2 + 1 : K + 1) * C;
  const float qmax = bits == 4 ? 7.0f : 127.0f;
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= (long long)n_seg * cells * ncol_out) return;
  const int ocol = (int)(t % ncol_out);
  const long long row = t / ncol_out;  // s * cells + cell
  const int cell = (int)(row % cells);
  const int s = (int)(row / cells);
  const IN* in = tab + row * ncol_in;
  const unsigned* am = amax + (long long)s * ncol_in;
  float* sc = scales + (long long)s * ncol_in;
  if (bits == 8) {
    const float scale = scale_of(am[ocol], qmax);
    if constexpr (DITHER) {
      const int k = ocol / C, c = ocol - k * C;
      codes[t] = (uint8_t)(int8_t)dithered_code(
          to_float(in[ocol]), scale, qmax,
          threefry::fold_in(dkey, (uint32_t)(s * K + k)),
          (unsigned long long)cell * C + c);
    } else {
      codes[t] = (uint8_t)(int8_t)code_of(to_float(in[ocol]), scale, qmax);
    }
    if (cell == 0) sc[ocol] = scale;
    return;
  }
  const int j = ocol / C, c = ocol % C;
  const int col0 = 2 * j * C + c, col1 = (2 * j + 1) * C + c;
  const float s0 = scale_of(am[col0], qmax);
  int lo, hi = 0;
  float s1 = 1.0f;
  if constexpr (DITHER) {
    const unsigned long long d = (unsigned long long)cell * C + c;
    lo = dithered_code(to_float(in[col0]), s0, qmax,
                       threefry::fold_in(dkey, (uint32_t)(s * K + 2 * j)), d);
    if (2 * j + 1 <= K) {
      s1 = scale_of(am[col1], qmax);
      hi = dithered_code(to_float(in[col1]), s1, qmax,
                         threefry::fold_in(dkey, (uint32_t)(s * K + 2 * j + 1)),
                         d);
    }
  } else {
    lo = code_of(to_float(in[col0]), s0, qmax);
    if (2 * j + 1 <= K) {
      s1 = scale_of(am[col1], qmax);
      hi = code_of(to_float(in[col1]), s1, qmax);
    }
  }
  codes[t] = nibble_pair(lo, hi);
  if (cell == 0) {
    sc[col0] = s0;
    if (2 * j + 1 <= K) sc[col1] = s1;
  }
}

// ---- the decimator ---------------------------------------------------------
//
// decimate_segment_pack.dec keeps every S-th plane of each table row: pure
// data movement, bound by bytes (the whole table read once, the kept planes
// written once). A row is (K+1)*C values, 3,078 bytes at bf16, C = 3, so
// the kept planes of a row are short runs at odd offsets. The kernel moves
// whole rows instead: a tile is R rows whose byte lengths in and out are
// multiples of 16 (the host plan, pack.decimate_plan, picks R and the rest),
// so every tile is one 1-D bulk copy each way. Persistent blocks walk the
// tiles: one thread keeps a ring of `stages` tiles loading
// (cp.async.bulk ... mbarrier::complete_tx), all threads copy the kept
// planes of the tile that has arrived into an output tile in shared memory,
// walking (row, kept plane, channel) by additions, and the thread sends it
// back by a bulk store (bulk_group; two output tiles, so a store overlaps
// the next tile's copy). Rows past the last whole tile (and every row of a
// table whose start is not 16-byte aligned) go through a plain row loop in
// the same launch. Nibble rows decode the sign-extended codes of the kept
// planes and pack pairs, as the plain version does.

constexpr int DEC_BARS = 128;   // bytes of mbarriers before the stages

// sign-extended code of full-pack plane p, channel c, from a nibble row
__device__ __forceinline__ int nibble_code(const uint8_t* row, int p, int C,
                                           int c) {
  const unsigned w = row[(p >> 1) * C + c];
  const unsigned n = (p & 1) ? (w >> 4) & 15u : w & 15u;
  return (int)(n ^ 8u) - 8;
}

// output column (kd, c) of a row from its input row: plane kd*S of a plain
// table; the pair of kept planes 2kd, 2kd + 1 of a nibble row (high nibble
// 0 past Kd)
template <typename T, bool NIB>
struct Keep {
  int C, SC, S, Kd;
  __device__ __forceinline__ T operator()(const T* row, int kd, int c) const {
    if constexpr (NIB) {
      const int lo = nibble_code(row, 2 * kd * S, C, c);
      const int hi =
          2 * kd + 1 <= Kd ? nibble_code(row, (2 * kd + 1) * S, C, c) : 0;
      return nibble_pair(lo, hi);
    } else {
      return row[kd * SC + c];
    }
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// arm `bar` for `bytes` and copy them from global `src` to shared `dst`
__device__ __forceinline__ void bulk_load(uint64_t* bar, void* dst,
                                          const void* src, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

template <typename T, bool NIB>
__global__ void __launch_bounds__(THREADS)
    decimate_kernel(const T* __restrict__ in, T* __restrict__ out,
                    long long rows, int ncol_in, int ncol_out,
                    Keep<T, NIB> keep, int R, int stages, long long tiles) {
  extern __shared__ __align__(128) unsigned char dsm[];
  const int C = keep.C, nkd = ncol_out / C;
  const int tin = R * ncol_in, tout = R * ncol_out;  // values a tile
  const unsigned bin = tin * sizeof(T), bout = tout * sizeof(T);
  const long long mine =
      tiles > blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  if (mine > 0) {
    uint64_t* full = reinterpret_cast<uint64_t*>(dsm);
    T* ring = reinterpret_cast<T*>(dsm + DEC_BARS);
    T* obuf = reinterpret_cast<T*>(dsm + DEC_BARS + (size_t)stages * bin);
    if (threadIdx.x == 0) {
      for (int s = 0; s < stages; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                     :: "r"(smem_u32(&full[s])) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int s = 0; s < stages && s < mine; ++s)
        bulk_load(&full[s], ring + s * tin,
                  in + (blockIdx.x + (long long)s * gridDim.x) * tin, bin);
    }
    __syncthreads();
    // value e = threadIdx.x + n * THREADS of a tile is (row r, kept
    // column kd, channel c), advanced by (dr, dkd, dc) with carries
    const int r0 = threadIdx.x / ncol_out;
    const int kd0 = (threadIdx.x - r0 * ncol_out) / C;
    const int c0 = threadIdx.x - r0 * ncol_out - kd0 * C;
    const int dr = THREADS / ncol_out;
    const int dkd = (THREADS - dr * ncol_out) / C;
    const int dc = THREADS - dr * ncol_out - dkd * C;
    int s = 0;
    unsigned phase = 0;
    for (long long i = 0; i < mine; ++i) {
      const long long t = blockIdx.x + i * gridDim.x;
      const T* src = ring + s * tin;
      T* dst = obuf + (i & 1) * tout;
      bar_wait(&full[s], phase);
      // the store that last read this output tile (tile i - 2) is done
      if (threadIdx.x == 0)
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      __syncthreads();
      int r = r0, kd = kd0, c = c0;
      for (int e = threadIdx.x; e < tout; e += THREADS) {
        dst[e] = keep(src + r * ncol_in, kd, c);
        c += dc;
        kd += dkd;
        r += dr;
        if (c >= C) { c -= C; ++kd; }
        if (kd >= nkd) { kd -= nkd; ++r; }
      }
      // the output tile is read by the bulk store (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (threadIdx.x == 0) {
        asm volatile(
            "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
            :: "l"(out + t * tout), "r"(smem_u32(dst)), "r"(bout)
            : "memory");
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        // every thread is past this stage: refill it
        if (i + stages < mine)
          bulk_load(&full[s], ring + s * tin,
                    in + (t + (long long)stages * gridDim.x) * tin, bin);
      }
      if (++s == stages) { s = 0; phase ^= 1; }
    }
    if (threadIdx.x == 0)
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
  // the tail: rows past the last whole tile, a row a block
  const int kdt = threadIdx.x / C, ct = threadIdx.x - kdt * C;
  const int dkt = THREADS / C, dct = THREADS - dkt * C;
  for (long long r = tiles * R + blockIdx.x; r < rows; r += gridDim.x) {
    const T* src = in + r * ncol_in;
    T* dst = out + r * ncol_out;
    int kd = kdt, c = ct;
    for (int j = threadIdx.x; j < ncol_out; j += THREADS) {
      dst[j] = keep(src, kd, c);
      c += dct;
      kd += dkt;
      if (c >= C) { c -= C; ++kd; }
    }
  }
}

// the largest dynamic shared memory a block may ask for on the current
// device, lifted once per kernel and device to the card's opt-in limit
template <typename KERN>
int dec_smem_limit(KERN kernel, int* limit) {
  static int optin[64] = {};
  int dev = 0;
  if (const cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (dev < 64 && optin[dev]) {
    *limit = optin[dev];
    return 0;
  }
  int v = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!e)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, v);
  if (e) return (int)e;
  if (dev < 64) optin[dev] = v;
  *limit = v;
  return 0;
}

template <typename T, bool NIB>
int decimate(const void* in, void* out, long long rows, int ncol_in,
             int ncol_out, int C, int S, int Kd, int R, int stages,
             long long tiles, int blocks, int smem, cudaStream_t st) {
  // the plan's shared memory is this kernel's layout, within the limit
  const long long need =
      tiles ? DEC_BARS + (long long)stages * R * ncol_in * sizeof(T)
                  + 2LL * R * ncol_out * sizeof(T)
            : 0;
  auto k = decimate_kernel<T, NIB>;
  int limit = 0;
  if (const int e = dec_smem_limit(k, &limit)) return e;
  if (smem != need || smem > limit || (tiles && (stages < 1 || stages > 8)))
    return (int)cudaErrorInvalidValue;
  const Keep<T, NIB> keep{C, S * C, S, Kd};
  k<<<blocks, THREADS, smem, st>>>((const T*)in, (T*)out, rows, ncol_in,
                                   ncol_out, keep, R, stages, tiles);
  return 0;
}

unsigned blocks_for(long long total) {
  return (unsigned)((total + THREADS - 1) / THREADS);
}

}  // namespace

// mode: 0 f32, 1 bf16 tables; 2 int8, 3 int4 codes with scales, amax
// (n_seg, K/S + 1, C) unsigned zeroed by the caller (phase 0, 1) or the
// field's amax (phase 2). Output plane k of segment s is absolute plane
// s*K + k*S. The volumes hold a-rows [a0, a0 + na) of na_total; halo_lo /
// halo_hi (row a0 - 1 / a0 + na, plane stride hsp, b stride hsb) are read
// only where a0 > 0 / a0 + na < na_total. phase: 0 the whole build, 1 the
// amax pass alone (out unused), 2 the codes from the given amax. CB_a ..
// smem_b: the launch plan (pack.py build_plan; Plan above), refused with
// cudaErrorInvalidValue unless it is this file's layout and covers the
// build.
extern "C" int pack_build(void* out, int mode, float* scales, unsigned* amax,
                          const float* ne, const float* te, const float* z,
                          const float* B, long long sp, long long sa,
                          long long sb, int comp_a, int comp_b, int comp_p,
                          int n_seg, int K, int S, int n_p, int na, int nb,
                          float pref, float da, float db, float two_dp,
                          float dp, float omega, float n_coef, float verdet,
                          int inv_brems, int phaseshift, int B_on,
                          int dither, long long key0, long long key1,
                          int a0, int na_total, const float* halo_lo,
                          const float* halo_hi, long long hsp, long long hsb,
                          int phase, int CB_a, int CB_b, int KB,
                          int n_chunk, int pitch, int slots, int lanes,
                          int CR, int blocks_a, int smem_a, int blocks_b,
                          int smem_b, void* stream) {
  const Plan L{CB_a,  CB_b,     KB,     n_chunk,  pitch, slots,
               lanes, CR,       blocks_a, smem_a, blocks_b, smem_b};
  Field F;
  F.ne = {ne, sp, sa, sb};
  F.hlo = {halo_lo, hsp, 0, hsb};
  F.hhi = {halo_hi, hsp, 0, hsb};
  F.te = {te, sp, sa, sb};
  F.z = {z, sp, sa, sb};
  F.ba = {B ? B + comp_a : nullptr, 3 * sp, 3 * sa, 3 * sb};
  F.bb = {B ? B + comp_b : nullptr, 3 * sp, 3 * sa, 3 * sb};
  F.bp = {B ? B + comp_p : nullptr, 3 * sp, 3 * sa, 3 * sb};
  F.n_seg = n_seg; F.K = K; F.S = S; F.Ko = K / S; F.n_p = n_p;
  F.na = na; F.nb = nb; F.cells = na * nb;
  F.a0 = a0; F.na_total = na_total; F.cell0 = (long long)a0 * nb;
  F.vec_ok = sp == 1 && sa % 4 == 0 && sb % 4 == 0 &&
             ((uintptr_t)ne & 15) == 0;
  F.pref = pref; F.da = da; F.db = db; F.two_dp = two_dp; F.dp = dp;
  F.omega = omega; F.n_coef = n_coef; F.verdet = verdet;
  cudaStream_t st = (cudaStream_t)stream;
  const uint2 dk = make_uint2((uint32_t)key0, (uint32_t)key1);
  int rc;
  switch (inv_brems | (phaseshift << 1) | (B_on << 2)) {
    case 0: rc = build_probe<Layout<0, 0, 0>>(F, L, mode, phase, out, amax, scales, dither, dk, st); break;
    case 1: rc = build_probe<Layout<1, 0, 0>>(F, L, mode, phase, out, amax, scales, dither, dk, st); break;
    case 2: rc = build_probe<Layout<0, 1, 0>>(F, L, mode, phase, out, amax, scales, dither, dk, st); break;
    case 3: rc = build_probe<Layout<1, 1, 0>>(F, L, mode, phase, out, amax, scales, dither, dk, st); break;
    case 4: rc = build_probe<Layout<0, 0, 1>>(F, L, mode, phase, out, amax, scales, dither, dk, st); break;
    case 5: rc = build_probe<Layout<1, 0, 1>>(F, L, mode, phase, out, amax, scales, dither, dk, st); break;
    case 6: rc = build_probe<Layout<0, 1, 1>>(F, L, mode, phase, out, amax, scales, dither, dk, st); break;
    default: rc = build_probe<Layout<1, 1, 1>>(F, L, mode, phase, out, amax, scales, dither, dk, st); break;
  }
  return rc ? rc : (int)cudaGetLastError();
}

// amax must be zeroed by the caller: (n_seg, K+1, C) unsigned. dither:
// add the dither of key (key0, key1).
template <typename IN>
void quantize(const IN* t, void* codes, float* scales, const unsigned* amax,
              int n_seg, int cells, int K, int C, int bits, int dither,
              uint2 dk, long long n_out, cudaStream_t st) {
  if (dither)
    quant_kernel<IN, true><<<blocks_for(n_out), THREADS, 0, st>>>(
        t, amax, (uint8_t*)codes, scales, n_seg, cells, K, C, bits, dk);
  else
    quant_kernel<IN, false><<<blocks_for(n_out), THREADS, 0, st>>>(
        t, amax, (uint8_t*)codes, scales, n_seg, cells, K, C, bits, dk);
}

extern "C" int pack_quantize(const void* table, int in_bf16, void* codes,
                             float* scales, unsigned* amax, int n_seg,
                             int cells, int K, int C, int bits, int dither,
                             long long key0, long long key1, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint2 dk = make_uint2((uint32_t)key0, (uint32_t)key1);
  const int ncol = (K + 1) * C;
  const long long n_amax = (long long)n_seg * ((cells + AMAX_CHUNK - 1) / AMAX_CHUNK) * ncol;
  const long long n_out = (long long)n_seg * cells * (bits == 4 ? K / 2 + 1 : K + 1) * C;
  if (in_bf16) {
    const __nv_bfloat16* t = (const __nv_bfloat16*)table;
    amax_kernel<<<blocks_for(n_amax), THREADS, 0, st>>>(t, amax, n_seg, cells, ncol);
    quantize(t, codes, scales, amax, n_seg, cells, K, C, bits, dither, dk,
             n_out, st);
  } else {
    const float* t = (const float*)table;
    amax_kernel<<<blocks_for(n_amax), THREADS, 0, st>>>(t, amax, n_seg, cells, ncol);
    quantize(t, codes, scales, amax, n_seg, cells, K, C, bits, dither, dk,
             n_out, st);
  }
  return (int)cudaGetLastError();
}

// A (rows, ncol_in) table to its (rows, ncol_out) decimation, every
// stride-th plane kept (nibbles: int4 pair rows), by the plan of
// pack.decimate_plan: `tiles` tiles of R rows through `stages` staged
// copies in `blocks` persistent blocks of `smem` bytes, then the tail rows.
extern "C" int pack_decimate(const void* in, void* out, int elem_bytes,
                             int nibbles, long long rows, int ncol_in,
                             int ncol_out, int C, int stride, int Kd, int R,
                             int stages, long long tiles, int blocks,
                             int smem, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (nibbles)
    rc = decimate<uint8_t, true>(in, out, rows, ncol_in, ncol_out, C, stride,
                                 Kd, R, stages, tiles, blocks, smem, st);
  else if (elem_bytes == 4)
    rc = decimate<float, false>(in, out, rows, ncol_in, ncol_out, C, stride,
                                Kd, R, stages, tiles, blocks, smem, st);
  else if (elem_bytes == 2)
    rc = decimate<uint16_t, false>(in, out, rows, ncol_in, ncol_out, C,
                                   stride, Kd, R, stages, tiles, blocks,
                                   smem, st);
  else
    rc = decimate<uint8_t, false>(in, out, rows, ncol_in, ncol_out, C,
                                  stride, Kd, R, stages, tiles, blocks, smem,
                                  st);
  return rc ? rc : (int)cudaGetLastError();
}
