// K8: cloud-in-cell deposit of per-ray values onto a regular 2-D grid.
//
// Replaces the JAX device program of deposit_cic
// (synthpy_tpu/ops/histogram.py:158-216), which the Fresnel hybrid
// (ops/fresnel.py:113-114, Refractometry.fresnel_solve) runs on the exit
// rays' amplitude and phase: t = (pos - c0) / d with d = c[1] - c[0] (both
// read from the coordinate arrays, a true division); a ray is inside when
// t is finite and in [0, n - 1]; its corner is clip(floor(t), 0, n - 2) and
// its fractions are clipped to [0, 1]; it adds value * w and w (the bilinear
// weight) to the V value channels and the weight channel of its four
// corners; then every node is divided by max(weight, 1e-12). A ray outside
// adds 0 * w, which is nothing unless a fraction is NaN (a NaN position):
// then, as in the JAX program, NaN goes to all channels of its corners.
// V = 1 deposits a real value, V = 2 a complex one (re, im) or two real
// values sharing one weight channel (the Fresnel hybrid's amplitude and
// phase at the same positions: one pass instead of two).
//
// What bounds it on the H100: by count, bytes. Each ray reads 4 (2 + V)
// bytes and the grid is written once, ~0.02 ms at 4 M rays. The first
// design (one thread a ray, 4 (V + 1) float atomics a ray into the grid in
// L2) queued its 50 M atomics on the L2 slices at 3% of that. This one
// gives every node one writer and adds in shared memory:
//
//   * The grid is cut into TILE x TILE-node tiles, and a counting sort
//     buckets the rays by tile. count_kernel's blocks count their rays'
//     entries a tile in shared memory (integer atomics) into a (tile,
//     block) matrix; column_kernel scans each tile's column (a block's
//     first slot in the tile) and totals it; plan_kernel (one block) scans
//     the totals into the tiles' ranges of the bucket array and cuts each
//     tile into work items of at most `chunk` entries (from the total, so
//     that a hot tile does not hold one SM alone). scatter_kernel's blocks
//     take the same rays, ROUND at a time: each ray's (t_x, t_y, values)
//     once into shared memory, its entries (a ray in each tile its four
//     corners touch) sorted there by tile, then each tile's run written at
//     the block's next slots in the tile's bucket: no global atomics, and
//     whole sectors (single 16-byte entries left partial sectors to the L2
//     and ran 0.19 ms at 4 M rays). A ray outside the grid with finite
//     positions adds exactly 0 and is dropped here; a NaN position goes to
//     the tiles of its corners (index 0 along a NaN coordinate).
//   * tile_kernel: persistent blocks take work items. A block loads its
//     item's entries into registers (PER_THREAD a thread, all loads in
//     flight), sorts them by corner cell into shared memory, and a thread a
//     cell sums its entries' four corners in registers and adds each corner
//     the tile owns into the tile's nodes in shared memory (a plane a
//     channel): V + 1 float atomics a cell, not an entry (a thread an entry
//     with atomics ran 0.16-0.17 ms at V = 2, this 0.096). It writes the
//     nodes, divided by the weight (or the sums, for return_acc), where the
//     tile has one item, else its partial tile to scratch; finish_kernel
//     sums a split tile's partials in item order and writes its nodes.
//     Every node is written once: no zeroed grid, no global float atomics.
//   * A call takes its rays in batches of at most `batch` (the caller's
//     choice), so that the bucket array, sized for four entries a ray, is
//     bounded whatever the rays: each batch runs the six kernels, its nodes
//     written as sums added to the batches' before it (into the grid for
//     return_acc, else into an accumulator in scratch), and the last
//     batch's nodes divided by the weight.
// A float atomicAdd to shared memory is a compare-and-swap loop on this
// card, and the entries of a cell are summed in the order the atomics gave
// their slots, so a node's last bits may change from run to run, as the
// first design's did. A pile of equal inexact addends is summed by cell,
// then by partial tile, not one add after another as the plain version
// does: nearer the exact sum, and up to ~5e-5 of the largest sum from the
// plain one. Built with --fmad=false: each product is rounded as the plain
// version rounds it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;  // nodes a tile along x and along y
constexpr int TILE_NODES = TILE * TILE;
constexpr int THREADS = 256;
constexpr int RAYS = 4;            // rays a scatter thread a round
constexpr int MAX_TILES = 4096;    // tiles the block histograms hold
constexpr int SORT_PER_SM = 4;     // count and scatter blocks an SM
constexpr int TILE_PER_SM = 8;     // tile_kernel blocks an SM
constexpr int ITEMS_PER_SM = 8;    // work items planned an SM
constexpr unsigned MIN_CHUNK = 2048;  // fewest entries an item is given
// entries a tile_kernel thread holds, and so the most an item is given
constexpr int PER_THREAD = 16;
constexpr unsigned MAX_CHUNK = THREADS * PER_THREAD;
constexpr int PLAN_THREADS = 1024;

struct Item {
  int tile;
  unsigned begin, end;  // its entries
};

struct Geometry {
  const float* xc;
  const float* yc;
  int nx, ny, nty;  // nodes along x, y; tiles along y
};

// clip(floor(t), 0, n - 2) as the JAX program computes it (NaN -> 0)
__device__ __forceinline__ int corner(float t, int n) {
  float f = floorf(t);
  if (isnan(f)) f = 0.0f;
  return (int)fminf(fmaxf(f, 0.0f), (float)(n - 2));
}

// clip(v, 0, 1), keeping a NaN
__device__ __forceinline__ float clip01(float v) {
  return v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
}

__device__ __forceinline__ bool inside(float tx, float ty, int nx, int ny) {
  return isfinite(tx) && isfinite(ty) && tx >= 0.0f &&
         tx <= (float)(nx - 1) && ty >= 0.0f && ty <= (float)(ny - 1);
}

// ray i's grid coordinates, and the tiles its corners touch (1, 2 or 4, in
// tiles[]); 0 for a ray that adds nothing
__device__ __forceinline__ int tiles_of(const Geometry& G, float x, float y,
                                        float& tx, float& ty, int tiles[4]) {
  const float x0 = G.xc[0], y0 = G.yc[0];
  tx = (x - x0) / (G.xc[1] - x0);
  ty = (y - y0) / (G.yc[1] - y0);
  if (!inside(tx, ty, G.nx, G.ny) && !isnan(tx) && !isnan(ty)) return 0;
  const int ix = corner(tx, G.nx), iy = corner(ty, G.ny);
  const int a0 = ix / TILE, a1 = (ix + 1) / TILE;
  const int b0 = iy / TILE, b1 = (iy + 1) / TILE;
  int k = 0;
  tiles[k++] = a0 * G.nty + b0;
  if (b1 != b0) tiles[k++] = a0 * G.nty + b1;
  if (a1 != a0) {
    tiles[k++] = a1 * G.nty + b0;
    if (b1 != b0) tiles[k++] = a1 * G.nty + b1;
  }
  return k;
}

// the sorting blocks' rounds: block b takes rounds b, b + B, ... of
// THREADS x RAYS consecutive rays (count_kernel and scatter_kernel, with
// the same grid, give a block the same rays)
constexpr long long ROUND = (long long)THREADS * RAYS;
constexpr int COUNT_THREADS = 1024;

// a sorting block's counter of tile t: in shared memory, or (grids past
// MAX_TILES tiles) its own slot of the (tile, block) matrix in scratch
struct Counters {
  unsigned* p;
  long long stride;

  __device__ __forceinline__ unsigned* at(int t) const {
    return p + t * stride;
  }
};

__device__ __forceinline__ Counters counters(unsigned* smem, unsigned* col,
                                             int T) {
  if (T <= MAX_TILES) return {smem, 1};
  return {col + blockIdx.x, (long long)gridDim.x};
}

// col[t B + b]: the entries block b gives tile t (COUNT_THREADS = ROUND a
// block)
__global__ void __launch_bounds__(COUNT_THREADS)
    count_kernel(const float* x, const float* y, Geometry G, int T,
                 unsigned* col, long long N) {
  extern __shared__ unsigned hist[];
  const Counters C = counters(hist, col, T);
  for (int t = threadIdx.x; t < T; t += COUNT_THREADS) *C.at(t) = 0;
  __syncthreads();
  // a ray a thread a round, the next round's position loaded ahead
  static_assert(ROUND == COUNT_THREADS, "a ray a count thread a round");
  const long long rounds = (N + ROUND - 1) / ROUND;
  long long r = blockIdx.x, i = r * ROUND + threadIdx.x;
  float px = i < N ? x[i] : 0.0f, py = i < N ? y[i] : 0.0f;
  for (; r < rounds; r += gridDim.x) {
    const long long in = i + (long long)gridDim.x * ROUND;
    const float qx = in < N ? x[in] : 0.0f, qy = in < N ? y[in] : 0.0f;
    float tx, ty;
    int tiles[4];
    const int k = i < N ? tiles_of(G, px, py, tx, ty, tiles) : 0;
    // (two branches, so that the shared one is a shared-memory atomic)
    for (int q = 0; q < k; ++q) {
      if (T <= MAX_TILES)
        atomicAdd(&hist[tiles[q]], 1u);
      else
        atomicAdd(C.at(tiles[q]), 1u);
    }
    i = in;
    px = qx;
    py = qy;
  }
  __syncthreads();
  if (T <= MAX_TILES)
    for (int t = threadIdx.x; t < T; t += COUNT_THREADS)
      col[(long long)t * gridDim.x + blockIdx.x] = hist[t];
}

// the exclusive prefix sum over the block of each thread's v (all threads
// call it), and the block's total in *total
__device__ __forceinline__ unsigned block_scan(unsigned v, unsigned* warps,
                                               unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned s = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned u = __shfl_up_sync(0xffffffffu, s, d);
    if (lane >= d) s += u;
  }
  if (lane == 31) warps[warp] = s;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < (int)(blockDim.x >> 5) ? warps[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned u = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += u;
    }
    warps[lane] = w;
    if (lane == 31) *total = w;
  }
  __syncthreads();
  const unsigned out = s - v + (warp ? warps[warp - 1] : 0u);
  __syncthreads();
  return out;
}

// one block a tile: its column of the (tile, block) matrix scanned in
// place (each block's first entry from the tile's start), the tile's total
// in count[t]
__global__ void __launch_bounds__(PLAN_THREADS)
    column_kernel(unsigned* col, int B, unsigned* count) {
  __shared__ unsigned warps[32], total;
  unsigned* c = col + (long long)blockIdx.x * B;
  const unsigned v = (int)threadIdx.x < B ? c[threadIdx.x] : 0u;
  const unsigned e = block_scan(v, warps, &total);
  if ((int)threadIdx.x < B) c[threadIdx.x] = e;
  if (threadIdx.x == 0) count[blockIdx.x] = total;
}

// one block: each tile's bucket range (start), its work items (first item,
// count) and the items, and their number
__global__ void __launch_bounds__(PLAN_THREADS)
    plan_kernel(const unsigned* count, int T, int target, unsigned* start_of,
                int* item0, int* nitems, Item* items, int* n_items) {
  __shared__ unsigned warps[32], total;
  const int per = (T + PLAN_THREADS - 1) / PLAN_THREADS;
  const int lo = min(T, (int)threadIdx.x * per), hi = min(T, lo + per);
  unsigned mine = 0;
  for (int t = lo; t < hi; ++t) mine += count[t];
  const unsigned start = block_scan(mine, warps, &total);
  const unsigned all = total;
  const unsigned chunk = min(MAX_CHUNK, max(
      MIN_CHUNK, (unsigned)(((unsigned long long)all + target - 1) / target)));
  unsigned k_mine = 0;
  for (int t = lo; t < hi; ++t)
    k_mine += max(1u, (count[t] + chunk - 1) / chunk);
  const unsigned k_start = block_scan(k_mine, warps, &total);
  unsigned e = start, k = k_start;
  for (int t = lo; t < hi; ++t) {
    const unsigned c = count[t], kt = max(1u, (c + chunk - 1) / chunk);
    start_of[t] = e;
    item0[t] = (int)k;
    nitems[t] = (int)kt;
    for (unsigned j = 0; j < kt; ++j)
      items[k + j] = Item{t, e + j * chunk, e + min(c, (j + 1) * chunk)};
    e += c;
    k += kt;
  }
  if (threadIdx.x == 0) *n_items = (int)total;
}

template <int V>
__device__ __forceinline__ float4 entry(float tx, float ty, const float* v) {
  return make_float4(tx, ty, v[0], V > 1 ? v[V - 1] : 0.0f);
}

// scatter_kernel's shared memory: a round's rays (t_x, t_y, values), its
// entries in tile order as (tile << 12 | ray) words, and four counters a
// tile
constexpr size_t STAGE = (size_t)ROUND * 4;  // a round's entries, at most
static_assert(ROUND <= 4096 && MAX_TILES <= (1 << 20), "entry words");
size_t scatter_smem(int T) {
  return ROUND * 16 + STAGE * 4 + (T <= MAX_TILES ? 16 * (size_t)T : 0);
}

template <int V>
__global__ void __launch_bounds__(THREADS)
    scatter_kernel(const float* x, const float* y, const float* vals,
                   Geometry G, int T, const unsigned* start_of,
                   unsigned* col, float4* entries, long long N) {
  extern __shared__ float4 smem4[];
  float4* ray = smem4;
  unsigned* slot_of = reinterpret_cast<unsigned*>(ray + ROUND);
  unsigned* next = slot_of + STAGE;
  unsigned* cnt = next + T;    // the round's entries a tile
  unsigned* first = cnt + T;   // their first staging slot
  unsigned* base = first + T;  // their first slot in the tile's bucket
  __shared__ unsigned warps[32], total;
  const bool staged = T <= MAX_TILES;
  // the block's next slot in each tile: the tile's start and the entries
  // of the blocks before it (column_kernel's scan)
  const Counters C = counters(next, col, T);
  for (int t = threadIdx.x; t < T; t += THREADS) {
    *C.at(t) = start_of[t] + col[(long long)t * gridDim.x + blockIdx.x];
    if (staged) cnt[t] = 0;
  }
  __syncthreads();
  constexpr int PER = 16;  // tiles a thread scans (MAX_TILES / THREADS)
  const long long rounds = (N + ROUND - 1) / ROUND;
  for (long long r = blockIdx.x; r < rounds; r += gridDim.x) {
    float px[RAYS], py[RAYS], pv[RAYS][V];
    int tiles[RAYS][4], k[RAYS];
    unsigned rank[RAYS][4];
#pragma unroll
    for (int j = 0; j < RAYS; ++j) {
      const long long i = r * ROUND + j * THREADS + threadIdx.x;
      px[j] = i < N ? x[i] : 0.0f;
      py[j] = i < N ? y[i] : 0.0f;
#pragma unroll
      for (int c = 0; c < V; ++c) pv[j][c] = i < N ? vals[i * V + c] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < RAYS; ++j) {
      const long long i = r * ROUND + j * THREADS + threadIdx.x;
      float tx, ty;
      k[j] = i < N ? tiles_of(G, px[j], py[j], tx, ty, tiles[j]) : 0;
      if (!staged) {
        for (int q = 0; q < k[j]; ++q)
          entries[atomicAdd(C.at(tiles[j][q]), 1u)] = entry<V>(tx, ty, pv[j]);
        continue;
      }
      ray[j * THREADS + threadIdx.x] = entry<V>(tx, ty, pv[j]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < k[j]) rank[j][q] = atomicAdd(&cnt[tiles[j][q]], 1u);
    }
    if (!staged) continue;
    __syncthreads();
    // the round's runs: each tile's first staging slot (a scan of the
    // counts) and its slots in the bucket, the block's next ones there
    const int t0 = threadIdx.x * PER;
    unsigned mine = 0;
    for (int t = t0; t < min(t0 + PER, T); ++t) mine += cnt[t];
    unsigned at = block_scan(mine, warps, &total);
    for (int t = t0; t < min(t0 + PER, T); ++t) {
      const unsigned c = cnt[t];
      first[t] = at;
      base[t] = next[t];
      next[t] += c;
      cnt[t] = 0;
      at += c;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < RAYS; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < k[j])
          slot_of[first[tiles[j][q]] + rank[j][q]] =
              (unsigned)tiles[j][q] << 12 | (j * THREADS + threadIdx.x);
    __syncthreads();
    // each tile's run written at its bucket slots, in staging order
    for (unsigned e = threadIdx.x; e < total; e += THREADS) {
      const unsigned w = slot_of[e];
      const int t = (int)(w >> 12);
      entries[base[t] + e - first[t]] = ray[w & 4095u];
    }
    __syncthreads();
  }
}

// a node's V outputs from its sums (weight last), first added to the
// earlier batches' sums where `prev` is given: the sums themselves, or each
// value divided by max(weight, 1e-12) (a NaN weight stays NaN)
template <int V>
__device__ __forceinline__ void write_node(float* out, long long j, float* s,
                                           bool ret_acc, const float* prev) {
  if (prev)
#pragma unroll
    for (int c = 0; c <= V; ++c) s[c] = prev[j * (V + 1) + c] + s[c];
  if (ret_acc) {
#pragma unroll
    for (int c = 0; c <= V; ++c) out[j * (V + 1) + c] = s[c];
    return;
  }
  const float d = s[V] < 1e-12f ? 1e-12f : s[V];
#pragma unroll
  for (int c = 0; c < V; ++c) out[j * V + c] = s[c] / d;
}

// the tile's nodes from its sums: where the tile has one work item, each
// node of the grid (divided by the weight, or the sums for ret_acc); else
// its partial tile, slot `it` of the scratch
template <int V>
__device__ __forceinline__ void write_tile(const float (*sums)[TILE_NODES],
                                          int it, int x0, int y0,
                                          bool split, const Geometry& G,
                                          float* out, float* partial,
                                          int ret_acc, const float* prev) {
  for (int j = threadIdx.x; j < TILE_NODES; j += THREADS) {
    if (split) {
#pragma unroll
      for (int c = 0; c <= V; ++c)
        partial[((long long)it * (V + 1) + c) * TILE_NODES + j] = sums[c][j];
      continue;
    }
    const int i = x0 + j / TILE, k = y0 + j % TILE;
    if (i < G.nx && k < G.ny) {
      float s[V + 1];
#pragma unroll
      for (int c = 0; c <= V; ++c) s[c] = sums[c][j];
      write_node<V>(out, (long long)i * G.ny + k, s, ret_acc, prev);
    }
  }
}

// an entry's corner cell, fractions and values (0 unless inside)
template <int V>
struct Ray {
  int ix, iy;
  bool in;
  float gx[2], gy[2], v[V];

  __device__ __forceinline__ Ray(const float4& E, const Geometry& G) {
    in = inside(E.x, E.y, G.nx, G.ny);
    ix = corner(E.x, G.nx);
    iy = corner(E.y, G.ny);
    const float fx = clip01(E.x - (float)ix), fy = clip01(E.y - (float)iy);
    gx[0] = 1.0f - fx;
    gx[1] = fx;
    gy[0] = 1.0f - fy;
    gy[1] = fy;
    const float ev[2] = {E.z, E.w};
#pragma unroll
    for (int c = 0; c < V; ++c) v[c] = in ? ev[c] : 0.0f;
  }

  // what it adds to channel c of corner (a, b): value * weight and the
  // weight inside; a NaN weight (a NaN position) to every channel
  __device__ __forceinline__ float add(int a, int b, int c) const {
    const float w = gx[a] * gy[b];
    if (!in) return isnan(w) ? w : 0.0f;
    return c < V ? v[c] * w : w;
  }
};

// the cells whose corners a tile owns: (TILE + 1)^2, from one before the
// tile's first node along each axis
constexpr int CELLS = (TILE + 1) * (TILE + 1);

__device__ __forceinline__ int cell_of(const float4& E, const Geometry& G,
                                       int x0, int y0) {
  return (corner(E.x, G.nx) - x0 + 1) * (TILE + 1) + corner(E.y, G.ny) - y0 +
         1;
}

// the sorted form: a block loads its item's entries into registers
// (PER_THREAD a thread, coalesced, all in flight), sorts them by corner
// cell into shared memory (integer atomics for the counts and slots), then
// a thread a cell adds its entries' corners up in registers and each
// corner the tile owns into the shared tile: V + 1 float atomics a cell,
// not an entry
template <int V>
__global__ void __launch_bounds__(THREADS)
    tile_kernel(const float4* entries, const Item* items, const int* n_items,
                const int* nitems, Geometry G, float* out, float* partial,
                int ret_acc, const float* prev) {
  extern __shared__ float4 stage[];  // MAX_CHUNK entries in cell order
  __shared__ float sums[V + 1][TILE_NODES];
  __shared__ unsigned cells[CELLS];
  __shared__ unsigned warps[32], total;
  const int n_it = *n_items;
  for (int it = blockIdx.x; it < n_it; it += gridDim.x) {
    const Item I = items[it];
    const int x0 = (I.tile / G.nty) * TILE, y0 = (I.tile % G.nty) * TILE;
    for (int j = threadIdx.x; j < TILE_NODES; j += THREADS)
#pragma unroll
      for (int c = 0; c <= V; ++c) sums[c][j] = 0.0f;
    for (int c = threadIdx.x; c < CELLS; c += THREADS) cells[c] = 0;
    float4 E[PER_THREAD];
    int cell[PER_THREAD];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const unsigned e = I.begin + j * THREADS + threadIdx.x;
      E[j] = e < I.end ? entries[e] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      cell[j] = I.begin + j * THREADS + threadIdx.x < I.end
                    ? cell_of(E[j], G, x0, y0)
                    : -1;
    __syncthreads();
    // the entries a cell, then each cell's first slot (a thread scans a
    // run of PER cells)
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      if (cell[j] >= 0) atomicAdd(&cells[cell[j]], 1u);
    __syncthreads();
    constexpr int PER = (CELLS + THREADS - 1) / THREADS;
    const int c0 = threadIdx.x * PER;
    unsigned run = 0;
    for (int c = c0; c < min(c0 + PER, CELLS); ++c) run += cells[c];
    unsigned at = block_scan(run, warps, &total);
    for (int c = c0; c < min(c0 + PER, CELLS); ++c) {
      const unsigned n = cells[c];
      cells[c] = at;
      at += n;
    }
    __syncthreads();
    // each entry at its slot in cell order; a cell's entries then lie from
    // the end of the cell before it (cells[c - 1] after the adds) to
    // cells[c]
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      if (cell[j] >= 0) stage[atomicAdd(&cells[cell[j]], 1u)] = E[j];
    __syncthreads();
    for (int c = threadIdx.x; c < CELLS; c += THREADS) {
      const unsigned lo = c ? cells[c - 1] : 0u, hi = cells[c];
      if (lo == hi) continue;
      const int lx = c / (TILE + 1) - 1, ly = c % (TILE + 1) - 1;
      float acc[2][2][V + 1];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int k = 0; k <= V; ++k) acc[a][b][k] = 0.0f;
      for (unsigned k = lo; k < hi; ++k) {
        const Ray<V> R(stage[k], G);
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b)
#pragma unroll
            for (int ch = 0; ch <= V; ++ch) acc[a][b][ch] += R.add(a, b, ch);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        if (lx + a < 0 || lx + a >= TILE) continue;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          if (ly + b < 0 || ly + b >= TILE) continue;
#pragma unroll
          for (int ch = 0; ch <= V; ++ch)
            atomicAdd(&sums[ch][(lx + a) * TILE + ly + b], acc[a][b][ch]);
        }
      }
    }
    __syncthreads();
    write_tile<V>(sums, it, x0, y0, nitems[I.tile] > 1, G, out, partial,
                  ret_acc, prev);
    __syncthreads();
  }
}

// the nodes of each split tile (one block a tile, a thread a node): its
// items' partial tiles summed in item order
template <int V>
__global__ void __launch_bounds__(TILE_NODES)
    finish_kernel(const float* partial, const int* item0, const int* nitems,
                  Geometry G, float* out, int ret_acc,
                  const float* prev) {
  const int t = blockIdx.x, n = nitems[t];
  if (n <= 1) return;
  const int k0 = item0[t], j = threadIdx.x;
  const int i = (t / G.nty) * TILE + j / TILE;
  const int k = (t % G.nty) * TILE + j % TILE;
  if (i >= G.nx || k >= G.ny) return;
  float s[V + 1];
#pragma unroll
  for (int c = 0; c <= V; ++c) s[c] = 0.0f;
#pragma unroll 4
  for (int m = 0; m < n; ++m)
#pragma unroll
    for (int c = 0; c <= V; ++c)
      s[c] += partial[((long long)(k0 + m) * (V + 1) + c) * TILE_NODES + j];
  write_node<V>(out, (long long)i * G.ny + k, s, ret_acc, prev);
}

// the scratch of a call: a batch's bucket entries, the (tile, block)
// matrix, the tiles' counts, starts and work items, the partial tiles, and
// where the batches' sums are carried past the grid, their accumulator
struct Layout {
  int T, B, target, items;  // tiles, sorting blocks, items planned, most
  long long bytes;
  long long o_col, o_count, o_start, o_item0, o_nitems, o_nit, o_items,
      o_partial, o_acc;
};

long long align256(long long b) { return (b + 255) / 256 * 256; }

// the most rays a batch takes: its four bucket entries a ray have 32-bit
// positions
constexpr long long MAX_BATCH = 1LL << 28;

long long batches(long long N, long long batch) {
  return N > batch ? (N + batch - 1) / batch : 1;
}

Layout layout_of(long long N, int V, int nx, int ny, int sms,
                 long long batch, int ret_acc) {
  Layout L;
  const long long Nb = min(N, batch);
  const int ntx = (nx + TILE - 1) / TILE, nty = (ny + TILE - 1) / TILE;
  L.T = ntx * nty;
  L.B = min(sms * SORT_PER_SM, PLAN_THREADS);
  L.target = sms * ITEMS_PER_SM;
  // sum over tiles of ceil(entries / chunk) <= T + entries / chunk
  L.items = L.T + (int)max((long long)L.target,
                           (4 * Nb + MAX_CHUNK - 1) / MAX_CHUNK);
  long long o = align256(4 * Nb * 16);  // at most four entries a ray
  L.o_col = o;
  o = align256(o + 4LL * L.T * L.B);
  L.o_count = o;
  o = align256(o + 4LL * L.T);
  L.o_start = o;
  o = align256(o + 4LL * L.T);
  L.o_item0 = o;
  o = align256(o + 4LL * L.T);
  L.o_nitems = o;
  o = align256(o + 4LL * L.T);
  L.o_nit = o;
  o = align256(o + 4);
  L.o_items = o;
  o = align256(o + (long long)sizeof(Item) * L.items);
  L.o_partial = o;
  o = align256(o + 4LL * L.items * (V + 1) * TILE_NODES);
  L.o_acc = o;
  const bool carried = batches(N, batch) > 1 && !ret_acc;
  L.bytes = align256(o + (carried ? 4LL * nx * ny * (V + 1) : 0));
  return L;
}

template <int V>
int launch(const float* x, const float* y, const float* vals, Geometry G,
           char* scratch, const Layout& L, float* out, int ret_acc,
           long long N, long long batch, int sms, cudaStream_t s) {
  float4* entries = reinterpret_cast<float4*>(scratch);
  unsigned* col = reinterpret_cast<unsigned*>(scratch + L.o_col);
  unsigned* count = reinterpret_cast<unsigned*>(scratch + L.o_count);
  unsigned* start = reinterpret_cast<unsigned*>(scratch + L.o_start);
  int* item0 = reinterpret_cast<int*>(scratch + L.o_item0);
  int* nitems = reinterpret_cast<int*>(scratch + L.o_nitems);
  int* n_items = reinterpret_cast<int*>(scratch + L.o_nit);
  Item* items = reinterpret_cast<Item*>(scratch + L.o_items);
  float* partial = reinterpret_cast<float*>(scratch + L.o_partial);
  float* acc = ret_acc ? out : reinterpret_cast<float*>(scratch + L.o_acc);
  const int T = L.T;
  const size_t hist = T <= MAX_TILES ? 4 * (size_t)T : 0;
  const size_t smem = scatter_smem(T);
  cudaFuncSetAttribute(scatter_kernel<V>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int tb = min(sms * TILE_PER_SM, L.items);
  const int stage = MAX_CHUNK * sizeof(float4);
  cudaFuncSetAttribute(tile_kernel<V>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, stage);
  const long long nb = batches(N, batch);
  for (long long b = 0; b < nb; ++b) {
    // batch b's rays; its nodes are the sums of the batches so far (in acc)
    // until the last, whose nodes are the call's output
    const long long r0 = b * batch, n = min(batch, N - r0);
    const float *xb = x + r0, *yb = y + r0, *vb = vals + r0 * V;
    const bool last = b == nb - 1;
    const float* prev = b ? acc : nullptr;
    float* dst = last ? out : acc;
    const int ret = last ? ret_acc : 1;
    count_kernel<<<L.B, COUNT_THREADS, hist, s>>>(xb, yb, G, T, col, n);
    column_kernel<<<T, PLAN_THREADS, 0, s>>>(col, L.B, count);
    plan_kernel<<<1, PLAN_THREADS, 0, s>>>(count, T, L.target, start, item0,
                                           nitems, items, n_items);
    scatter_kernel<V><<<L.B, THREADS, smem, s>>>(xb, yb, vb, G, T, start,
                                                 col, entries, n);
    tile_kernel<V><<<tb, THREADS, stage, s>>>(entries, items, n_items,
                                              nitems, G, dst, partial, ret,
                                              prev);
    finish_kernel<V><<<T, TILE_NODES, 0, s>>>(partial, item0, nitems, G, dst,
                                              ret, prev);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The scratch bytes a deposit_cic call needs, in 256-byte blocks (a
// batch's four bucket entries a ray, the tiles' counts, ranges and work
// items, the (tile, block) matrix, partial tiles, and the accumulator of a
// call of more than one batch without ret_acc); 0 for arguments the deposit
// refuses.
extern "C" int deposit_scratch_blocks(long long N, int V, int nx, int ny,
                                      int sms, long long batch,
                                      int ret_acc) {
  if (N < 0 || V < 1 || V > 2 || nx < 2 || ny < 2 || sms < 1 ||
      batch < 1 || batch > MAX_BATCH)
    return 0;
  return (int)(layout_of(N, V, nx, ny, sms, batch, ret_acc).bytes / 256);
}

// x, y: (N,) f32 positions; vals: (N, V) f32, V = 1 or 2; xc (nx,), yc
// (ny,) f32 node coordinates in device memory, nx, ny >= 2; scratch:
// deposit_scratch_blocks(N, V, nx, ny, sms, batch, ret_acc) x 256 bytes in
// device memory, 16-byte aligned; out: (nx, ny, V) f32, the
// weight-normalised grid, or with ret_acc (nx, ny, V + 1), the sums (weight
// last); batch: the most rays a batch takes, 1 .. 2^28; sms: the card's
// SMs. Six device kernels a batch. Returns cudaGetLastError(), or
// cudaErrorInvalidValue.
extern "C" int deposit_cic(const float* x, const float* y, const float* vals,
                           int V, const float* xc, const float* yc, int nx,
                           int ny, void* scratch, long long scratch_bytes,
                           float* out, int ret_acc, long long N,
                           long long batch, int sms, void* stream) {
  if (N < 0 || V < 1 || V > 2 || nx < 2 || ny < 2 || sms < 1 ||
      batch < 1 || batch > MAX_BATCH || ((uintptr_t)scratch & 15))
    return (int)cudaErrorInvalidValue;
  const Layout L = layout_of(N, V, nx, ny, sms, batch, ret_acc);
  if (scratch_bytes < L.bytes) return (int)cudaErrorInvalidValue;
  const Geometry G = {xc, yc, nx, ny, (ny + TILE - 1) / TILE};
  cudaStream_t s = (cudaStream_t)stream;
  char* sc = reinterpret_cast<char*>(scratch);
  if (V == 1)
    return launch<1>(x, y, vals, G, sc, L, out, ret_acc, N, batch, sms, s);
  return launch<2>(x, y, vals, G, sc, L, out, ret_acc, N, batch, sms, s);
}
