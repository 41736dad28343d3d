// K3: the detector, in two forms that share the state read, the
// back-projection and the stage loop.
//
// Replaces two JAX device programs. detect_image, the incoherent form,
// replaces the one that turns the exit state into an image:
// reassemble_state (synthpy_tpu/tracer/zscan.py:64), ray_to_Jonesvector's
// back-projection and arctan angles (tracer/propagator.py:138-160),
// m_to_mm (optics/rtm.py:18), apply_stages' folded 4x4 ABCD stages with
// aperture, stop, rectangle and knife-edge NaN kills (optics/compose.py
// :78), and histogram2d's numpy-rule binning and scatter-add
// (ops/histogram.py:26-66).
// detect_field, the coherent form, replaces the coherent branch of
// synthpy_tpu/pipeline.py:115-123: the Jones vector from amp, phase and pol
// (propagator.py:161-167), the interferometer's tilted reference beam
// (compose.py:123), the stage list with its ("phase",) and ("mark",)
// checkpoints (compose.py:92-104: E times exp(i k |transverse path|)), and
// complex_histogram's field sums (ops/histogram.py:69: x_edges_n - 1
// pixels, digitize - 1, the right edge dropped) into an (ny, nx, C) f32
// accumulator, C = 2 (legacy: Re Jx, Re Jy) or 4 (intensity: Re and Im of
// both); finalize_complex stays in PyTorch.
// The exit states of the z-scan marches share one exit plane p_end; those of
// the time tracer (pipeline.py:140 synth_image) each sit at their own
// probing coordinate, which the kernel then reads per ray (p_ray) in place
// of p_end, as ray_to_Jonesvector reads row p of the (9, N) state.
//
// What bounds it on the H100: by count, bytes. Each ray reads its 32-byte
// (N, 8) exit state (and 4 bytes of weight) and does ~60 flops and 2
// arctans (the coherent form adds 2-5 sin/cos pairs and a square root),
// then adds into a (ny, nx) f32 image (or C of them) that fits in L2.
// Measured at the main path's shapes (4 M rays of a beam that lands on
// ~7,600 bins) the incoherent form runs at about a quarter of the bytes
// bound, and the atomics hold it: without them it takes two fifths of the
// time, as adds to a few thousand hot addresses queue in L2 (PERF.md). The
// design fuses the whole chain into one pass, one thread per ray in the
// caller's order, so no (9, N) or (4, N) intermediate is written; the stage
// list comes in as a kernel parameter (no copy to the device per call) and
// sits in shared memory, and the state row comes in as two 16-byte loads.
// Each kept ray adds once (C times for the field). In the caller's order a
// warp's rays land on ~32 distinct bins, so adding once per (warp, bin)
// (__match_any_sync) saves nothing; it saves a third of the time on states
// stored in the march's entry-cell order (~2 bins a warp), but the march
// writes each ray back to its own row, and reading the states through that
// order, or copying them into it, costs more than the atomics it saves.
// The stage table of up to MAX_OPS stages comes by value and sits in a
// static shared array; a longer one (a user's stage list, which compose
// cannot fold) comes as a device copy (dops), chosen by the wrapper by
// length alone, and is read where it is: every thread reads the same stage
// row, which L1 serves as a broadcast. One template instance of each kernel
// for each, so that the by-value path compiles as it did before long tables
// existed.
// bin_image and bin_field bin bare (N,) rays, the diagnostic classes' and
// ops.histogram's entry points (histogram.py:26-66 histogram2d with
// optional weights, :69 complex_histogram's field sums): the same bin_of /
// pixel_of rules and atomics, without the state read and the stages.
//
// The cluster form of unweighted bin_image. At the diagnostics path's
// shapes 4 M rays land on ~12,600 bins of a 431 x 321 image (up to ~440 a
// bin), and the one-thread-a-ray form's adds, queued in L2, take four
// fifths of its time. So unweighted counts are held on chip: across a
// thread-block cluster of 2^lg blocks on neighbouring SMs, block r holding
// the image rows iy with iy % 2^lg == r (row iy >> lg of its slice) as
// int32 in shared memory; rows are dealt out in turn, not in bands, so
// that a beam's hot rows spread over every block. Each block takes a
// contiguous range of rays (a cluster the ranges of its blocks), CL_RAYS
// rays a thread a trip with their loads issued before their adds, and adds
// 1 for each kept ray into the slice that owns its row through
// cluster.map_shared_rank (distributed shared memory, a native integer
// add): the 540 KiB of a 431 x 321 image in a cluster of 4. After the
// cluster's last add each block adds its slice's nonzero counts into the
// zeroed image with global float atomics: integer counts below 2^24 are
// exact as floats and in any order, so the image is the one-thread form's,
// bit for bit, and no partial images go through device memory (summing
// them in a second kernel ran 12% slower). plan_of picks the cluster and
// the grid from the image's bytes and the card's attributes (shared memory
// a block, cudaOccupancyMaxActiveClusters) and is the plan's one owner:
// bin_image derives it at each call, k3_plan reports it. An image past the
// largest cluster keeps the one-thread form; a cluster launch that fails
// returns its error.
// Weighted bins and field sums keep the one-thread form: in distributed
// shared memory a float add is a compare-and-swap loop (so is
// red.shared::cluster.add.f32), and the cluster form ran 1.4-2.0x slower
// than L2's native float reductions (PERF.md).
//
// Built with --fmad=false: every product and sum is rounded as the plain
// PyTorch version rounds it (its complex products written out in real
// arithmetic), so a ray near a bin edge lands in the same bin, counts match
// exactly, and a ray's field is the plain version's; field sums then differ
// only by the order of the atomic adds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int OP_WIDTH = 17;  // kind, then 16 parameters
constexpr int MAX_OPS = 16;   // stages passed by value

struct Ops {
  float v[MAX_OPS * OP_WIDTH];
};

enum Op {
  MATRIX = 0, APERTURE = 1, STOP = 2, RECT = 3, KNIFE = 4, PHASE = 5,
  MARK = 6
};

// numpy-rule bin of v in [lo, hi]: v == hi goes to the last bin; false for
// NaN and out-of-range values
__device__ __forceinline__ bool bin_of(float v, float lo, float hi,
                                       float scale, int n, int& idx) {
  const float f = floorf((v - lo) * scale);
  idx = v == hi ? n - 1 : (int)fminf(fmaxf(f, 0.0f), (float)(n - 1));
  return isfinite(v) && v >= lo && v <= hi;
}

// complex_histogram's pixel of v: floor((v + L/2) / (L/n)) in [0, n), false
// for NaN and out-of-range values
__device__ __forceinline__ bool pixel_of(float v, float half, float d, int n,
                                         int& idx) {
  const float f = floorf((v + half) / d);
  idx = (int)fminf(fmaxf(f, 0.0f), (float)(n - 1));
  return isfinite(v) && f >= 0.0f && f < (float)n;
}

// The RTM ray [x, theta, y, phi] (mm, rad) of one permuted exit state (lo =
// a, b, va, vb; vp) back-projected from p_end to the plane at depth; rows
// 0/2 are (a, b), or (b, a) when probing along y.
__device__ __forceinline__ void exit_ray(float4 lo, float vp, int swap,
                                         float p_end, float depth,
                                         float r[4]) {
  const float pa = swap ? lo.y : lo.x, va = swap ? lo.w : lo.z;
  const float pb = swap ? lo.x : lo.y, vb = swap ? lo.z : lo.w;
  const float t_bp = (p_end - depth) / vp;
  r[0] = (pa - va * t_bp) * 1000.0f;
  r[1] = atanf(va / vp);
  r[2] = (pb - vb * t_bp) * 1000.0f;
  r[3] = atanf(vb / vp);
}

// E (Jx, Jy as re, im pairs) times exp(i k |transverse path|) from the
// checkpoint (m0, m2) to r (compose.advance_phase).
__device__ __forceinline__ void advance_phase(float E[4], const float r[4],
                                              float m0, float m2, float k) {
  const float dx = (r[0] - m0) * 1e-3f, dy = (r[2] - m2) * 1e-3f;
  const float d2 = dx * dx + dy * dy;
  const float kp = k * (d2 > 0.0f ? sqrtf(d2) : 0.0f);
  const float c = cosf(kp), s = sinf(kp);
#pragma unroll
  for (int j = 0; j < 4; j += 2) {
    const float re = E[j], im = E[j + 1];
    E[j] = re * c - im * s;
    E[j + 1] = re * s + im * c;
  }
}

// Run the stage list on r (and, for FIELD, on E with wavenumber k); false
// when a filter stops the ray, which then reaches no bin.
template <bool FIELD>
__device__ __forceinline__ bool run_stages(float r[4], float E[4],
                                           const float* sops, int n_ops,
                                           float k) {
  float m0 = r[0], m2 = r[2];
  for (int o = 0; o < n_ops; ++o) {
    const float* op = sops + o * OP_WIDTH;
    const int kind = (int)op[0];
    const float* p = op + 1;
    if (kind == MATRIX) {
      float out[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        out[q] = p[4 * q] * r[0] + p[4 * q + 1] * r[1] + p[4 * q + 2] * r[2] +
                 p[4 * q + 3] * r[3];
#pragma unroll
      for (int q = 0; q < 4; ++q) r[q] = out[q];
    } else if (kind == APERTURE) {
      if (r[0] * r[0] + r[2] * r[2] > p[0]) return false;
    } else if (kind == STOP) {
      if (r[0] * r[0] + r[2] * r[2] < p[0]) return false;
    } else if (kind == RECT) {
      if (r[0] * r[0] > p[0] && r[2] * r[2] > p[1]) return false;
    } else if (kind == KNIFE) {  // row p[0], direction p[1], offset p[2]
      const float v = r[(int)p[0]];
      if (p[1] > 0.0f ? v > p[2] : v < p[2]) return false;
    } else if constexpr (FIELD) {
      if (kind == PHASE) advance_phase(E, r, m0, m2, k);
      m0 = r[0];  // PHASE and MARK move the checkpoint
      m2 = r[2];
    }
  }
  return true;
}

// A kept ray's field into its pixel: (Re Jx, Re Jy) for n_ch 2, all four
// parts for n_ch 4.
__device__ __forceinline__ void add_field(float* cell, const float E[4],
                                          int n_ch) {
  if (n_ch == 2) {
    atomicAdd(cell, E[0]);
    atomicAdd(cell + 1, E[2]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) atomicAdd(cell + c, E[c]);
  }
}

// A block's stage table: with IN_PLACE the device table where it is, else
// the by-value kernel parameter copied into a static shared array.
template <bool IN_PLACE>
__device__ __forceinline__ const float* stage_table(const Ops& ops,
                                                    const float* dops,
                                                    int n_ops) {
  if constexpr (IN_PLACE) {
    return dops;
  } else {
    __shared__ float sops[MAX_OPS * OP_WIDTH];
    for (int j = threadIdx.x; j < n_ops * OP_WIDTH; j += blockDim.x)
      sops[j] = ops.v[j];
    __syncthreads();
    return sops;
  }
}

// Thread i bins ray i. With p_ray, ray i sits at its own probing
// coordinate p_ray[i] (the time tracer's exit states), else at p_end.
template <bool IN_PLACE>
__global__ void detect_kernel(const float* uf, const float* p_ray,
                              const float* weights, float* H, long long N,
                              int swap, float p_end, float depth,
                              const Ops ops, const float* dops, int n_ops,
                              int nx, int ny, float xlo, float xhi, float xs,
                              float ylo, float yhi, float ys) {
  const float* sops = stage_table<IN_PLACE>(ops, dops, n_ops);
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= N) return;
  const float4* u = reinterpret_cast<const float4*>(uf + i * 8);
  float r[4];
  exit_ray(u[0], u[1].x, swap, p_ray ? p_ray[i] : p_end, depth, r);
  if (!run_stages<false>(r, nullptr, sops, n_ops, 0.0f)) return;
  int ix, iy;
  if (bin_of(r[0], xlo, xhi, xs, nx, ix) && bin_of(r[2], ylo, yhi, ys, ny, iy))
    atomicAdd(H + iy * nx + ix, weights ? weights[i] : 1.0f);
}

// The coherent form: thread i adds ray i's field to its pixel's n_ch sums.
template <bool IN_PLACE>
__global__ void field_kernel(const float* uf, const float* p_ray, float* H,
                             long long N, int swap, float p_end, float depth,
                             const Ops ops, const float* dops, int n_ops,
                             float k, int npx, int npy, float xhalf, float dx,
                             float yhalf, float dy, int n_ch, int ref,
                             float fr, float cr, float sr) {
  const float* sops = stage_table<IN_PLACE>(ops, dops, n_ops);
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= N) return;
  const float4* u = reinterpret_cast<const float4*>(uf + i * 8);
  const float4 hi = u[1];  // vp, amp, phase, pol
  float r[4];
  exit_ray(u[0], hi.x, swap, p_ray ? p_ray[i] : p_end, depth, r);
  // amp e^(i phase) times the polarisation R(pol) y-hat = (-sin, cos)
  const float er = hi.y * cosf(hi.z), ei = hi.y * sinf(hi.z);
  const float sp = -sinf(hi.w), cp = cosf(hi.w);
  float E[4] = {er * sp, ei * sp, er * cp, ei * cp};
  if (ref) {
    const float a = fr * (cr * r[0] + sr * r[2]);
    E[2] = E[2] + cosf(a);
    E[3] = E[3] + sinf(a);
  }
  if (!run_stages<true>(r, E, sops, n_ops, k)) return;
  int ix, iy;
  if (!pixel_of(r[0], xhalf, dx, npx, ix) ||
      !pixel_of(r[2], yhalf, dy, npy, iy))
    return;
  add_field(H + ((long long)iy * npx + ix) * n_ch, E, n_ch);
}

// Bare rays: thread i adds ray i (weight w[i], or 1) to its numpy-rule bin.
__global__ void bin_image_kernel(const float* x, const float* y,
                                 const float* w, float* H, long long N,
                                 int nx, int ny, float xlo, float xhi,
                                 float xs, float ylo, float yhi, float ys) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= N) return;
  int ix, iy;
  if (bin_of(x[i], xlo, xhi, xs, nx, ix) && bin_of(y[i], ylo, yhi, ys, ny, iy))
    atomicAdd(H + iy * nx + ix, w ? w[i] : 1.0f);
}

// Bare rays with their Jones vectors (Ex, Ey interleaved re, im): thread i
// adds ray i's field to its pixel's n_ch sums, as field_kernel does.
__global__ void bin_field_kernel(const float* x, const float* y,
                                 const float2* Ex, const float2* Ey, float* H,
                                 long long N, int npx, int npy, float xhalf,
                                 float dx, float yhalf, float dy, int n_ch) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= N) return;
  int ix, iy;
  if (!pixel_of(x[i], xhalf, dx, npx, ix) ||
      !pixel_of(y[i], yhalf, dy, npy, iy))
    return;
  const float2 ex = Ex[i], ey = Ey[i];
  const float E[4] = {ex.x, ex.y, ey.x, ey.y};
  add_field(H + ((long long)iy * npx + ix) * n_ch, E, n_ch);
}

// -- the cluster form of unweighted bin_image ---------------------------------

constexpr int CL_THREADS = 1024;     // a cluster block's threads
constexpr int CL_RAYS = 4;           // rays a thread a trip, loads first
constexpr int RAYS_A_BLOCK = 4096;   // the fewest rays a block is given
constexpr int PORTABLE_CLUSTER = 8;  // the largest cluster any card takes
constexpr int MAX_CLUSTER = 16;      // the largest the plan asks for
constexpr int SMEM_KEEP = 1024;      // shared bytes a block keeps free

// k3_plan's entry points (bin_image kind 0: unweighted, 1: weighted;
// bin_field and detect_field kind = n_ch)
enum Entry { BIN_IMAGE = 0, BIN_FIELD = 1, DETECT_FIELD = 2 };

// The cluster form: the block's slice zeroed, its range of rays counted
// into the cluster's slices, its nonzero counts added into H.
__global__ void __launch_bounds__(CL_THREADS, 1)
    bin_image_cluster(const float* __restrict__ x,
                      const float* __restrict__ y, float* H, long long N,
                      int nx, int ny, float xlo, float xhi, float xs,
                      float ylo, float yhi, float ys, int lg) {
  extern __shared__ __align__(16) int img[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int mask = (1 << lg) - 1;
  const int words = ((ny + mask) >> lg) * nx;
  for (int k = threadIdx.x; k < words; k += CL_THREADS) img[k] = 0;
  cl.sync();  // every slice zeroed before any block adds into it
  const long long per = (N + gridDim.x - 1) / gridDim.x;
  const long long r0 = blockIdx.x * per;
  const long long r1 = min(N, r0 + per);
  for (long long i0 = r0 + threadIdx.x; i0 < r1;
       i0 += (long long)CL_RAYS * CL_THREADS) {
    int ix[CL_RAYS], iy[CL_RAYS];
    bool keep[CL_RAYS];
#pragma unroll
    for (int r = 0; r < CL_RAYS; ++r) {
      const long long i = i0 + (long long)r * CL_THREADS;
      keep[r] = i < r1 &&
                bin_of(__ldg(x + i), xlo, xhi, xs, nx, ix[r]) &
                    bin_of(__ldg(y + i), ylo, yhi, ys, ny, iy[r]);
    }
#pragma unroll
    for (int r = 0; r < CL_RAYS; ++r)
      if (keep[r])
        atomicAdd(cl.map_shared_rank(img, iy[r] & mask) +
                      (iy[r] >> lg) * nx + ix[r], 1);
  }
  cl.sync();  // every add landed; from here a block reads only its slice
  for (int k = threadIdx.x; k < words; k += CL_THREADS) {
    const int iy = ((k / nx) << lg) + rank;
    if (img[k] && iy < ny) atomicAdd(H + iy * nx + k % nx, (float)img[k]);
  }
}

// The launch plan of one call.
struct Plan {
  int cluster;   // blocks a cluster; 0: the one-thread form
  int lg;        // log2(cluster)
  int rows;      // image rows a block holds, ceil(ny / cluster)
  int clusters;  // the grid's clusters
  int smem;      // dynamic shared bytes a block
  int active;    // clusters the card holds at once
};

// the cluster kernel's launch attributes: its slice's shared bytes, and
// clusters past the portable size where asked
cudaError_t set_attributes(int smem, int cluster) {
  cudaError_t rc = cudaFuncSetAttribute(
      bin_image_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc == cudaSuccess && cluster > PORTABLE_CLUSTER)
    rc = cudaFuncSetAttribute(
        bin_image_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return rc;
}

cudaLaunchConfig_t cluster_config(int cluster, int clusters, int smem,
                                  cudaLaunchAttribute* attr,
                                  cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * cluster));
  cfg.blockDim = dim3(CL_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// cudaOccupancyMaxActiveClusters of the cluster kernel at (cluster, smem)
// on card dev, kept once asked (an attribute set and a query a call
// otherwise); 0 where the card takes no cluster of that size
cudaError_t active_clusters(int dev, int cluster, int smem, int& n) {
  struct Seen {
    int dev, cluster, smem, n;
  };
  static Seen seen[64];
  static int n_seen = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> hold(lock);
  for (int j = 0; j < n_seen; ++j)
    if (seen[j].dev == dev && seen[j].cluster == cluster &&
        seen[j].smem == smem) {
      n = seen[j].n;
      return cudaSuccess;
    }
  cudaError_t rc = set_attributes(smem, cluster);
  if (rc == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(cluster, 1, smem, attr, 0);
    rc = cudaOccupancyMaxActiveClusters(&n, bin_image_cluster, &cfg);
  }
  if (rc != cudaSuccess) {
    // past the portable size a card may refuse the size: no cluster of
    // it, and no error left behind
    if (cluster <= PORTABLE_CLUSTER) return rc;
    cudaGetLastError();
    n = 0;
  }
  if (n_seen < 64) seen[n_seen++] = {dev, cluster, smem, n};
  return cudaSuccess;
}

// The plan of N unweighted rays onto an nx x ny image on card dev: the
// smallest cluster (1, 2, 4, ..., MAX_CLUSTER) whose slices, ceil(ny /
// cluster) rows of nx int32 counts, fit a block's shared memory and of
// which the card holds a cluster at once; one cluster for each
// RAYS_A_BLOCK rays of its blocks, at most as many as the card holds.
// None fits (or the card takes no cluster launch): the one-thread form,
// cluster 0.
cudaError_t plan_of(int dev, int nx, int ny, long long N, Plan& p) {
  p = Plan{0, 0, 0, 0, 0, 0};
  int optin = 0, clusters_ok = 0;
  cudaError_t rc = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&clusters_ok, cudaDevAttrClusterLaunch, dev);
  if (rc != cudaSuccess) return rc;
  if (!clusters_ok) return cudaSuccess;
  for (int lg = 0; (1 << lg) <= MAX_CLUSTER; ++lg) {
    const int cluster = 1 << lg;
    const int rows = (ny + cluster - 1) / cluster;
    const long long bytes = (long long)rows * nx * 4;
    if (bytes + SMEM_KEEP > optin) continue;
    int active = 0;
    rc = active_clusters(dev, cluster, (int)bytes, active);
    if (rc != cudaSuccess) return rc;
    if (active < 1) continue;
    const long long want = (N + (long long)RAYS_A_BLOCK * cluster - 1) /
                           ((long long)RAYS_A_BLOCK * cluster);
    p = Plan{cluster, lg, rows,
             (int)(want < 1 ? 1 : want < active ? want : active),
             (int)bytes, active};
    return cudaSuccess;
  }
  return cudaSuccess;
}

}  // namespace

// uf: (N, 8) f32 exit states, 16-byte aligned; weights: (N,) f32 or null;
// H: (ny, nx) f32, zeroed; ops: (n_ops, 17) f32 stage table in host
// memory, taken by value when dops is null (n_ops <= MAX_OPS); dops: the
// same table in device memory, or null; p_ray: (N,) f32 probing coordinate of
// each exit state, or null when every ray sits at p_end. Returns
// cudaGetLastError(), or cudaErrorInvalidValue.
extern "C" int detect_image(const float* uf, const float* weights, float* H,
                            long long N, int swap, float p_end, float depth,
                            const float* ops, const float* dops, int n_ops,
                            int nx, int ny, float xlo, float xhi, float xs,
                            float ylo, float yhi, float ys,
                            const float* p_ray, void* stream) {
  if (n_ops < 0 || (n_ops > MAX_OPS && !dops))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  Ops table;
  if (!dops)
    for (int j = 0; j < n_ops * OP_WIDTH; ++j) table.v[j] = ops[j];
  const unsigned blocks = (unsigned)((N + THREADS - 1) / THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (dops)
    detect_kernel<true><<<blocks, THREADS, 0, s>>>(
        uf, p_ray, weights, H, N, swap, p_end, depth, table, dops, n_ops, nx,
        ny, xlo, xhi, xs, ylo, yhi, ys);
  else
    detect_kernel<false><<<blocks, THREADS, 0, s>>>(
        uf, p_ray, weights, H, N, swap, p_end, depth, table, dops, n_ops, nx,
        ny, xlo, xhi, xs, ylo, yhi, ys);
  return (int)cudaGetLastError();
}

// The coherent form: H (npy, npx, n_ch) f32, zeroed; n_ch 2 (legacy) or 4
// (intensity); k = 2 pi / wavelength in f32; (xhalf, dx) = (Lx / 2, Lx /
// npx) in f32, likewise y; ref: add the reference beam fr (cr x + sr y).
// Other arguments as detect_image's.
extern "C" int detect_field(const float* uf, float* H, long long N, int swap,
                            float p_end, float depth, const float* ops,
                            const float* dops, int n_ops, float k, int npx,
                            int npy, float xhalf, float dx, float yhalf,
                            float dy, int n_ch, int ref, float fr, float cr,
                            float sr, const float* p_ray, void* stream) {
  if (n_ops < 0 || (n_ops > MAX_OPS && !dops) || (n_ch != 2 && n_ch != 4))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  Ops table;
  if (!dops)
    for (int j = 0; j < n_ops * OP_WIDTH; ++j) table.v[j] = ops[j];
  const unsigned blocks = (unsigned)((N + THREADS - 1) / THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (dops)
    field_kernel<true><<<blocks, THREADS, 0, s>>>(
        uf, p_ray, H, N, swap, p_end, depth, table, dops, n_ops, k, npx, npy,
        xhalf, dx, yhalf, dy, n_ch, ref, fr, cr, sr);
  else
    field_kernel<false><<<blocks, THREADS, 0, s>>>(
        uf, p_ray, H, N, swap, p_end, depth, table, dops, n_ops, k, npx, npy,
        xhalf, dx, yhalf, dy, n_ch, ref, fr, cr, sr);
  return (int)cudaGetLastError();
}

// Bare rays: x, y (N,) f32; w (N,) f32 or null; H (ny, nx) f32, zeroed;
// (lo, hi, bins per unit) of each axis as bin_params gives them. Unweighted
// rays take the plan's form (plan_of), weighted ones the one-thread form.
extern "C" int bin_image(const float* x, const float* y, const float* w,
                         float* H, long long N, int nx, int ny, float xlo,
                         float xhi, float xs, float ylo, float yhi, float ys,
                         void* stream) {
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  Plan p;
  if (!w) {
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess) rc = plan_of(dev, nx, ny, N, p);
    if (rc == cudaSuccess && p.cluster) rc = set_attributes(p.smem, p.cluster);
    if (rc != cudaSuccess) return (int)rc;
  }
  if (!w && p.cluster) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        cluster_config(p.cluster, p.clusters, p.smem, attr, s);
    return (int)cudaLaunchKernelEx(&cfg, bin_image_cluster, x, y, H, N, nx,
                                   ny, xlo, xhi, xs, ylo, yhi, ys, p.lg);
  }
  const unsigned blocks = (unsigned)((N + THREADS - 1) / THREADS);
  bin_image_kernel<<<blocks, THREADS, 0, s>>>(x, y, w, H, N, nx, ny, xlo, xhi,
                                              xs, ylo, yhi, ys);
  return (int)cudaGetLastError();
}

// Bare rays with their fields: x, y (N,) f32; Ex, Ey (N,) complex64 as
// (re, im) pairs; H (npy, npx, n_ch) f32, zeroed; (xhalf, dx) as for
// detect_field.
extern "C" int bin_field(const float* x, const float* y, const float* Ex,
                         const float* Ey, float* H, long long N, int npx,
                         int npy, float xhalf, float dx, float yhalf, float dy,
                         int n_ch, void* stream) {
  if (n_ch != 2 && n_ch != 4) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const unsigned blocks = (unsigned)((N + THREADS - 1) / THREADS);
  bin_field_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, y, reinterpret_cast<const float2*>(Ex),
      reinterpret_cast<const float2*>(Ey), H, N, npx, npy, xhalf, dx, yhalf,
      dy, n_ch);
  return (int)cudaGetLastError();
}

// The launch plan of an entry point's call on card dev: entry 0
// (bin_image; kind 0 unweighted, 1 weighted), 1 (bin_field; kind = n_ch,
// 2 or 4) or 2 (detect_field; kind = n_ch) for N rays onto an nx x ny
// image. plan[0..4]: the blocks a cluster (0: the one-thread form), the
// clusters, the rows a block holds, its shared bytes, the clusters the
// card holds at once. Returns 0, or the cudaError that stopped the plan
// (cudaErrorInvalidValue for an entry or kind the source does not take).
extern "C" int k3_plan(int dev, int entry, int kind, int nx, int ny,
                       long long N, long long* plan) {
  const bool ok = entry == BIN_IMAGE ? kind == 0 || kind == 1
                  : entry == BIN_FIELD || entry == DETECT_FIELD
                      ? kind == 2 || kind == 4
                      : false;
  if (!ok || nx < 1 || ny < 1 || N < 0) return (int)cudaErrorInvalidValue;
  Plan p = Plan{0, 0, 0, 0, 0, 0};
  if (entry == BIN_IMAGE && kind == 0) {
    const cudaError_t rc = plan_of(dev, nx, ny, N, p);
    if (rc != cudaSuccess) return (int)rc;
  }
  const long long out[5] = {p.cluster, p.clusters, p.rows, p.smem, p.active};
  for (int j = 0; j < 5; ++j) plan[j] = out[j];
  return 0;
}
