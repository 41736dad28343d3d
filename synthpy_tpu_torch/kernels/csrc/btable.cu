// K14: the plane-batch write of a reduced-precision B table.
//
// Replaces synthpy_tpu/tracer/particles.py:134-145 build_B_table.write: one
// float32 batch of pb planes, (pb, ny, nz, 3) row-major, goes into the
// table at plane i0 in place. bfloat16: the round-to-nearest-even cast.
// int8: q = batch / scale[c] plus the dither uniform(fold_in(PRNGKey(
// dither), i0), q.shape, -0.5, 0.5) when asked, then round half to even,
// clip to +-127 and convert. As XLA's CPU compiler builds JAX's jitted
// write (found by planting values at code boundaries): the division by
// the constant scale is a product with its float32 reciprocal, and with
// the dither the product and the add are one fused multiply-add. The
// dither is JAX's threefry stream over the batch's row-major counters
// (threefry.cuh, shared with K2, K9 and K10); the caller folds the plane
// into the key on the host, so the codes are the plain version's draws
// from synthpy_tpu_torch.random bit for bit.
//
// What bounds it on the H100: bfloat16, bytes (4 read and 2 written a
// value); int8 with the dither, by the count, the threefry hash (74
// integer operations a value, 43 of them rotates, xors and shifts that
// no multiply-add can take: chip_smoke.py K14_DITHER_INT_OPS and
// K14_DITHER_ALU_OPS), else bytes.
//   * bfloat16 is a streaming cast in groups of 8 values: a thread makes
//     a group's two 16-byte loads (__ldg), converts them by
//     __floats2bfloat162_rn pairs and writes one 16-byte store, a block for
//     every THREADS groups (variant runs on an H100 80GB HBM3 at 700 W,
//     PERF.md §6: ~5% faster than a few blocks an SM striding over the
//     batch two groups a thread at a time, ~2% faster than with the
//     read-once / streaming hints __ldcs and __stcs). The table's plane
//     i0 starts 16-byte aligned only when ny*nz*3*2 is a multiple of 16,
//     so the values up to the table's next 16-byte boundary (the head)
//     and after the last whole group (the tail) take scalar accesses in
//     the same launch; where the batch is not 16-byte aligned at the
//     head's end, a group's loads are scalar too.
//   * int8 in groups of GROUP = 12 values a thread (three 16-byte loads,
//     three 4-byte stores), persistent blocks striding over the groups.
//     The component of a group's value k is (head + k) mod 3 in every
//     group, so a thread turns the three scales into reciprocals (IEEE
//     divisions, the codes' bits unchanged) once, in that order, and makes
//     the key's schedule once (threefry::Schedule). The counter's high
//     word is 0 (a batch holds fewer than 2^32 values; the entry point
//     refuses more), so each value's hash starts from its 32-bit index.
//     The table's plane i0 may start at any byte: the values up to its
//     next 4-byte boundary (the head) and after the last whole group (the
//     tail) go one by one in the same launch; where the batch is not
//     16-byte aligned at the head's end, a group's loads are scalar.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int THREADS = 256;

// the 8 values of group g: two float4 loads, or eight float loads
template <bool VEC>
__device__ __forceinline__ void load8(const float* in, long long g,
                                      float4& a, float4& b) {
  if constexpr (VEC) {
    const float4* p = reinterpret_cast<const float4*>(in) + 2 * g;
    a = __ldg(p);
    b = __ldg(p + 1);
  } else {
    const float* p = in + 8 * g;
    a = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
    b = make_float4(__ldg(p + 4), __ldg(p + 5), __ldg(p + 6),
                    __ldg(p + 7));
  }
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store8(uint4* out, long long g,
                                       const float4& a, const float4& b) {
  const uint4 v = make_uint4(bf16x2(a.x, a.y), bf16x2(a.z, a.w),
                             bf16x2(b.x, b.y), bf16x2(b.z, b.w));
  out[g] = v;
}

// out + head is 16-byte aligned; values [head, head + 8 * groups) go in
// groups of 8, the rest one by one
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    to_bf16(__nv_bfloat16* out, const float* in, long long n, int head,
            long long groups) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nt = (long long)gridDim.x * THREADS;
  const long long rest = head + 8 * groups;
  if (t < head) out[t] = __float2bfloat16_rn(in[t]);
  if (rest + t < n) out[rest + t] = __float2bfloat16_rn(in[rest + t]);
  const float* src = in + head;
  uint4* dst = reinterpret_cast<uint4*>(out + head);
  for (long long g = t; g < groups; g += nt) {
    float4 a, b;
    load8<VEC>(src, g, a, b);
    store8(dst, g, a, b);
  }
}

constexpr int GROUP = 12;

__device__ __forceinline__ float pick3(uint32_t c, float r0, float r1,
                                       float r2) {
  return c == 0 ? r0 : (c == 1 ? r1 : r2);
}

// the code of value e (x its float32 value, rcp its component's
// reciprocal): x rcp, plus the dither's uniform in a fused multiply-add,
// rounded half to even, clipped, converted
template <bool DITHER>
__device__ __forceinline__ uint32_t code(float x, float rcp,
                                         const threefry::Schedule& S,
                                         uint32_t e) {
  float q;
  if constexpr (DITHER) {
    const uint2 y = threefry::hash(S, 0u, e);
    q = __fmaf_rn(x, rcp, threefry::uniform_of(y.x ^ y.y, -0.5f, 0.5f));
  } else {
    q = __fmul_rn(x, rcp);
  }
  const float c = fminf(fmaxf(rintf(q), -127.0f), 127.0f);
  return (uint32_t)(int)c;
}

// four codes' low bytes as one word, the first lowest
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x3340), __byte_perm(c, d, 0x3340),
                     0x5410);
}

// out + head is 4-byte aligned (and in + head 16-byte aligned when VEC);
// values [head, head + GROUP * groups) go in groups, the rest one by one
template <bool DITHER, bool VEC>
__global__ void __launch_bounds__(THREADS)
    to_int8(int8_t* out, const float* in, uint32_t n, uint32_t head,
            uint32_t groups, const float* scale, uint2 key) {
  const threefry::Schedule S(key);
  const float s0 = __fdiv_rn(1.0f, scale[0]), s1 = __fdiv_rn(1.0f, scale[1]),
              s2 = __fdiv_rn(1.0f, scale[2]);
  // a group's value k is of component (head + k) mod 3
  const uint32_t h = head % 3;
  const float r0 = pick3(h, s0, s1, s2), r1 = pick3((h + 1) % 3, s0, s1, s2),
              r2 = pick3((h + 2) % 3, s0, s1, s2);
  const uint32_t t = blockIdx.x * THREADS + threadIdx.x;
  const uint32_t nt = gridDim.x * THREADS;
  const uint32_t rest = head + GROUP * groups;
  if (t < head)
    out[t] = (int8_t)code<DITHER>(in[t], pick3(t % 3, s0, s1, s2), S, t);
  if (t < n - rest) {
    const uint32_t e = rest + t;
    out[e] = (int8_t)code<DITHER>(in[e], pick3(e % 3, s0, s1, s2), S, e);
  }
  for (uint32_t g = t; g < groups; g += nt) {
    const uint32_t e0 = head + GROUP * g;
    float v[GROUP];
    if constexpr (VEC) {
      const float4* src = reinterpret_cast<const float4*>(in + e0);
#pragma unroll
      for (int m = 0; m < GROUP / 4; ++m) {
        const float4 f = __ldg(src + m);
        v[4 * m] = f.x; v[4 * m + 1] = f.y;
        v[4 * m + 2] = f.z; v[4 * m + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < GROUP; ++k) v[k] = __ldg(in + e0 + k);
    }
    uint32_t c[GROUP];
#pragma unroll
    for (int k = 0; k < GROUP; ++k)
      c[k] = code<DITHER>(v[k], k % 3 == 0 ? r0 : (k % 3 == 1 ? r1 : r2), S,
                          e0 + k);
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + e0);
#pragma unroll
    for (int m = 0; m < GROUP / 4; ++m)
      dst[m] = pack4(c[4 * m], c[4 * m + 1], c[4 * m + 2], c[4 * m + 3]);
  }
}

template <bool DITHER, bool VEC>
int launch_int8(int8_t* out, const float* in, uint32_t n, uint32_t head,
                uint32_t groups, const float* scale, uint2 key,
                cudaStream_t st) {
  auto kernel = to_int8<DITHER, VEC>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       THREADS, 0);
  if (rc != cudaSuccess) return (int)rc;
  const long long need = ((long long)groups + THREADS - 1) / THREADS;
  const long long most = (long long)(per_sm < 1 ? 1 : per_sm) * sms;
  const unsigned grid =
      (unsigned)(need < 1 ? 1 : (need < most ? need : most));
  kernel<<<grid, THREADS, 0, st>>>(out, in, n, head, groups, scale, key);
  return (int)cudaGetLastError();
}

}  // namespace

// out: the table's first element of plane i0; in: the (pb, ny, nz, 3)
// float32 batch; n = pb * ny * nz * 3; mode 1 bfloat16, 2 int8 (scale: (3,)
// float32 on the card; dither: on/off, key0/key1 the words of the folded
// key; fewer than 2^32 values).
extern "C" int btable_write(void* out, int mode, const float* in,
                            long long n, const float* scale, int dither,
                            long long key0, long long key1, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const uint2 key = make_uint2((uint32_t)key0, (uint32_t)key1);
  if (mode == 1) {
    // values up to the table's next 16-byte boundary, then whole groups
    const uintptr_t o = (uintptr_t)out, i = (uintptr_t)in;
    long long head = (long long)((16 - o % 16) % 16) / 2;
    if (head > n) head = n;
    const long long groups = (n - head) / 8;
    const long long need = (groups + THREADS - 1) / THREADS;
    const unsigned grid = (unsigned)(need < 1 ? 1 : need);
    __nv_bfloat16* tab = reinterpret_cast<__nv_bfloat16*>(out);
    if ((i + 4 * head) % 16 == 0)
      to_bf16<true><<<grid, THREADS, 0, st>>>(tab, in, n, (int)head, groups);
    else
      to_bf16<false><<<grid, THREADS, 0, st>>>(tab, in, n, (int)head, groups);
  } else {
    // n < 2^32: the hash's counter is the value's 32-bit index
    if (n >= (1LL << 32)) return (int)cudaErrorInvalidValue;
    int8_t* tab = reinterpret_cast<int8_t*>(out);
    const uintptr_t o = (uintptr_t)out, i = (uintptr_t)in;
    long long head = (long long)((4 - o % 4) % 4);
    if (head > n) head = n;
    const uint32_t groups = (uint32_t)((n - head) / GROUP);
    const bool vec = (i + 4 * head) % 16 == 0;
    const uint32_t un = (uint32_t)n, uh = (uint32_t)head;
    if (dither)
      return vec ? launch_int8<true, true>(tab, in, un, uh, groups, scale,
                                           key, st)
                 : launch_int8<true, false>(tab, in, un, uh, groups, scale,
                                            key, st);
    return vec ? launch_int8<false, true>(tab, in, un, uh, groups, scale, key,
                                          st)
               : launch_int8<false, false>(tab, in, un, uh, groups, scale,
                                           key, st);
  }
  return (int)cudaGetLastError();
}
