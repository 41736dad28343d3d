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
//   * int8 keeps one thread a value (one hash a value), consecutive threads
//     on consecutive values; the component of a value is its index mod 3.

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

template <bool DITHER>
__global__ void __launch_bounds__(THREADS)
    to_int8(int8_t* out, const float* in, long long n, const float* scale,
            uint2 key) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= n) return;
  const float rcp = __fdiv_rn(1.0f, scale[e % 3]);
  float q;
  if constexpr (DITHER)
    q = __fmaf_rn(in[e], rcp, threefry::uniform(key, (unsigned long long)e,
                                                -0.5f, 0.5f));
  else
    q = __fmul_rn(in[e], rcp);
  const float code = fminf(fmaxf(rintf(q), -127.0f), 127.0f);
  out[e] = (int8_t)(int)code;
}

}  // namespace

// out: the table's first element of plane i0; in: the (pb, ny, nz, 3)
// float32 batch; n = pb * ny * nz * 3; mode 1 bfloat16, 2 int8 (scale: (3,)
// float32 on the card; dither: on/off, key0/key1 the words of the folded
// key).
extern "C" int btable_write(void* out, int mode, const float* in,
                            long long n, const float* scale, int dither,
                            long long key0, long long key1, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
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
  } else if (dither) {
    to_int8<true><<<blocks, THREADS, 0, st>>>(
        reinterpret_cast<int8_t*>(out), in, n, scale, key);
  } else {
    to_int8<false><<<blocks, THREADS, 0, st>>>(
        reinterpret_cast<int8_t*>(out), in, n, scale, key);
  }
  return (int)cudaGetLastError();
}
