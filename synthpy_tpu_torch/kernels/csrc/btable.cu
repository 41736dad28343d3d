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
// What bounds it on the H100: bytes (4 read and 1-2 written a value). The
// design: one thread a value, consecutive threads on consecutive values, so
// both the batch reads and the table writes coalesce; the component of a
// value is its index mod 3.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    to_bf16(__nv_bfloat16* out, const float* in, long long n) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e < n) out[e] = __float2bfloat16_rn(in[e]);
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
  if (mode == 1)
    to_bf16<<<blocks, THREADS, 0, st>>>(
        reinterpret_cast<__nv_bfloat16*>(out), in, n);
  else if (dither)
    to_int8<true><<<blocks, THREADS, 0, st>>>(
        reinterpret_cast<int8_t*>(out), in, n, scale, key);
  else
    to_int8<false><<<blocks, THREADS, 0, st>>>(
        reinterpret_cast<int8_t*>(out), in, n, scale, key);
  return (int)cudaGetLastError();
}
