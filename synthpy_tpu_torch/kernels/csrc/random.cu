// K10: JAX's threefry random streams (jax.random.bits / uniform / normal).
//
// Replaces the threefry-2x32 draws of jax.random inside the JAX package's
// device programs: the GRF noise of synthpy_tpu/fields/grf.py (grf_fft
// :79-80, grf_domain_fft :151-152, _cos_modes :175-178,
// grf_vector_solenoidal :377-383) and the beam of tracer/beam.py :97-139.
// The stream itself lives in threefry.cuh, shared with K2's and K9's
// dither.
//
// What bounds it on the H100: operations. A draw is one threefry hash (20
// rounds of an add, a rotate and a xor, and the key schedule: ~110 integer
// operations) against 4 bytes written; a normal adds log1pf, a square root
// and a 9-term polynomial. The design: one thread per draw over a
// grid-stride loop, the counter the 64-bit flat index, consecutive threads
// on consecutive outputs (coalesced 4-byte stores). The key is a kernel
// argument in registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int THREADS = 256;

enum Mode { BITS = 0, UNIFORM = 1, NORMAL = 2 };

template <int MODE>
__global__ void __launch_bounds__(THREADS)
    draw(void* out, uint2 key, long long n, long long offset, float lo,
         float hi) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const unsigned long long c = (unsigned long long)(offset + i);
    if constexpr (MODE == BITS)
      reinterpret_cast<uint32_t*>(out)[i] = threefry::bits(key, c);
    else if constexpr (MODE == UNIFORM)
      reinterpret_cast<float*>(out)[i] = threefry::uniform(key, c, lo, hi);
    else
      reinterpret_cast<float*>(out)[i] = threefry::normal(key, c);
  }
}

}  // namespace

// mode: 0 bits (uint32), 1 uniform [lo, hi) and 2 normal (float32); n
// draws of flat index offset .. offset+n-1 under the key (k0, k1).
extern "C" int random_draw(void* out, int mode, long long k0, long long k1,
                           long long n, long long offset, float lo,
                           float hi, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return 0;
  const uint2 key = make_uint2((uint32_t)k0, (uint32_t)k1);
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  const unsigned g = (unsigned)blocks;
  if (mode == BITS)
    draw<BITS><<<g, THREADS, 0, st>>>(out, key, n, offset, lo, hi);
  else if (mode == UNIFORM)
    draw<UNIFORM><<<g, THREADS, 0, st>>>(out, key, n, offset, lo, hi);
  else
    draw<NORMAL><<<g, THREADS, 0, st>>>(out, key, n, offset, lo, hi);
  return (int)cudaGetLastError();
}
