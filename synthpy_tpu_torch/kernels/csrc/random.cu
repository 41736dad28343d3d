// K10: JAX's threefry random streams (jax.random.bits / uniform / normal).
//
// Replaces the threefry-2x32 draws of jax.random inside the JAX package's
// device programs: the GRF noise of synthpy_tpu/fields/grf.py (grf_fft
// :79-80, grf_domain_fft :151-152, _cos_modes :175-178,
// grf_vector_solenoidal :377-383) and the beam of tracer/beam.py :97-139.
// The stream itself lives in threefry.cuh, shared with K2's, K9's and K14's
// dither; what only K10 runs is in this file.
//
// What bounds it on the H100: integer operations. A draw is one threefry
// hash: 20 rounds of an add, a rotate and a xor, five key injections of two
// adds, and the two words' xor, against 4 bytes written. The rotates and
// xors (41 a draw, 43 with a uniform's shift and or) issue only on the 64
// INT32 lanes of an SM; the adds also issue as multiply-adds (IMAD) on the
// FMA pipe, where nvcc puts most of them. A normal adds log1pf, the square
// root and a 9-term polynomial on the float pipe. So the least time is the
// INT32 lanes' (43 operations a draw at 16.7 T/s), and the design is about
// issuing little else:
//
//   * Four consecutive flat indices a thread a trip, one 16-byte store;
//     a scalar head up to a row's first 16-byte boundary and a scalar tail,
//     so that any n and offset work. The key schedule once a thread.
//   * Where a launch's counters share one high word (offset and offset + n
//     - 1 agree above bit 31, as on every path today), the counter is 32
//     bits: the high word and the key fold into x0 once, and x1 is the low
//     word plus the key plus the index, one add a draw. A launch whose
//     counters cross 2^32 keeps the 64-bit form.
//   * The normal's erf_inv takes a warp-uniform branch: where every lane of
//     the warp has w < 5 (~90% of warps) the polynomial runs with its
//     literal coefficients; a warp with any w >= 5 takes the selecting form
//     of threefry.cuh. Both are the same operations in the same order, so
//     the bits are the selecting form's.
//   * One launch draws up to MAX_STREAMS streams of the same length: rows
//     of an (S, n) tensor, each with its key, mode and [lo, hi) (a beam's
//     phi, chi and positions), or two streams interleaved as (re, im) pairs
//     of one complex64 tensor (the GRF's noise: normal(kr) + 1j
//     normal(ki)), with no pass to interleave them.
// Every output is bit-equal to the one-draw-a-thread kernel this replaces.
// Built with --fmad=false and without fast math: log1pf and sqrtf are the
// accurate library functions, and each product is rounded before its add.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int THREADS = 256;
// the grid's blocks an SM: twice the 2048 threads an SM holds, so that
// the last wave's blocks are short (2-4% faster than one wave's worth)
constexpr int BLOCKS_PER_SM = 16;
constexpr int VEC = 4;            // draws a thread a trip: one 16-byte store
constexpr int MAX_STREAMS = 8;

enum Mode { BITS = 0, UNIFORM = 1, NORMAL = 2 };

// the streams of a launch, a kernel parameter
struct Streams {
  uint2 key[MAX_STREAMS];
  int mode[MAX_STREAMS];
  float lo[MAX_STREAMS], hi[MAX_STREAMS];
};

// a stream's key schedule with its counters' high word folded in: a draw
// of flat index c hashes (hi32(c) + k0, lo32(c) + k1)
struct Keyed {
  threefry::Schedule S;
  uint32_t x0, x1;  // hi32(offset) + k0, lo32(offset) + k1

  __device__ __forceinline__ Keyed(uint2 key, unsigned long long offset)
      : S(key),
        x0((uint32_t)(offset >> 32) + S.k0),
        x1((uint32_t)offset + S.k1) {}
};

// threefry::hash's 20 rounds and injections on words the key is added to
__device__ __forceinline__ uint32_t rounds(const threefry::Schedule& S,
                                           uint32_t x0, uint32_t x1) {
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = threefry::rotl(x1, rot[g & 1][r]);
      x1 ^= x0;
    }
    x0 += S.inj0[g];
    x1 += S.inj1[g];
  }
  return x0 ^ x1;
}

// the bits of index i of the launch (counter offset + i): 32-bit when the
// launch's counters share one high word, else 64-bit
template <bool WIDE>
__device__ __forceinline__ uint32_t bits_at(const Keyed& K,
                                            unsigned long long offset,
                                            unsigned long long i) {
  if constexpr (WIDE) {
    const unsigned long long c = offset + i;
    return rounds(K.S, (uint32_t)(c >> 32) + K.S.k0, (uint32_t)c + K.S.k1);
  } else {
    return rounds(K.S, K.x0, K.x1 + (uint32_t)i);
  }
}

// XLA's ErfInv for float32 (threefry::erf_inv), with a warp-uniform branch
// to the w < 5 polynomial's literal coefficients
__device__ __forceinline__ float erf_inv(float x) {
  const float w = -log1pf(-x * x);
  float p;
  if (__all_sync(__activemask(), w < 5.0f)) {
    const float v = w - 2.5f;
    p = 2.81022636e-08f;
    p = 3.43273939e-07f + p * v;
    p = -3.5233877e-06f + p * v;
    p = -4.39150654e-06f + p * v;
    p = 0.00021858087f + p * v;
    p = -0.00125372503f + p * v;
    p = -0.00417768164f + p * v;
    p = 0.246640727f + p * v;
    p = 1.50140941f + p * v;
  } else {
    const float lt5[9] = {2.81022636e-08f,  3.43273939e-07f,
                          -3.5233877e-06f,  -4.39150654e-06f,
                          0.00021858087f,   -0.00125372503f,
                          -0.00417768164f,  0.246640727f,
                          1.50140941f};
    const float ge5[9] = {-0.000200214257f, 0.000100950558f,
                          0.00134934322f,   -0.00367342844f,
                          0.00573950773f,   -0.0076224613f,
                          0.00943887047f,   1.00167406f,
                          2.83297682f};
    const bool lt = w < 5.0f;
    const float v = lt ? w - 2.5f : sqrtf(w) - 3.0f;
    p = lt ? lt5[0] : ge5[0];
#pragma unroll
    for (int i = 1; i < 9; ++i) p = (lt ? lt5[i] : ge5[i]) + p * v;
  }
  return fabsf(x) == 1.0f ? x * 3.402823466e38f : p * x;
}

// the output word of a draw's bits in each mode
template <int MODE>
__device__ __forceinline__ uint32_t value(uint32_t b, float lo, float hi) {
  if constexpr (MODE == BITS) {
    return b;
  } else if constexpr (MODE == UNIFORM) {
    return __float_as_uint(threefry::uniform_of(b, lo, hi));
  } else {
    // nextafter(-1, 0) in float32, and sqrt(2) rounded to float32
    return __float_as_uint(
        1.41421356f * erf_inv(threefry::uniform_of(b, -0.99999994f, 1.0f)));
  }
}

template <int MODE, bool WIDE>
__device__ __forceinline__ void draw_row(uint32_t* row, const Streams& P,
                                         int s, long long n,
                                         unsigned long long offset) {
  const Keyed K(P.key[s], offset);
  const float lo = P.lo[s], hi = P.hi[s];
  // the row's first 16-byte boundary (the tensor's is one)
  const long long head =
      min((long long)((VEC - ((uintptr_t)row >> 2)) & (VEC - 1)), n);
  const long long quads = (n - head) / VEC;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  if (t < head) row[t] = value<MODE>(bits_at<WIDE>(K, offset, t), lo, hi);
  const long long i_tail = head + quads * VEC + t;
  if (i_tail < n)
    row[i_tail] = value<MODE>(bits_at<WIDE>(K, offset, i_tail), lo, hi);
  for (long long q = t; q < quads; q += stride) {
    const long long i = head + q * VEC;
    uint32_t v[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      v[k] = value<MODE>(bits_at<WIDE>(K, offset, i + k), lo, hi);
    *reinterpret_cast<uint4*>(row + i) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// rows: stream s = blockIdx.y fills row s of an (S, n) tensor
template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
    draw_rows(uint32_t* out, Streams P, long long n,
              unsigned long long offset) {
  const int s = blockIdx.y;
  uint32_t* row = out + (long long)s * n;
  if (P.mode[s] == BITS)
    draw_row<BITS, WIDE>(row, P, s, n, offset);
  else if (P.mode[s] == UNIFORM)
    draw_row<UNIFORM, WIDE>(row, P, s, n, offset);
  else
    draw_row<NORMAL, WIDE>(row, P, s, n, offset);
}

// pairs: the normals of streams 0 and 1 interleaved, (s0[i], s1[i]) at
// element i (a complex64 tensor)
template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
    draw_pair(uint2* out, Streams P, long long n,
              unsigned long long offset) {
  const Keyed A(P.key[0], offset), B(P.key[1], offset);
  const long long quads = n / VEC;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long i_tail = quads * VEC + t;
  if (i_tail < n)
    out[i_tail] = make_uint2(
        value<NORMAL>(bits_at<WIDE>(A, offset, i_tail), 0.0f, 0.0f),
        value<NORMAL>(bits_at<WIDE>(B, offset, i_tail), 0.0f, 0.0f));
  for (long long q = t; q < quads; q += stride) {
    const long long i = q * VEC;
    uint32_t a[VEC], b[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      a[k] = value<NORMAL>(bits_at<WIDE>(A, offset, i + k), 0.0f, 0.0f);
      b[k] = value<NORMAL>(bits_at<WIDE>(B, offset, i + k), 0.0f, 0.0f);
    }
    uint4* o = reinterpret_cast<uint4*>(out + i);
    o[0] = make_uint4(a[0], b[0], a[1], b[1]);
    o[1] = make_uint4(a[2], b[2], a[3], b[3]);
  }
}

}  // namespace

// S streams of n draws each, flat indices offset .. offset + n - 1 of
// stream s under the key (keys[2 s], keys[2 s + 1]). pair 0: stream s, in
// mode modes[s] (0 bits (uint32), 1 uniform on [lo[s], hi[s]), 2 normal
// (float32)), is row s of out, an (S, n) tensor; pair 1: the normals of
// S = 2 streams interleaved, element i of out (n pairs) is (stream 0's,
// stream 1's), and modes, lo and hi are not read. out is 16-byte aligned;
// keys, modes, lo and hi are host arrays. Returns cudaGetLastError(), or
// cudaErrorInvalidValue.
extern "C" int random_draw(void* out, int S, const uint32_t* keys,
                           const int* modes, const float* lo,
                           const float* hi, long long n, long long offset,
                           int pair, void* stream) {
  if (S < 1 || S > MAX_STREAMS || n < 0 || offset < 0 ||
      ((uintptr_t)out & 15) || (pair && S != 2))
    return (int)cudaErrorInvalidValue;
  Streams P = {};
  for (int s = 0; s < S; ++s) {
    P.key[s] = make_uint2(keys[2 * s], keys[2 * s + 1]);
    if (pair) continue;
    if (modes[s] < BITS || modes[s] > NORMAL)
      return (int)cudaErrorInvalidValue;
    P.mode[s] = modes[s];
    P.lo[s] = lo[s];
    P.hi[s] = hi[s];
  }
  if (n == 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int rows = pair ? 1 : S;
  // quads a row, and one more for a head or tail
  const long long work = n / VEC + 1;
  long long blocks = (work + THREADS - 1) / THREADS;
  const long long cap = (long long)(sms > 0 ? sms : 132) * BLOCKS_PER_SM;
  if (blocks > cap / rows) blocks = cap / rows > 0 ? cap / rows : 1;
  const dim3 grid((unsigned)blocks, rows);
  const unsigned long long off = (unsigned long long)offset;
  const bool wide =
      (off >> 32) != ((off + (unsigned long long)n - 1) >> 32);
  cudaStream_t st = (cudaStream_t)stream;
  if (pair) {
    uint2* o = reinterpret_cast<uint2*>(out);
    if (wide)
      draw_pair<true><<<grid, THREADS, 0, st>>>(o, P, n, off);
    else
      draw_pair<false><<<grid, THREADS, 0, st>>>(o, P, n, off);
  } else {
    uint32_t* o = reinterpret_cast<uint32_t*>(out);
    if (wide)
      draw_rows<true><<<grid, THREADS, 0, st>>>(o, P, n, off);
    else
      draw_rows<false><<<grid, THREADS, 0, st>>>(o, P, n, off);
  }
  return (int)cudaGetLastError();
}
