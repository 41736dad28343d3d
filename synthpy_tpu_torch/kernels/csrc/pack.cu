// K2: segment-pack builder, quantiser and decimator.
//
// Replaces the JAX device programs of synthpy_tpu/tracer/zscan.py:
//   * build_segment_pack_device's seg_fn (zscan.py:1812): per K-slab segment,
//     the transverse gradients pref*jnp.gradient(ne), the probe-axis central
//     difference with the first-plane x2 and last-plane 2*G + pref*ne/dp rules
//     (zscan.py:1825-1838), the kappa, omega(n-1) and Verdet*ne*B channels,
//     zeroed pad planes, stored as [seg, cell, k*C + c];
//   * quantize_segment_pack.quant (zscan.py:493): per-(segment, plane,
//     channel) amax over cells, scale = amax/qmax, round half to even, int8
//     codes or int4 nibble pairs (plane 2j low, 2j+1 high);
//   * decimate_segment_pack.dec (zscan.py:576, :597): keep every stride-th
//     plane, repacking nibble pairs.
//
// What bounds it on the H100: bytes. Each output value costs a few flops
// against 1-4 bytes written and ~4 bytes of ne read (the stencil's other
// reads hit L1/L2), far below the card's ~20 flop/byte f32 balance point.
// The design therefore makes every access coalesced: one thread per
// (segment, cell, plane block) with the plane index fastest, so a warp writes
// one contiguous run of a table row and, for z-probing (ne[x, y, z] with z
// contiguous), reads consecutive ne values. No probe-major copy of the volume
// is made (the JAX program's moveaxis + pad); pad planes are decided by index.
// The quantised tiers reuse the float build: a quantised pack is the
// quantisation of the f32 pack (as in the JAX package, whose fused quantiser
// computes the same f32 values), done in two passes: a per-(segment, plane,
// channel) amax by one atomicMax per thread over a chunk of cells, then the
// codes. IEEE division (__fdiv_rn) and rintf keep the codes those of
// jnp.round(v / scale). This file is built with --fmad=false so that no
// multiply-add is contracted and the plain PyTorch version can match it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float OMEGA_PE_COEFF = 5.64e4f;
constexpr float V_THE_COEFF = 4.19e5f;
constexpr float L_QUANTUM_COEFF = 2.760428269727312e-10f;
constexpr float KAPPA_COEFF = 3.1e-5f;
constexpr float E_CHARGE = 1.602176634e-19f;
constexpr float C_LIGHT = 2.99792458e8f;

constexpr int THREADS = 256;
constexpr int AMAX_CHUNK = 64;

struct Vol {
  const float* p;
  long long sp, sa, sb;
  __device__ __forceinline__ float at(int g, int a, int b) const {
    return p[g * sp + a * sa + b * sb];
  }
};

struct Field {
  Vol ne, te, z, ba, bb, bp;
  int n_seg, K, n_p, na, nb, cells;
  float pref, da, db, two_dp, dp, omega, n_coef, verdet;
};

template <int IB, int PS, int BON>
struct Layout {
  static constexpr int C = 3 + IB + PS + 3 * BON;
  static constexpr int KI = 3;
  static constexpr int PI = 3 + IB;
  static constexpr int FI = 3 + IB + PS;
  static constexpr bool inv_brems = IB, phaseshift = PS, B_on = BON;
};

// synthpy_tpu/constants.py kappa/coulomb_log in the same operation order
__device__ float kappa_of(float ne, float Te, float Z, float omega) {
  const float ne_cc = ne * 1e-6f;
  const float o_max = fmaxf(OMEGA_PE_COEFF * sqrtf(ne_cc), omega);
  const float L_classical = Z * E_CHARGE / Te;
  const float L_quantum = L_QUANTUM_COEFF / sqrtf(Te);
  const float L_max = fmaxf(L_classical, L_quantum);
  const float CL = fmaxf(2.0f, logf(V_THE_COEFF * sqrtf(Te) / (o_max * L_max)));
  const float r = ne_cc / omega;
  return KAPPA_COEFF * Z * C_LIGHT * (r * r) * CL * powf(Te, -1.5f);
}

// jnp.gradient along one transverse axis at index i of n, spacing h, from
// the values at the clamped neighbours i-1 and i+1
__device__ __forceinline__ float grad1(float lo, float hi, int i, int n,
                                       float h) {
  return (i == 0 || i == n - 1) ? (hi - lo) / h : (hi - lo) * 0.5f / h;
}

// Channel values of absolute plane g (segment s, plane k: g = s*K + k) at
// transverse cell (a, b); exactly zero on the pad planes g > n_p - 1.
template <class LY>
__device__ void channel_values(const Field& F, int g, int a, int b,
                               float v[LY::C]) {
  if (g > F.n_p - 1) {
#pragma unroll
    for (int c = 0; c < LY::C; ++c) v[c] = 0.0f;
    return;
  }
  const float body = F.ne.at(g, a, b);
  // one-sided at the edges, central inside (jnp.gradient)
  const int a0 = a == 0 ? 0 : a - 1, a1 = a == F.na - 1 ? a : a + 1;
  const int b0 = b == 0 ? 0 : b - 1, b1 = b == F.nb - 1 ? b : b + 1;
  v[0] = F.pref * grad1(F.ne.at(g, a0, b), F.ne.at(g, a1, b), a, F.na, F.da);
  v[1] = F.pref * grad1(F.ne.at(g, a, b0), F.ne.at(g, a, b1), b, F.nb, F.db);
  // padded volume: a duplicate of plane 0 in front, zeros behind
  const float up = g + 1 <= F.n_p - 1 ? F.ne.at(g + 1, a, b) : 0.0f;
  const float dn = F.ne.at(g >= 1 ? g - 1 : 0, a, b);
  float gp = F.pref * (up - dn) / F.two_dp;
  if (g == 0) gp = 2.0f * gp;
  if (g == F.n_p - 1) gp = 2.0f * gp + F.pref * body / F.dp;
  v[2] = gp;
  if constexpr (LY::inv_brems)
    v[LY::KI] = kappa_of(body, F.te.at(g, a, b), F.z.at(g, a, b), F.omega);
  if constexpr (LY::phaseshift) {
    const float arg = 1.0f - F.n_coef * body;
    v[LY::PI] = F.omega * ((arg > 0.0f ? sqrtf(arg) : 0.0f) - 1.0f);
  }
  if constexpr (LY::B_on) {
    v[LY::FI + 0] = F.verdet * body * F.ba.at(g, a, b);
    v[LY::FI + 1] = F.verdet * body * F.bb.at(g, a, b);
    v[LY::FI + 2] = F.verdet * body * F.bp.at(g, a, b);
  }
}

__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

// One thread per (segment, cell, plane k), k fastest: thread t writes the C
// values at flat offset t*C of the (n_seg, cells, (K+1)*C) table.
template <class LY, typename OUT>
__global__ void build_kernel(Field F, OUT* out) {
  constexpr int C = LY::C;
  const long long nblk = F.K + 1;
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= (long long)F.n_seg * F.cells * nblk) return;
  const int k = (int)(t % nblk);
  const long long rest = t / nblk;
  const int cell = (int)(rest % F.cells);
  const int s = (int)(rest / F.cells);
  float v[C];
  channel_values<LY>(F, s * F.K + k, cell / F.nb, cell % F.nb, v);
  OUT* o = out + t * C;
#pragma unroll
  for (int c = 0; c < C; ++c) store(o + c, v[c]);
}

template <class LY>
int build_layout(const Field& F, void* out, int out_bf16, cudaStream_t st) {
  const long long total = (long long)F.n_seg * F.cells * (F.K + 1);
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  if (out_bf16)
    build_kernel<LY, __nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        F, (__nv_bfloat16*)out);
  else
    build_kernel<LY, float><<<blocks, THREADS, 0, st>>>(F, (float*)out);
  return 0;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// amax over cells of every (segment, column = k*C + c): a thread folds a
// chunk of cells, then one atomicMax on the float's bits (|v| >= 0 orders as
// an unsigned integer). Columns are fastest, so reads are coalesced.
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

// amax * f32(1/qmax), as the JAX package's compiled amax / qmax computes it
// (XLA turns a division by a constant into a multiplication by its
// correctly rounded reciprocal)
__device__ __forceinline__ float scale_of(unsigned amax_bits, float qmax) {
  const float am = __uint_as_float(amax_bits);
  return am > 0.0f ? __fmul_rn(am, __frcp_rn(qmax)) : 1.0f;
}

__device__ __forceinline__ int code_of(float v, float scale, float qmax) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -qmax), qmax);
}

__device__ __forceinline__ uint8_t nibble_pair(int lo, int hi) {
  return (uint8_t)((lo & 15) | ((hi & 15) << 4));
}

// Codes: one thread per (segment, cell, output column), columns fastest.
// int8: column k*C + c. int4: column j*C + c holds planes 2j (low nibble)
// and 2j + 1 (high nibble; zero past plane K). Cell-0 threads write scales.
template <typename IN>
__global__ void quant_kernel(const IN* tab, const unsigned* amax,
                             uint8_t* codes, float* scales, int n_seg,
                             int cells, int K, int C, int bits) {
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
    codes[t] = (uint8_t)(int8_t)code_of(to_float(in[ocol]), scale, qmax);
    if (cell == 0) sc[ocol] = scale;
    return;
  }
  const int j = ocol / C, c = ocol % C;
  const int col0 = 2 * j * C + c, col1 = (2 * j + 1) * C + c;
  const float s0 = scale_of(am[col0], qmax);
  const int lo = code_of(to_float(in[col0]), s0, qmax);
  int hi = 0;
  float s1 = 1.0f;
  if (2 * j + 1 <= K) {
    s1 = scale_of(am[col1], qmax);
    hi = code_of(to_float(in[col1]), s1, qmax);
  }
  codes[t] = nibble_pair(lo, hi);
  if (cell == 0) {
    sc[col0] = s0;
    if (2 * j + 1 <= K) sc[col1] = s1;
  }
}

template <typename T>
__global__ void decimate_kernel(const T* in, T* out, int n_seg, int cells,
                                int K, int C, int stride) {
  const int Kd = K / stride;
  const int ncol_in = (K + 1) * C, ncol_out = (Kd + 1) * C;
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= (long long)n_seg * cells * ncol_out) return;
  const int ocol = (int)(t % ncol_out);
  const long long row = t / ncol_out;
  const int kd = ocol / C, c = ocol % C;
  out[t] = in[row * ncol_in + (long long)kd * stride * C + c];
}

// sign-extended code of full-pack plane p, channel c, from a nibble row
__device__ __forceinline__ int nibble_code(const uint8_t* row, int p, int C,
                                           int c) {
  const unsigned w = row[(p >> 1) * C + c];
  const unsigned n = (p & 1) ? (w >> 4) & 15u : w & 15u;
  return (int)(n ^ 8u) - 8;
}

__global__ void decimate_nibble_kernel(const uint8_t* in, uint8_t* out,
                                       int n_seg, int cells, int K, int C,
                                       int stride) {
  const int Kd = K / stride;
  const int ncol_in = (K / 2 + 1) * C, ncol_out = (Kd / 2 + 1) * C;
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= (long long)n_seg * cells * ncol_out) return;
  const int ocol = (int)(t % ncol_out);
  const long long row = t / ncol_out;
  const int j = ocol / C, c = ocol % C;
  const uint8_t* r = in + row * ncol_in;
  const int lo = nibble_code(r, 2 * j * stride, C, c);
  const int hi = 2 * j + 1 <= Kd ? nibble_code(r, (2 * j + 1) * stride, C, c) : 0;
  out[t] = nibble_pair(lo, hi);
}

unsigned blocks_for(long long total) {
  return (unsigned)((total + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" int pack_build(void* out, int out_bf16, const float* ne,
                          const float* te, const float* z, const float* B,
                          long long sp, long long sa, long long sb,
                          int comp_a, int comp_b, int comp_p, int n_seg,
                          int K, int n_p, int na, int nb, float pref,
                          float da, float db, float two_dp, float dp,
                          float omega, float n_coef, float verdet,
                          int inv_brems, int phaseshift, int B_on,
                          void* stream) {
  Field F;
  F.ne = {ne, sp, sa, sb};
  F.te = {te, sp, sa, sb};
  F.z = {z, sp, sa, sb};
  F.ba = {B ? B + comp_a : nullptr, 3 * sp, 3 * sa, 3 * sb};
  F.bb = {B ? B + comp_b : nullptr, 3 * sp, 3 * sa, 3 * sb};
  F.bp = {B ? B + comp_p : nullptr, 3 * sp, 3 * sa, 3 * sb};
  F.n_seg = n_seg; F.K = K; F.n_p = n_p; F.na = na; F.nb = nb;
  F.cells = na * nb;
  F.pref = pref; F.da = da; F.db = db; F.two_dp = two_dp; F.dp = dp;
  F.omega = omega; F.n_coef = n_coef; F.verdet = verdet;
  cudaStream_t st = (cudaStream_t)stream;
  switch (inv_brems | (phaseshift << 1) | (B_on << 2)) {
    case 0: build_layout<Layout<0, 0, 0>>(F, out, out_bf16, st); break;
    case 1: build_layout<Layout<1, 0, 0>>(F, out, out_bf16, st); break;
    case 2: build_layout<Layout<0, 1, 0>>(F, out, out_bf16, st); break;
    case 3: build_layout<Layout<1, 1, 0>>(F, out, out_bf16, st); break;
    case 4: build_layout<Layout<0, 0, 1>>(F, out, out_bf16, st); break;
    case 5: build_layout<Layout<1, 0, 1>>(F, out, out_bf16, st); break;
    case 6: build_layout<Layout<0, 1, 1>>(F, out, out_bf16, st); break;
    default: build_layout<Layout<1, 1, 1>>(F, out, out_bf16, st); break;
  }
  return (int)cudaGetLastError();
}

// amax must be zeroed by the caller: (n_seg, K+1, C) unsigned.
extern "C" int pack_quantize(const void* table, int in_bf16, void* codes,
                             float* scales, unsigned* amax, int n_seg,
                             int cells, int K, int C, int bits,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int ncol = (K + 1) * C;
  const long long n_amax = (long long)n_seg * ((cells + AMAX_CHUNK - 1) / AMAX_CHUNK) * ncol;
  const long long n_out = (long long)n_seg * cells * (bits == 4 ? K / 2 + 1 : K + 1) * C;
  if (in_bf16) {
    const __nv_bfloat16* t = (const __nv_bfloat16*)table;
    amax_kernel<<<blocks_for(n_amax), THREADS, 0, st>>>(t, amax, n_seg, cells, ncol);
    quant_kernel<<<blocks_for(n_out), THREADS, 0, st>>>(
        t, amax, (uint8_t*)codes, scales, n_seg, cells, K, C, bits);
  } else {
    const float* t = (const float*)table;
    amax_kernel<<<blocks_for(n_amax), THREADS, 0, st>>>(t, amax, n_seg, cells, ncol);
    quant_kernel<<<blocks_for(n_out), THREADS, 0, st>>>(
        t, amax, (uint8_t*)codes, scales, n_seg, cells, K, C, bits);
  }
  return (int)cudaGetLastError();
}

extern "C" int pack_decimate(const void* in, void* out, int elem_bytes,
                             int nibbles, int n_seg, int cells, int K, int C,
                             int stride, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int Kd = K / stride;
  const long long n_out = (long long)n_seg * cells * (nibbles ? Kd / 2 + 1 : Kd + 1) * C;
  const unsigned b = blocks_for(n_out);
  if (nibbles)
    decimate_nibble_kernel<<<b, THREADS, 0, st>>>(
        (const uint8_t*)in, (uint8_t*)out, n_seg, cells, K, C, stride);
  else if (elem_bytes == 4)
    decimate_kernel<<<b, THREADS, 0, st>>>(
        (const float*)in, (float*)out, n_seg, cells, K, C, stride);
  else if (elem_bytes == 2)
    decimate_kernel<<<b, THREADS, 0, st>>>(
        (const uint16_t*)in, (uint16_t*)out, n_seg, cells, K, C, stride);
  else
    decimate_kernel<<<b, THREADS, 0, st>>>(
        (const uint8_t*)in, (uint8_t*)out, n_seg, cells, K, C, stride);
  return (int)cudaGetLastError();
}
