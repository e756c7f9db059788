// sha_probe.cu -- probes of the SHA-256 kernels' arithmetic on the card,
// for the poh and sha256 phases of chip_smoke.py; no kernel of the port's
// paths calls them.  One warp each, timed by clock64 in every thread.
//
//  * fdt_probe_sha_op_launch(kind, in, out, cycles, n, stream):
//      kind 0..4, latency: one chain of n dependent instructions of one
//        kind (0 SHF.R.W, 1 LOP3, 2 IADD3, 3 IMAD) or, kind 4, n steps of
//        the round's critical path SHF.R.W -> LOP3 -> IADD3;
//      kind 5..9, issue: 8 independent chains of n instructions each
//        (5 SHF.R.W, 6 LOP3, 7 IADD3, 8 IMAD, 9 four IADD3 and four IMAD
//        chains): the cycles of one instruction of a lone warp.
//    The caller reads the SASS (cuobjdump) to confirm each loop holds the
//    instructions it names.
//  * fdt_probe_poh_launch(which, state, out, cycles, n, stream): 32 lanes
//    run n PoH appends s = SHA-256(s) each on their 8 state words, each
//    variant its own kernel (its own register allocation): 0 the
//    compression csrc/sha256.cu had before its redesign (a copy kept here,
//    `old_`), 1 sha256.cuh's on one warp, 2 the same with every add on the
//    FMA pipe (IMAD; `x_`, an experiment kept for its number), 3
//    sha256.cuh's poh_split, the schedule on a second warp (fdt_poh_chain's
//    design), 4 a copy of poh_split's round warp alone, without the
//    hand-over (`round_warp_alone`).  The
//    caller holds `out` of 0..3 against hashlib and runs them in turns.

#include <cuda_runtime.h>

#include "../sha256.cuh"

// -- the compression before its redesign, as it was --------------------------

__constant__ uint32_t OLD_K256[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
    0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
    0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
    0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
    0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
    0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
    0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
    0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

__constant__ uint32_t OLD_H256[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u,
                                     0xa54ff53au, 0x510e527fu, 0x9b05688cu,
                                     0x1f83d9abu, 0x5be0cd19u};

__device__ __forceinline__ uint32_t old_rotr(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

__device__ __forceinline__ void old_compress(uint32_t s[8], const uint32_t m[16]) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; i++) w[i] = m[i];
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
  uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int t = 0; t < 64; t++) {
    if (t >= 16) {
      const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint32_t s0 = old_rotr(w15, 7) ^ old_rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = old_rotr(w2, 17) ^ old_rotr(w2, 19) ^ (w2 >> 10);
      w[t & 15] += s0 + w[(t - 7) & 15] + s1;
    }
    const uint32_t t1 = h + (old_rotr(e, 6) ^ old_rotr(e, 11) ^ old_rotr(e, 25)) +
                        ((e & f) ^ (~e & g)) + OLD_K256[t] + w[t & 15];
    const uint32_t t2 = (old_rotr(a, 2) ^ old_rotr(a, 13) ^ old_rotr(a, 22)) +
                        ((a & b) ^ (a & c) ^ (b & c));
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  s[0] += a;
  s[1] += b;
  s[2] += c;
  s[3] += d;
  s[4] += e;
  s[5] += f;
  s[6] += g;
  s[7] += h;
}

__device__ __forceinline__ void old_sha256_of_32(uint32_t s[8]) {
  uint32_t m[16];
#pragma unroll
  for (int i = 0; i < 8; i++) {
    m[i] = s[i];
    m[8 + i] = 0;
    s[i] = OLD_H256[i];
  }
  m[8] = 0x80000000u;
  m[15] = 32 * 8;
  old_compress(s, m);
}

// -- instruction chains ------------------------------------------------------

__device__ __forceinline__ uint32_t p_shf(uint32_t lo, uint32_t hi, uint32_t n) {
  uint32_t r;
  asm volatile("shf.r.wrap.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(lo), "r"(hi), "r"(n));
  return r;
}

__device__ __forceinline__ uint32_t p_lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("lop3.b32 %0, %1, %2, %3, 0x96;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

__device__ __forceinline__ uint32_t p_add3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("add.u32 %0, %1, %2;\n\tadd.u32 %0, %0, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

__device__ __forceinline__ uint32_t p_mad(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// one step of kind `kind` on x, with the operands p, q (q odd): each of
// the 8 unrolled steps has its own p and q, so that no two steps fold
__device__ __forceinline__ uint32_t op_step(int kind, uint32_t x, uint32_t p,
                                            uint32_t q, uint32_t u) {
  switch (kind) {
    case 0: return p_shf(x, p, u);
    case 1: return p_lop3(x, p, q);
    case 2: return p_add3(x, p, q);
    case 3: return p_mad(x, q, p);
    default: return p_add3(p_lop3(p_shf(x, x, u), p, q), q, p);
  }
}

// in: 16 operands p[8], q[8], then the shift amount, then 32 seeds
template <int KIND>
__device__ __forceinline__ void latency_chain(const uint32_t* in, uint32_t* out,
                                              long long* cycles, int n) {
  const int t = threadIdx.x;
  uint32_t p[8], q[8];
#pragma unroll
  for (int s = 0; s < 8; s++) {
    p[s] = in[s];
    q[s] = in[8 + s] | 1;
  }
  const uint32_t u = in[16];
  uint32_t x = in[17 + t];
  __syncwarp();
  const long long t0 = clock64();
  for (int i = 0; i < n; i += 8) {
#pragma unroll
    for (int s = 0; s < 8; s++) x = op_step(KIND, x, p[s], q[s], u);
  }
  const long long t1 = clock64();
  out[t] = x;
  cycles[t] = t1 - t0;
}

// 8 independent chains; KIND 5 is four IADD3 chains beside four IMAD ones
template <int KIND>
__device__ __forceinline__ void issue_chains(const uint32_t* in, uint32_t* out,
                                             long long* cycles, int n) {
  const int t = threadIdx.x;
  uint32_t p[8], q[8], x[8];
#pragma unroll
  for (int s = 0; s < 8; s++) {
    p[s] = in[s];
    q[s] = in[8 + s] | 1;
    x[s] = in[17 + ((t + 5 * s) & 31)];
  }
  const uint32_t u = in[16];
  __syncwarp();
  const long long t0 = clock64();
  for (int i = 0; i < n; i += 8) {
#pragma unroll
    for (int s = 0; s < 8; s++) {
#pragma unroll
      for (int j = 0; j < 8; j++)
        x[j] = op_step(KIND == 5 ? (j < 4 ? 2 : 3) : KIND, x[j], p[s], q[s], u);
    }
  }
  const long long t1 = clock64();
  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) r ^= x[j];
  out[t] = r;
  cycles[t] = t1 - t0;
}

extern "C" __global__ void fdt_probe_sha_op(int kind, const uint32_t* in,
                                            uint32_t* out, long long* cycles,
                                            int n) {
  switch (kind) {
    case 0: latency_chain<0>(in, out, cycles, n); break;
    case 1: latency_chain<1>(in, out, cycles, n); break;
    case 2: latency_chain<2>(in, out, cycles, n); break;
    case 3: latency_chain<3>(in, out, cycles, n); break;
    case 4: latency_chain<4>(in, out, cycles, n); break;
    case 5: issue_chains<0>(in, out, cycles, n); break;
    case 6: issue_chains<1>(in, out, cycles, n); break;
    case 7: issue_chains<2>(in, out, cycles, n); break;
    case 8: issue_chains<3>(in, out, cycles, n); break;
    default: issue_chains<5>(in, out, cycles, n); break;
  }
}

// in: 49 words (p[8], q[8], the shift amount, 32 seeds); n a multiple of 8;
// out, cycles: 32 each
extern "C" cudaError_t fdt_probe_sha_op_launch(int kind, const uint32_t* in,
                                               uint32_t* out, long long* cycles,
                                               int n, int threads, void* stream) {
  fdt_probe_sha_op<<<1, threads, 0, (cudaStream_t)stream>>>(kind, in, out, cycles, n);
  return cudaGetLastError();
}

// -- an experiment: the round's adds on the FMA pipe ---------------------------

// 1 and -1 that ptxas cannot see, so that a mad.lo.u32 by them stays an
// IMAD (the FMA pipe) and does not become an IADD3 (the ALU pipe)
__constant__ uint32_t X_ONE = 1u, X_NEG = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t x_mad(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t x_add(uint32_t a, uint32_t b) { return x_mad(a, X_ONE, b); }

// sha256.cuh's round with every add but the schedule's constants on IMAD
__device__ __forceinline__ void x_round(uint32_t wk, uint32_t& a, uint32_t& b,
                                        uint32_t& c, uint32_t& d, uint32_t& e,
                                        uint32_t& f, uint32_t& g, uint32_t& h) {
  const uint32_t pe = x_add(x_add(h, d), wk);
  const uint32_t e2 = x_add(big_sigma1(e), x_add(sha_ch(e, f, g), pe));
  const uint32_t a2 = x_add(e2, x_add(big_sigma0(a), x_mad(d, X_NEG, sha_maj(a, b, c))));
  h = g; g = f; f = e; e = e2; d = c; c = b; b = a; a = a2;
}

__device__ __forceinline__ uint32_t x_sched(uint32_t w16, uint32_t w15, uint32_t w7,
                                            uint32_t w2) {
  return x_add(x_add(small_sigma0(w15), w16), x_add(w7, small_sigma1(w2)));
}

__device__ __forceinline__ void x_compress(uint32_t s[8], const uint32_t m[16]) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; i++) w[i] = m[i];
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3], e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int t = 0; t < 64; t++) {
    if (t >= 16)
      w[t & 15] = x_sched(w[t & 15], w[(t - 15) & 15], w[(t - 7) & 15], w[(t - 2) & 15]);
    x_round(k256(t) + w[t & 15], a, b, c, d, e, f, g, h);
  }
  const uint32_t r[8] = {a, b, c, d, e, f, g, h};
#pragma unroll
  for (int i = 0; i < 8; i++) s[i] = x_add(s[i], r[i]);
}

__device__ __forceinline__ void x_sha256_of_32(uint32_t s[8]) {
  uint32_t m[16];
#pragma unroll
  for (int i = 0; i < 8; i++) {
    m[i] = s[i];
    m[8 + i] = 0;
    s[i] = h256(i);
  }
  m[8] = 0x80000000u;
  m[15] = 32 * 8;
  x_compress(s, m);
}

// poh_split's round warp as it is, without the schedule warp and the four
// barrier operations of an append: the same stores, rounds and shared
// loads, on W + K that nobody writes (its output is no hash).  The cycles
// against poh_split's are what the hand-over costs.
__device__ __forceinline__ void round_warp_alone(uint32_t s[8], int32_t n, uint32_t* st_sm,
                                                 const uint32_t* wk_sm) {
  const int l = threadIdx.x & 31;
#pragma unroll 1
  for (int32_t k = 0; k < n; k++) {
#pragma unroll
    for (int i = 0; i < 8; i++) st_sm[i * 32 + l] = s[i];
    uint32_t m[16], wk[64];
    poh_block(s, m);
    uint32_t a = h256(0), b = h256(1), c = h256(2), d = h256(3);
    uint32_t e = h256(4), f = h256(5), g = h256(6), h = h256(7);
    poh_rounds<0, 11>(m, wk, a, b, c, d, e, f, g, h);
    poh_load<16, POH_C1>(wk, wk_sm, l);
    poh_rounds<11, POH_C1 - 4>(m, wk, a, b, c, d, e, f, g, h);
    poh_load<POH_C1, POH_C2>(wk, wk_sm, l);
    poh_rounds<POH_C1 - 4, POH_C2 - 4>(m, wk, a, b, c, d, e, f, g, h);
    poh_load<POH_C2, 64>(wk, wk_sm, l);
    poh_rounds<POH_C2 - 4, 64>(m, wk, a, b, c, d, e, f, g, h);
    const uint32_t r[8] = {a, b, c, d, e, f, g, h};
#pragma unroll
    for (int i = 0; i < 8; i++) s[i] = h256(i) + r[i];
  }
}

// -- one warp of PoH chains ----------------------------------------------------

// one kernel a variant, so that each gets its own register allocation
#define POH_PROBE(NAME, BLOCK_THREADS, LOOP)                                          \
  extern "C" __global__ void __launch_bounds__(BLOCK_THREADS)                         \
      NAME(const uint32_t* state, uint32_t* out, long long* cycles, int n) {          \
    __shared__ uint32_t st_sm[8 * 32], wk_sm[48 * 32];                               \
    (void)st_sm;                                                                      \
    (void)wk_sm;                                                                      \
    const int t = threadIdx.x & 31;                                                   \
    uint32_t s[8];                                                                    \
    _Pragma("unroll") for (int i = 0; i < 8; i++) s[i] = state[8 * t + i];           \
    __syncthreads();                                                                  \
    const long long t0 = clock64();                                                   \
    LOOP;                                                                             \
    const long long t1 = clock64();                                                   \
    if (threadIdx.x < 32) {                                                           \
      _Pragma("unroll") for (int i = 0; i < 8; i++) out[8 * t + i] = s[i];           \
      cycles[t] = t1 - t0;                                                            \
    }                                                                                 \
  }

POH_PROBE(fdt_probe_poh_old, 32, _Pragma("unroll 1") for (int k = 0; k < n; k++) old_sha256_of_32(s))
POH_PROBE(fdt_probe_poh_one_warp, 32,
          _Pragma("unroll 1") for (int k = 0; k < n; k++) sha256_of_32(s))
POH_PROBE(fdt_probe_poh_one_warp_fma, 32,
          _Pragma("unroll 1") for (int k = 0; k < n; k++) x_sha256_of_32(s))
POH_PROBE(fdt_probe_poh_two_warps, 64, poh_split(s, n, n, st_sm, wk_sm))
POH_PROBE(fdt_probe_poh_round_warp_alone, 32, round_warp_alone(s, n, st_sm, wk_sm))

// which: 0 the compression before the redesign, 1 sha256.cuh's on one
// warp, 2 the same with every add on IMAD, 3 sha256.cuh's poh_split (two
// warps: fdt_poh_chain's design), 4 poh_split's round warp alone, without
// the hand-over (its output is no hash).  state, out: 32 x 8 words;
// cycles: 32
extern "C" cudaError_t fdt_probe_poh_launch(int which, const uint32_t* state,
                                            uint32_t* out, long long* cycles,
                                            int n, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (which) {
    case 0: fdt_probe_poh_old<<<1, 32, 0, st>>>(state, out, cycles, n); break;
    case 1: fdt_probe_poh_one_warp<<<1, 32, 0, st>>>(state, out, cycles, n); break;
    case 2: fdt_probe_poh_one_warp_fma<<<1, 32, 0, st>>>(state, out, cycles, n); break;
    case 3: fdt_probe_poh_two_warps<<<1, 64, 0, st>>>(state, out, cycles, n); break;
    default: fdt_probe_poh_round_warp_alone<<<1, 32, 0, st>>>(state, out, cycles, n);
  }
  return cudaGetLastError();
}
