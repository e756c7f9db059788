// sha256.cuh -- the SHA-256 compression shared by csrc/sha256.cu's two
// kernels and csrc/probe/sha_probe.cu, for the card (nvcc) and for the
// host build (plain C++, no __CUDACC__) that the CPU tests run.
//
// The round, laid out around its critical path.  A round computes
//   T1 = h + Σ1(e) + Ch(e,f,g) + K[t] + W[t];  e' = d + T1;
//   a' = T1 + Σ0(a) + Maj(a,b,c).
// Of those terms only Σ1(e) and Ch(e,f,g) depend on the e of this round:
// h is the e of three rounds back and d the a of three rounds back, so
// pe = h + d + K[t] + W[t] is summed off the chain and
//   e' = Σ1(e) + Ch(e,f,g) + pe           (funnel shift -> LOP3 -> IADD3)
//   a' = e' + Σ0(a) + (Maj(a,b,c) - d)    (one IADD3 after e')
// leave three dependent instructions a round on each of the two chains,
// where the textbook order left about five.  The two final sums are
// opaque three-input adds (sha_add3), so that the compiler cannot
// reassociate them back into the textbook order or cancel the d.
// Rotates are single funnel shifts (SHF.R.W); each Σ/σ and Ch and Maj is
// one LOP3, which nvcc forms from the C expressions.  The round constants
// are literals (k256 below), so a round whose W is constant (the padding
// words of a 32-byte PoH append, the whole padding block of a mixin) has
// a constant K + W, and the message schedule folds every term that
// depends only on constant words.
//
// The schedule on a second warp.  A compression is ~1,400 SASS
// instructions, ~1,200 of them on the ALU pipe (shifts, LOP3s, IADD3s),
// and a lone warp issues one of those every 2 cycles on its
// sub-partition's 16 INT32 lanes (the probe: 2.1 cycles, against 4.3
// cycles of latency), so one thread per lane is bound by its warp's
// issue, ~38 cycles a round, not by the 3-deep chain.  The kernels
// therefore give each 32 lanes two warps on two sub-partitions: the
// schedule warp computes W[t] + K[t] for t >= 16 (and, for messages,
// stages and pads the blocks) and hands it over in shared memory behind
// named barriers; the round warp runs only the rounds, ~13 ALU
// instructions a round.  sha_expand and sha_rounds below are the two
// halves, and the host build runs them one after the other.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define SHA_FN __device__ __forceinline__
#define SHA_UNROLL _Pragma("unroll")
#else
#define SHA_FN static inline
#define SHA_UNROLL
#endif

// FIPS 180-4 section 4.2.2: the first 32 bits of the fractional parts of
// the cube roots of the first 64 primes (utils/shaconst.py's K32 derives
// the same values; the CPU tests compare the two).  A local constexpr
// table: indexed by an unrolled round number it folds to an immediate.
SHA_FN uint32_t k256(int t) {
  constexpr uint32_t K256[64] = {
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
  return K256[t];
}

// the initial state: square roots of the first 8 primes (H32)
SHA_FN uint32_t h256(int i) {
  constexpr uint32_t H256[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u,
                                0xa54ff53au, 0x510e527fu, 0x9b05688cu,
                                0x1f83d9abu, 0x5be0cd19u};
  return H256[i];
}

SHA_FN uint32_t rotr(uint32_t x, int n) {
#ifdef __CUDACC__
  return __funnelshift_r(x, x, n);
#else
  return (x >> n) | (x << (32 - n));
#endif
}

// a + b + c, summed in that shape: on the card two PTX adds the compiler
// cannot reassociate, which ptxas fuses into one IADD3
SHA_FN uint32_t sha_add3(uint32_t a, uint32_t b, uint32_t c) {
#ifdef __CUDACC__
  uint32_t r;
  asm("add.u32 %0, %1, %2;\n\tadd.u32 %0, %0, %3;"
      : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
#else
  return a + b + c;
#endif
}

SHA_FN uint32_t big_sigma0(uint32_t x) { return rotr(x, 2) ^ rotr(x, 13) ^ rotr(x, 22); }
SHA_FN uint32_t big_sigma1(uint32_t x) { return rotr(x, 6) ^ rotr(x, 11) ^ rotr(x, 25); }
SHA_FN uint32_t small_sigma0(uint32_t x) { return rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3); }
SHA_FN uint32_t small_sigma1(uint32_t x) { return rotr(x, 17) ^ rotr(x, 19) ^ (x >> 10); }
SHA_FN uint32_t sha_ch(uint32_t e, uint32_t f, uint32_t g) { return (e & f) ^ (~e & g); }
SHA_FN uint32_t sha_maj(uint32_t a, uint32_t b, uint32_t c) {
  return (a & b) ^ (a & c) ^ (b & c);
}

// Round t on the state a..h, given wk = W[t] + K[t].
SHA_FN void sha_round(uint32_t wk, uint32_t& a, uint32_t& b, uint32_t& c,
                      uint32_t& d, uint32_t& e, uint32_t& f, uint32_t& g,
                      uint32_t& h) {
  const uint32_t pe = h + d + wk;  // off the chain
  const uint32_t q = sha_maj(a, b, c) - d;
  const uint32_t e2 = sha_add3(big_sigma1(e), sha_ch(e, f, g), pe);
  const uint32_t a2 = sha_add3(e2, big_sigma0(a), q);
  h = g;
  g = f;
  f = e;
  e = e2;
  d = c;
  c = b;
  b = a;
  a = a2;
}

// Schedule word t >= 16 from W[t-16], W[t-15], W[t-7], W[t-2].
SHA_FN uint32_t sha_sched(uint32_t w16, uint32_t w15, uint32_t w7, uint32_t w2) {
  return small_sigma0(w15) + w16 + w7 + small_sigma1(w2);
}

// One compression: s = s + rounds(s, m).  m: one 64-byte block as 16
// big-endian words.
SHA_FN void sha256_compress(uint32_t s[8], const uint32_t m[16]) {
  uint32_t w[16];
  SHA_UNROLL
  for (int i = 0; i < 16; i++) w[i] = m[i];
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
  uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
  SHA_UNROLL
  for (int t = 0; t < 64; t++) {
    if (t >= 16)
      w[t & 15] = sha_sched(w[t & 15], w[(t - 15) & 15], w[(t - 7) & 15], w[(t - 2) & 15]);
    sha_round(k256(t) + w[t & 15], a, b, c, d, e, f, g, h);
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

// The schedule half of a compression: wk[t] = W[t] + K[t] for the 64
// rounds of the block m.
SHA_FN void sha_expand(const uint32_t m[16], uint32_t wk[64]) {
  uint32_t w[16];
  SHA_UNROLL
  for (int i = 0; i < 16; i++) w[i] = m[i];
  SHA_UNROLL
  for (int t = 0; t < 64; t++) {
    if (t >= 16)
      w[t & 15] = sha_sched(w[t & 15], w[(t - 15) & 15], w[(t - 7) & 15], w[(t - 2) & 15]);
    wk[t] = w[t & 15] + k256(t);
  }
}

// The round half: s = s + rounds(s, wk).
SHA_FN void sha_rounds(uint32_t s[8], const uint32_t wk[64]) {
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
  uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
  SHA_UNROLL
  for (int t = 0; t < 64; t++) sha_round(wk[t], a, b, c, d, e, f, g, h);
  s[0] += a;
  s[1] += b;
  s[2] += c;
  s[3] += d;
  s[4] += e;
  s[5] += f;
  s[6] += g;
  s[7] += h;
}

// The block of a 32-byte PoH append: the state, then the constant padding.
SHA_FN void poh_block(const uint32_t s[8], uint32_t m[16]) {
  SHA_UNROLL
  for (int i = 0; i < 8; i++) {
    m[i] = s[i];
    m[8 + i] = 0;
  }
  m[8] = 0x80000000u;
  m[15] = 32 * 8;
}

// s = SHA-256(s as 32 bytes): one block whose second half is the constant
// padding (0x80000000, six zero words, the bit length 256).
SHA_FN void sha256_of_32(uint32_t s[8]) {
  uint32_t m[16];
  poh_block(s, m);
  SHA_UNROLL
  for (int i = 0; i < 8; i++) s[i] = h256(i);
  sha256_compress(s, m);
}

// s = SHA-256(s || mix as 64 bytes): the message block, then the padding
// block, whose schedule is constant throughout.
SHA_FN void sha256_of_64(uint32_t s[8], const uint32_t mix[8]) {
  uint32_t m[16];
  SHA_UNROLL
  for (int i = 0; i < 8; i++) {
    m[i] = s[i];
    m[8 + i] = mix[i];
    s[i] = h256(i);
  }
  sha256_compress(s, m);
  SHA_UNROLL
  for (int i = 0; i < 16; i++) m[i] = 0;
  m[0] = 0x80000000u;
  m[15] = 64 * 8;
  sha256_compress(s, m);
}

#ifndef __CUDACC__
// The PoH chain of one lane on its state words, as the two warps of
// poh_split compute it: max(n, 0) appends s = SHA-256(s) (each the
// schedule half, then the round half), then, where has_mix,
// s = SHA-256(s || mix).
static inline void poh_words(uint32_t s[8], int32_t n, bool has_mix,
                             const uint32_t mix[8]) {
  for (int32_t k = 0; k < n; k++) {
    uint32_t m[16], wk[64];
    poh_block(s, m);
    sha_expand(m, wk);
    for (int i = 0; i < 8; i++) s[i] = h256(i);
    sha_rounds(s, wk);
  }
  if (has_mix) sha256_of_64(s, mix);
}
#endif

// Blocks of a lane's padded message: ceil((len + 9) / 64), none for a
// negative length.  A caller compresses at most its padded width's count.
SHA_FN int64_t padded_blocks(int64_t len) {
  return len < 0 ? 0 : (len + 9 + 63) / 64;
}

#ifdef __CUDACC__
// -- two warps on 32 lanes: the schedule warp and the round warp ----------
//
// A 64-thread block: warp 0 runs the rounds, warp 1 the schedule, both on
// the same 32 lanes (thread t of each warp on lane t).  They meet at named
// barriers 1..4 of 64 threads (barrier 0 is __syncthreads): the producer
// arrives (bar.arrive does not wait), the consumer syncs.

SHA_FN void sha_bar_sync(int id) { asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory"); }
SHA_FN void sha_bar_arrive(int id) { asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory"); }

// PoH appends.  The schedule of an append depends on the state the last
// one produced, so each append starts with a hand-over: the round warp
// writes the state (barrier 1) and runs rounds 0..15 on it while the
// schedule warp computes W[16..63] + K in three chunks (barriers 2, 3, 4:
// rounds 16..23, 24..39, 40..63).  The round warp waits for a chunk a few
// rounds before it needs it, so that its loads are in flight while the
// rounds before it run.  Both warps loop the group's largest count; a lane
// whose own count is done keeps its state.
#define POH_C1 24
#define POH_C2 40

// Rounds LO..HI-1 of an append: W + K from the block m below round 16,
// from wk (the schedule warp's) above.
template <int LO, int HI>
SHA_FN void poh_rounds(const uint32_t m[16], const uint32_t wk[64], uint32_t& a,
                       uint32_t& b, uint32_t& c, uint32_t& d, uint32_t& e,
                       uint32_t& f, uint32_t& g, uint32_t& h) {
  SHA_UNROLL
  for (int t = LO; t < HI; t++)
    sha_round(t < 16 ? m[t] + k256(t) : wk[t], a, b, c, d, e, f, g, h);
}

// wk[LO..HI-1] from the schedule warp's chunk in shared memory
template <int LO, int HI>
SHA_FN void poh_load(uint32_t wk[64], const uint32_t* wk_sm, int l) {
  SHA_UNROLL
  for (int u = LO; u < HI; u++) wk[u] = wk_sm[(u - 16) * 32 + l];
}

// st_sm: 8 x 32 words, wk_sm: 48 x 32 words, [word][lane].
SHA_FN void poh_split(uint32_t s[8], int32_t n, int32_t group_n, uint32_t* st_sm,
                      uint32_t* wk_sm) {
  const int l = threadIdx.x & 31;
  if (threadIdx.x < 32) {  // the round warp
#pragma unroll 1
    for (int32_t k = 0; k < group_n; k++) {
      SHA_UNROLL
      for (int i = 0; i < 8; i++) st_sm[i * 32 + l] = s[i];
      sha_bar_arrive(1);
      uint32_t m[16], wk[64];
      poh_block(s, m);
      uint32_t a = h256(0), b = h256(1), c = h256(2), d = h256(3);
      uint32_t e = h256(4), f = h256(5), g = h256(6), h = h256(7);
      poh_rounds<0, 11>(m, wk, a, b, c, d, e, f, g, h);
      sha_bar_sync(2);
      poh_load<16, POH_C1>(wk, wk_sm, l);
      poh_rounds<11, POH_C1 - 4>(m, wk, a, b, c, d, e, f, g, h);
      sha_bar_sync(3);
      poh_load<POH_C1, POH_C2>(wk, wk_sm, l);
      poh_rounds<POH_C1 - 4, POH_C2 - 4>(m, wk, a, b, c, d, e, f, g, h);
      sha_bar_sync(4);
      poh_load<POH_C2, 64>(wk, wk_sm, l);
      poh_rounds<POH_C2 - 4, 64>(m, wk, a, b, c, d, e, f, g, h);
      if (k < n) {
        s[0] = h256(0) + a;
        s[1] = h256(1) + b;
        s[2] = h256(2) + c;
        s[3] = h256(3) + d;
        s[4] = h256(4) + e;
        s[5] = h256(5) + f;
        s[6] = h256(6) + g;
        s[7] = h256(7) + h;
      }
    }
  } else {  // the schedule warp
#pragma unroll 1
    for (int32_t k = 0; k < group_n; k++) {
      sha_bar_sync(1);
      uint32_t cur[8], m[16], w[16];
      SHA_UNROLL
      for (int i = 0; i < 8; i++) cur[i] = st_sm[i * 32 + l];
      poh_block(cur, m);
      SHA_UNROLL
      for (int i = 0; i < 16; i++) w[i] = m[i];
      SHA_UNROLL
      for (int t = 16; t < 64; t++) {
        w[t & 15] = sha_sched(w[t & 15], w[(t - 15) & 15], w[(t - 7) & 15], w[(t - 2) & 15]);
        wk_sm[(t - 16) * 32 + l] = w[t & 15] + k256(t);
        if (t == POH_C1 - 1) sha_bar_arrive(2);
        if (t == POH_C2 - 1) sha_bar_arrive(3);
      }
      sha_bar_arrive(4);
    }
  }
}
#endif
