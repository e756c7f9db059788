// sha256.cu -- SHA-256 for NVIDIA Hopper (sm_90a): the batched hash of
// padded messages and the Proof-of-History chain.
//
// Replaces two XLA functions of the JAX package (neither is a Pallas
// kernel): firedancer_tpu/ops/sha256.py :: _compress_block, scanned over
// each lane's blocks by _sha256_impl (kernel fdt_sha256_blocks), and
// firedancer_tpu/ops/poh.py :: _verify_entries_impl, one device program
// that runs every lane max_hashcnt masked compressions under a fori_loop
// and then the mixin (kernel fdt_poh_chain).  In eager PyTorch that loop
// would be one batched compression of some two thousand launches per hash,
// so a 12,500-hash PoH tick interval could not be checked in the slot's
// 400 ms without a kernel.
//
// Interface: words are SHA-256's big-endian 32-bit words, lane-major.
//   fdt_sha256_blocks(words (B, max_blocks, 16), nblocks (B,), out (B, 8),
//                     B, max_blocks)
//     compresses lane i's first nblocks[i] blocks (already padded by the
//     caller, ops/sha256.py::padded_words) from the initial state.
//   fdt_poh_chain(state (B, 8), n_plain (B,), mixin (B, 8), has_mixin (B,),
//                 out (B, 8), B)
//     runs max(n_plain[i], 0) plain appends state = SHA-256(state) and then,
//     where has_mixin[i], state = SHA-256(state || mixin[i]) (two
//     compressions): _verify_entries_impl's result, where n_plain = -1
//     (hashcnt 0 with a mixin) means no append.  Each lane loops its own
//     count where JAX masks every lane to max_hashcnt steps; the outputs
//     are the same.
//
// What bounds it: 32-bit integer ALU issue (shifts, three-input logic and
// adds), about a thousand instructions per compression per lane; bytes are
// few.  But a PoH lane is a chain of dependent compressions, and each round
// of a compression depends on the one before, so with a few thousand lanes
// the chain's latency, not the issue rate, sets fdt_poh_chain's time: the
// longest lane's compressions times the cycles of one dependent compression
// (chip_smoke.py's poh phase measures both and reports this floor beside
// the issue bound).
//
// Design: one thread per lane, the state and the 16-word message window in
// registers, the 64 rounds unrolled so every window index and round
// constant is a compile-time value.  Blocks of 64 threads spread a small
// batch over many SMs, one warp per SM sub-partition.  A simple kernel:
// several lanes per thread, to hide the round latency, is later work.
//
// Compiled without __CUDACC__ (plain C++), the lane functions build a host
// library (fdt_sha256_blocks_host, fdt_poh_chain_host) that the CPU tests
// hold against hashlib and the JAX package.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SHA_FN __device__ __forceinline__
#define SHA_UNROLL _Pragma("unroll")
#define SHA_CONST __constant__
#else
#define SHA_FN static inline
#define SHA_UNROLL
#define SHA_CONST static const
#endif

#define SHA_THREADS 64

// FIPS 180-4 section 4.2.2: the first 32 bits of the fractional parts of
// the cube roots of the first 64 primes (utils/shaconst.py's K32 derives
// the same values; the CPU tests compare the two).
SHA_CONST uint32_t K256[64] = {
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

// the initial state: square roots of the first 8 primes (H32)
SHA_CONST uint32_t H256[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u,
                              0xa54ff53au, 0x510e527fu, 0x9b05688cu,
                              0x1f83d9abu, 0x5be0cd19u};

SHA_FN uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

// One compression: s = s + rounds(s, m).  m: one 64-byte block as 16 words.
SHA_FN void sha256_compress(uint32_t s[8], const uint32_t m[16]) {
  uint32_t w[16];
  SHA_UNROLL
  for (int i = 0; i < 16; i++) w[i] = m[i];
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
  uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
  SHA_UNROLL
  for (int t = 0; t < 64; t++) {
    if (t >= 16) {
      const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      w[t & 15] += s0 + w[(t - 7) & 15] + s1;
    }
    const uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) +
                        ((e & f) ^ (~e & g)) + K256[t] + w[t & 15];
    const uint32_t t2 =
        (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c));
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

// s = SHA-256(s as 32 bytes): one block, the padding words constant.
SHA_FN void sha256_of_32(uint32_t s[8]) {
  uint32_t m[16];
  SHA_UNROLL
  for (int i = 0; i < 8; i++) {
    m[i] = s[i];
    m[8 + i] = 0;
    s[i] = H256[i];
  }
  m[8] = 0x80000000u;
  m[15] = 32 * 8;
  sha256_compress(s, m);
}

// s = SHA-256(s || mix as 64 bytes): the message block, then the padding.
SHA_FN void sha256_of_64(uint32_t s[8], const uint32_t mix[8]) {
  uint32_t m[16];
  SHA_UNROLL
  for (int i = 0; i < 8; i++) {
    m[i] = s[i];
    m[8 + i] = mix[i];
    s[i] = H256[i];
  }
  sha256_compress(s, m);
  SHA_UNROLL
  for (int i = 0; i < 16; i++) m[i] = 0;
  m[0] = 0x80000000u;
  m[15] = 64 * 8;
  sha256_compress(s, m);
}

// Lane `lane` of fdt_sha256_blocks.
SHA_FN void blocks_lane(const uint32_t* words, const int32_t* nblocks,
                        uint32_t* out, int max_blocks, int lane) {
  uint32_t s[8];
  SHA_UNROLL
  for (int i = 0; i < 8; i++) s[i] = H256[i];
  const int n = nblocks[lane] < max_blocks ? nblocks[lane] : max_blocks;
  const uint32_t* p = words + (int64_t)lane * max_blocks * 16;
  for (int k = 0; k < n; k++, p += 16) {
    uint32_t m[16];
    SHA_UNROLL
    for (int i = 0; i < 16; i++) m[i] = p[i];
    sha256_compress(s, m);
  }
  SHA_UNROLL
  for (int i = 0; i < 8; i++) out[(int64_t)lane * 8 + i] = s[i];
}

// Lane `lane` of fdt_poh_chain.
SHA_FN void poh_lane(const uint32_t* state, const int32_t* n_plain,
                     const uint32_t* mixin, const uint8_t* has_mixin,
                     uint32_t* out, int lane) {
  uint32_t s[8];
  SHA_UNROLL
  for (int i = 0; i < 8; i++) s[i] = state[(int64_t)lane * 8 + i];
  const int32_t n = n_plain[lane];
  for (int32_t k = 0; k < n; k++) sha256_of_32(s);
  if (has_mixin[lane]) {
    uint32_t mix[8];
    SHA_UNROLL
    for (int i = 0; i < 8; i++) mix[i] = mixin[(int64_t)lane * 8 + i];
    sha256_of_64(s, mix);
  }
  SHA_UNROLL
  for (int i = 0; i < 8; i++) out[(int64_t)lane * 8 + i] = s[i];
}

#ifdef __CUDACC__

extern "C" __global__ void __launch_bounds__(SHA_THREADS)
fdt_sha256_blocks(const uint32_t* __restrict__ words,
                  const int32_t* __restrict__ nblocks,
                  uint32_t* __restrict__ out, int B, int max_blocks) {
  const int lane = blockIdx.x * SHA_THREADS + threadIdx.x;
  if (lane < B) blocks_lane(words, nblocks, out, max_blocks, lane);
}

extern "C" __global__ void __launch_bounds__(SHA_THREADS)
fdt_poh_chain(const uint32_t* __restrict__ state,
              const int32_t* __restrict__ n_plain,
              const uint32_t* __restrict__ mixin,
              const uint8_t* __restrict__ has_mixin,
              uint32_t* __restrict__ out, int B) {
  const int lane = blockIdx.x * SHA_THREADS + threadIdx.x;
  if (lane < B) poh_lane(state, n_plain, mixin, has_mixin, out, lane);
}

extern "C" cudaError_t fdt_sha256_blocks_launch(const uint32_t* words,
                                                const int32_t* nblocks,
                                                uint32_t* out, int B,
                                                int max_blocks, void* stream) {
  if (B <= 0) return cudaSuccess;
  fdt_sha256_blocks<<<(B + SHA_THREADS - 1) / SHA_THREADS, SHA_THREADS, 0,
                      (cudaStream_t)stream>>>(words, nblocks, out, B,
                                              max_blocks);
  return cudaGetLastError();
}

extern "C" cudaError_t fdt_poh_chain_launch(const uint32_t* state,
                                            const int32_t* n_plain,
                                            const uint32_t* mixin,
                                            const uint8_t* has_mixin,
                                            uint32_t* out, int B,
                                            void* stream) {
  if (B <= 0) return cudaSuccess;
  fdt_poh_chain<<<(B + SHA_THREADS - 1) / SHA_THREADS, SHA_THREADS, 0,
                  (cudaStream_t)stream>>>(state, n_plain, mixin, has_mixin,
                                          out, B);
  return cudaGetLastError();
}

#else  // plain C++: the host build the CPU tests hold against hashlib

extern "C" void fdt_sha256_blocks_host(const uint32_t* words,
                                       const int32_t* nblocks, uint32_t* out,
                                       int B, int max_blocks) {
  for (int lane = 0; lane < B; lane++)
    blocks_lane(words, nblocks, out, max_blocks, lane);
}

extern "C" void fdt_poh_chain_host(const uint32_t* state,
                                   const int32_t* n_plain,
                                   const uint32_t* mixin,
                                   const uint8_t* has_mixin, uint32_t* out,
                                   int B) {
  for (int lane = 0; lane < B; lane++)
    poh_lane(state, n_plain, mixin, has_mixin, out, lane);
}

#endif
