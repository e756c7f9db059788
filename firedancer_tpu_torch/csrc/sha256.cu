// sha256.cu -- SHA-256 for NVIDIA Hopper (sm_90a): the batched hash of
// variable-length messages and the Proof-of-History chain, both on the
// compression of sha256.cuh.
//
// Replaces two XLA functions of the JAX package (neither is a Pallas
// kernel): firedancer_tpu/ops/sha256.py :: _sha256_impl, the padding and
// the scan of _compress_block over each lane's blocks (kernel
// fdt_sha256_blocks), and firedancer_tpu/ops/poh.py :: _verify_entries_impl,
// one device program that runs every lane max_hashcnt masked compressions
// under a fori_loop and then the mixin (kernel fdt_poh_chain).
//
// Interface: bytes in, bytes out.
//   fdt_sha256_blocks(msgs (B, W) uint8, lens (B,) int32 or int64,
//                     out (B, 32) uint8)
//     the SHA-256 digest of each lane's first lens[i] bytes: padding (0x80,
//     zeros, the 64-bit bit length) and the big-endian words are made in
//     the kernel; a lane compresses at most ceil((W + 9) / 64) blocks, and
//     bytes past W read as zeros (ops/sha256.py::padded_words).
//   fdt_poh_chain(state (B, 32) uint8, n_plain (B,) int32,
//                 mixin (B, 32) uint8, has_mixin (B,) uint8,
//                 out (B, 32) uint8)
//     max(n_plain[i], 0) appends state = SHA-256(state), then, where
//     has_mixin[i], state = SHA-256(state || mixin[i]) (two compressions):
//     _verify_entries_impl's result, where n_plain = -1 (hashcnt 0 with a
//     mixin) means no append.  Each group of 32 lanes loops its own
//     largest count (a lane whose count is done keeps its state) where JAX
//     masks every lane to max_hashcnt steps; the outputs are the same.
//
// What bounds them.  A compression is ~1,400 operations (FIPS 180-4's
// rotates, logic and adds; chip_smoke.py's sha_compression_ops), 1,024
// of them rotates, shifts and logic that only the ALU pipe runs, and its
// 64 rounds form one dependent chain.  A PoH lane is a chain of thousands of
// dependent compressions and a message lane one of up to 20, so neither
// kernel has the lanes to fill the card (1,024 PoH lanes are 32 lane
// groups, 4,096 message lanes 128, of the card's 528 SM sub-partitions):
// the time is the longest lane's compressions times the cycles of one
// dependent compression.  The round's critical path is three dependent
// instructions (sha256.cuh), ~12.9 cycles at the probe's latencies; a
// lone warp issues an ALU instruction every ~2.1 cycles, so it is the
// round warp's issue that sets the cycles of a compression.
// chip_smoke.py's poh and sha256 phases report that latency floor (from
// csrc/probe/sha_probe.cu's clock64 probe) beside the card's issue bound.
//
// Design.  Each 32 lanes get a block of two warps on two SM
// sub-partitions (sha256.cuh): the schedule warp makes every round's
// W + K and hands it over in shared memory behind named barriers, the
// round warp keeps the state in registers and runs only the rounds.
// fdt_poh_chain reads each lane's 32-byte state (and mixin) as two
// 16-byte loads, byte-swaps in registers (__byte_perm) and loops the
// group's largest count of appends (poh_split: the schedule of an append
// follows the state the last one made, so the round warp hands its state
// over and runs rounds 0..15 while the schedule warp expands it), then
// the lane's mixin on the round warp alone.  In fdt_sha256_blocks the
// schedule warp stages its lanes' next 64-byte blocks in shared memory
// with 16-byte cp.async copies, whatever the rows' alignment: each lane
// copies the five aligned 16-byte granules from the one that holds its
// block's first byte (80 bytes, five neighbouring threads on one lane),
// and reads its 16 words back at the row's offset in its granule, two
// shared words and one __byte_perm a word (the byte swap and the shift in
// one instruction).  The stage is double buffered, so that block k + 1
// arrives while block k is padded and expanded.  The W + K of two blocks
// are double buffered too, so the schedule warp expands block k + 1 while
// the round warp compresses block k.  4,096 lanes are 128 blocks, one an
// SM.
//
// Compiled without __CUDACC__ (plain C++), the lane functions build a host
// library (fdt_sha256_blocks_host, fdt_poh_chain_host) that the CPU tests
// hold against hashlib and the JAX package.

#include "sha256.cuh"

// shared bytes of one lane's staged block: the five 16-byte granules
// that hold its 64 bytes at any alignment
#define SHA_ROW 80
#define SHA_CHUNKS (SHA_ROW / 16)

// max_blocks of a width: the padded message's blocks
SHA_FN int64_t width_blocks(int64_t width) { return (width + 9 + 63) / 64; }

// Where a lane's row starts inside its 16-byte granule: its staged block's
// first byte lies that far into the stage row (64 k keeps it).
SHA_FN int row_offset(uintptr_t msgs, int64_t lane, int64_t width) {
  return (int)((msgs + (uintptr_t)(lane * width)) & 15);
}

// Chunk r (0..4) of warp thread t when the warp stages a block of its
// lanes lane0..lane0+31: 16-byte granule q of lane l's block, from the
// granule that holds the block's first byte.  The plan holds what keeps
// from block to block: dst, its place in the stage (lane row l, SHA_ROW
// bytes apart); src, its 16-byte aligned address in block 0; rem, the
// row's bytes from there to the row's end (none past the batch, and none
// for the fifth granule of a row that starts on one).  Bytes before the
// row's start are the row before's, or for the first row bytes of the
// granule that holds msgs' first byte: read, never used.  The kernel's
// copies and the host build's emulation share it.
struct StagePlan {
  int dst;
  uintptr_t src;
  int64_t rem;
};

SHA_FN StagePlan stage_plan(uintptr_t msgs, int t, int r, int64_t lane0, int B,
                            int64_t width) {
  const int c = t + 32 * r;
  const int l = c / SHA_CHUNKS, q = c % SHA_CHUNKS;
  const uintptr_t row = msgs + (uintptr_t)((lane0 + l) * width);
  const int o = (int)(row & 15);
  const bool used = lane0 + l < B && (q < 4 || o != 0);
  return {l * SHA_ROW + 16 * q, (row & ~(uintptr_t)15) + 16 * q, used ? width + o - 16 * q : 0};
}

// The bytes chunk `p` copies in block k: those before the row's end, at
// most 16 (the copy zero fills the rest, so bytes past the width read as
// zeros); its source is p.src + 64 k.
SHA_FN int stage_bytes(const StagePlan& p, int k) {
  const int64_t left = p.rem - 64 * (int64_t)k;
  return left <= 0 ? 0 : left < 16 ? (int)left : 16;
}

// a lane's block count: its padded blocks, at most the width's, none past
// the batch
SHA_FN int lane_blocks(int64_t nblk, int64_t width, bool live) {
  const int64_t maxb = width_blocks(width);
  return live ? (int)(nblk < maxb ? nblk : maxb) : 0;
}

// __byte_perm(x, y, sel): byte n of the result is byte (sel >> 4n) & 7 of
// the eight bytes y:x (x the low four); the host build spells it out.
SHA_FN uint32_t sha_byte_perm(uint32_t x, uint32_t y, uint32_t sel) {
#ifdef __CUDACC__
  return __byte_perm(x, y, sel);
#else
  const uint64_t v = (uint64_t)y << 32 | x;
  uint32_t r = 0;
  for (int n = 0; n < 4; n++)
    r |= (uint32_t)(v >> (8 * ((sel >> (4 * n)) & 7)) & 0xFF) << (8 * n);
  return r;
#endif
}

// The 16 big-endian words of a lane's staged block, whose first byte lies
// o bytes into its stage row (row: 4-byte aligned): word j is the bytes
// o + 4j .. o + 4j + 3, taken from the two little-endian row words that
// hold them by one byte permutation (the byte swap and the shift at once).
SHA_FN void stage_words(const uint8_t* row, int o, uint32_t m[16]) {
  const uint32_t sel = 0x0123u + 0x1111u * (uint32_t)(o & 3);
  uint32_t v[17];
  SHA_UNROLL
  for (int i = 0; i < 17; i++) {
#ifdef __CUDACC__
    v[i] = reinterpret_cast<const uint32_t*>(row)[(o >> 2) + i];
#else
    const uint8_t* p = row + 4 * ((o >> 2) + i);
    v[i] = (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 | (uint32_t)p[3] << 24;
#endif
  }
  SHA_UNROLL
  for (int j = 0; j < 16; j++) m[j] = sha_byte_perm(v[j], v[j + 1], sel);
}

// x >> n, and 0 from n = 32 on (a negative n, as unsigned, is 0 too)
SHA_FN uint32_t shr_clamp(uint32_t x, uint32_t n) {
#ifdef __CUDACC__
  return __funnelshift_rc(x, 0u, n);
#else
  return n >= 32 ? 0u : x >> n;
#endif
}

// Block k of a lane's 16 big-endian message words, padded as
// firedancer_tpu/ops/sha256.py::_pad pads: of the L = len - 64 k message
// bytes from the block's start, word j keeps its first clamp(L - 4j, 0, 4)
// bytes and takes the 0x80 byte where L - 4j is 0..3, and the lane's last
// block (k == nblk - 1) ends in the 64-bit big-endian bit length.  No
// branch a word: a block before the lane's end (L >= 64) keeps them all.
SHA_FN void pad_block(uint32_t m[16], int64_t len, int k, int64_t nblk) {
  const int64_t rest = len - 64 * (int64_t)k;
  const int bits = 8 * (int)(rest < -8 ? -8 : rest > 64 ? 64 : rest);
  SHA_UNROLL
  for (int j = 0; j < 16; j++) {
    const int sj = bits - 32 * j;  // message bits from word j on
    const uint32_t drop = shr_clamp(0xFFFFFFFFu, (uint32_t)(sj > 0 ? sj : 0));
    m[j] = (m[j] & ~drop) | shr_clamp(0x80000000u, (uint32_t)sj);
  }
  if (k == nblk - 1) {
    const uint64_t nbits = (uint64_t)len << 3;
    m[14] = (uint32_t)(nbits >> 32);
    m[15] = (uint32_t)nbits;
  }
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

SHA_FN uint32_t bswap32(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

// 8 big-endian words of 32 bytes at p (16-byte aligned) / back
SHA_FN void load_words8(const uint8_t* p, uint32_t w[8]) {
  const uint4 lo = *reinterpret_cast<const uint4*>(p);
  const uint4 hi = *reinterpret_cast<const uint4*>(p + 16);
  const uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  SHA_UNROLL
  for (int i = 0; i < 8; i++) w[i] = bswap32(v[i]);
}

SHA_FN void store_words8(uint8_t* p, const uint32_t w[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(bswap32(w[0]), bswap32(w[1]), bswap32(w[2]), bswap32(w[3]));
  *reinterpret_cast<uint4*>(p + 16) =
      make_uint4(bswap32(w[4]), bswap32(w[5]), bswap32(w[6]), bswap32(w[7]));
}

// Block k of the warp's 32 lanes into `stage`, as one commit group of
// 16-byte cp.async copies (a zero fill reads nothing: its source is the
// granule of msgs' first byte, `zero_src`).
SHA_FN void stage_block(uint8_t* stage, const StagePlan plan[SHA_CHUNKS],
                        uintptr_t zero_src, int k) {
  SHA_UNROLL
  for (int r = 0; r < SHA_CHUNKS; r++) {
    const int bytes = stage_bytes(plan[r], k);
    const unsigned d = (unsigned)__cvta_generic_to_shared(stage + plan[r].dst);
    const uintptr_t src = bytes ? plan[r].src + 64 * (uintptr_t)k : zero_src;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Block k + 1's copies go out before block k's row is read, so that they
// fly while the schedule warp pads and expands block k and the round warp
// compresses block k - 1.  The schedule warp hands each block's 64 words
// W[t] + K[t] over in wk[k & 1] ([quad][lane][4]: a quarter warp's 16-byte
// reads of one quad are 128 contiguous bytes), barrier 1 + (k & 1) when it
// is full, and waits for barrier 3 + (k & 1), which the round warp arrives
// at when it has compressed the block that buffer held before.
extern "C" __global__ void __launch_bounds__(64)
fdt_sha256_blocks(const uint8_t* __restrict__ msgs, const void* __restrict__ lens,
                  int lens64, uint8_t* __restrict__ out, int B, int64_t width) {
  __shared__ __align__(16) uint8_t stage[2][32 * SHA_ROW];
  __shared__ __align__(16) uint32_t wk_sm[2][16 * 32 * 4];
  const int t = threadIdx.x & 31;
  const int64_t lane0 = (int64_t)blockIdx.x * 32;
  const int64_t lane = lane0 + t;
  int64_t len = 0;
  if (lane < B)
    len = lens64 ? ((const int64_t*)lens)[lane] : ((const int32_t*)lens)[lane];
  const int64_t nblk = padded_blocks(len);
  const int n = lane_blocks(nblk, width, lane < B);
  const int group_n = (int)__reduce_max_sync(0xffffffffu, (unsigned)n);

  if (threadIdx.x >= 32) {  // the schedule warp: stage, pad, expand
    const int o = row_offset((uintptr_t)msgs, lane, width);
    const uintptr_t zero_src = (uintptr_t)msgs & ~(uintptr_t)15;
    StagePlan plan[SHA_CHUNKS];
    SHA_UNROLL
    for (int r = 0; r < SHA_CHUNKS; r++)
      plan[r] = stage_plan((uintptr_t)msgs, t, r, lane0, B, width);
    if (group_n > 0) stage_block(stage[0], plan, zero_src, 0);
    for (int k = 0; k < group_n; k++) {
      if (k + 1 < group_n) {
        stage_block(stage[(k + 1) & 1], plan, zero_src, k + 1);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncwarp();
      uint32_t m[16], wk[64];
      stage_words(stage[k & 1] + t * SHA_ROW, o, m);
      __syncwarp();  // every read of this stage before it is staged again
      // only where a lane of the warp still hashing reaches its message's end
      if (__any_sync(0xffffffffu, k < n && 64 * (int64_t)k + 64 > len)) pad_block(m, len, k, nblk);
      sha_expand(m, wk);
      if (k >= 2) sha_bar_sync(3 + (k & 1));
      uint4* dst = reinterpret_cast<uint4*>(wk_sm[k & 1]) + t;
      SHA_UNROLL
      for (int q = 0; q < 16; q++)
        dst[32 * q] = make_uint4(wk[4 * q], wk[4 * q + 1], wk[4 * q + 2], wk[4 * q + 3]);
      sha_bar_arrive(1 + (k & 1));
    }
  } else {  // the round warp
    uint32_t s[8];
    SHA_UNROLL
    for (int i = 0; i < 8; i++) s[i] = h256(i);
    for (int k = 0; k < group_n; k++) {
      sha_bar_sync(1 + (k & 1));
      const uint4* src = reinterpret_cast<const uint4*>(wk_sm[k & 1]) + t;
      uint32_t wk[64];
      SHA_UNROLL
      for (int q = 0; q < 16; q++) {
        const uint4 v = src[32 * q];
        wk[4 * q] = v.x;
        wk[4 * q + 1] = v.y;
        wk[4 * q + 2] = v.z;
        wk[4 * q + 3] = v.w;
      }
      if (k < n) sha_rounds(s, wk);
      if (k + 2 < group_n) sha_bar_arrive(3 + (k & 1));
    }
    if (lane < B) store_words8(out + lane * 32, s);
  }
}

// 32 lanes a block: poh_split's two warps, then the round warp's mixin
extern "C" __global__ void __launch_bounds__(64)
fdt_poh_chain(const uint8_t* __restrict__ state,
              const int32_t* __restrict__ n_plain,
              const uint8_t* __restrict__ mixin,
              const uint8_t* __restrict__ has_mixin,
              uint8_t* __restrict__ out, int B) {
  __shared__ uint32_t st_sm[8 * 32], wk_sm[48 * 32];
  const int64_t lane = (int64_t)blockIdx.x * 32 + (threadIdx.x & 31);
  const bool live = lane < B;
  const int32_t n = live ? n_plain[lane] : 0;
  const int32_t group_n = (int32_t)__reduce_max_sync(0xffffffffu, (unsigned)(n > 0 ? n : 0));
  uint32_t s[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (live) load_words8(state + lane * 32, s);
  poh_split(s, n, group_n, st_sm, wk_sm);
  if (threadIdx.x >= 32 || !live) return;
  if (has_mixin[lane]) {
    uint32_t mix[8];
    load_words8(mixin + lane * 32, mix);
    sha256_of_64(s, mix);
  }
  store_words8(out + lane * 32, s);
}

static inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }


extern "C" cudaError_t fdt_sha256_blocks_launch(const uint8_t* msgs,
                                                const void* lens, int lens64,
                                                uint8_t* out, int B,
                                                int64_t width, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (!aligned16(out)) return cudaErrorMisalignedAddress;
  fdt_sha256_blocks<<<(B + 31) / 32, 64, 0, (cudaStream_t)stream>>>(
      msgs, lens, lens64, out, B, width);
  return cudaGetLastError();
}

extern "C" cudaError_t fdt_poh_chain_launch(const uint8_t* state,
                                            const int32_t* n_plain,
                                            const uint8_t* mixin,
                                            const uint8_t* has_mixin,
                                            uint8_t* out, int B,
                                            void* stream) {
  if (B <= 0) return cudaSuccess;
  if (!aligned16(state) || !aligned16(mixin) || !aligned16(out))
    return cudaErrorMisalignedAddress;
  fdt_poh_chain<<<(B + 31) / 32, 64, 0, (cudaStream_t)stream>>>(
      state, n_plain, mixin, has_mixin, out, B);
  return cudaGetLastError();
}

#else  // plain C++: the host build the CPU tests hold against hashlib

static inline uint32_t be_word(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3];
}

static inline void put_be_words8(uint8_t* p, const uint32_t w[8]) {
  for (int i = 0; i < 8; i++)
    for (int b = 0; b < 4; b++) p[4 * i + b] = (uint8_t)(w[i] >> (24 - 8 * b));
}

static inline int64_t lane_len(const void* lens, int lens64, int64_t lane) {
  return lens64 ? ((const int64_t*)lens)[lane] : ((const int32_t*)lens)[lane];
}

// The kernel's warps one after another: each block k of a warp's lanes
// staged by the 32 threads' five chunks (stage_chunk) into a buffer laid
// out as the kernel's shared memory, then each lane's row read back at its
// offset, padded and compressed.  The bytes a chunk holds before msgs'
// first byte are not read here (zeros: the kernel reads and drops them).
extern "C" void fdt_sha256_blocks_host(const uint8_t* msgs, const void* lens,
                                       int lens64, uint8_t* out, int B,
                                       int64_t width) {
  const uintptr_t base = (uintptr_t)msgs;
  uint8_t stage[32 * SHA_ROW];
  for (int64_t lane0 = 0; lane0 < B; lane0 += 32) {
    int64_t len[32], nblk[32];
    int n[32], warp_n = 0;
    uint32_t s[32][8];
    for (int t = 0; t < 32; t++) {
      const bool live = lane0 + t < B;
      len[t] = live ? lane_len(lens, lens64, lane0 + t) : 0;
      nblk[t] = padded_blocks(len[t]);
      n[t] = lane_blocks(nblk[t], width, live);
      warp_n = n[t] > warp_n ? n[t] : warp_n;
      for (int i = 0; i < 8; i++) s[t][i] = h256(i);
    }
    for (int k = 0; k < warp_n; k++) {
      for (int t = 0; t < 32; t++)
        for (int r = 0; r < SHA_CHUNKS; r++) {
          const StagePlan p = stage_plan(base, t, r, lane0, B, width);
          const int bytes = stage_bytes(p, k);
          const uintptr_t src = p.src + 64 * (uintptr_t)k;
          for (int b = 0; b < 16; b++)
            stage[p.dst + b] = b < bytes && src + b >= base ? msgs[(src + b) - base] : 0;
        }
      for (int t = 0; t < 32; t++) {
        if (k >= n[t]) continue;
        uint32_t m[16], wk[64];
        stage_words(stage + t * SHA_ROW, row_offset(base, lane0 + t, width), m);
        pad_block(m, len[t], k, nblk[t]);
        sha_expand(m, wk);
        sha_rounds(s[t], wk);
      }
    }
    for (int t = 0; t < 32 && lane0 + t < B; t++) put_be_words8(out + (lane0 + t) * 32, s[t]);
  }
}

extern "C" void fdt_poh_chain_host(const uint8_t* state, const int32_t* n_plain,
                                   const uint8_t* mixin, const uint8_t* has_mixin,
                                   uint8_t* out, int B) {
  for (int64_t lane = 0; lane < B; lane++) {
    uint32_t s[8], mix[8];
    for (int i = 0; i < 8; i++) {
      s[i] = be_word(state + lane * 32 + 4 * i);
      mix[i] = be_word(mixin + lane * 32 + 4 * i);
    }
    poh_words(s, n_plain[lane], has_mixin[lane] != 0, mix);
    put_be_words8(out + lane * 32, s);
  }
}

#endif
