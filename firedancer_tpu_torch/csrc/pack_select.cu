// pack_select.cu -- the pack engine's greedy conflict scan for NVIDIA
// Hopper (sm_90a).
//
// Replaces an XLA function of the JAX package (not a Pallas kernel):
// firedancer_tpu/ops/pack_select.py :: _select_impl, one compiled lax.scan
// over the K priority-ordered candidates.  In eager PyTorch that scan is a
// Python loop of about 15 launches per candidate (ops/pack_select.py ::
// select_plain), some 250 ms at K = 1024, while the pack tile schedules a
// microblock per bank every 2 ms.
//
// What it computes: walk candidates i = 0..K-1 in order; take i iff its
// writable bits miss every selected bit (W vs RW), its bits miss every
// selected writable bit (RW vs W), cu_used + cost[i] <= cu_limit and
// taken < txn_limit; a take ORs its bits into the selected sets and adds
// its cost.  The selected sets start as in_use_rw / in_use_w.  Bitsets are
// W2 32-bit words per row (the host's u64 words split little-endian).
//
// Interface:
//   fdt_pack_select_launch(cand_rw (K, W2), cand_w (K, W2), in_use_rw (W2,),
//                          in_use_w (W2,), costs (K,) int64, take (K,) u8,
//                          stats (4,) int64 or NULL, K, W2, cu_limit,
//                          txn_limit, stream)
//     stats: the chain's steps, then the clock64 cycles of staging and
//     phase 1 (with the live list), of phase 2 and of the whole kernel
//   fdt_pack_select_call(src[5], off[6], host_in, dev_in, host_out, dev_out,
//                        K, W2, cu_limit, txn_limit, stream)
//     one select of the host's rows: the five inputs src (cand_rw,
//     cand_w, in_use_rw, in_use_w as 32-bit words or their u64 pairs,
//     costs) are copied into the pinned block host_in at the byte offsets
//     off[0..4] (off[i + 1] - off[i] bytes each; off[5] is the block's
//     end: the caller owns the layout), the block to dev_in; the kernel
//     reads the same offsets in dev_in and writes dev_out = stats (4,)
//     int64 | take (K,) u8, copied back to host_out; all on `stream`,
//     which the call then waits for.  One copy each way, one launch, and
//     the caller (ctypes) holds no interpreter lock throughout.
//   fdt_pack_select_seg_rows(W2)
//     rows of one segment at width W2 (ps_seg_rows; both builds export it)
//   fdt_pack_select_chain_probe_launch(words (65,), n, take_steps,
//                          cycles (1,) int64, sink (1,), stream)
//     the chain's warps run n steps on rows in shared memory (each a take
//     when take_steps, else none) and report the clock64 cycles.
//
// What bounds it: each take depends on every take before it, and its bytes
// are few (2 K W2 4 + 8 K: ~270 KB at K = 1024, W2 = 32, 0.08 us at the
// card's memory rate), so the dependent chain sets the time.  A chain of K
// decisions (one warp, one candidate a step) costs ~75 cycles a candidate.
//
// Design: the chain's depth is takes, not K.  Only a take changes the
// state; the selected sets only grow and cu_used and taken only rise, so a
// row that fails at some state fails at every later one, and the next take
// after a take is the first later row that passes against the current
// state.  One block of 1024 threads; per segment of ps_seg_rows(W2) rows:
//   staging: up to PS_STAGE_MAX_W2 words the block copies the segment's
//     rows and costs into shared memory with cp.async, every thread 16
//     bytes a copy: one SM's fastest way in (a ring of gathered live-row
//     chunks, or one bulk copy per 64-row tile, ran slower on the card);
//     wider rows stay in global memory;
//   phase 1: every row against the current state, in parallel: the budget
//     one row a lane (a ballot), the conflicts one row at a time with
//     lane = word (a vote); the live mask is compacted into a list in
//     shared memory (pad rows, in-use conflicts and rows over budget die
//     here; take = 0);
//   phase 2: PS_CHAIN_WARPS warps walk a window of the next 32 live rows,
//     four rows a warp, against their own copies of the selected sets
//     (registers, up to 64 words), the budget beside each; a ballot through
//     shared memory and the chain's barrier find the first passer; a take
//     ORs its row into every chain warp's sets and adds its cost and count
//     (no barrier), and the window restarts right after it; a window with
//     no passer retires whole.  It stops when taken == txn_limit or no
//     live row is left.
// So a segment takes at most ceil(live / 32) + takes steps; the step count
// goes to `stats`.

// Compiled without __CUDACC__ (plain C++), fdt_pack_select_host runs the
// same two phases in the same step order and counts the same steps; the CPU
// tests hold it against select_plain and a Python greedy.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#include <string.h>
#define PS_FN __host__ __device__ __forceinline__
#else
#include <vector>
#define PS_FN static inline
#endif

#define PS_WARP 32
#define PS_THREADS 1024
#define PS_WARPS (PS_THREADS / PS_WARP)
// rows a chain step tests, the warps that test them, and rows a warp
#define PS_WINDOW 32
#define PS_CHAIN_WARPS 8
#define PS_ROWS_PER_WARP (PS_WINDOW / PS_CHAIN_WARPS)
// most rows of a segment (the live list's length), and their groups of 32
#define PS_SEG_MAX 4096
#define PS_GROUPS (PS_SEG_MAX / PS_WARP)
// widest row held in shared memory: 2 words a lane
#define PS_STAGE_MAX_W2 (2 * PS_WARP)
// widest row: the two selected sets fill 64 KB of shared memory
#define PS_MAX_W2 8192

// The budget half of a decision: cu_used + cost <= cu_limit, written so
// that it cannot overflow while cu_used <= cu_limit, and taken < txn_limit.
PS_FN int ps_fits(int64_t cost, int64_t cu_used, int64_t cu_limit,
                  int64_t taken, int64_t txn_limit) {
  return (cost <= cu_limit - cu_used) & (taken < txn_limit);
}

// The conflict half, one word: candidate writes a selected bit, or touches
// a selected writable bit.
PS_FN uint32_t ps_word_hit(uint32_t c_rw, uint32_t c_w, uint32_t s_rw,
                           uint32_t s_w) {
  return (c_w & s_rw) | (c_rw & s_w);
}

// Words of a row each lane holds when segments are staged (0: not staged).
PS_FN int ps_nw(int W2) {
  return W2 <= PS_WARP ? 1 : W2 <= PS_STAGE_MAX_W2 ? 2 : 0;
}

// Rows of a segment: staged, 128 KB of rows (512 rows up to 32 words, 256
// up to 64); else PS_SEG_MAX.
PS_FN int ps_seg_rows(int W2) {
  return W2 <= PS_WARP ? 512 : W2 <= PS_STAGE_MAX_W2 ? 256 : PS_SEG_MAX;
}

// Dynamic shared memory of the kernel: a staged segment's rows and costs
// (staged), the chain's budget state, the selected sets, the live bits and
// offsets, the ballot flags (two buffers) and the live list.
PS_FN size_t ps_smem_bytes(int W2) {
  const size_t rows = ps_nw(W2) ? (size_t)ps_seg_rows(W2) : 0;
  return rows * 2 * W2 * 4 + rows * 8 + 2 * 8 + (size_t)2 * W2 * 4 +
         (PS_GROUPS + PS_GROUPS + 1 + 2 * PS_WINDOW) * 4 + PS_SEG_MAX * 2;
}

#ifdef __CUDACC__

__device__ __forceinline__ uint32_t ps_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ps_cp_async(void* smem, const void* gmem,
                                            int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     ps_smem_addr(smem)),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     ps_smem_addr(smem)),
                 "l"(gmem)
                 : "memory");
}

// The block copies `bytes` (a multiple of 4) from global to shared memory
// with cp.async: 16 bytes a copy when both ends are 16-byte aligned (vec),
// the rest 4 bytes a copy.
__device__ __forceinline__ void ps_stage(void* dst, const void* src,
                                         size_t bytes, int vec) {
  const int t = threadIdx.x;
  const size_t n16 = vec ? bytes / 16 : 0;
  for (size_t i = t; i < n16; i += PS_THREADS)
    ps_cp_async((char*)dst + 16 * i, (const char*)src + 16 * i, 16);
  for (size_t i = 16 * n16 / 4 + t; i < bytes / 4; i += PS_THREADS)
    ps_cp_async((char*)dst + 4 * i, (const char*)src + 4 * i, 4);
}

// The chain's barrier: its PS_CHAIN_WARPS warps only (the others wait at
// the block's barrier after the chain).
__device__ __forceinline__ void ps_chain_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(PS_CHAIN_WARPS * PS_WARP) : "memory");
}

// NW > 0: a segment's rows and costs are staged whole in shared memory
// (cp.async by the block), and each chain warp keeps its own copy of the
// selected sets in registers (lane m holds words lane + 32 m), so a take
// needs no barrier.  NW == 0: wider rows read from global memory, the sets
// in shared memory, a chain barrier after each take.  vec: the rows and
// costs are 16-byte aligned (the host checks), so the copies take 16 bytes.
template <int NW>
__global__ void __launch_bounds__(PS_THREADS)
pack_select_kernel(const uint32_t* __restrict__ cand_rw,
                   const uint32_t* __restrict__ cand_w,
                   const uint32_t* __restrict__ in_use_rw,
                   const uint32_t* __restrict__ in_use_w,
                   const int64_t* __restrict__ costs,
                   uint8_t* __restrict__ take, int64_t* __restrict__ stats,
                   int K, int W2, int64_t cu_limit, int64_t txn_limit,
                   int vec) {
  extern __shared__ __align__(16) unsigned char ps_smem[];
  const int t = threadIdx.x, lane = t & (PS_WARP - 1), warp = t / PS_WARP;
  const int seg = ps_seg_rows(W2);
  const int rows = NW ? seg : 0;
  uint32_t* g_rw = (uint32_t*)ps_smem;  // the staged segment, NW > 0
  uint32_t* g_w = g_rw + rows * W2;
  int64_t* g_cost = (int64_t*)(g_w + rows * W2);
  int64_t* s_state = g_cost + rows;  // the chain's cu_used, taken
  // the sets: NW == 0 for the whole run, NW > 0 to hand them over between
  // segments (the chain warps' registers to every warp's)
  uint32_t* s_rw = (uint32_t*)(s_state + 2);
  uint32_t* s_w = s_rw + W2;
  uint32_t* s_bits = s_w + W2;
  int* s_off = (int*)(s_bits + PS_GROUPS);  // PS_GROUPS + 1: the total last
  int* s_pass = s_off + PS_GROUPS + 1;      // two buffers of PS_WINDOW
  uint16_t* s_live = (uint16_t*)(s_pass + 2 * PS_WINDOW);

  for (int j = t; j < W2; j += PS_THREADS) {
    s_rw[j] = in_use_rw[j];
    s_w[j] = in_use_w[j];
  }
  __syncthreads();
  // the chain's state: every thread holds a copy (the chain warps' is
  // the live one within a segment)
  int64_t cu_used = 0, taken = 0, steps = 0;
  int parity = 0;
  const long long t_start = clock64();
  long long t_phase1 = 0, t_chain = 0;
  for (int s0 = 0; s0 < K; s0 += seg) {
    const long long t_seg = clock64();
    const int n = min(seg, K - s0);
    const int groups = (n + PS_WARP - 1) / PS_WARP;
    // the selected sets as they stand (NW > 0: registers, lane + 32 m;
    // words past W2 are 0, so they hit nothing)
    uint32_t srw[NW ? NW : 1], sw[NW ? NW : 1];
#pragma unroll
    for (int m = 0; m < (NW ? NW : 1); m++) {
      const int j = lane + m * PS_WARP;
      srw[m] = NW && j < W2 ? s_rw[j] : 0u;
      sw[m] = NW && j < W2 ? s_w[j] : 0u;
    }
    if (NW) {
      // -- stage the segment (the block's reads of the last one are done)
      ps_stage(g_rw, cand_rw + (size_t)s0 * W2, (size_t)n * W2 * 4, vec);
      ps_stage(g_w, cand_w + (size_t)s0 * W2, (size_t)n * W2 * 4, vec);
      ps_stage(g_cost, costs + s0, (size_t)n * 8, vec);
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                       "memory");
      __syncthreads();
    }
    // -- phase 1: every row against the current state, in parallel --------
    // a warp takes 32 rows: the budget one row a lane, then the conflicts
    // one row at a time (lane = word); rows past n are read but dropped
    for (int g = warp; g < groups; g += PS_WARPS) {
      const int base = g * PS_WARP;
      const int mine = min(base + lane, n - 1);
      if (base + lane < n) take[s0 + base + lane] = 0;
      const int64_t c = NW ? g_cost[mine] : __ldg(costs + s0 + mine);
      const uint32_t fits = __ballot_sync(
          0xffffffffu,
          base + lane < n && ps_fits(c, cu_used, cu_limit, taken, txn_limit));
      uint32_t hits = 0;
      if (NW) {
        // words past W2 read the next row's (or the next array's): the
        // sets are 0 there
        const uint32_t* prw = g_rw + base * W2 + lane;
        const uint32_t* pw = g_w + base * W2 + lane;
#pragma unroll 8
        for (int r = 0; r < PS_WARP; r++) {
          uint32_t h = 0;
#pragma unroll
          for (int m = 0; m < (NW ? NW : 1); m++)
            h |= ps_word_hit(prw[r * W2 + m * PS_WARP], pw[r * W2 + m * PS_WARP],
                             srw[m], sw[m]);
          hits |= (uint32_t)__any_sync(0xffffffffu, h != 0) << r;
        }
      } else {
        // global loads in batches of 8 rows, no branch around a load (rows
        // past n read row n - 1), so that a batch's loads are all in flight
#pragma unroll 1
        for (int r0 = 0; r0 < PS_WARP; r0 += 8) {
          uint32_t h[8] = {0, 0, 0, 0, 0, 0, 0, 0};
          for (int j = lane; j < W2; j += PS_WARP) {
            const uint32_t a = s_rw[j], b = s_w[j];
#pragma unroll
            for (int u = 0; u < 8; u++) {
              const int64_t at =
                  (int64_t)(s0 + min(base + r0 + u, n - 1)) * W2 + j;
              h[u] |= ps_word_hit(__ldg(cand_rw + at), __ldg(cand_w + at), a, b);
            }
          }
#pragma unroll
          for (int u = 0; u < 8; u++)
            hits |= (uint32_t)__any_sync(0xffffffffu, h[u] != 0) << (r0 + u);
        }
      }
      if (lane == 0) s_bits[g] = fits & ~hits;
    }
    __syncthreads();
    // offsets of each group's live rows in the list: one warp's scan
    if (warp == 0) {
      constexpr int per = PS_GROUPS / PS_WARP;
      int cnt[per], sum = 0;
#pragma unroll
      for (int q = 0; q < per; q++) {
        const int g = lane * per + q;
        cnt[q] = g < groups ? __popc(s_bits[g]) : 0;
        sum += cnt[q];
      }
      int inc = sum;
#pragma unroll
      for (int d = 1; d < PS_WARP; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += v;
      }
      int run = inc - sum;
#pragma unroll
      for (int q = 0; q < per; q++) {
        s_off[lane * per + q] = run;
        run += cnt[q];
      }
      if (lane == PS_WARP - 1) s_off[PS_GROUPS] = inc;
    }
    __syncthreads();
    for (int g = warp; g < groups; g += PS_WARPS) {
      const uint32_t bits = s_bits[g];
      if ((bits >> lane) & 1u)
        s_live[s_off[g] + __popc(bits & ((1u << lane) - 1u))] =
            (uint16_t)(g * PS_WARP + lane);
    }
    const int n_live = s_off[PS_GROUPS];
    __syncthreads();
    const long long t_live = clock64();
    t_phase1 += t_live - t_seg;

    // -- phase 2: the chain over the live list, on PS_CHAIN_WARPS warps ----
    if (warp < PS_CHAIN_WARPS) {
      int p = 0;
      while (p < n_live && taken < txn_limit) {
        // warp w tests live rows p + 4 w .. p + 4 w + 3 (bit 4 w + u): every
        // load first, then the votes; no branch on a vote (rows past the
        // list read its last row and are dropped)
        int r[PS_ROWS_PER_WARP];
        uint32_t hit[PS_ROWS_PER_WARP];
        int64_t cost[PS_ROWS_PER_WARP];
#pragma unroll
        for (int u = 0; u < PS_ROWS_PER_WARP; u++)
          r[u] = s_live[min(p + PS_ROWS_PER_WARP * warp + u, n_live - 1)];
#pragma unroll
        for (int u = 0; u < PS_ROWS_PER_WARP; u++) {
          hit[u] = 0;
          if (NW) {
#pragma unroll
            for (int m = 0; m < (NW ? NW : 1); m++) {
              const int at = r[u] * W2 + lane + m * PS_WARP;
              hit[u] |= ps_word_hit(g_rw[at], g_w[at], srw[m], sw[m]);
            }
            cost[u] = g_cost[r[u]];
          } else {
            const int64_t row = (int64_t)(s0 + r[u]) * W2;
            for (int j = lane; j < W2; j += PS_WARP)
              hit[u] |= ps_word_hit(__ldg(cand_rw + row + j),
                                    __ldg(cand_w + row + j), s_rw[j], s_w[j]);
            cost[u] = __ldg(costs + s0 + r[u]);
          }
        }
        uint32_t bits = 0;
#pragma unroll
        for (int u = 0; u < PS_ROWS_PER_WARP; u++) {
          const int ok = (p + PS_ROWS_PER_WARP * warp + u < n_live) &
                         ps_fits(cost[u], cu_used, cu_limit, taken, txn_limit);
          const int clear = !__any_sync(0xffffffffu, hit[u] != 0);
          bits |= (uint32_t)(ok & clear) << u;
        }
        if (lane == 0) s_pass[parity * PS_WINDOW + warp] = bits;
        ps_chain_sync();
        const uint32_t mask = __reduce_or_sync(
            0xffffffffu, lane < PS_CHAIN_WARPS
                             ? (uint32_t)s_pass[parity * PS_WINDOW + lane]
                                   << (PS_ROWS_PER_WARP * lane)
                             : 0u);
        parity ^= 1;
        steps++;
        if (mask == 0) {  // uniform: no passer, the window retires whole
          p += PS_WINDOW;
          continue;
        }
        // the take: every chain warp ORs the row into its sets (NW > 0), or
        // the chain warps into the shared sets and a barrier (NW == 0)
        const int qt = p + __ffs(mask) - 1;
        const int rt = s_live[qt];
        if (NW) {
#pragma unroll
          for (int m = 0; m < (NW ? NW : 1); m++) {
            const int j = lane + m * PS_WARP;
            const uint32_t keep = j < W2 ? ~0u : 0u;
            srw[m] |= g_rw[rt * W2 + j] & keep;
            sw[m] |= g_w[rt * W2 + j] & keep;
          }
          cu_used += g_cost[rt];
        } else {
          for (int j = t; j < W2; j += PS_CHAIN_WARPS * PS_WARP) {
            s_rw[j] |= __ldg(cand_rw + (int64_t)(s0 + rt) * W2 + j);
            s_w[j] |= __ldg(cand_w + (int64_t)(s0 + rt) * W2 + j);
          }
          cu_used += __ldg(costs + s0 + rt);
        }
        taken++;
        if (t == 0) take[s0 + rt] = 1;
        p = qt + 1;
        if (!NW) ps_chain_sync();
      }
      // hand the state and the sets over to every warp
      if (t == 0) {
        s_state[0] = cu_used;
        s_state[1] = taken;
      }
      if (NW && warp == 0) {
#pragma unroll
        for (int m = 0; m < (NW ? NW : 1); m++) {
          const int j = lane + m * PS_WARP;
          if (j < W2) {
            s_rw[j] = srw[m];
            s_w[j] = sw[m];
          }
        }
      }
    }
    __syncthreads();
    cu_used = s_state[0];
    taken = s_state[1];
    t_chain += clock64() - t_live;
  }
  if (t == 0 && stats) {
    stats[0] = steps;
    stats[1] = t_phase1;
    stats[2] = t_chain;
    stats[3] = clock64() - t_start;
  }
}

// n chain steps as the staged kernel (NW = 1) runs them, timed with
// clock64: PS_CHAIN_WARPS warps each test PS_ROWS_PER_WARP rows held in
// shared memory (through the live list) against their register sets, the
// votes, the ballot through shared memory and the chain barrier; with
// take_steps the take: the first passer's row ORed into every warp's sets.
// words[64] is 0 (the OR keeps the sets clear, so every vote passes); the
// rows change every step through a multiply off the chain.
__global__ void __launch_bounds__(PS_CHAIN_WARPS * PS_WARP)
pack_select_chain_probe(const uint32_t* __restrict__ words, int64_t n,
                        int take_steps, long long* cycles, uint32_t* sink) {
  __shared__ uint32_t s_row[2][PS_WINDOW][PS_WARP];
  __shared__ int64_t s_cost[PS_WINDOW];
  __shared__ uint16_t s_idx[PS_WINDOW];
  __shared__ int s_pass[2 * PS_WINDOW];
  const int t = threadIdx.x, lane = t & (PS_WARP - 1), warp = t / PS_WARP;
  const uint32_t keep = words[2 * PS_WARP];
  for (int r = warp; r < PS_WINDOW; r += PS_CHAIN_WARPS) {
    s_row[0][r][lane] = words[lane] * (r + 1);
    s_row[1][r][lane] = words[PS_WARP + lane] * (r + 1);
    if (lane == 0) {
      s_cost[r] = 1;
      s_idx[r] = (uint16_t)(PS_WINDOW - 1 - r);
    }
  }
  __syncthreads();
  uint32_t srw = 0, sw = 0, salt = 0;
  int64_t cu_used = 0, taken = 0;
  int parity = 0;
  const long long c0 = clock64();
  for (int64_t k = 0; k < n; k++) {
    int r[PS_ROWS_PER_WARP];
    uint32_t hit[PS_ROWS_PER_WARP];
    int64_t cost[PS_ROWS_PER_WARP];
#pragma unroll
    for (int u = 0; u < PS_ROWS_PER_WARP; u++)
      r[u] = s_idx[PS_ROWS_PER_WARP * warp + u];
#pragma unroll
    for (int u = 0; u < PS_ROWS_PER_WARP; u++) {
      hit[u] = ps_word_hit(s_row[0][r[u]][lane] ^ salt, s_row[1][r[u]][lane],
                           srw, sw);
      cost[u] = s_cost[r[u]];
    }
    uint32_t bits = 0;
#pragma unroll
    for (int u = 0; u < PS_ROWS_PER_WARP; u++) {
      const int ok = take_steps & ps_fits(cost[u], cu_used, n, taken, n);
      const int clear = !__any_sync(0xffffffffu, hit[u] != 0);
      bits |= (uint32_t)(ok & clear) << u;
    }
    if (lane == 0) s_pass[parity * PS_WINDOW + warp] = bits;
    __syncthreads();
    const uint32_t mask = __reduce_or_sync(
        0xffffffffu, lane < PS_CHAIN_WARPS
                         ? (uint32_t)s_pass[parity * PS_WINDOW + lane]
                               << (PS_ROWS_PER_WARP * lane)
                         : 0u);
    parity ^= 1;
    if (mask != 0) {
      const int f = s_idx[__ffs(mask) - 1];
      srw |= s_row[0][f][lane] & keep;
      sw |= s_row[1][f][lane] & keep;
      cu_used += s_cost[f];
      taken++;
    }
    salt = salt * 0x9E3779B1u + 0x7F4A7C15u;
  }
  const long long c1 = clock64();
  if (t == 0) {
    cycles[0] = c1 - c0;
    sink[0] = srw ^ sw ^ salt ^ (uint32_t)taken;
  }
}

// Lets pack_select_kernel<NW> take the dynamic shared memory of its widest
// row (over 48 KB for every NW), once per device: the attribute is the
// kernel's on the current device, and a runtime call on every select would
// sit on the pack tile's path.
#define PS_MAX_DEVICES 64
template <int NW>
static cudaError_t ps_allow_smem() {
  static volatile bool done[PS_MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < PS_MAX_DEVICES && done[dev]) return cudaSuccess;
  const int widest = NW == 1 ? PS_WARP : NW == 2 ? PS_STAGE_MAX_W2 : PS_MAX_W2;
  err = cudaFuncSetAttribute(pack_select_kernel<NW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)ps_smem_bytes(widest));
  if (err == cudaSuccess && dev < PS_MAX_DEVICES) done[dev] = true;
  return err;
}

template <int NW>
static cudaError_t ps_launch_nw(const uint32_t* cand_rw,
                                const uint32_t* cand_w,
                                const uint32_t* in_use_rw,
                                const uint32_t* in_use_w,
                                const int64_t* costs, uint8_t* take,
                                int64_t* stats, int K, int W2,
                                int64_t cu_limit, int64_t txn_limit,
                                cudaStream_t s) {
  const cudaError_t err = ps_allow_smem<NW>();
  if (err != cudaSuccess) return err;
  const size_t smem = ps_smem_bytes(W2);
  const int vec = (uintptr_t)cand_rw % 16 == 0 &&
                  (uintptr_t)cand_w % 16 == 0 && (uintptr_t)costs % 16 == 0;
  pack_select_kernel<NW><<<1, PS_THREADS, smem, s>>>(
      cand_rw, cand_w, in_use_rw, in_use_w, costs, take, stats, K, W2,
      cu_limit, txn_limit, vec);
  return cudaGetLastError();
}

static cudaError_t ps_launch(const uint32_t* cand_rw, const uint32_t* cand_w,
                             const uint32_t* in_use_rw,
                             const uint32_t* in_use_w, const int64_t* costs,
                             uint8_t* take, int64_t* stats, int K, int W2,
                             int64_t cu_limit, int64_t txn_limit,
                             cudaStream_t s) {
  if (W2 < 1 || W2 > PS_MAX_W2) return cudaErrorInvalidValue;
  switch (ps_nw(W2)) {
    case 1:
      return ps_launch_nw<1>(cand_rw, cand_w, in_use_rw, in_use_w, costs, take,
                             stats, K, W2, cu_limit, txn_limit, s);
    case 2:
      return ps_launch_nw<2>(cand_rw, cand_w, in_use_rw, in_use_w, costs, take,
                             stats, K, W2, cu_limit, txn_limit, s);
    default:
      return ps_launch_nw<0>(cand_rw, cand_w, in_use_rw, in_use_w, costs, take,
                             stats, K, W2, cu_limit, txn_limit, s);
  }
}

extern "C" cudaError_t fdt_pack_select_launch(
    const uint32_t* cand_rw, const uint32_t* cand_w, const uint32_t* in_use_rw,
    const uint32_t* in_use_w, const int64_t* costs, uint8_t* take,
    int64_t* stats, int K, int W2, int64_t cu_limit, int64_t txn_limit,
    void* stream) {
  if (K <= 0) return cudaSuccess;
  return ps_launch(cand_rw, cand_w, in_use_rw, in_use_w, costs, take, stats,
                   K, W2, cu_limit, txn_limit, (cudaStream_t)stream);
}

extern "C" cudaError_t fdt_pack_select_call(
    const void* const* src, const size_t* off, void* host_in, void* dev_in,
    void* host_out, void* dev_out, int K, int W2, int64_t cu_limit,
    int64_t txn_limit, void* stream) {
  if (K <= 0 || W2 < 1 || W2 > PS_MAX_W2) return cudaErrorInvalidValue;
  for (int i = 0; i < 5; i++)
    memcpy((char*)host_in + off[i], src[i], off[i + 1] - off[i]);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemcpyAsync(dev_in, host_in, off[5], cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return err;
  const char* d = (const char*)dev_in;
  err = ps_launch((const uint32_t*)(d + off[0]), (const uint32_t*)(d + off[1]),
                  (const uint32_t*)(d + off[2]), (const uint32_t*)(d + off[3]),
                  (const int64_t*)(d + off[4]), (uint8_t*)dev_out + 32,
                  (int64_t*)dev_out, K, W2, cu_limit, txn_limit, s);
  if (err != cudaSuccess) return err;
  err = cudaMemcpyAsync(host_out, dev_out, 32 + (size_t)K,
                        cudaMemcpyDeviceToHost, s);
  if (err != cudaSuccess) return err;
  return cudaStreamSynchronize(s);
}

extern "C" cudaError_t fdt_pack_select_chain_probe_launch(
    const uint32_t* words, int64_t n, int take_steps, long long* cycles,
    uint32_t* sink, void* stream) {
  pack_select_chain_probe<<<1, PS_CHAIN_WARPS * PS_WARP, 0,
                            (cudaStream_t)stream>>>(
      words, n, take_steps, cycles, sink);
  return cudaGetLastError();
}

#else  // plain C++: the host build the CPU tests hold against select_plain

static int ps_row_passes(const uint32_t* rw, const uint32_t* w,
                         const std::vector<uint32_t>& srw,
                         const std::vector<uint32_t>& sw, int W2,
                         int64_t cost, int64_t cu_used, int64_t cu_limit,
                         int64_t taken, int64_t txn_limit) {
  uint32_t hit = 0;
  for (int j = 0; j < W2; j++) hit |= ps_word_hit(rw[j], w[j], srw[j], sw[j]);
  return hit == 0 && ps_fits(cost, cu_used, cu_limit, taken, txn_limit);
}

extern "C" void fdt_pack_select_host(const uint32_t* cand_rw,
                                     const uint32_t* cand_w,
                                     const uint32_t* in_use_rw,
                                     const uint32_t* in_use_w,
                                     const int64_t* costs, uint8_t* take,
                                     int64_t* stats, int K, int W2,
                                     int64_t cu_limit, int64_t txn_limit) {
  std::vector<uint32_t> srw(in_use_rw, in_use_rw + W2);
  std::vector<uint32_t> sw(in_use_w, in_use_w + W2);
  std::vector<int> live;
  int64_t cu_used = 0, taken = 0, steps = 0;
  const int seg = ps_seg_rows(W2);
  for (int s0 = 0; s0 < K; s0 += seg) {
    const int n = K - s0 < seg ? K - s0 : seg;
    // phase 1: every row of the segment against the current state
    live.clear();
    for (int i = s0; i < s0 + n; i++) {
      take[i] = 0;
      if (ps_row_passes(cand_rw + (int64_t)i * W2, cand_w + (int64_t)i * W2,
                        srw, sw, W2, costs[i], cu_used, cu_limit, taken,
                        txn_limit))
        live.push_back(i);
    }
    // phase 2: windows of PS_WINDOW live rows, the first passer taken
    const int n_live = (int)live.size();
    int p = 0;
    while (p < n_live && taken < txn_limit) {
      steps++;
      int f = -1;
      for (int q = p; q < p + PS_WINDOW && q < n_live && f < 0; q++)
        if (ps_row_passes(cand_rw + (int64_t)live[q] * W2,
                          cand_w + (int64_t)live[q] * W2, srw, sw, W2,
                          costs[live[q]], cu_used, cu_limit, taken, txn_limit))
          f = q;
      if (f < 0) {
        p += PS_WINDOW;
        continue;
      }
      const int i = live[f];
      for (int j = 0; j < W2; j++) {
        srw[j] |= cand_rw[(int64_t)i * W2 + j];
        sw[j] |= cand_w[(int64_t)i * W2 + j];
      }
      cu_used += costs[i];
      taken++;
      take[i] = 1;
      p = f + 1;
    }
  }
  if (stats) {  // the steps; the host build times nothing
    stats[0] = steps;
    stats[1] = stats[2] = stats[3] = 0;
  }
}

#endif

extern "C" int fdt_pack_select_seg_rows(int W2) { return ps_seg_rows(W2); }
