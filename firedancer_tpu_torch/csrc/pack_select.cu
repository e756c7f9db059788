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
//                          K, W2, cu_limit, txn_limit, stream)
//   fdt_pack_select_chain_probe_launch(words (64,), n, cycles (1,) int64,
//                          sink (1,), stream)
//     one warp runs n dependent steps of the scan's decision on register
//     words and reports the clock64 cycles: the chain floor's step.
//
// What bounds it: the scan is sequential, each decision depends on the one
// before, and its bytes are few (2 K W2 4 + 8 K: ~270 KB at K = 1024,
// W2 = 32, 0.08 us at the card's memory rate).  So the dependent chain sets
// the time: per candidate two three-input logic ops over the held words, a
// warp vote, the 64-bit budget compare and the predicated ORs, some 20-40
// cycles, K times, on one SM.
//
// Design: one block.  Up to W2 = 256 it is one warp: lane t holds words
// t, t + 32, ... of the two selected sets in registers (NW words each), every
// candidate row is one coalesced read, __any_sync gives the conflict, and
// every lane carries cu_used and taken identically, so no shuffle is
// needed; lane 0 writes the take.  Wider rows take ceil(W2 / 256) warps of
// eight words a thread and vote with __syncthreads_or (W2 <= 8192).  The
// loads do not depend on the chain: each thread keeps the next PS_AHEAD
// candidates' words in a register ring, refilled right after a candidate
// is decided, so the loop waits on the chain and not on memory.  A simple
// kernel: the whole card but one SM idles, and the chain is its time.
//
// Compiled without __CUDACC__ (plain C++), fdt_pack_select_host runs the
// same decision (ps_fits, ps_word_hit) over the words in order; the CPU
// tests hold it against select_plain and a Python greedy.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PS_FN __host__ __device__ __forceinline__
#else
#include <vector>
#define PS_FN static inline
#endif

#define PS_WARP 32
// most words of each selected set a thread holds, and the widest row
#define PS_NW_MAX 8
#define PS_MAX_THREADS 1024
#define PS_MAX_W2 (PS_NW_MAX * PS_MAX_THREADS)
// candidates whose words are in flight ahead of the one being decided (16
// measured the same as 4 at K = 1024 on an H100, so the loads are covered)
#define PS_AHEAD 4

// The budget half of a decision: cu_used + cost <= cu_limit, written so
// that it cannot overflow while cu_used <= cu_limit, and taken < txn_limit.
PS_FN int ps_fits(int64_t cost, int64_t cu_used, int64_t cu_limit,
                  int64_t taken, int64_t txn_limit) {
  return cost <= cu_limit - cu_used && taken < txn_limit;
}

// The conflict half, one word: candidate writes a selected bit, or touches
// a selected writable bit.
PS_FN uint32_t ps_word_hit(uint32_t c_rw, uint32_t c_w, uint32_t s_rw,
                           uint32_t s_w) {
  return (c_w & s_rw) | (c_rw & s_w);
}

// Threads of the block for a row of W2 words: one warp up to
// PS_WARP * PS_NW_MAX words, else a warp per PS_WARP * PS_NW_MAX.
PS_FN int ps_threads(int W2) {
  const int per_warp = PS_WARP * PS_NW_MAX;
  return W2 <= per_warp ? PS_WARP : PS_WARP * ((W2 + per_warp - 1) / per_warp);
}

#ifdef __CUDACC__

template <int NW>
__device__ __forceinline__ void ps_load(uint32_t (&rw)[NW], uint32_t (&w)[NW],
                                        int64_t& cost,
                                        const uint32_t* __restrict__ cand_rw,
                                        const uint32_t* __restrict__ cand_w,
                                        const int64_t* __restrict__ costs,
                                        int i, int K, int W2, int t, int T) {
  if (i >= K) return;
  const int64_t row = (int64_t)i * W2;
#pragma unroll
  for (int m = 0; m < NW; m++) {
    const int j = t + m * T;
    rw[m] = j < W2 ? __ldg(cand_rw + row + j) : 0u;
    w[m] = j < W2 ? __ldg(cand_w + row + j) : 0u;
  }
  cost = __ldg(costs + i);
}

// One warp's variants may use up to 255 registers a thread; the multi-warp
// variant (rows over 256 words) is held to 64 by its 1024 threads.
template <int NW, bool MULTI>
__global__ void __launch_bounds__(MULTI ? PS_MAX_THREADS : PS_WARP)
pack_select_kernel(const uint32_t* __restrict__ cand_rw,
                   const uint32_t* __restrict__ cand_w,
                   const uint32_t* __restrict__ in_use_rw,
                   const uint32_t* __restrict__ in_use_w,
                   const int64_t* __restrict__ costs,
                   uint8_t* __restrict__ take, int K, int W2,
                   int64_t cu_limit, int64_t txn_limit) {
  const int t = threadIdx.x, T = blockDim.x;
  uint32_t srw[NW], sw[NW];
#pragma unroll
  for (int m = 0; m < NW; m++) {
    const int j = t + m * T;
    srw[m] = j < W2 ? in_use_rw[j] : 0u;
    sw[m] = j < W2 ? in_use_w[j] : 0u;
  }
  uint32_t brw[PS_AHEAD][NW], bw[PS_AHEAD][NW];
  int64_t bc[PS_AHEAD];
#pragma unroll
  for (int d = 0; d < PS_AHEAD; d++) {
    bc[d] = 0;
    ps_load<NW>(brw[d], bw[d], bc[d], cand_rw, cand_w, costs, d, K, W2, t, T);
  }
  int64_t cu_used = 0, taken = 0;
  for (int i0 = 0; i0 < K; i0 += PS_AHEAD) {
#pragma unroll
    for (int d = 0; d < PS_AHEAD; d++) {
      const int i = i0 + d;
      if (i >= K) break;  // uniform: every thread sees the same i
      uint32_t hit = 0;
#pragma unroll
      for (int m = 0; m < NW; m++)
        hit |= ps_word_hit(brw[d][m], bw[d][m], srw[m], sw[m]);
      const int conflict = MULTI ? __syncthreads_or(hit != 0)
                                 : __any_sync(0xffffffffu, hit != 0);
      const int tk = !conflict &&
                     ps_fits(bc[d], cu_used, cu_limit, taken, txn_limit);
      const uint32_t mask = tk ? 0xffffffffu : 0u;
#pragma unroll
      for (int m = 0; m < NW; m++) {
        srw[m] |= brw[d][m] & mask;
        sw[m] |= bw[d][m] & mask;
      }
      cu_used += tk ? bc[d] : 0;
      taken += tk;
      if (t == 0) take[i] = (uint8_t)tk;
      ps_load<NW>(brw[d], bw[d], bc[d], cand_rw, cand_w, costs,
                  i + PS_AHEAD, K, W2, t, T);
    }
  }
}

// n dependent decisions of one warp on register words, timed with clock64:
// the scan's chain without its loads (the candidate's words change every
// step through a multiply that is off the chain).
__global__ void pack_select_chain_probe(const uint32_t* __restrict__ words,
                                        int64_t n, long long* cycles,
                                        uint32_t* sink) {
  const int t = threadIdx.x;
  uint32_t crw = words[t], cw = words[PS_WARP + t], srw = 0, sw = 0;
  int64_t cu_used = 0, taken = 0;
  const long long c0 = clock64();
  for (int64_t k = 0; k < n; k++) {
    const uint32_t hit = ps_word_hit(crw, cw, srw, sw);
    const int tk = !__any_sync(0xffffffffu, hit != 0) &&
                   ps_fits(1, cu_used, n, taken, n);
    const uint32_t mask = tk ? 0xffffffffu : 0u;
    srw |= crw & mask;
    sw |= cw & mask;
    cu_used += tk;
    taken += tk;
    crw = crw * 0x9E3779B1u + 0x7F4A7C15u;
    cw = cw * 0x85EBCA77u + 0xC2B2AE3Du;
  }
  const long long c1 = clock64();
  if (t == 0) {
    cycles[0] = c1 - c0;
    sink[0] = srw ^ sw ^ (uint32_t)taken;
  }
}

extern "C" cudaError_t fdt_pack_select_launch(
    const uint32_t* cand_rw, const uint32_t* cand_w, const uint32_t* in_use_rw,
    const uint32_t* in_use_w, const int64_t* costs, uint8_t* take, int K,
    int W2, int64_t cu_limit, int64_t txn_limit, void* stream) {
  if (K <= 0) return cudaSuccess;
  if (W2 < 1 || W2 > PS_MAX_W2) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int T = ps_threads(W2);
  const int nw = (W2 + T - 1) / T;
  if (T > PS_WARP)
    pack_select_kernel<PS_NW_MAX, true><<<1, T, 0, s>>>(
        cand_rw, cand_w, in_use_rw, in_use_w, costs, take, K, W2, cu_limit,
        txn_limit);
  else if (nw <= 1)
    pack_select_kernel<1, false><<<1, T, 0, s>>>(
        cand_rw, cand_w, in_use_rw, in_use_w, costs, take, K, W2, cu_limit,
        txn_limit);
  else if (nw <= 2)
    pack_select_kernel<2, false><<<1, T, 0, s>>>(
        cand_rw, cand_w, in_use_rw, in_use_w, costs, take, K, W2, cu_limit,
        txn_limit);
  else if (nw <= 4)
    pack_select_kernel<4, false><<<1, T, 0, s>>>(
        cand_rw, cand_w, in_use_rw, in_use_w, costs, take, K, W2, cu_limit,
        txn_limit);
  else
    pack_select_kernel<PS_NW_MAX, false><<<1, T, 0, s>>>(
        cand_rw, cand_w, in_use_rw, in_use_w, costs, take, K, W2, cu_limit,
        txn_limit);
  return cudaGetLastError();
}

extern "C" cudaError_t fdt_pack_select_chain_probe_launch(
    const uint32_t* words, int64_t n, long long* cycles, uint32_t* sink,
    void* stream) {
  pack_select_chain_probe<<<1, PS_WARP, 0, (cudaStream_t)stream>>>(
      words, n, cycles, sink);
  return cudaGetLastError();
}

#else  // plain C++: the host build the CPU tests hold against select_plain

extern "C" void fdt_pack_select_host(const uint32_t* cand_rw,
                                     const uint32_t* cand_w,
                                     const uint32_t* in_use_rw,
                                     const uint32_t* in_use_w,
                                     const int64_t* costs, uint8_t* take,
                                     int K, int W2, int64_t cu_limit,
                                     int64_t txn_limit) {
  std::vector<uint32_t> srw(in_use_rw, in_use_rw + W2);
  std::vector<uint32_t> sw(in_use_w, in_use_w + W2);
  int64_t cu_used = 0, taken = 0;
  for (int i = 0; i < K; i++) {
    const uint32_t* rw = cand_rw + (int64_t)i * W2;
    const uint32_t* w = cand_w + (int64_t)i * W2;
    uint32_t hit = 0;
    for (int j = 0; j < W2; j++) hit |= ps_word_hit(rw[j], w[j], srw[j], sw[j]);
    const int tk = hit == 0 &&
                   ps_fits(costs[i], cu_used, cu_limit, taken, txn_limit);
    if (tk) {
      for (int j = 0; j < W2; j++) {
        srw[j] |= rw[j];
        sw[j] |= w[j];
      }
      cu_used += costs[i];
      taken++;
    }
    take[i] = (uint8_t)tk;
  }
}

#endif
