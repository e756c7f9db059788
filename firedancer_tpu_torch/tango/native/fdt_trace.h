/* Copy of firedancer_tpu/tango/native/fdt_trace.h, kept in the port so that
   firedancer_tpu_torch builds its ring library from its own sources. */

/* fdt_trace.h — in-burst observability for the native data plane.
 *
 * Reference model (behavior contract only; implementation original):
 * the reference stamps a compressed publish timestamp into every frag
 * meta as it is published (fd_frag_meta_ts_comp, fd_tango_base.h) and
 * histogram-samples inside the tile loop itself (fd_mux.c:435-444) —
 * measurement happens WHERE THE WORK HAPPENS, not at a batch boundary
 * after it.  This build's native stem (fdt_stem.c) ran the whole
 * drain→handle→publish burst in C but applied every latency sample and
 * span event from Python at the burst boundary with ONE post-burst
 * clock read, so on the native path all frags of a burst shared a
 * timestamp and tail percentiles were burst-quantized — exactly where "The Tail at Scale" (Dean & Barroso,
 * CACM 2013) says the tail matters, and the opposite of Dapper's
 * (Sigelman et al., 2010) always-on in-path span emission.  fdt_trace
 * moves the measurement substrate into the burst:
 *
 *   1. per-frag compressed timestamps: one coarse CLOCK_MONOTONIC read
 *      per frag at drain time and at publish time, in the SAME
 *      µs-mod-2^32 domain as disco.mux.now_ts / ts_diff;
 *   2. native log2-histogram updates: qwait/svc/e2e samples written
 *      straight into the tile's shared metrics hist words with
 *      disco/metrics.py Metrics.hist_sample's exact bucketing
 *      (floor(log2(max(v,1))) clamped to nb-1; sum += max(v,0));
 *   3. a native single-writer span emitter producing records
 *      byte-compatible with disco/trace.py's SpanRing (same 4-u64
 *      event layout, same reserve-before-store / commit-after-store
 *      cursor discipline, same 1-in-N sig-keyed sampling), so the
 *      Python reader tools (scripts/fdttrace.py, flight timelines)
 *      drain native and Python streams indistinguishably.
 *
 * The block is configured host-side (tango/rings.py Stem.arm_trace)
 * as a flat u64 word array; 0 pointers disable the matching feature so
 * an untraced stem pays nothing.  The injected-clock word exists for
 * the differential parity harness: a deterministic (value, step) pair
 * replaces the real clock so the native path's hists and span streams
 * can be asserted BIT-IDENTICAL to the Python loop's on the same frag
 * stream. */

#ifndef FDT_TRACE_H
#define FDT_TRACE_H

#include <stdint.h>

#define FDT_TRACE_MAGIC 0xf17eda2ce57e0002UL
#define FDT_TRACE_WORDS 128

/* ---- block word indices ------------------------------------------------ */

#define FDT_TRACE_W_MAGIC 0
/* span ring words base (disco/trace.py SpanRing layout: word0 committed
   cursor, word1 depth, word2 sample, word3 reserve cursor, events at
   word8 + (i % depth) * 4).  0 = span emission off. */
#define FDT_TRACE_W_RING 1
/* 1-in-N sig sampling (>= 1; 1 = every frag) — MUST match the Python
   Tracer's sample so the same frags are traced at every hop across
   native and Python tiles */
#define FDT_TRACE_W_SAMPLE 2
/* injected clock ptr (u64[2]: {value, step}; each read returns value
   then advances it by step).  0 = CLOCK_MONOTONIC.  Harness-only: the
   deterministic clock that makes native-vs-Python parity assertable. */
#define FDT_TRACE_W_CLOCK 3
/* buffered PUBLISH span rows (u64 (cap, 4)) + capacity + live count.
   Publish spans are BUFFERED during the handler and flushed after the
   batch's INGEST block so the ring's event order matches the Python
   loop's (ingest before that batch's publishes). */
#define FDT_TRACE_W_PUBROWS 4
#define FDT_TRACE_W_PUBCAP 5
#define FDT_TRACE_W_PUBCNT 6
/* u32[cap] drain-time per-frag timestamp scratch */
#define FDT_TRACE_W_TS 7
/* batch_sz hist (0 = off): sampled once per handled run, the Python
   loop's per-drained-batch hist_sample("batch_sz", n) */
#define FDT_TRACE_W_BATCH 8
#define FDT_TRACE_W_BATCH_NB 9
/* u64 (cap, 4) INGEST span row scratch: the batch's ingest events are
   assembled here and written as ONE block (Tracer.ingest's write
   granularity) before the buffered publish rows flush */
#define FDT_TRACE_W_INROWS 10

/* per-in block i at FDT_TRACE_IN0 + i * FDT_TRACE_IN_STRIDE:
   link id + (hist base ptr, bucket count) for qwait/e2e/svc.  A 0 hist
   ptr disables that sample (hand-built test ctxs without link hists). */
#define FDT_TRACE_IN0 16
#define FDT_TRACE_IN_STRIDE 8
#define FDT_TRACE_I_LINK 0
#define FDT_TRACE_I_QWAIT 1
#define FDT_TRACE_I_QWAIT_NB 2
#define FDT_TRACE_I_E2E 3
#define FDT_TRACE_I_E2E_NB 4
#define FDT_TRACE_I_SVC 5
#define FDT_TRACE_I_SVC_NB 6

/* per-out o at FDT_TRACE_OUT0 + o: the out link's span-event link id */
#define FDT_TRACE_OUT0 80

/* span kinds (disco/trace.py INGEST/PUBLISH) */
#define FDT_TRACE_K_INGEST 1
#define FDT_TRACE_K_PUBLISH 2

/* Layout self-description so the Python side can assert against drift. */
uint64_t fdt_trace_words( void );

/* One coarse compressed timestamp: CLOCK_MONOTONIC ns / 1000 mod 2^32 —
   the exact domain of disco.mux.now_ts (time.monotonic_ns() // 1000
   truncated to u32), so native and Python stamps interleave on one
   clock. */
uint32_t fdt_trace_now( void );

/* The trace block's clock: the injected (value, step) pair when armed,
   fdt_trace_now() otherwise.  tr must be a valid trace block. */
uint32_t fdt_trace_read_clock( uint64_t * tr );

/* Signed µs distance a - b mod 2^32 (positive: a after b) — the C
   restatement of disco.mux.ts_diff, valid while the true distance is
   under 2^31 µs.  Exported for the wrap-boundary differential test. */
int64_t fdt_trace_ts_diff( uint32_t a, uint32_t b );

/* One log2-hist sample with Metrics.hist_sample's exact semantics:
   bucket floor(log2(max(v,1))) clamped to nb-1; h[nb] += max(v,0);
   h[nb+1] += 1.  h points at the hist's first bucket word inside the
   tile's shared metrics region. */
void fdt_trace_hist_sample( uint64_t * h, int64_t nb, int64_t v );

/* Append a (k, 4) u64 event block to a SpanRing, byte-compatible with
   disco/trace.py SpanRing.write_block: reserve cursor bumped BEFORE the
   stores (seq_cst — release would let the event stores hoist above it,
   see fdt_trace.c), committed cursor after (release), oversized blocks
   keep their tail while the cursor advances by the full block.  Single
   writer: the owning tile's thread. */
void fdt_trace_span_block( uint64_t * ring, uint64_t const * rows,
                           int64_t k );

/* One span event (packs w0 = kind<<56 | link<<48 | aux16<<32 | ts and
   delegates to fdt_trace_span_block) — the unit-test / annotation
   entry point. */
void fdt_trace_span( uint64_t * ring, uint64_t kind, uint64_t link,
                     uint64_t aux16, uint64_t ts, uint64_t seq,
                     uint64_t sig, uint64_t aux64 );

#endif /* FDT_TRACE_H */
