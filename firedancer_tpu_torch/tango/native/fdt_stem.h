/* fdt_stem.h — GIL-released native inner loop for data-plane tiles.
 *
 * The port's copy of firedancer_tpu/tango/native/fdt_stem.h, trimmed to
 * the handlers the port's ingress, leader and validator paths use: dedup,
 * bank (fdt_bank_pipeline over the shared account table), pack (insert,
 * completions and the fdt_pack_sched after-credit hook), PoH, shred and
 * net (fdt_net.c: the tx burst and the rx after-credit hook).  The
 * elastic epoch watch (cfg words 14/15) is not carried; the words stay in
 * the layout, unused, and fdt_stem_run rejects an unknown handler id
 * (returns -1).
 *
 * Reference model (behavior contract only; implementation original):
 * fd_stem/fd_mux run the whole tile hot loop in C — poll the in
 * mcaches, invoke the tile callback, publish, update flow control —
 * without ever touching an interpreter (src/disco/stem/fd_stem.c,
 * src/disco/mux/fd_mux.c:90-707).  fdt_stem moves the per-burst mux
 * bookkeeping — drain, frag handling, publish, credit/fseq updates —
 * into ONE ctypes call: Python regains control only at the BURST
 * BOUNDARY (max_frags consumed, caught up, zero credits, or a frag that
 * needs the Python slow path), which is where housekeeping, heartbeats,
 * metrics flush and trace emission already live.
 *
 * The stem is configured through a flat u64 config block (see the
 * FDT_STEM_* word indices below) built host-side: raw pointers to the
 * SAME mcache/dcache/fseq/tcache regions the Python loop uses, so the
 * two loops are interchangeable mid-run and every ring op the stem
 * performs is one the Python loop performs too (fdt_mcache_publish's
 * invalidate→body→seq release ordering, drain's overrun resync,
 * fdt_fctl_cr_avail's credit bound).
 *
 * Handlers (FDT_STEM_H_*) are native re-statements of the tiles'
 * on_frags fast paths, bit-identical by contract and by test
 * (tests/test_torch_stem.py holds the port's stem, the JAX package's
 * stem and the port's Python loop against each other):
 *
 *   dedup — fdt_tcache_dedup_j with the journal discipline unchanged
 *     (arm slot 0 + out-seq BEFORE the insert, survivor-list rewrite to
 *     the inactive slot on zero-tag pass-throughs, phase cleared after
 *     the publish).
 *   bank — fdt_bank_pipeline: fdt_mb_decode + fdt_txn_scan +
 *     fdt_bank_exec fused into one call per microblock.  Anything the
 *     table path cannot express (a non-fast txn, a cold key, a
 *     NONTRIVIAL account) hands the frag back to Python UNCONSUMED — the
 *     journal's (tag, done) resume makes the partial fast prefix
 *     exactly-once.
 *   pack — the insert path: gather + txn_scan(+bitsets) + free-slot
 *     scatter into the pack engine's dense arrays.  The eviction path
 *     (pool full) bails to Python before mutating anything.  Completion
 *     rings (ins[1..]) release their microblocks natively.
 *   poh / shred — the block-egress bodies of fdt_poh.c / fdt_shred.c.
 *   net — fdt_net.c: tx sendmmsg straight from the in dcache, rx
 *     recvmmsg straight into the out dcache as the after-credit hook.
 *
 * A handler may also return fewer frags than drained WITHOUT raising
 * the python flag (journal-capacity chunking); the stem rewinds the in
 * cursor to the first unhandled frag — safe on reliable links because
 * the consumer's fseq never advances past what was handled. */

#ifndef FDT_STEM_H
#define FDT_STEM_H

#include <stdint.h>

/* ---- geometry ---------------------------------------------------------- */

/* 8 in-links: the pack tile consumes one txn ring plus one completion
   ring per bank */
#define FDT_STEM_MAX_INS 8
#define FDT_STEM_MAX_OUTS 8
#define FDT_STEM_N_CTRS 16

#define FDT_STEM_MAGIC 0xf17eda2ce57e0001UL

/* handler ids (cfg word 1) — the JAX package's numbering */
#define FDT_STEM_H_DEDUP 1
#define FDT_STEM_H_BANK 2
#define FDT_STEM_H_PACK 3
#define FDT_STEM_H_POH 4
#define FDT_STEM_H_SHRED 5
#define FDT_STEM_H_NET 6

/* after-credit hook ids (cfg word 11): invoked ONCE per fdt_stem_run
   call at the burst boundary — the native analog of the Python loop's
   tile.after_credit slot, which is where producer tiles generate work.
   The hook publishes through the SAME out blocks the frag handlers use
   and must re-read per-out cr_avail itself. */
#define FDT_STEM_AC_PACK 1
#define FDT_STEM_AC_POH 2
#define FDT_STEM_AC_SHRED 3
#define FDT_STEM_AC_NET 4

/* cfg word 13: stem flags */
#define FDT_STEM_F_MANUAL 1UL /* manual-credit tile (shred <-> keyguard
   ring cycle): SKIP the global min-over-outs credit gate — valid only
   for handlers that never publish from the frag path; every publish
   happens in the after-credit hook behind that ring's OWN cr_avail
   (the Python manual_credits contract, disco/mux.py) */

/* run statuses (cfg word 5, written by fdt_stem_run) */
#define FDT_STEM_IDLE 0   /* caught up: nothing more to consume */
#define FDT_STEM_BUDGET 1 /* max_frags consumed; more may be ready */
#define FDT_STEM_PYTHON 2 /* frag(s) pending that need the Python path;
                             cfg word 6 = the in-link index (or
                             FDT_STEM_IN_AC when the after-credit hook
                             requested the handback) */
#define FDT_STEM_BP 3     /* credits exhausted with input pending */

/* status_in sentinel: the PYTHON handback came from the after-credit
   hook (block-boundary end_block), not from a pending frag */
#define FDT_STEM_IN_AC 0xFFFFFFFFUL

/* ---- out-block word layout (shared with fdt_pack_sched) ----------------
 *
 * The after-credit hooks live in fdt_pack.c / fdt_poh.c / fdt_shred.c
 * but publish through the stem's out blocks; these indices are the single
 * source of truth for that layout.  One block per out at word
 * FDT_STEM_OUT0 + o * STRIDE. */

#define FDT_STEM_OUT0 112
#define FDT_STEM_OUT_STRIDE 16
#define FDT_STEM_O_MCACHE 0
#define FDT_STEM_O_DCACHE 1
#define FDT_STEM_O_CHUNKP 2
#define FDT_STEM_O_MTU 3
#define FDT_STEM_O_WMARK 4
#define FDT_STEM_O_DEPTH 5
#define FDT_STEM_O_NFSEQ 6
#define FDT_STEM_O_FSEQ0 7
#define FDT_STEM_O_SEQ 11
#define FDT_STEM_O_PUBLISHED 12
#define FDT_STEM_O_BYTES 13
#define FDT_STEM_O_SIGS 14
#define FDT_STEM_O_TSORIGS 15

/* ---- config block (u64 words; built host-side) -------------------------
 *
 * word 0  magic
 * word 1  handler id
 * word 2  n_ins  (<= FDT_STEM_MAX_INS)
 * word 3  n_outs (<= FDT_STEM_MAX_OUTS)
 * word 4  cap: per-in frag-scratch capacity (also bounds max_frags)
 * word 5  status (out)
 * word 6  status_in (out): in-link index for FDT_STEM_PYTHON
 * word 7  handler args block ptr (layout per handler, see fdt_stem.c)
 * word 8  counters ptr: u64[FDT_STEM_N_CTRS], zeroed per call; the
 *         handler accumulates tile-counter deltas here and Python
 *         applies them ONCE per burst (the batched-metrics contract)
 * word 9  tspub for every publish this call (compressed u32 domain)
 * word 10 sweep-rotation cursor (C-owned, persists across calls: the
 *         sweep start index rotates so a saturated in-link cannot
 *         starve the others — the Python loop's drain-order rotation,
 *         kept across the burst boundary)
 * word 11 after-credit hook id (FDT_STEM_AC_*, 0 = none): invoked once
 *         per call at the burst boundary, unless the burst ended in
 *         PYTHON (the Python after_credit will run) or with zero
 *         credits (the Python loop skips after_credit on backpressure
 *         iterations — same gate)
 * word 12 after-credit args block ptr (layout per hook; the pack hook
 *         is fdt_pack.h's FDT_PACK_SS_* block)
 * word 13 stem flags (FDT_STEM_F_*: bit0 = manual-credit tile)
 * words 14, 15 reserved (the JAX package's elastic epoch watch)
 * word 240 in-burst trace block ptr (0 = untraced; fdt_trace.h layout,
 *         armed by tango/rings.py Stem.arm_trace): per-frag drain/
 *         publish timestamps, native qwait/svc/e2e hist updates, and
 *         native span emission for the duration of each fdt_stem_run
 *         call
 *
 * per-in block i at word 16 + 12*i:
 *   +0 mcache ptr          +1 dcache base ptr (0 = none)
 *   +2 fseq ptr            +3 seq cursor (in/out)
 *   +4 flags (bit0 = native-handled; clear = python-only: a pending
 *      frag on this link returns FDT_STEM_PYTHON)
 *   +5 reserved (handlers address payloads by chunk * FDT_CHUNK_SZ,
 *      never by a row width)
 *   +6 frag scratch ptr (fdt_frag_t[cap]): drained metas, python-read
 *      after the burst for trace ingest + latency hists
 *   +7 consumed this call (out)   +8 bytes consumed (out)
 *   +9 overruns this call (out)   +10,+11 reserved
 *
 * per-out block o at word FDT_STEM_OUT0 + 16*o (FDT_STEM_O_* indices):
 *   +0 mcache ptr          +1 dcache base ptr (0 = none)
 *   +2 chunk-cursor ptr (u64 word: a host scratch word the Python side
 *      syncs with DCache.chunk around every call)
 *   +3 mtu                 +4 wmark_chunks        +5 depth (= cr_max)
 *   +6 n consumer fseqs    +7..+10 consumer fseq ptrs (<= 4)
 *   +11 seq cursor (in/out)
 *   +12 published this call (out)  +13 bytes published (out)
 *   +14 published-sig scratch ptr (u64[cap], 0 = skip) — for
 *       tracer.publish at the burst boundary
 *   +15 published-tsorig scratch ptr (u32[cap], 0 = skip)
 */

#define FDT_STEM_CFG_WORDS 256

/* cfg word 240: the in-burst trace block pointer (fdt_trace.h) */
#define FDT_STEM_C_TRACE 240

/* Layout self-description so the Python side can assert against drift. */
uint64_t fdt_stem_cfg_words( void );

/* ---- shared out-block primitives (fdt_pack.c / fdt_poh.c / fdt_shred.c /
 * fdt_net.c)
 *
 * The after-credit hooks and the block-egress handlers live in their own
 * translation units but publish through the stem's out blocks; these
 * helpers are the one publish/credit implementation so the
 * ring-publish-order (payload bytes before release-ordered meta) and the
 * credit bound cannot fork per handler. */

/* cr_avail for one out block, re-read from the LIVE consumer fseqs —
   never cache the result across a publish. */
int64_t fdt_stem_out_cr( uint64_t const * ob );

/* Publish one frag on an out block: payload into the out dcache at the
   shared chunk cursor first, then the release-ordered mcache publish —
   the exact op sequence OutLink.publish performs. */
void fdt_stem_out_emit( uint64_t * ob, uint64_t sig,
                        uint8_t const * payload, uint64_t sz,
                        uint16_t ctl, uint32_t tsorig, uint32_t tspub,
                        int64_t sig_cap );

/* Publish a frag whose payload the caller already placed in the out
   dcache at `chunk` (recvmmsg-into-dcache rows, encode-in-place) — the
   same metadata/trace body as
   fdt_stem_out_emit without the copy.  These two are the ONLY native
   publish entry points: publishing around them would bypass per-frag
   tspub stamping and span propagation. */
void fdt_stem_out_emit_at( uint64_t * ob, uint64_t sig, uint32_t chunk,
                           uint64_t sz, uint16_t ctl, uint32_t tsorig,
                           uint32_t tspub, int64_t sig_cap );

/* Run the stem until a burst boundary: consume up to max_frags frags
   across the native-handled in-links, dispatching each drained run to
   the configured handler (which publishes through the out blocks under
   the per-sweep credit bound min over outs of fdt_fctl_cr_avail).
   Consumed in-links' fseqs are updated after every sweep so upstream
   credits keep flowing during a long burst.  Returns total frags
   consumed (>= 0) and writes cfg status words, or -1 on a bad config
   block (bad magic, too many links, or a handler or hook id the port
   does not carry). */
int64_t fdt_stem_run( uint64_t * cfg, int64_t max_frags );

/* Fused bank fast path: decode one microblock + scan-classify + execute
   all-fast batches through fdt_bank_exec, in one call.  bargs is the
   bank handler's args block (see fdt_stem.c BH_*): decode/scan
   scratch arrays plus the shared account table, the per-bank undo
   journal (whose python-owned word 31 carries the completed-seq mark),
   and the zero_check feature flag.  mb_tag is the carrying frag's seq —
   the crash-resume journal key, so a SIGKILL mid-microblock resumes
   through the SAME (tag, txns-done) protocol the Python path uses.
   out_stats u64[8]: [0] rc (0 executed, 1 malformed, 2 needs the
   Python path — nothing consumed beyond the journal's own progress,
   3 already complete: republish without re-executing), [1] txn count,
   [2] newly executed, [3] newly failed, [4] fees collected.
   Returns rc. */
int64_t fdt_bank_pipeline( uint8_t const * mb, int64_t mb_sz,
                           uint64_t * bargs, uint64_t mb_tag,
                           uint64_t * out_stats );

#endif /* FDT_STEM_H */
