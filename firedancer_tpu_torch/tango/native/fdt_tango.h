/* Copy of firedancer_tpu/tango/native/fdt_tango.h, kept in the port so that
   firedancer_tpu_torch builds its ring library from its own sources. */

/* fdt_tango.h — host-side IPC messaging layer for firedancer_tpu.
 *
 * TPU-native re-design of the reference's tango layer
 * (reference: src/tango/fd_tango_base.h:4-110 documents the concepts this
 * mirrors: 64-bit monotone seq numbers, 32-byte frag metadata with an
 * app-defined 64-bit sig field, SOM/EOM/ERR control bits, chunk-addressed
 * payload cache, consumer-side overrun detection, credit-based flow
 * control over fseq backchannels, cnc out-of-band control, and the tcache
 * dedup tag cache — see also src/tango/mcache/fd_mcache.h,
 * src/tango/tcache/fd_tcache.h).
 *
 * Differences from the reference, deliberate and TPU-motivated:
 *   - Batch-first API: fdt_mcache_drain / fdt_tcache_dedup operate on
 *     arrays so a JAX bridge tile can drain thousands of frags per call,
 *     amortizing host->device dispatch.  The reference is one-frag-at-a-
 *     time because its consumers are C hot loops.
 *   - Objects are plain memory regions sized by *_footprint() and
 *     initialized by *_new(); placement (shared memory mapping, NUMA) is
 *     the caller's concern.  No gaddr/laddr translation layer: Python
 *     owns the workspace mapping and passes raw pointers.
 *   - C11 atomics instead of compiler fences + SSE pair loads.
 *
 * All functions are thread-safe under the single-producer/multi-consumer
 * discipline documented per object below.
 */

#ifndef FDT_TANGO_H
#define FDT_TANGO_H

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- frag metadata ----------------------------------------------------- */

/* 32-byte frag descriptor published into an mcache line.  seq is written
   last with release ordering; consumers detect overwrite by re-reading seq
   after copying the body (reference: fd_frag_meta_t,
   src/tango/fd_tango_base.h:113-150). */
/* Exactly 32 bytes with no padding; deliberately NOT declared with an
   alignment attribute — out-buffers come from numpy allocations that only
   guarantee 16-byte alignment. */
typedef struct fdt_frag {
  uint64_t seq;    /* sequence number of this frag */
  uint64_t sig;    /* app-defined signature (e.g. first 8B of ed25519 sig) */
  uint32_t chunk;  /* payload location, FDT_CHUNK_SZ units into the dcache */
  uint16_t sz;     /* payload size in bytes */
  uint16_t ctl;    /* SOM|EOM|ERR | origin<<3 */
  uint32_t tsorig; /* compressed timestamp: frag production started */
  uint32_t tspub;  /* compressed timestamp: frag published */
} fdt_frag_t;

#define FDT_CHUNK_SZ   (64UL)
#define FDT_CTL_SOM    (1U)
#define FDT_CTL_EOM    (2U)
#define FDT_CTL_ERR    (4U)
#define FDT_SEQ_NULL   (~0UL)

/* ---- mcache: single-producer multi-consumer frag ring ------------------ */

/* Layout: [ header (1 cacheline-pair) | fdt_frag_t[depth] ].
   depth must be a power of two.  Producer publishes strictly increasing
   seq; consumers poll by expected seq and detect being lapped. */

uint64_t fdt_mcache_align( void );
uint64_t fdt_mcache_footprint( uint64_t depth );
/* Initialize; returns 0 on success, -1 on bad depth.  All lines start at
   FDT_SEQ_NULL-marked (seq = seq0 - depth, so they read as "ancient"). */
int      fdt_mcache_new( void * mem, uint64_t depth, uint64_t seq0 );
uint64_t fdt_mcache_depth( void const * mcache );
/* The seq the ring was initialized at (rejoin helpers clamp to it: seqs
   before seq0 alias the "ancient"-marked init lines and must never be
   polled as live). */
uint64_t fdt_mcache_seq0( void const * mcache );
/* Producer's next-to-publish seq (monotone published watermark + 1). */
uint64_t fdt_mcache_seq_query( void const * mcache );
/* Restart-only cursor repair: advance seq_prod past a line a crashed
   incarnation published without advancing the cursor.  Never rewrites
   the line (it may be under a consumer's speculative copy). */
void fdt_mcache_seq_advance( void * mcache, uint64_t seq );
/* Publish one frag at seq (must be the producer's current seq; caller
   advances seq themselves).  Release-ordered. */
void fdt_mcache_publish( void * mcache, uint64_t seq, uint64_t sig,
                         uint32_t chunk, uint16_t sz, uint16_t ctl,
                         uint32_t tsorig, uint32_t tspub );

/* Consumer poll: attempt to read the frag with sequence number seq_expect.
   Returns:
     0  -> *out filled with frag seq_expect (torn-read safe)
     -1 -> not yet published (caught up)
     1  -> overrun: producer lapped us; *out_seq_now holds the seq found
           on the line so the caller can resynchronize. */
int fdt_mcache_poll( void const * mcache, uint64_t seq_expect,
                     fdt_frag_t * out, uint64_t * out_seq_now );

/* Batch drain for bridge tiles: copy up to max consecutive frags starting
   at *seq_io into out[].  On return *seq_io is advanced past everything
   consumed (including any overrun resync jump).  *overrun_cnt accumulates
   the number of frags lost to overruns.  Returns number of frags copied. */
uint64_t fdt_mcache_drain( void const * mcache, uint64_t * seq_io,
                           uint64_t max, fdt_frag_t * out,
                           uint64_t * overrun_cnt );

/* Batch publish for bridge tiles: publish n frags at consecutive seqs
   starting at seq0 (each release-ordered, so consumers may begin draining
   the head of the batch while the tail is still being written).  Returns
   seq0 + n.  Caller is responsible for flow control (n <= cr_avail). */
uint64_t fdt_mcache_publish_batch( void * mcache, uint64_t seq0,
                                   uint64_t const * sigs,
                                   uint32_t const * chunks,
                                   uint16_t const * szs,
                                   uint16_t const * ctls,
                                   uint32_t const * tsorigs,
                                   uint32_t tspub, uint64_t n );

/* ---- dcache: chunk-addressed payload region ---------------------------- */

/* A dcache is just bytes; the compact circular bump allocation discipline
   (reference: fd_dcache_compact_next, src/tango/dcache/fd_dcache.h) is a
   pure function over chunk indices, provided here for producers. */

uint64_t fdt_dcache_footprint( uint64_t mtu, uint64_t depth );
/* Number of FDT_CHUNK_SZ chunks a payload of sz bytes occupies. */
uint64_t fdt_dcache_chunk_cnt( uint64_t sz );
/* Advance a chunk index past a just-written payload of sz bytes, wrapping
   to 0 when fewer than mtu bytes remain before wmark_chunks. */
uint64_t fdt_dcache_compact_next( uint64_t chunk, uint64_t sz,
                                  uint64_t mtu, uint64_t wmark_chunks );

/* Batch gather for bridge tiles: copy n payloads (chunks[i], szs[i]) out of
   the dcache into a dense row-major (n, width) byte matrix, zero-padding
   each row past its payload (rows are pre-zeroed by the caller or not;
   this function zero-fills the tail itself).  szs[i] > width is clamped.
   One native call replaces n Python-side copies on the hot path. */
void fdt_dcache_gather( void const * dcache_base, uint32_t const * chunks,
                        uint16_t const * szs, uint64_t n, uint64_t width,
                        uint8_t * out );

/* Batch scatter for bridge tiles: the producer-side dual of gather.  Copy n
   payloads (rows of a dense (n, width) matrix, row i holding szs[i] live
   bytes) into the dcache using the compact circular discipline starting at
   chunk index *chunk_io, recording each payload's chunk index in
   out_chunks[i].  *chunk_io is advanced past the batch.  One native call
   replaces n Python-side write()s. */
void fdt_dcache_scatter( void * dcache_base, uint64_t * chunk_io,
                         uint64_t mtu, uint64_t wmark_chunks,
                         uint8_t const * rows, uint16_t const * szs,
                         uint64_t n, uint64_t width, uint32_t * out_chunks );

/* ---- fseq: consumer progress backchannel ------------------------------- */

/* One cacheline: consumer's completed-through seq (atomic), plus a small
   diagnostic area (reference: src/tango/fseq/fd_fseq.h:95-118). */

uint64_t fdt_fseq_align( void );
uint64_t fdt_fseq_footprint( void );
void     fdt_fseq_new( void * mem, uint64_t seq0 );
uint64_t fdt_fseq_query( void const * fseq );
void     fdt_fseq_update( void * fseq, uint64_t seq );
/* diag slots: 0..7 app-defined u64 accumulators (e.g. overrun counts) */
uint64_t fdt_fseq_diag_query( void const * fseq, uint64_t idx );
void     fdt_fseq_diag_add( void * fseq, uint64_t idx, uint64_t delta );

/* ---- fctl: credit-based flow control ----------------------------------- */

/* Pure helper: given the producer's seq and the minimum of all reliable
   consumers' fseqs, how many publishes are safe?  cr_max is bounded by the
   ring depth (publishing depth ahead of the slowest reliable consumer
   would overrun it; reference model: src/tango/fctl/fd_fctl.h). */
uint64_t fdt_fctl_cr_avail( uint64_t seq_prod, uint64_t seq_cons_min,
                            uint64_t cr_max );

/* ---- cnc: command and control ------------------------------------------ */

typedef enum {
  FDT_CNC_SIG_BOOT = 0,
  FDT_CNC_SIG_RUN  = 1,
  FDT_CNC_SIG_HALT = 2,
  FDT_CNC_SIG_FAIL = 3,
} fdt_cnc_sig_t;

uint64_t fdt_cnc_align( void );
uint64_t fdt_cnc_footprint( void );
void     fdt_cnc_new( void * mem );
uint64_t fdt_cnc_signal_query( void const * cnc );
void     fdt_cnc_signal( void * cnc, uint64_t sig );
void     fdt_cnc_heartbeat( void * cnc, uint64_t now );
uint64_t fdt_cnc_heartbeat_query( void const * cnc );

/* ---- tcache: dedup tag cache ------------------------------------------- */

/* Remembers the most recent `depth` unique 64-bit tags: a ring of tags in
   insertion order plus an open-addressed key-only map for O(1) query.
   Inserting when full evicts the oldest ring entry from the map
   (reference semantics: src/tango/tcache/fd_tcache.h:1-22,344-400).
   Tag 0 is reserved as "null" and always reads as duplicate-free no-op.
   Single-writer. */

uint64_t fdt_tcache_align( void );
/* map_cnt must be a power of two > depth (recommend >= 2*depth). */
uint64_t fdt_tcache_footprint( uint64_t depth, uint64_t map_cnt );
int      fdt_tcache_new( void * mem, uint64_t depth, uint64_t map_cnt );
uint64_t fdt_tcache_depth( void const * tcache );
/* Batch query+insert: for each tags[i], is_dup[i]=1 if it was already
   present (and it is NOT re-inserted), else 0 and it is inserted (evicting
   the oldest if at capacity).  Duplicates within the batch are detected.
   Returns the number of duplicates. */
uint64_t fdt_tcache_dedup( void * tcache, uint64_t const * tags, uint64_t n,
                           uint8_t * is_dup );
/* Single query without insert (1 = present). */
int fdt_tcache_query( void const * tcache, uint64_t tag );
void fdt_tcache_reset( void * tcache );

/* Journaled dedup: identical to fdt_tcache_dedup, but every tag ABOUT
   TO BE INSERTED is first appended to a crash journal (jnl[2] = count,
   written release AFTER the tag word, tags from jnl[4]; jnl[3] set when
   jcap overflows — jnl[0]/jnl[1] are caller-owned phase/seq words).  A
   consumer killed between the insert and its downstream publish can
   then grant the journaled tags a one-shot replay amnesty instead of
   losing them to its own surviving history (tiles/dedup.py). */
uint64_t fdt_tcache_dedup_j( void * tcache, uint64_t const * tags,
                             uint64_t n, uint8_t * is_dup, uint64_t * jnl,
                             uint64_t jcap );

#ifdef __cplusplus
}
#endif

#endif /* FDT_TANGO_H */
