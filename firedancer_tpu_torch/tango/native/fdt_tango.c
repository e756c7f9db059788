/* Copy of firedancer_tpu/tango/native/fdt_tango.c, kept in the port so that
   firedancer_tpu_torch builds its ring library from its own sources. */

/* fdt_tango.c — implementation.  See fdt_tango.h for the design notes and
 * reference citations.  Original implementation (no reference code reused):
 * C11 atomics express the publish/consume protocol the reference builds
 * from compiler fences and SSE pair loads (src/tango/mcache/fd_mcache.h:288-310,
 * consumer pattern src/disco/mux/fd_mux.c:561-594). */

#include "fdt_tango.h"

#include <stdatomic.h>
#include <string.h>

#define CACHELINE 64UL

static inline int is_pow2( uint64_t x ) { return x && !( x & ( x - 1UL ) ); }

/* ==== mcache ============================================================ */

/* Header occupies two cachelines: line 0 = static geometry, line 1 = the
   producer's published-seq watermark (kept away from geometry so consumer
   polling of geometry never false-shares with the producer's stores). */
typedef struct {
  uint64_t magic;
  uint64_t depth;
  uint64_t seq0;
  uint64_t _pad0[ 5 ];
  _Atomic uint64_t seq_prod; /* next seq the producer will publish */
  uint64_t _pad1[ 7 ];
} fdt_mcache_hdr_t;

#define FDT_MCACHE_MAGIC 0xf17eda2ce37a0001UL

static inline fdt_frag_t * mcache_line( void * mcache ) {
  return (fdt_frag_t *)( (char *)mcache + sizeof( fdt_mcache_hdr_t ) );
}
static inline fdt_frag_t const * mcache_line_c( void const * mcache ) {
  return (fdt_frag_t const *)( (char const *)mcache + sizeof( fdt_mcache_hdr_t ) );
}

uint64_t fdt_mcache_align( void ) { return 128UL; }

uint64_t fdt_mcache_footprint( uint64_t depth ) {
  if( !is_pow2( depth ) || depth < 2UL ) return 0UL;
  return sizeof( fdt_mcache_hdr_t ) + depth * sizeof( fdt_frag_t );
}

int fdt_mcache_new( void * mem, uint64_t depth, uint64_t seq0 ) {
  if( !is_pow2( depth ) || depth < 2UL ) return -1;
  fdt_mcache_hdr_t * h = (fdt_mcache_hdr_t *)mem;
  memset( mem, 0, fdt_mcache_footprint( depth ) );
  h->magic = FDT_MCACHE_MAGIC;
  h->depth = depth;
  h->seq0  = seq0;
  atomic_store_explicit( &h->seq_prod, seq0, memory_order_release );
  /* Mark every line as holding an "ancient" seq so consumers polling for
     seq0.. see not-yet-published rather than garbage. */
  fdt_frag_t * line = mcache_line( mem );
  for( uint64_t i = 0; i < depth; i++ ) line[ i ].seq = seq0 - depth + i;
  return 0;
}

uint64_t fdt_mcache_depth( void const * mcache ) {
  return ( (fdt_mcache_hdr_t const *)mcache )->depth;
}

uint64_t fdt_mcache_seq0( void const * mcache ) {
  return ( (fdt_mcache_hdr_t const *)mcache )->seq0;
}

uint64_t fdt_mcache_seq_query( void const * mcache ) {
  fdt_mcache_hdr_t const * h = (fdt_mcache_hdr_t const *)mcache;
  return atomic_load_explicit( (_Atomic uint64_t *)&h->seq_prod,
                               memory_order_acquire );
}

void fdt_mcache_seq_advance( void * mcache, uint64_t seq ) {
  /* Producer-side cursor repair (fdt_producer_rejoin): completes a
     publish that crashed between its line-seq store and the seq_prod
     advance.  The line already carries its final seq (consumers may have
     consumed it), so the ONLY safe recovery is advancing the cursor past
     it — re-publishing would invalidate a live line under a concurrent
     consumer's speculative copy (spurious overrun on a reliable link). */
  fdt_mcache_hdr_t * h = (fdt_mcache_hdr_t *)mcache;
  atomic_store_explicit( &h->seq_prod, seq, memory_order_release );
}

void fdt_mcache_publish( void * mcache, uint64_t seq, uint64_t sig,
                         uint32_t chunk, uint16_t sz, uint16_t ctl,
                         uint32_t tsorig, uint32_t tspub ) {
  fdt_mcache_hdr_t * h = (fdt_mcache_hdr_t *)mcache;
  uint64_t depth = h->depth;
  fdt_frag_t * f = mcache_line( mcache ) + ( seq & ( depth - 1UL ) );
  /* Invalidate the line first so a concurrent consumer mid-copy of the old
     frag cannot validate against either the old or the new seq.  seq-1 is
     never congruent to this line's seqs (depth >= 2 enforced at new). */
  atomic_store_explicit( (_Atomic uint64_t *)&f->seq, seq - 1UL,
                         memory_order_relaxed );
  atomic_thread_fence( memory_order_release );
  f->sig    = sig;
  f->chunk  = chunk;
  f->sz     = sz;
  f->ctl    = ctl;
  f->tsorig = tsorig;
  f->tspub  = tspub;
  atomic_thread_fence( memory_order_release );
  atomic_store_explicit( (_Atomic uint64_t *)&f->seq, seq,
                         memory_order_release );
  atomic_store_explicit( &h->seq_prod, seq + 1UL, memory_order_release );
}

int fdt_mcache_poll( void const * mcache, uint64_t seq_expect,
                     fdt_frag_t * out, uint64_t * out_seq_now ) {
  fdt_mcache_hdr_t const * h = (fdt_mcache_hdr_t const *)mcache;
  uint64_t depth = h->depth;
  fdt_frag_t const * f = mcache_line_c( mcache ) + ( seq_expect & ( depth - 1UL ) );
  uint64_t seq_found = atomic_load_explicit( (_Atomic uint64_t *)&f->seq,
                                             memory_order_acquire );
  if( seq_found != seq_expect ) {
    if( out_seq_now ) *out_seq_now = seq_found;
    /* signed distance: behind -> not yet published; ahead -> overrun */
    return ( (int64_t)( seq_found - seq_expect ) < 0L ) ? -1 : 1;
  }
  /* speculative copy, then confirm the line wasn't overwritten under us */
  fdt_frag_t tmp;
  tmp.sig    = f->sig;
  tmp.chunk  = f->chunk;
  tmp.sz     = f->sz;
  tmp.ctl    = f->ctl;
  tmp.tsorig = f->tsorig;
  tmp.tspub  = f->tspub;
  atomic_thread_fence( memory_order_acquire );
  uint64_t seq_check = atomic_load_explicit( (_Atomic uint64_t *)&f->seq,
                                             memory_order_acquire );
  if( seq_check != seq_expect ) {
    if( out_seq_now ) *out_seq_now = seq_check;
    return 1; /* torn: overwritten mid-copy */
  }
  tmp.seq = seq_expect;
  *out = tmp;
  return 0;
}

uint64_t fdt_mcache_drain( void const * mcache, uint64_t * seq_io,
                           uint64_t max, fdt_frag_t * out,
                           uint64_t * overrun_cnt ) {
  uint64_t seq = *seq_io;
  uint64_t n = 0;
  while( n < max ) {
    uint64_t seq_now;
    int rc = fdt_mcache_poll( mcache, seq, out + n, &seq_now );
    if( rc == 0 ) { n++; seq++; continue; }
    if( rc < 0 ) break; /* caught up */
    /* Overrun: resynchronize to the producer's current horizon minus the
       ring depth (oldest frag still guaranteed live-ish), counting losses.
       All seq arithmetic is mod 2^64 with signed-distance comparisons: the
       old `seq_prod > depth ? seq_prod - depth : 0` clamp mis-resynced to
       seq 0 when seq_prod had just wrapped past 2^64 (seq_prod numerically
       tiny but the live window is [seq_prod - depth, seq_prod)), skipping
       frags that were still readable. */
    uint64_t depth = fdt_mcache_depth( mcache );
    uint64_t seq_prod = fdt_mcache_seq_query( mcache );
    uint64_t seq_new = seq_prod - depth; /* mod-2^64 */
    if( (int64_t)( seq_new - seq ) <= 0L ) seq_new = seq + 1UL;
    if( overrun_cnt ) *overrun_cnt += seq_new - seq;
    seq = seq_new;
  }
  *seq_io = seq;
  return n;
}

uint64_t fdt_mcache_publish_batch( void * mcache, uint64_t seq0,
                                   uint64_t const * sigs,
                                   uint32_t const * chunks,
                                   uint16_t const * szs,
                                   uint16_t const * ctls,
                                   uint32_t const * tsorigs,
                                   uint32_t tspub, uint64_t n ) {
  for( uint64_t i = 0; i < n; i++ )
    fdt_mcache_publish( mcache, seq0 + i, sigs[ i ],
                        chunks ? chunks[ i ] : 0U,
                        szs ? szs[ i ] : (uint16_t)0,
                        ctls ? ctls[ i ] : (uint16_t)( FDT_CTL_SOM | FDT_CTL_EOM ),
                        tsorigs ? tsorigs[ i ] : tspub,
                        tspub );
  return seq0 + n;
}

/* ==== dcache ============================================================ */

uint64_t fdt_dcache_chunk_cnt( uint64_t sz ) {
  return ( sz + FDT_CHUNK_SZ - 1UL ) / FDT_CHUNK_SZ;
}

uint64_t fdt_dcache_footprint( uint64_t mtu, uint64_t depth ) {
  /* Compact ring discipline needs room for depth in-flight payloads plus
     one mtu of slack so the wrap check never splits a payload. */
  uint64_t chunk_per = fdt_dcache_chunk_cnt( mtu );
  return ( chunk_per * ( depth + 2UL ) ) * FDT_CHUNK_SZ;
}

uint64_t fdt_dcache_compact_next( uint64_t chunk, uint64_t sz,
                                  uint64_t mtu, uint64_t wmark_chunks ) {
  uint64_t next = chunk + fdt_dcache_chunk_cnt( sz );
  if( next + fdt_dcache_chunk_cnt( mtu ) > wmark_chunks ) next = 0UL;
  return next;
}

void fdt_dcache_gather( void const * dcache_base, uint32_t const * chunks,
                        uint16_t const * szs, uint64_t n, uint64_t width,
                        uint8_t * out ) {
  uint8_t const * base = (uint8_t const *)dcache_base;
  for( uint64_t i = 0; i < n; i++ ) {
    uint64_t sz = szs[ i ];
    if( sz > width ) sz = width;
    uint8_t * row = out + i * width;
    memcpy( row, base + (uint64_t)chunks[ i ] * FDT_CHUNK_SZ, sz );
    memset( row + sz, 0, width - sz );
  }
}

void fdt_dcache_scatter( void * dcache_base, uint64_t * chunk_io,
                         uint64_t mtu, uint64_t wmark_chunks,
                         uint8_t const * rows, uint16_t const * szs,
                         uint64_t n, uint64_t width, uint32_t * out_chunks ) {
  uint8_t * base  = (uint8_t *)dcache_base;
  uint64_t  chunk = *chunk_io;
  for( uint64_t i = 0; i < n; i++ ) {
    uint64_t sz = szs[ i ];
    if( sz > width ) sz = width;
    memcpy( base + chunk * FDT_CHUNK_SZ, rows + i * width, sz );
    out_chunks[ i ] = (uint32_t)chunk;
    chunk = fdt_dcache_compact_next( chunk, sz, mtu, wmark_chunks );
  }
  *chunk_io = chunk;
}

/* ==== fseq ============================================================== */

typedef struct {
  _Atomic uint64_t seq;
  uint64_t _pad[ 7 ];
  _Atomic uint64_t diag[ 8 ];
} fdt_fseq_t;

uint64_t fdt_fseq_align( void ) { return CACHELINE; }
uint64_t fdt_fseq_footprint( void ) { return sizeof( fdt_fseq_t ); }

void fdt_fseq_new( void * mem, uint64_t seq0 ) {
  fdt_fseq_t * f = (fdt_fseq_t *)mem;
  memset( mem, 0, sizeof( fdt_fseq_t ) );
  atomic_store_explicit( &f->seq, seq0, memory_order_release );
}

uint64_t fdt_fseq_query( void const * fseq ) {
  return atomic_load_explicit( (_Atomic uint64_t *)&( (fdt_fseq_t const *)fseq )->seq,
                               memory_order_acquire );
}

void fdt_fseq_update( void * fseq, uint64_t seq ) {
  atomic_store_explicit( &( (fdt_fseq_t *)fseq )->seq, seq,
                         memory_order_release );
}

uint64_t fdt_fseq_diag_query( void const * fseq, uint64_t idx ) {
  return atomic_load_explicit(
      (_Atomic uint64_t *)&( (fdt_fseq_t const *)fseq )->diag[ idx & 7UL ],
      memory_order_relaxed );
}

void fdt_fseq_diag_add( void * fseq, uint64_t idx, uint64_t delta ) {
  atomic_fetch_add_explicit( &( (fdt_fseq_t *)fseq )->diag[ idx & 7UL ], delta,
                             memory_order_relaxed );
}

/* ==== fctl ============================================================== */

uint64_t fdt_fctl_cr_avail( uint64_t seq_prod, uint64_t seq_cons_min,
                            uint64_t cr_max ) {
  /* Consumer has processed through seq_cons_min-1; producer may publish up
     to seq_cons_min + cr_max - 1 without lapping it. */
  uint64_t in_flight = seq_prod - seq_cons_min; /* mod-2^64 safe */
  if( (int64_t)in_flight < 0L ) return cr_max;  /* consumer ahead: fresh */
  return in_flight >= cr_max ? 0UL : cr_max - in_flight;
}

/* ==== cnc =============================================================== */

typedef struct {
  _Atomic uint64_t sig;
  _Atomic uint64_t heartbeat;
  uint64_t _pad[ 6 ];
} fdt_cnc_t;

uint64_t fdt_cnc_align( void ) { return CACHELINE; }
uint64_t fdt_cnc_footprint( void ) { return sizeof( fdt_cnc_t ); }

void fdt_cnc_new( void * mem ) {
  memset( mem, 0, sizeof( fdt_cnc_t ) );
  atomic_store_explicit( &( (fdt_cnc_t *)mem )->sig, FDT_CNC_SIG_BOOT,
                         memory_order_release );
}

uint64_t fdt_cnc_signal_query( void const * cnc ) {
  return atomic_load_explicit( (_Atomic uint64_t *)&( (fdt_cnc_t const *)cnc )->sig,
                               memory_order_acquire );
}

void fdt_cnc_signal( void * cnc, uint64_t sig ) {
  atomic_store_explicit( &( (fdt_cnc_t *)cnc )->sig, sig, memory_order_release );
}

void fdt_cnc_heartbeat( void * cnc, uint64_t now ) {
  atomic_store_explicit( &( (fdt_cnc_t *)cnc )->heartbeat, now,
                         memory_order_relaxed );
}

uint64_t fdt_cnc_heartbeat_query( void const * cnc ) {
  return atomic_load_explicit(
      (_Atomic uint64_t *)&( (fdt_cnc_t const *)cnc )->heartbeat,
      memory_order_relaxed );
}

/* ==== tcache ============================================================ */

/* Layout: [ hdr | ring: u64[depth] | map: u64[map_cnt] ].  The map is
   key-only open addressing with linear probing; 0 means empty.  Deleting
   (on ring eviction) uses the standard backward-shift so probe chains stay
   intact.  Single-writer, so no atomics needed beyond the caller's own
   serialization. */
typedef struct {
  uint64_t magic;
  uint64_t depth;
  uint64_t map_cnt;
  uint64_t ring_cnt;  /* number of live entries (<= depth) */
  uint64_t ring_head; /* next slot to write (oldest when full) */
  uint64_t _pad[ 3 ];
} fdt_tcache_hdr_t;

#define FDT_TCACHE_MAGIC 0xf17eda2ce37a0002UL

static inline uint64_t * tc_ring( void * t ) {
  return (uint64_t *)( (char *)t + sizeof( fdt_tcache_hdr_t ) );
}
static inline uint64_t * tc_map( void * t ) {
  fdt_tcache_hdr_t * h = (fdt_tcache_hdr_t *)t;
  return tc_ring( t ) + h->depth;
}

uint64_t fdt_tcache_align( void ) { return CACHELINE; }

uint64_t fdt_tcache_footprint( uint64_t depth, uint64_t map_cnt ) {
  if( !depth || !is_pow2( map_cnt ) || map_cnt <= depth ) return 0UL;
  return sizeof( fdt_tcache_hdr_t ) + ( depth + map_cnt ) * sizeof( uint64_t );
}

int fdt_tcache_new( void * mem, uint64_t depth, uint64_t map_cnt ) {
  uint64_t fp = fdt_tcache_footprint( depth, map_cnt );
  if( !fp ) return -1;
  memset( mem, 0, fp );
  fdt_tcache_hdr_t * h = (fdt_tcache_hdr_t *)mem;
  h->magic   = FDT_TCACHE_MAGIC;
  h->depth   = depth;
  h->map_cnt = map_cnt;
  return 0;
}

uint64_t fdt_tcache_depth( void const * tcache ) {
  return ( (fdt_tcache_hdr_t const *)tcache )->depth;
}

void fdt_tcache_reset( void * tcache ) {
  fdt_tcache_hdr_t * h = (fdt_tcache_hdr_t *)tcache;
  h->ring_cnt  = 0;
  h->ring_head = 0;
  memset( tc_map( tcache ), 0, h->map_cnt * sizeof( uint64_t ) );
  memset( tc_ring( tcache ), 0, h->depth * sizeof( uint64_t ) );
}

/* Avalanching mix so adversarial tags still spread over the map
   (splitmix64 finalizer; public-domain construction). */
static inline uint64_t tc_hash( uint64_t x ) {
  x ^= x >> 30; x *= 0xbf58476d1ce4e5b9UL;
  x ^= x >> 27; x *= 0x94d049bb133111ebUL;
  x ^= x >> 31;
  return x;
}

static inline int tc_map_query( uint64_t const * map, uint64_t mask,
                                uint64_t tag ) {
  uint64_t i = tc_hash( tag ) & mask;
  for(;;) {
    uint64_t k = map[ i ];
    if( k == tag ) return 1;
    if( !k ) return 0;
    i = ( i + 1UL ) & mask;
  }
}

static inline void tc_map_insert( uint64_t * map, uint64_t mask,
                                  uint64_t tag ) {
  uint64_t i = tc_hash( tag ) & mask;
  while( map[ i ] ) i = ( i + 1UL ) & mask;
  map[ i ] = tag;
}

static void tc_map_remove( uint64_t * map, uint64_t mask, uint64_t tag ) {
  uint64_t i = tc_hash( tag ) & mask;
  while( map[ i ] != tag ) {
    if( !map[ i ] ) return; /* not present (tag 0 shenanigans) */
    i = ( i + 1UL ) & mask;
  }
  /* backward-shift deletion */
  uint64_t hole = i;
  for(;;) {
    i = ( i + 1UL ) & mask;
    uint64_t k = map[ i ];
    if( !k ) break;
    uint64_t home = tc_hash( k ) & mask;
    /* can k legally move into hole? yes iff hole is in [home, i) cyclically */
    uint64_t d_hole = ( hole - home ) & mask;
    uint64_t d_i    = ( i - home ) & mask;
    if( d_hole <= d_i ) { map[ hole ] = k; hole = i; }
  }
  map[ hole ] = 0UL;
}

uint64_t fdt_tcache_dedup_j( void * tcache, uint64_t const * tags,
                             uint64_t n, uint8_t * is_dup, uint64_t * jnl,
                             uint64_t jcap ) {
  fdt_tcache_hdr_t * h = (fdt_tcache_hdr_t *)tcache;
  uint64_t * ring = tc_ring( tcache );
  uint64_t * map  = tc_map( tcache );
  uint64_t mask   = h->map_cnt - 1UL;
  uint64_t dups   = 0;
  uint64_t jcnt   = 0;
  for( uint64_t i = 0; i < n; i++ ) {
    uint64_t tag = tags[ i ];
    if( !tag ) { is_dup[ i ] = 0; continue; } /* null tag: pass-through */
    if( tc_map_query( map, mask, tag ) ) {
      is_dup[ i ] = 1;
      dups++;
      continue;
    }
    is_dup[ i ] = 0;
    /* journal BEFORE the insert becomes visible: a kill at any point
       from here on leaves the tag recoverable (tag word first, count
       published after with release ordering) */
    if( jnl ) {
      if( jcnt < jcap ) {
        jnl[ 4 + jcnt ] = tag;
        __atomic_store_n( &jnl[ 2 ], jcnt + 1UL, __ATOMIC_RELEASE );
        jcnt++;
      } else {
        __atomic_store_n( &jnl[ 3 ], 1UL, __ATOMIC_RELEASE );
      }
    }
    if( h->ring_cnt == h->depth ) {
      uint64_t old = ring[ h->ring_head ];
      if( old ) tc_map_remove( map, mask, old );
    } else {
      h->ring_cnt++;
    }
    ring[ h->ring_head ] = tag;
    h->ring_head = ( h->ring_head + 1UL ) % h->depth;
    tc_map_insert( map, mask, tag );
  }
  return dups;
}

uint64_t fdt_tcache_dedup( void * tcache, uint64_t const * tags, uint64_t n,
                           uint8_t * is_dup ) {
  /* the unjournaled dedup IS the journaled one with no journal — one
     insert/evict body, so the two can never disagree */
  return fdt_tcache_dedup_j( tcache, tags, n, is_dup, 0, 0 );
}

int fdt_tcache_query( void const * tcache, uint64_t tag ) {
  fdt_tcache_hdr_t const * h = (fdt_tcache_hdr_t const *)tcache;
  if( !tag ) return 0;
  uint64_t const * map =
      (uint64_t const *)( (char const *)tcache + sizeof( fdt_tcache_hdr_t ) ) +
      h->depth;
  return tc_map_query( map, h->map_cnt - 1UL, tag );
}

/* ==== verify lane expansion ============================================= */

/* fdt_sha512.c (same shared library) */
extern void fdt_sha512_rpm( uint8_t const * r, uint8_t const * a,
                            uint8_t const * m, uint64_t mlen, uint8_t * out );

/* One-pass gather + trailer parse + per-signature lane expansion for the
   verify tile (tiles/verify.py).  For each frag (chunks[i], szs[i]):
     - copy the full payload into rows_out[i] (zero-padded to width) so the
       tile can republish it downstream without re-reading the dcache;
     - parse the 16-byte wire trailer (tiles/wire.py format: u16 sig_off,
       pub_off, msg_off, msg_len, txn_sz; u8 sig_cnt, ...);
     - emit one verify lane per signature j in [0, sig_cnt):
         msgs[lane]: payload[msg_off .. msg_off+msg_len) padded to msg_width
         lens[lane]  = msg_len
         sigs[lane]  = payload[sig_off + 64 j ..][0:64]
         pubs[lane]  = payload[pub_off + 32 j ..][0:32]
     - write per-txn sig_cnt[i] and tags[i] (first 8 bytes of the first
       signature, little-endian, the dedup key — fd_dedup keys the tango
       sig field the same way).
   A malformed trailer (offsets past the payload) yields one lane of
   zeroed sig/pub (which can never verify) instead of out-of-bounds reads.
   Caller sizes lane outputs for the worst case (n * max sigs per txn).
   Returns the lane count. */
uint64_t fdt_verify_expand( void const * dcache_base,
                            uint32_t const * chunks, uint16_t const * szs,
                            uint64_t n, uint64_t width,
                            uint8_t * rows_out, uint64_t msg_width,
                            uint8_t * msgs, int32_t * lens,
                            uint8_t * sigs, uint8_t * pubs,
                            int32_t * txn_idx, int32_t * sig_cnt,
                            uint64_t * tags, uint8_t * digests ) {
  uint8_t const * base = (uint8_t const *)dcache_base;
  uint64_t lane = 0UL;
  for( uint64_t i = 0; i < n; i++ ) {
    uint64_t sz = szs[ i ];
    if( sz > width ) sz = width;
    uint8_t const * p   = base + (uint64_t)chunks[ i ] * FDT_CHUNK_SZ;
    uint8_t       * row = rows_out + i * width;
    memcpy( row, p, sz );
    memset( row + sz, 0, width - sz );

    uint64_t ok = sz >= 16UL;
    uint64_t tb = ok ? sz - 16UL : 0UL;
    uint64_t sig_off = 0, pub_off = 0, msg_off = 0, msg_len = 0, cnt = 0;
    if( ok ) {
      sig_off = (uint64_t)p[ tb + 0 ] | ( (uint64_t)p[ tb + 1 ] << 8 );
      pub_off = (uint64_t)p[ tb + 2 ] | ( (uint64_t)p[ tb + 3 ] << 8 );
      msg_off = (uint64_t)p[ tb + 4 ] | ( (uint64_t)p[ tb + 5 ] << 8 );
      msg_len = (uint64_t)p[ tb + 6 ] | ( (uint64_t)p[ tb + 7 ] << 8 );
      cnt     = (uint64_t)p[ tb + 10 ];
      /* msg_width only bounds the copy-out buffer; digest-only callers
         (msgs == NULL) hash messages of any length */
      if( msgs && msg_len > msg_width ) msg_len = 0, ok = 0;
      if( msg_off + msg_len > tb ) msg_len = 0, ok = 0;
      if( !cnt || sig_off + 64UL * cnt > tb || pub_off + 32UL * cnt > tb )
        ok = 0;
    }
    if( !ok ) {
      /* one poisoned lane: zero sig/pub never verifies */
      if( msgs ) {
        memset( msgs + lane * msg_width, 0, msg_width );
        lens[ lane ] = 0;
      }
      memset( sigs + lane * 64UL, 0, 64UL );
      memset( pubs + lane * 32UL, 0, 32UL );
      if( digests ) memset( digests + lane * 64UL, 0, 64UL );
      txn_idx[ lane ] = (int32_t)i;
      sig_cnt[ i ] = 1;
      tags[ i ] = 0UL;
      lane++;
      continue;
    }
    sig_cnt[ i ] = (int32_t)cnt;
    uint64_t tag = 0UL;
    for( int b = 7; b >= 0; b-- )
      tag = ( tag << 8 ) | p[ sig_off + (uint64_t)b ];
    tags[ i ] = tag;
    for( uint64_t j = 0; j < cnt; j++ ) {
      if( msgs ) {  /* NULL when the caller ships digests instead */
        uint8_t * m = msgs + lane * msg_width;
        memcpy( m, p + msg_off, msg_len );
        memset( m + msg_len, 0, msg_width - msg_len );
        lens[ lane ] = (int32_t)msg_len;
      }
      memcpy( sigs + lane * 64UL, p + sig_off + 64UL * j, 64UL );
      memcpy( pubs + lane * 32UL, p + pub_off + 32UL * j, 32UL );
      if( digests )
        /* k-digest = SHA512(R || A || M): host-side so the device is
           shipped 64 digest bytes instead of msg_width message bytes */
        fdt_sha512_rpm( p + sig_off + 64UL * j, p + pub_off + 32UL * j,
                        p + msg_off, msg_len, digests + lane * 64UL );
      txn_idx[ lane ] = (int32_t)i;
      lane++;
    }
  }
  return lane;
}
