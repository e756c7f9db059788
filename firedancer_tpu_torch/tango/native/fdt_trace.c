/* Copy of firedancer_tpu/tango/native/fdt_trace.c, kept in the port so that
   firedancer_tpu_torch builds its ring library from its own sources. */

/* fdt_trace.c — implementation.  See fdt_trace.h for the design notes
 * and reference citations.  Original implementation: the span writer
 * restates disco/trace.py SpanRing.write_block's reserve→store→commit
 * discipline over the same memory layout, and the hist updater restates
 * disco/metrics.py Metrics.hist_sample's bucketing — both are pinned
 * byte/word-identical by differential tests
 * (tests/test_fdttrace_native.py). */

#define _POSIX_C_SOURCE 199309L

#include "fdt_trace.h"

#include <time.h>

uint64_t fdt_trace_words( void ) { return FDT_TRACE_WORDS; }

static inline uint64_t mono_ns( void ) {
  struct timespec ts;
  clock_gettime( CLOCK_MONOTONIC, &ts );
  return (uint64_t)( (int64_t)ts.tv_sec * 1000000000LL +
                     (int64_t)ts.tv_nsec );
}

#if defined( __x86_64__ )
#include <x86intrin.h>

/* Per-frag clock reads are the whole cost of in-burst timestamping (a
   vDSO clock_gettime is ~20-25 ns; two reads per frag at 2M frags/s is
   ~8-10% of the hop) — so the hot path reads the TSC (~6-8 ns) and
   interpolates against a CLOCK_MONOTONIC anchor re-taken every ~64 µs,
   the reference's fd_tempo tickcount-calibration idea.  The domain
   stays time.monotonic_ns µs mod 2^32: anchors come from the same
   clock Python reads, and interpolation error is bounded by the tsc
   frequency estimate's jitter over one recalibration window (sub-µs).
   Stamps can step backwards ~ns-scale across an anchor re-take; every
   consumer diffs through ts_diff and clamps at zero, exactly as the
   Python loop already must (its own cross-thread stamps jitter too).
   Thread-local: one calibration per tile thread, no sharing. */

#define RECAL_NS 262144.0 /* re-anchor every ~256 µs */

/* initial-exec TLS: the default global-dynamic model in a dlopen'd .so
   routes every access through __tls_get_addr (~10-20 ns — more than
   the rdtsc itself); initial-exec resolves to a fixed fs-relative
   offset.  Safe here: glibc reserves surplus static TLS for exactly
   this, and the block is ~64 bytes. */
static _Thread_local __attribute__(( tls_model( "initial-exec" ) )) struct {
  uint64_t base_us;     /* anchor, already in the µs domain */
  uint64_t base_ns;     /* same anchor untruncated — the frequency
                           estimate divides over one ~256 µs window, so
                           a µs-truncated numerator would skew it ~0.4%
                           (~1 µs of drift per window) */
  uint64_t base_tsc;
  uint64_t us_mult;     /* µs per tick, 32.32 fixed point */
  uint64_t recal_ticks; /* interpolation window in ticks */
  double ns_per_tick;   /* kept for anchor bookkeeping only */
  int valid;
} tcal;

static void tcal_anchor( uint64_t ns, uint64_t tsc ) {
  tcal.base_us = ns / 1000UL;
  tcal.base_ns = ns;
  tcal.base_tsc = tsc;
  /* µs/tick in 32.32: ns_per_tick / 1000 * 2^32 */
  tcal.us_mult = (uint64_t)( tcal.ns_per_tick * 4294967.296 );
  tcal.recal_ticks = (uint64_t)( RECAL_NS / tcal.ns_per_tick );
}

uint32_t fdt_trace_now( void ) {
  uint64_t tsc = __rdtsc();
  /* hot path: integer 32.32 interpolation against the last anchor —
     rdtsc + one mul/shift/add */
  uint64_t dt = tsc - tcal.base_tsc;
  if( __builtin_expect( tcal.valid && dt < tcal.recal_ticks, 1 ) )
    return (uint32_t)( tcal.base_us + ( ( dt * tcal.us_mult ) >> 32 ) );
  if( !tcal.valid ) {
    /* first use on this thread: a one-off ~20 µs spin calibration so
       even the first window interpolates with a measured frequency */
    uint64_t ns0 = mono_ns();
    uint64_t tsc0 = __rdtsc();
    uint64_t ns1 = ns0;
    while( ns1 - ns0 < 20000UL ) ns1 = mono_ns();
    uint64_t tsc1 = __rdtsc();
    tcal.ns_per_tick =
        tsc1 > tsc0 ? (double)( ns1 - ns0 ) / (double)( tsc1 - tsc0 )
                    : 1.0;
    if( tcal.ns_per_tick <= 0.01 || tcal.ns_per_tick > 100.0 )
      tcal.ns_per_tick = 1.0;
    tcal_anchor( ns1, tsc1 );
    tcal.valid = 1;
    return (uint32_t)( ns1 / 1000UL );
  }
  /* window expired: re-anchor on the real clock and refresh the
     frequency estimate from the elapsed window */
  uint64_t ns = mono_ns();
  if( tsc > tcal.base_tsc + 1000UL ) {
    double est = (double)( ns - tcal.base_ns ) /
                 (double)( tsc - tcal.base_tsc );
    /* reject insane estimates (VM migration, suspended thread) */
    if( est > 0.01 && est < 100.0 ) tcal.ns_per_tick = est;
  }
  tcal_anchor( ns, tsc );
  return (uint32_t)( ns / 1000UL );
}

#else /* portable fallback: one vDSO read per stamp */

uint32_t fdt_trace_now( void ) {
  return (uint32_t)( mono_ns() / 1000UL );
}

#endif

uint32_t fdt_trace_read_clock( uint64_t * tr ) {
  uint64_t cp = tr[ FDT_TRACE_W_CLOCK ];
  if( cp ) {
    uint64_t * c = (uint64_t *)cp;
    /* the clock words are read cross-process by the test collector:
       relaxed atomics keep each word untorn (single writer, no
       ordering needed) */
    uint64_t cv = __atomic_load_n( &c[ 0 ], __ATOMIC_RELAXED );
    __atomic_store_n( &c[ 0 ], cv + c[ 1 ], __ATOMIC_RELAXED );
    return (uint32_t)cv;
  }
  return fdt_trace_now();
}

int64_t fdt_trace_ts_diff( uint32_t a, uint32_t b ) {
  uint32_t d = a - b; /* mod 2^32 */
  return d >= 0x80000000U ? (int64_t)d - 0x100000000LL : (int64_t)d;
}

void fdt_trace_hist_sample( uint64_t * h, int64_t nb, int64_t v ) {
  int64_t vv = v < 1 ? 1 : v;
  int64_t b = 63 - __builtin_clzll( (uint64_t)vv );
  if( b > nb - 1 ) b = nb - 1;
  /* hist words are scraped live by the Python collector while the
     tile keeps sampling: relaxed load/store (cheaper than a locked
     RMW — the tile is the only writer) keeps every word untorn */
  __atomic_store_n( &h[ b ],
                    __atomic_load_n( &h[ b ], __ATOMIC_RELAXED ) + 1UL,
                    __ATOMIC_RELAXED );
  __atomic_store_n( &h[ nb ],
                    __atomic_load_n( &h[ nb ], __ATOMIC_RELAXED ) +
                        (uint64_t)( v > 0 ? v : 0 ),
                    __ATOMIC_RELAXED );
  __atomic_store_n( &h[ nb + 1 ],
                    __atomic_load_n( &h[ nb + 1 ], __ATOMIC_RELAXED ) + 1UL,
                    __ATOMIC_RELAXED );
}

/* SpanRing layout (disco/trace.py): header 8 u64 words, 4-word events */
#define RING_W_COMMITTED 0
#define RING_W_DEPTH 1
#define RING_W_RESERVE 3
#define RING_HDR_WORDS 8
#define RING_EVENT_WORDS 4

void fdt_trace_span_block( uint64_t * ring, uint64_t const * rows,
                           int64_t k ) {
  if( k <= 0 ) return;
  uint64_t w = ring[ RING_W_COMMITTED ];
  uint64_t depth = ring[ RING_W_DEPTH ];
  /* reserve before storing: a concurrent reader bounds the slots this
     store may be scribbling over by re-checking the reserve cursor
     (SpanRing.read's torn-window accounting).  SEQ_CST, not RELEASE:
     release only keeps PRIOR accesses above the store — the event-slot
     stores below could legally hoist above a release reserve bump,
     silently voiding the reserve-covers-in-progress-writes contract
     the cross-process reader depends on.  Once per block, so the
     full fence costs nothing measurable. */
  __atomic_store_n( &ring[ RING_W_RESERVE ], w + (uint64_t)k,
                    __ATOMIC_SEQ_CST );
  int64_t kept = k;
  int64_t skip = 0;
  if( (uint64_t)kept > depth ) {
    skip = kept - (int64_t)depth;
    kept = (int64_t)depth;
  }
  for( int64_t j = 0; j < kept; j++ ) {
    uint64_t slot = ( w + (uint64_t)( skip + j ) ) % depth;
    uint64_t * ev = ring + RING_HDR_WORDS + slot * RING_EVENT_WORDS;
    uint64_t const * r = rows + ( skip + j ) * RING_EVENT_WORDS;
    ev[ 0 ] = r[ 0 ];
    ev[ 1 ] = r[ 1 ];
    ev[ 2 ] = r[ 2 ];
    ev[ 3 ] = r[ 3 ];
  }
  __atomic_store_n( &ring[ RING_W_COMMITTED ], w + (uint64_t)k,
                    __ATOMIC_RELEASE );
}

void fdt_trace_span( uint64_t * ring, uint64_t kind, uint64_t link,
                     uint64_t aux16, uint64_t ts, uint64_t seq,
                     uint64_t sig, uint64_t aux64 ) {
  uint64_t row[ RING_EVENT_WORDS ];
  row[ 0 ] = ( ( kind & 0xFFUL ) << 56 ) | ( ( link & 0xFFUL ) << 48 ) |
             ( ( aux16 & 0xFFFFUL ) << 32 ) | ( ts & 0xFFFFFFFFUL );
  row[ 1 ] = seq;
  row[ 2 ] = sig;
  row[ 3 ] = aux64;
  fdt_trace_span_block( ring, row, 1 );
}
