/* fdt_stem.c — the port's copy of firedancer_tpu/tango/native/fdt_stem.c
 * without the elastic epoch watch.
 * Implementation.  See fdt_stem.h for the design notes and reference
 * citations.  Original implementation: the burst loop composes
 * the SAME primitive ring ops the Python loop uses (fdt_mcache_drain /
 * fdt_mcache_publish / fdt_fseq_update / fdt_fctl_cr_avail), so the stem
 * introduces no new ring protocol, only a new loop over the same one. */

/* clock_gettime(CLOCK_MONOTONIC) under -std=c11: the after-credit
   hook's cadence clock — the same clock source Python's
   time.monotonic_ns / tango.tempo.tickcount reads */
#define _POSIX_C_SOURCE 199309L

#include "fdt_stem.h"

#include "fdt_bank.h"
#include "fdt_net.h"
#include "fdt_pack.h"
#include "fdt_poh.h"
#include "fdt_shred.h"
#include "fdt_tango.h"
#include "fdt_trace.h"

#include <stdatomic.h>
#include <string.h>
#include <time.h>

/* ---- cfg word indices (fdt_stem.h documents the layout) ---------------- */

#define C_MAGIC 0
#define C_HANDLER 1
#define C_NINS 2
#define C_NOUTS 3
#define C_CAP 4
#define C_STATUS 5
#define C_STATUS_IN 6
#define C_ARGS 7
#define C_CTRS 8
#define C_TSPUB 9
/* C-owned sweep-rotation cursor: persists ACROSS calls so a
   budget-bounded burst cannot pin the sweep start at in 0 (the Python
   loop rotates its drain order per iteration for the same reason — a
   saturated in-link must not starve the others) */
#define C_ROT 10
/* after-credit hook: id + args block (fdt_stem.h word 11/12) */
#define C_AC 11
#define C_AC_ARGS 12
/* stem flags (fdt_stem.h word 13): FDT_STEM_F_* */
#define C_FLAGS 13
/* in-burst trace block ptr (fdt_stem.h word 240; fdt_trace.h layout) */
#define C_TRACE FDT_STEM_C_TRACE

#define IN0 16
#define IN_STRIDE 12
#define I_MCACHE 0
#define I_DCACHE 1
#define I_FSEQ 2
#define I_SEQ 3
#define I_FLAGS 4
/* word 5 reserved */
#define I_FRAGS 6
#define I_CONSUMED 7
#define I_BYTES 8
#define I_OVR 9

/* out-block layout is shared with fdt_pack_sched (fdt_stem.h is the
   single source of truth) */
#define OUT0 FDT_STEM_OUT0
#define OUT_STRIDE FDT_STEM_OUT_STRIDE
#define O_MCACHE FDT_STEM_O_MCACHE
#define O_DCACHE FDT_STEM_O_DCACHE
#define O_CHUNKP FDT_STEM_O_CHUNKP
#define O_MTU FDT_STEM_O_MTU
#define O_WMARK FDT_STEM_O_WMARK
#define O_DEPTH FDT_STEM_O_DEPTH
#define O_NFSEQ FDT_STEM_O_NFSEQ
#define O_FSEQ0 FDT_STEM_O_FSEQ0
#define O_SEQ FDT_STEM_O_SEQ
#define O_PUBLISHED FDT_STEM_O_PUBLISHED
#define O_BYTES FDT_STEM_O_BYTES
#define O_SIGS FDT_STEM_O_SIGS
#define O_TSORIGS FDT_STEM_O_TSORIGS

#define IN_F_NATIVE 1UL

static inline int64_t seq_delta( uint64_t a, uint64_t b ) {
  return (int64_t)( a - b ); /* signed distance mod 2^64 */
}

/* ---- parsed runtime view ----------------------------------------------- */

typedef struct {
  uint64_t * w; /* raw cfg words */
  uint64_t handler;
  int64_t n_ins;
  int64_t n_outs;
  int64_t cap;
  uint64_t * args;
  uint64_t * ctrs;
  uint32_t tspub;
  uint64_t ac;        /* after-credit hook id (0 = none) */
  uint64_t * ac_args; /* hook args block (pack: FDT_PACK_SS_*) */
  int manual;      /* manual-credit tile: skip the global credit gate
                      (handlers never publish from the frag path) */
  int need_python; /* set by a handler: the NEXT unhandled frag needs
                      the Python path (fallback, eviction, assert) */
} stem_t;

static inline uint64_t * in_blk( stem_t * st, int64_t i ) {
  return st->w + IN0 + i * IN_STRIDE;
}
static inline uint64_t * out_blk( stem_t * st, int64_t o ) {
  return st->w + OUT0 + o * OUT_STRIDE;
}

/* ---- in-burst tracing --------------------------------------------------
 *
 * The trace block (fdt_trace.h) rides cfg word C_TRACE and is consulted
 * from the one publish body below via thread-local state armed for the
 * duration of fdt_stem_run — so every handler and after-credit hook
 * that publishes through fdt_stem_out_emit(_at) gets per-frag publish
 * timestamps and PUBLISH span emission with NO signature change, and a
 * direct (non-stem) emit call traces nothing.  One stem runs per tile
 * thread, so thread-local is exactly per-tile. */

/* initial-exec TLS: see fdt_trace.c's tcal note — the default model in
   a dlopen'd .so pays a __tls_get_addr call per access on the per-frag
   publish path */
static _Thread_local __attribute__(( tls_model( "initial-exec" ) ))
uint64_t * tls_trace = 0;
static _Thread_local __attribute__(( tls_model( "initial-exec" ) ))
uint64_t * tls_cfg = 0;

static inline uint64_t trace_w0( uint64_t kind, uint64_t link,
                                 uint32_t ts ) {
  return ( ( kind & 0xFFUL ) << 56 ) | ( ( link & 0xFFUL ) << 48 ) |
         (uint64_t)ts;
}

/* flush the buffered PUBLISH span rows to the ring (ordering contract:
   the caller writes the batch's INGEST block first) */
static void trace_flush_pub( uint64_t * tr ) {
  uint64_t cnt = tr[ FDT_TRACE_W_PUBCNT ];
  if( !cnt ) return;
  uint64_t * ring = (uint64_t *)tr[ FDT_TRACE_W_RING ];
  if( ring )
    fdt_trace_span_block( ring, (uint64_t *)tr[ FDT_TRACE_W_PUBROWS ],
                          (int64_t)cnt );
  tr[ FDT_TRACE_W_PUBCNT ] = 0;
}

/* 1-in-N sig sampling: N is a power of two in practice (the default
   TraceConfig sample is 64), where a mask beats the hardware div on
   the per-publish path; arbitrary N falls back to the modulo */
static inline int trace_sampled( uint64_t sig, uint64_t sample ) {
  if( sample <= 1UL ) return 1;
  if( ( sample & ( sample - 1UL ) ) == 0UL )
    return ( sig & ( sample - 1UL ) ) == 0UL;
  return sig % sample == 0UL;
}

static void trace_pub_span( uint64_t * tr, uint64_t link, uint64_t seq,
                            uint64_t sig, uint32_t tsorig,
                            uint32_t tspub ) {
  uint64_t * rows = (uint64_t *)tr[ FDT_TRACE_W_PUBROWS ];
  if( !rows ) return;
  uint64_t cnt = tr[ FDT_TRACE_W_PUBCNT ];
  if( cnt >= tr[ FDT_TRACE_W_PUBCAP ] ) {
    trace_flush_pub( tr ); /* overflow: flush early, order best-effort */
    cnt = 0;
  }
  uint64_t * r = rows + cnt * 4;
  r[ 0 ] = trace_w0( FDT_TRACE_K_PUBLISH, link, tspub );
  r[ 1 ] = seq;
  r[ 2 ] = sig;
  r[ 3 ] = (uint64_t)tsorig; /* Tracer.publish w3 with tsorigs given */
  tr[ FDT_TRACE_W_PUBCNT ] = cnt + 1;
}

/* The one publish body every native path shares: release-ordered mcache
   publish + sig/tsorig scratch + out-block bookkeeping, with the trace
   hook applied when a stem armed it — a fresh per-frag compressed
   publish timestamp (the burst-quantization fix: downstream qwait no
   longer sees every frag of a burst stamped alike) and a buffered
   PUBLISH span for sampled sigs. */
static void stem_emit_common( uint64_t * o, uint64_t sig, uint32_t chunk,
                              uint64_t sz, uint16_t ctl, uint32_t tsorig,
                              uint32_t tspub, int64_t sig_cap ) {
  uint64_t * tr = tls_trace;
  if( tr ) tspub = fdt_trace_read_clock( tr );
  /* THE publish body every native path shares */
  fdt_mcache_publish( (void *)o[ O_MCACHE ], o[ O_SEQ ], sig, chunk,
                      (uint16_t)sz, ctl, tsorig, tspub );
  uint64_t p = o[ O_PUBLISHED ];
  if( (int64_t)p < sig_cap ) {
    if( o[ O_SIGS ] ) ( (uint64_t *)o[ O_SIGS ] )[ p ] = sig;
    if( o[ O_TSORIGS ] ) ( (uint32_t *)o[ O_TSORIGS ] )[ p ] = tsorig;
  }
  if( tr && tr[ FDT_TRACE_W_RING ] &&
      trace_sampled( sig, tr[ FDT_TRACE_W_SAMPLE ] ) ) {
    int64_t oi =
        ( o - ( tls_cfg + FDT_STEM_OUT0 ) ) / FDT_STEM_OUT_STRIDE;
    uint64_t link = ( oi >= 0 && oi < FDT_STEM_MAX_OUTS )
                        ? tr[ FDT_TRACE_OUT0 + oi ]
                        : 0UL;
    trace_pub_span( tr, link, o[ O_SEQ ], sig, tsorig, tspub );
  }
  o[ O_SEQ ] = o[ O_SEQ ] + 1UL;
  o[ O_PUBLISHED ] = p + 1UL;
  o[ O_BYTES ] += sz;
}

/* Publish one frag on an out block: payload (if any) goes into the out
   dcache at the shared chunk cursor first (the ring-publish-order rule:
   bytes before metadata), then the release-ordered mcache publish — the
   exact op sequence OutLink.publish performs, so the wire stream is
   bit-identical to the Python loop's.  Exported: the block-egress
   handlers (fdt_poh.c / fdt_shred.c) publish through this one body. */
void fdt_stem_out_emit( uint64_t * o, uint64_t sig,
                        uint8_t const * payload, uint64_t sz,
                        uint16_t ctl, uint32_t tsorig, uint32_t tspub,
                        int64_t sig_cap ) {
  uint32_t chunk = 0;
  if( payload && o[ O_DCACHE ] ) {
    uint64_t * cur = (uint64_t *)o[ O_CHUNKP ];
    uint64_t c = *cur;
    memcpy( (uint8_t *)o[ O_DCACHE ] + c * FDT_CHUNK_SZ, payload, sz );
    chunk = (uint32_t)c;
    *cur = fdt_dcache_compact_next( c, sz, o[ O_MTU ], o[ O_WMARK ] );
  }
  stem_emit_common( o, sig, chunk, sz, ctl, tsorig, tspub, sig_cap );
}

/* Publish a frag whose payload the caller ALREADY placed in the out
   dcache (fdt_net_rx's recvmmsg-into-dcache rows, fdt_pack_sched's
   encode-in-place) — same metadata/trace body,
   no copy.  Every native publish routes through one of these two entry
   points, so per-frag tspub stamping and span propagation cannot be
   bypassed. */
void fdt_stem_out_emit_at( uint64_t * o, uint64_t sig, uint32_t chunk,
                           uint64_t sz, uint16_t ctl, uint32_t tsorig,
                           uint32_t tspub, int64_t sig_cap ) {
  stem_emit_common( o, sig, chunk, sz, ctl, tsorig, tspub, sig_cap );
}

/* cr_avail for one out block against its slowest reliable consumer —
   exported so the after-credit hooks gate every publish round on a
   LIVE fseq read, never a credit count cached across a publish. */
int64_t fdt_stem_out_cr( uint64_t const * ob ) {
  uint64_t nf = ob[ O_NFSEQ ];
  uint64_t avail = ob[ O_DEPTH ];
  if( nf ) {
    uint64_t lo = fdt_fseq_query( (void *)ob[ O_FSEQ0 ] );
    for( uint64_t j = 1; j < nf && j < 4; j++ ) {
      uint64_t v = fdt_fseq_query( (void *)ob[ O_FSEQ0 + j ] );
      if( seq_delta( v, lo ) < 0 ) lo = v;
    }
    avail = fdt_fctl_cr_avail( ob[ O_SEQ ], lo, ob[ O_DEPTH ] );
  }
  return (int64_t)avail;
}

static void stem_publish( stem_t * st, int64_t oi, uint64_t sig,
                          uint8_t const * payload, uint64_t sz,
                          uint32_t tsorig ) {
  fdt_stem_out_emit( out_blk( st, oi ), sig, payload, sz,
                     (uint16_t)( FDT_CTL_SOM | FDT_CTL_EOM ), tsorig,
                     st->tspub, st->cap );
}

/* ==== dedup handler ===================================================== */

/* args block (u64 words) */
#define DH_TCACHE 0
#define DH_JNL 1 /* 0 = unjournaled (multi-out dedup shape) */
#define DH_JCAP 2
#define DH_ISDUP 3 /* u8[cap] scratch */
#define DH_TAGS 4  /* u64[cap] scratch */

/* journal word layout — MUST match tiles/dedup.py (_J_* / _B_*) */
#define DJ_PHASE 0
#define DJ_SEQ0 1
#define DJ_ACTIVE 2
#define DJ_SLOT0 8
#define DB_CNT 2
#define DB_TAGS 4

/* counter scratch indices (tiles/dedup.py maps these to names) */
#define DC_DUP 0

static int64_t h_dedup( stem_t * st, int64_t ii, fdt_frag_t const * f,
                        int64_t n ) {
  uint64_t * a = st->args;
  void * tc = (void *)a[ DH_TCACHE ];
  uint64_t * jnl = (uint64_t *)a[ DH_JNL ];
  uint64_t jcap = a[ DH_JCAP ];
  uint8_t * isdup = (uint8_t *)a[ DH_ISDUP ];
  uint64_t * tags = (uint64_t *)a[ DH_TAGS ];
  uint64_t * o = out_blk( st, 0 );
  uint8_t const * in_dc = (uint8_t const *)in_blk( st, ii )[ I_DCACHE ];

  /* never outgrow the crash journal (tiles/dedup.py chunking rule): a
     shorter return WITHOUT need_python makes the stem rewind and drain
     the rest next sweep */
  if( jnl && (uint64_t)n > jcap ) n = (int64_t)jcap;

  for( int64_t k = 0; k < n; k++ ) tags[ k ] = f[ k ].sig;

  if( jnl ) {
    /* arm the journal BEFORE the insert mutates the shm cache: slot 0
       zeroed + seq0 first, phase last (release), so a kill sees either
       a clean journal or a fully-described window */
    uint64_t * b0 = jnl + DJ_SLOT0;
    uint64_t blk = 4UL + jcap;
    jnl[ DJ_ACTIVE ] = 0UL;
    b0[ DB_CNT ] = 0UL;
    b0[ DB_CNT + 1 ] = 0UL; /* overflow flag */
    jnl[ DJ_SEQ0 ] = o[ O_SEQ ];
    __atomic_store_n( &jnl[ DJ_PHASE ], 1UL, __ATOMIC_RELEASE );
    st->ctrs[ DC_DUP ] +=
        fdt_tcache_dedup_j( tc, tags, (uint64_t)n, isdup, b0, jcap );
    int64_t n_surv = 0;
    int zero_tag = 0;
    for( int64_t k = 0; k < n; k++ )
      if( !isdup[ k ] ) {
        n_surv++;
        if( !f[ k ].sig ) zero_tag = 1;
      }
    if( !n_surv ) {
      __atomic_store_n( &jnl[ DJ_PHASE ], 0UL, __ATOMIC_RELEASE );
      return n;
    }
    if( zero_tag ) {
      /* zero-tag survivors publish without a fresh insert, so the
         out-seq -> journal mapping needs the FULL survivor list:
         write it to the inactive slot and flip with one store */
      uint64_t * b1 = jnl + DJ_SLOT0 + blk;
      uint64_t m = 0;
      for( int64_t k = 0; k < n; k++ )
        if( !isdup[ k ] ) b1[ DB_TAGS + m++ ] = f[ k ].sig;
      b1[ DB_CNT ] = m;
      __atomic_store_n( &jnl[ DJ_ACTIVE ], 1UL, __ATOMIC_RELEASE );
    }
  } else {
    st->ctrs[ DC_DUP ] +=
        fdt_tcache_dedup( tc, tags, (uint64_t)n, isdup );
  }

  for( int64_t k = 0; k < n; k++ ) {
    if( isdup[ k ] ) continue;
    stem_publish( st, 0, f[ k ].sig,
                  in_dc + (uint64_t)f[ k ].chunk * FDT_CHUNK_SZ,
                  f[ k ].sz, f[ k ].tsorig );
  }
  if( jnl ) __atomic_store_n( &jnl[ DJ_PHASE ], 0UL, __ATOMIC_RELEASE );
  return n;
}

/* ==== bank handler (fused decode -> scan -> exec pipeline) ============== */

/* args block (u64 words) — decode/scan scratch + table/journal wiring */
#define BH_ROWS 0 /* u8 (max_n, stride) decode scratch */
#define BH_STRIDE 1
#define BH_SZS 2 /* u32[max_n] */
#define BH_MAXN 3
#define BH_OK 4
#define BH_ISVOTE 5
#define BH_FAST 6
#define BH_COST 7
#define BH_REWARDS 8
#define BH_CULIM 9
#define BH_TAGS 10
#define BH_LAMPORTS 11
#define BH_PAYER 12
#define BH_SRC 13
#define BH_DST 14
#define BH_FEE 15
#define BH_IDX 16    /* i64[max_n] */
#define BH_STATUS 17 /* u8[max_n] */
#define BH_OFEES 18  /* u64[max_n] */
#define BH_TABLE 19
#define BH_JOURNAL 20
#define BH_ZEROCHECK 21
#define BH_BANKID 22

/* counter scratch indices (tiles/bank.py maps these to names) */
#define BC_EXEC_MB 0
#define BC_EXEC_TXNS 1
#define BC_FAILED 2
#define BC_FAST 3
#define BC_FEES 4
#define BC_MALFORMED 5
#define BC_NATIVE 6

/* python-owned completed-seq journal word (BankTable._JW_COMPLETED) */
#define BJ_COMPLETED 31
/* C undo-journal words read for the resume computation (fdt_bank.c) */
#define BJ_TAG 0
#define BJ_DONE 1

int64_t fdt_bank_pipeline( uint8_t const * mb, int64_t mb_sz,
                           uint64_t * a, uint64_t mb_tag,
                           uint64_t * out_stats ) {
  memset( out_stats, 0, 8 * sizeof( uint64_t ) );
  uint64_t * jw = (uint64_t *)a[ BH_JOURNAL ];

  /* replay below the completed-seq mark was applied in full by a
     previous incarnation: republish, never re-execute (the same
     wrap-safe compare as BankTable.already_complete) */
  uint64_t comp = jw[ BJ_COMPLETED ];
  if( comp && seq_delta( mb_tag, comp ) < 0 ) {
    out_stats[ 0 ] = 3;
    return 3;
  }

  uint8_t * rows = (uint8_t *)a[ BH_ROWS ];
  int64_t stride = (int64_t)a[ BH_STRIDE ];
  uint32_t * szs = (uint32_t *)a[ BH_SZS ];
  int64_t max_n = (int64_t)a[ BH_MAXN ];
  /* a microblock too large for the fixed native scratch is NOT
     malformed — Python's growable scratch handles it */
  if( mb_sz >= 8 ) {
    int64_t n16 = (int64_t)( (uint16_t)mb[ 6 ] |
                             ( (uint16_t)mb[ 7 ] << 8 ) );
    if( n16 > max_n ) {
      out_stats[ 0 ] = 2;
      return 2;
    }
  }
  int64_t n = fdt_mb_decode( mb, mb_sz, rows, stride, szs, max_n );
  if( n < 0 ) {
    out_stats[ 0 ] = 1;
    return 1;
  }
  out_stats[ 1 ] = (uint64_t)n;

  uint8_t * ok = (uint8_t *)a[ BH_OK ];
  uint8_t * fast = (uint8_t *)a[ BH_FAST ];
  fdt_txn_scan( rows, stride, 0, szs, n, 0, ok, (uint8_t *)a[ BH_ISVOTE ],
                fast, (uint32_t *)a[ BH_COST ],
                (uint64_t *)a[ BH_REWARDS ], (uint32_t *)a[ BH_CULIM ],
                (uint64_t *)a[ BH_TAGS ], (uint64_t *)a[ BH_LAMPORTS ],
                (uint32_t *)a[ BH_PAYER ], (uint32_t *)a[ BH_SRC ],
                (uint32_t *)a[ BH_DST ], (uint32_t *)a[ BH_FEE ], 0, 0, 0,
                0, 0, 0, 0, 0, 0, 0, 0 );

  /* any non-fast txn (incl. parse failures) takes the general-executor
     path: hand the WHOLE microblock back to Python untouched — the
     journal's (tag, done) keeps an interrupted earlier attempt's fast
     prefix exactly-once through the Python resume */
  for( int64_t t = 0; t < n; t++ )
    if( !fast[ t ] ) {
      out_stats[ 0 ] = 2;
      return 2;
    }

  int64_t * idx = (int64_t *)a[ BH_IDX ];
  for( int64_t t = 0; t < n; t++ ) idx[ t ] = t;
  uint8_t * status = (uint8_t *)a[ BH_STATUS ];
  uint64_t * ofees = (uint64_t *)a[ BH_OFEES ];

  /* the effective start fdt_bank_exec's journal adoption will use
     (needed to count only what THIS call executes) */
  int64_t start = 0;
  if( jw[ BJ_TAG ] == mb_tag ) {
    start = (int64_t)jw[ BJ_DONE ];
    if( start > n ) start = n;
  }
  int64_t done = fdt_bank_exec(
      rows, stride, idx, 0, n, (uint32_t *)a[ BH_PAYER ],
      (uint32_t *)a[ BH_SRC ], (uint32_t *)a[ BH_DST ],
      (uint32_t *)a[ BH_FEE ], (uint64_t *)a[ BH_LAMPORTS ],
      (uint8_t *)a[ BH_TABLE ], (uint8_t *)jw, mb_tag,
      (int64_t)a[ BH_ZEROCHECK ], status, ofees );
  int64_t newly = done > start ? done - start : 0;
  uint64_t failed = 0, fees = 0;
  for( int64_t t = start; t < done; t++ ) {
    if( status[ t ] != FDT_BANK_OK ) failed++;
    fees += ofees[ t ];
  }
  out_stats[ 2 ] = (uint64_t)newly;
  out_stats[ 3 ] = failed;
  out_stats[ 4 ] = fees;
  if( done < n ) {
    /* MISS (cold key: funk resolve) or NONTRIVIAL (general executor):
       Python-only work — progress so far is in the journal */
    out_stats[ 0 ] = 2;
    return 2;
  }
  /* fully executed: record the completed-seq mark (mark_complete).
     Release so a recovery process that reads the mark also sees every
     slot/journal store this batch made before it */
  __atomic_store_n( &jw[ BJ_COMPLETED ], mb_tag + 1UL, __ATOMIC_RELEASE );
  out_stats[ 0 ] = 0;
  return 0;
}

static int64_t h_bank( stem_t * st, int64_t ii, fdt_frag_t const * f,
                       int64_t n ) {
  uint64_t * a = st->args;
  uint8_t const * in_dc = (uint8_t const *)in_blk( st, ii )[ I_DCACHE ];
  uint64_t stats[ 8 ];
  for( int64_t k = 0; k < n; k++ ) {
    uint8_t const * p = in_dc + (uint64_t)f[ k ].chunk * FDT_CHUNK_SZ;
    uint64_t sz = f[ k ].sz;
    if( sz < 8 ) { st->need_python = 1; return k; }
    uint64_t handle = (uint64_t)p[ 0 ] | ( (uint64_t)p[ 1 ] << 8 ) |
                      ( (uint64_t)p[ 2 ] << 16 ) |
                      ( (uint64_t)p[ 3 ] << 24 );
    uint64_t bank = (uint64_t)p[ 4 ] | ( (uint64_t)p[ 5 ] << 8 );
    if( bank != a[ BH_BANKID ] ) { st->need_python = 1; return k; }
    uint64_t sig = ( bank << 32 ) | handle;
    int64_t rc =
        fdt_bank_pipeline( p, (int64_t)sz, a, f[ k ].seq, stats );
    if( rc == 2 ) {
      /* a fast prefix may have executed before the stop — count it
         NOW (the Python resume counts only what IT executes, and the
         journal's done-mark keeps the split exactly-once) */
      st->ctrs[ BC_FAST ] += stats[ 2 ];
      st->ctrs[ BC_FAILED ] += stats[ 3 ];
      st->ctrs[ BC_FEES ] += stats[ 4 ];
      st->ctrs[ BC_NATIVE ] += stats[ 2 ];
      st->need_python = 1;
      return k;
    }
    if( rc == 1 ) {
      /* malformed microblock: metered drop that still completes at
         pack (handle/locks never leak); nothing goes to poh */
      st->ctrs[ BC_MALFORMED ]++;
      stem_publish( st, 0, sig, 0, 0, st->tspub );
      continue;
    }
    if( rc == 0 ) {
      st->ctrs[ BC_EXEC_MB ]++;
      st->ctrs[ BC_EXEC_TXNS ] += stats[ 1 ];
      st->ctrs[ BC_FAST ] += stats[ 2 ];
      st->ctrs[ BC_FAILED ] += stats[ 3 ];
      st->ctrs[ BC_FEES ] += stats[ 4 ];
      st->ctrs[ BC_NATIVE ] += stats[ 2 ];
    }
    /* rc == 3 (already complete): republish only, no counters —
       the dead incarnation already counted it in the shm metrics */
    stem_publish( st, 1, sig, p, sz, st->tspub ); /* poh first */
    stem_publish( st, 0, sig, 0, 0, st->tspub );  /* then free the bank */
  }
  return n;
}


/* ==== pack insert handler =============================================== */

/* args block (u64 words): engine arrays + scan scratch.  The engine's
   dense pool arrays are numpy allocations owned by ballet/pack.Pack —
   never reallocated after init, single-writer (the pack tile). */
#define PH_STATE 0 /* u8[P]: 0 free, 1 pending, 2 inflight */
#define PH_POOL 1  /* P */
#define PH_ROWS 2
#define PH_ROWW 3 /* engine payload width */
#define PH_SZS 4  /* u16[P] */
#define PH_REWARDS 5
#define PH_COST 6
#define PH_EXPIRES 7
#define PH_SIGTAG 8
#define PH_ISVOTE 9 /* u8[P] (numpy bool_) */
#define PH_BSRW 10
#define PH_BSW 11
#define PH_W 12 /* bitset words per row */
#define PH_WHASH 13
#define PH_WCNT 14
#define PH_MAXW 15
#define PH_RHASH 16
#define PH_RCNT 17
#define PH_MAXR 18
#define PH_NBITS 19
#define PH_TRAILER 20 /* wire trailer bytes excluded from the scan sz */
/* scan scratch */
#define PH_SROWS 21
#define PH_SW 22
#define PH_SCAP 23
#define PH_SSZS 24
#define PH_SOK 25
#define PH_SISVOTE 26
#define PH_SFAST 27
#define PH_SCOST 28
#define PH_SREW 29
#define PH_SCULIM 30
#define PH_STAGS 31
#define PH_SLAM 32
#define PH_SPAYER 33
#define PH_SSRC 34
#define PH_SDST 35
#define PH_SFEE 36
#define PH_SBSRW 37
#define PH_SBSW 38
#define PH_SWHASH 39
#define PH_SWCNT 40
#define PH_SRHASH 41
#define PH_SRCNT 42

/* counter scratch indices (tiles/pack.py maps these to names) */
#define PC_INSERTED 0
#define PC_REJECTED 1
#define PC_MICROBLOCKS 2
#define PC_MB_TXNS 3
#define PC_COMPLETIONS 4
#define PC_STALE 5

#define PACK_ST_FREE 0
#define PACK_ST_PENDING 1

/* Completion-ring handler (ins[1..]): sig carries
   (bank << 32) | handle; look the microblock up in the outstanding
   registry (first match, the numpy flatnonzero[0] order the Python
   path uses), release its exact account locks via fdt_pack_release_x
   walking the pick-order slot chain, free the pool slots, and drop
   busy/outstanding counts — so a pending completion no longer ejects
   the stem.  A completion with no registry entry is a METERED drop
   (stale_completions), never a crash: a restarted bank replays its
   ring window and re-publishes completions this tile already
   released (exactly-once lives in the bank journal). */
static int64_t h_pack_comp( stem_t * st, fdt_frag_t const * f,
                            int64_t n ) {
  uint64_t * a = st->ac_args;
  if( !a ) { st->need_python = 1; return 0; }
  uint8_t * state = (uint8_t *)a[ FDT_PACK_SS_STATE ];
  uint64_t const * whash = (uint64_t const *)a[ FDT_PACK_SS_WHASH ];
  uint8_t const * wcnt = (uint8_t const *)a[ FDT_PACK_SS_WCNT ];
  int64_t maxw = (int64_t)a[ FDT_PACK_SS_MAXW ];
  uint64_t const * rhash = (uint64_t const *)a[ FDT_PACK_SS_RHASH ];
  uint8_t const * rcnt = (uint8_t const *)a[ FDT_PACK_SS_RCNT ];
  int64_t maxr = (int64_t)a[ FDT_PACK_SS_MAXR ];
  uint64_t * lwk = (uint64_t *)a[ FDT_PACK_SS_LWKEYS ];
  int64_t * lwv = (int64_t *)a[ FDT_PACK_SS_LWVALS ];
  int64_t lmask = (int64_t)a[ FDT_PACK_SS_LMASK ];
  uint64_t * lrk = (uint64_t *)a[ FDT_PACK_SS_LRKEYS ];
  int64_t * lrv = (int64_t *)a[ FDT_PACK_SS_LRVALS ];
  int64_t * sw = (int64_t *)a[ FDT_PACK_SS_WORDS ];
  uint8_t * mb_used = (uint8_t *)a[ FDT_PACK_SS_MB_USED ];
  int64_t * mb_bank = (int64_t *)a[ FDT_PACK_SS_MB_BANK ];
  uint64_t * mb_handle = (uint64_t *)a[ FDT_PACK_SS_MB_HANDLE ];
  int64_t * mb_head = (int64_t *)a[ FDT_PACK_SS_MB_HEAD ];
  int64_t * mb_cnt = (int64_t *)a[ FDT_PACK_SS_MB_CNT ];
  int64_t * mb_next = (int64_t *)a[ FDT_PACK_SS_MB_NEXT ];
  int64_t mb_cap = (int64_t)a[ FDT_PACK_SS_MB_CAP ];
  int64_t n_banks = (int64_t)a[ FDT_PACK_SS_NBANKS ];
  int64_t * bank_busy = (int64_t *)a[ FDT_PACK_SS_BANK_BUSY ];
  int64_t * idx = (int64_t *)a[ FDT_PACK_SS_PICKS ];

  for( int64_t k = 0; k < n; k++ ) {
    uint64_t sig = f[ k ].sig;
    int64_t bank = (int64_t)( sig >> 32 );
    uint64_t handle = sig & 0xFFFFFFFFUL;
    int64_t m = -1;
    if( bank < n_banks )
      for( int64_t i = 0; i < mb_cap; i++ )
        if( mb_used[ i ] && mb_bank[ i ] == bank
            && mb_handle[ i ] == handle ) { m = i; break; }
    if( m < 0 ) {
      st->ctrs[ PC_STALE ]++;
      continue;
    }
    int64_t cnt = mb_cnt[ m ];
    int64_t s = mb_head[ m ];
    for( int64_t j = 0; j < cnt && s >= 0; j++ ) {
      idx[ j ] = s;
      s = mb_next[ s ];
    }
    fdt_pack_release_x( idx, cnt, whash, wcnt, maxw, rhash, rcnt, maxr,
                        lwk, lwv, lmask, lrk, lrv, lmask );
    for( int64_t j = 0; j < cnt; j++ ) state[ idx[ j ] ] = PACK_ST_FREE;
    mb_used[ m ] = 0;
    sw[ 3 ]--;
    bank_busy[ bank ]--;
    st->ctrs[ PC_COMPLETIONS ]++;
  }
  return n;
}

static int64_t h_pack( stem_t * st, int64_t ii, fdt_frag_t const * f,
                       int64_t n ) {
  if( ii > 0 ) return h_pack_comp( st, f, n );
  uint64_t * a = st->args;
  uint8_t const * in_dc = (uint8_t const *)in_blk( st, ii )[ I_DCACHE ];
  int64_t scap = (int64_t)a[ PH_SCAP ];
  if( n > scap ) n = scap; /* chunk: the stem rewinds + re-drains */

  uint8_t * srows = (uint8_t *)a[ PH_SROWS ];
  int64_t sw = (int64_t)a[ PH_SW ];
  uint32_t * sszs = (uint32_t *)a[ PH_SSZS ];
  uint64_t trailer = a[ PH_TRAILER ];
  for( int64_t k = 0; k < n; k++ ) {
    uint64_t sz = f[ k ].sz;
    if( sz > (uint64_t)sw ) sz = (uint64_t)sw;
    uint8_t * row = srows + k * sw;
    memcpy( row, in_dc + (uint64_t)f[ k ].chunk * FDT_CHUNK_SZ, sz );
    memset( row + sz, 0, (uint64_t)sw - sz );
    sszs[ k ] = sz > trailer ? (uint32_t)( sz - trailer ) : 0U;
  }

  uint8_t * sok = (uint8_t *)a[ PH_SOK ];
  int64_t maxw = (int64_t)a[ PH_MAXW ];
  int64_t maxr = (int64_t)a[ PH_MAXR ];
  fdt_txn_scan(
      srows, sw, 0, sszs, n, (int64_t)a[ PH_NBITS ], sok,
      (uint8_t *)a[ PH_SISVOTE ], (uint8_t *)a[ PH_SFAST ],
      (uint32_t *)a[ PH_SCOST ], (uint64_t *)a[ PH_SREW ],
      (uint32_t *)a[ PH_SCULIM ], (uint64_t *)a[ PH_STAGS ],
      (uint64_t *)a[ PH_SLAM ], (uint32_t *)a[ PH_SPAYER ],
      (uint32_t *)a[ PH_SSRC ], (uint32_t *)a[ PH_SDST ],
      (uint32_t *)a[ PH_SFEE ], (uint64_t *)a[ PH_SBSRW ],
      (uint64_t *)a[ PH_SBSW ], (uint64_t *)a[ PH_SWHASH ],
      (uint8_t *)a[ PH_SWCNT ], maxw, (uint64_t *)a[ PH_SRHASH ],
      (uint8_t *)a[ PH_SRCNT ], maxr, 0, 0, 0 );

  int64_t n_ok = 0;
  for( int64_t k = 0; k < n; k++ )
    if( sok[ k ] ) n_ok++;

  if( n_ok ) {
    /* free-slot scatter, ascending slot order (numpy flatnonzero
       order, so the pool layout is bit-identical to insert_batch).
       The priority-eviction path (pool full) is Python-only: count
       free slots FIRST and bail before mutating anything. */
    uint8_t * state = (uint8_t *)a[ PH_STATE ];
    int64_t P = (int64_t)a[ PH_POOL ];
    int64_t n_free = 0;
    for( int64_t s = 0; s < P && n_free < n_ok; s++ )
      if( state[ s ] == PACK_ST_FREE ) n_free++;
    if( n_free < n_ok ) { st->need_python = 1; return 0; }
    int64_t W = (int64_t)a[ PH_W ];
    uint8_t * erows = (uint8_t *)a[ PH_ROWS ];
    int64_t eroww = (int64_t)a[ PH_ROWW ];
    int64_t cw = sw < eroww ? sw : eroww;
    uint16_t * eszs = (uint16_t *)a[ PH_SZS ];
    uint64_t * erew = (uint64_t *)a[ PH_REWARDS ];
    uint32_t * ecost = (uint32_t *)a[ PH_COST ];
    uint64_t * eexp = (uint64_t *)a[ PH_EXPIRES ];
    uint64_t * etag = (uint64_t *)a[ PH_SIGTAG ];
    uint8_t * evote = (uint8_t *)a[ PH_ISVOTE ];
    uint64_t * ebsrw = (uint64_t *)a[ PH_BSRW ];
    uint64_t * ebsw = (uint64_t *)a[ PH_BSW ];
    uint64_t * ewh = (uint64_t *)a[ PH_WHASH ];
    uint8_t * ewc = (uint8_t *)a[ PH_WCNT ];
    uint64_t * erh = (uint64_t *)a[ PH_RHASH ];
    uint8_t * erc = (uint8_t *)a[ PH_RCNT ];
    uint32_t const * scost = (uint32_t const *)a[ PH_SCOST ];
    uint64_t const * srew = (uint64_t const *)a[ PH_SREW ];
    uint8_t const * sisvote = (uint8_t const *)a[ PH_SISVOTE ];
    uint64_t const * sbsrw = (uint64_t const *)a[ PH_SBSRW ];
    uint64_t const * sbsw = (uint64_t const *)a[ PH_SBSW ];
    uint64_t const * swh = (uint64_t const *)a[ PH_SWHASH ];
    uint8_t const * swc = (uint8_t const *)a[ PH_SWCNT ];
    uint64_t const * srh = (uint64_t const *)a[ PH_SRHASH ];
    uint8_t const * src_ = (uint8_t const *)a[ PH_SRCNT ];

    int64_t slot = 0;
    int64_t placed = 0;
    for( int64_t k = 0; k < n && placed < n_ok; k++ ) {
      if( !sok[ k ] ) continue;
      while( slot < P && state[ slot ] != PACK_ST_FREE ) slot++;
      if( slot >= P ) break; /* unreachable: n_free >= n_ok above */
      memcpy( erows + slot * eroww, srows + k * sw, (uint64_t)cw );
      eszs[ slot ] = (uint16_t)sszs[ k ];
      uint64_t rw = srew[ k ];
      erew[ slot ] = rw > 0xFFFFFFFFUL ? 0xFFFFFFFFUL : rw;
      ecost[ slot ] = scost[ k ];
      eexp[ slot ] = 0UL;
      etag[ slot ] = f[ k ].sig; /* dedup tag rides the frag sig */
      evote[ slot ] = sisvote[ k ] ? 1 : 0;
      memcpy( ebsrw + slot * W, sbsrw + k * W, (uint64_t)W * 8UL );
      memcpy( ebsw + slot * W, sbsw + k * W, (uint64_t)W * 8UL );
      memcpy( ewh + slot * maxw, swh + k * maxw, (uint64_t)maxw * 8UL );
      ewc[ slot ] = swc[ k ];
      memcpy( erh + slot * maxr, srh + k * maxr, (uint64_t)maxr * 8UL );
      erc[ slot ] = src_[ k ];
      state[ slot ] = PACK_ST_PENDING;
      slot++;
      placed++;
    }
  }
  st->ctrs[ PC_INSERTED ] += (uint64_t)n_ok;
  st->ctrs[ PC_REJECTED ] += (uint64_t)( n - n_ok );
  return n;
}

/* ==== block-egress handlers ============================================= */

/* poh — mixin ladder (fdt_poh.c): every drained microblock frag mixes
   into the chain and emits one entry on outs[0].  The stem's per-sweep
   credit bound already caps n at cr, so each emit is credit-backed. */
static int64_t h_poh( stem_t * st, int64_t ii, fdt_frag_t const * f,
                      int64_t n ) {
  uint8_t const * in_dc = (uint8_t const *)in_blk( st, ii )[ I_DCACHE ];
  return fdt_poh_mixins( st->args, out_blk( st, 0 ), st->cap, st->tspub,
                         st->ctrs, in_dc, f, n, ii );
}

/* shred — batch append (ins[0]) / signature patch (ins[1]); a negative
   return from either body names a frag that needs the Python path
   (slot-boundary shredding, batch spill, a Python-held pending set). */
/* net — tx burst (fdt_net.c): sendmmsg straight from the in dcache; a
   destination missing from the route cache hands back to Python (the
   IpStack lookup + fdt_net_route_put slow path). */
static int64_t h_net( stem_t * st, int64_t ii, fdt_frag_t const * f,
                      int64_t n ) {
  uint8_t const * in_dc = (uint8_t const *)in_blk( st, ii )[ I_DCACHE ];
  int64_t r = fdt_net_tx( st->args, in_dc, f, n, st->ctrs );
  if( r < 0 ) {
    st->need_python = 1;
    return ~r;
  }
  return r;
}

static int64_t h_shred( stem_t * st, int64_t ii, fdt_frag_t const * f,
                        int64_t n ) {
  uint8_t const * in_dc = (uint8_t const *)in_blk( st, ii )[ I_DCACHE ];
  int64_t r = ii == 0
                  ? fdt_shred_entries( st->args, in_dc, f, n, st->ctrs )
                  : fdt_shred_sign( st->args, in_dc, f, n, st->ctrs );
  if( r < 0 ) {
    st->need_python = 1;
    return ~r;
  }
  return r;
}

/* ==== the burst loop ==================================================== */

/* Apply the in-burst trace for one handled run: per-frag qwait/e2e
   hist samples against the DRAIN-TIME stamps (captured before the
   handler ran — the per-frag clock reads that remove the burst
   quantization), the batch's INGEST span block, then the publish spans
   the handler buffered (the Python loop's ring order: ingest before
   that batch's publishes), one batch svc sample and the batch_sz
   sample — everything the Python loop records per drained batch,
   recorded here per handled run with identical bucketing. */
static void stem_trace_apply( uint64_t * tr, int64_t ii,
                              fdt_frag_t const * f,
                              uint32_t const * tsbuf, int64_t handled ) {
  uint64_t const * ib = tr + FDT_TRACE_IN0 + ii * FDT_TRACE_IN_STRIDE;
  uint64_t * hq = (uint64_t *)ib[ FDT_TRACE_I_QWAIT ];
  uint64_t * he = (uint64_t *)ib[ FDT_TRACE_I_E2E ];
  int64_t qnb = (int64_t)ib[ FDT_TRACE_I_QWAIT_NB ];
  int64_t enb = (int64_t)ib[ FDT_TRACE_I_E2E_NB ];
  for( int64_t j = 0; j < handled; j++ ) {
    if( hq ) {
      int64_t d = fdt_trace_ts_diff( tsbuf[ j ], f[ j ].tspub );
      fdt_trace_hist_sample( hq, qnb, d > 0 ? d : 0 );
    }
    if( he ) {
      int64_t d = fdt_trace_ts_diff( tsbuf[ j ], f[ j ].tsorig );
      fdt_trace_hist_sample( he, enb, d > 0 ? d : 0 );
    }
  }
  uint64_t * ring = (uint64_t *)tr[ FDT_TRACE_W_RING ];
  if( ring ) {
    uint64_t sample = tr[ FDT_TRACE_W_SAMPLE ];
    uint64_t link = ib[ FDT_TRACE_I_LINK ];
    uint64_t * rows = (uint64_t *)tr[ FDT_TRACE_W_INROWS ];
    int64_t m = 0;
    for( int64_t j = 0; j < handled; j++ ) {
      uint64_t sig = f[ j ].sig;
      if( !trace_sampled( sig, sample ) ) continue;
      uint64_t * r = rows + m * 4;
      r[ 0 ] = trace_w0( FDT_TRACE_K_INGEST, link, tsbuf[ j ] );
      r[ 1 ] = f[ j ].seq;
      r[ 2 ] = sig;
      r[ 3 ] = ( (uint64_t)f[ j ].tsorig << 32 ) |
               (uint64_t)f[ j ].tspub;
      m++;
    }
    if( m ) fdt_trace_span_block( ring, rows, m );
  }
  trace_flush_pub( tr );
  uint64_t * hs = (uint64_t *)ib[ FDT_TRACE_I_SVC ];
  if( hs && handled > 0 ) {
    int64_t d =
        fdt_trace_ts_diff( fdt_trace_read_clock( tr ), tsbuf[ 0 ] );
    fdt_trace_hist_sample( hs, (int64_t)ib[ FDT_TRACE_I_SVC_NB ],
                           d > 0 ? d : 0 );
  }
  uint64_t * hb = (uint64_t *)tr[ FDT_TRACE_W_BATCH ];
  if( hb )
    fdt_trace_hist_sample( hb, (int64_t)tr[ FDT_TRACE_W_BATCH_NB ],
                           handled );
}

/* min over outs of cr_avail against the slowest reliable consumer —
   re-read from the live fseqs at every call site (per sweep AND before
   the after-credit hook), never carried across a boundary */
static int64_t stem_min_cr( stem_t * st ) {
  int64_t cr = st->cap;
  for( int64_t o = 0; o < st->n_outs; o++ ) {
    int64_t avail = fdt_stem_out_cr( out_blk( st, o ) );
    if( avail < cr ) cr = avail;
  }
  return cr;
}

uint64_t fdt_stem_cfg_words( void ) { return FDT_STEM_CFG_WORDS; }

int64_t fdt_stem_run( uint64_t * cfg, int64_t max_frags ) {
  if( cfg[ C_MAGIC ] != FDT_STEM_MAGIC ) return -1;
  stem_t st;
  st.w = cfg;
  st.handler = cfg[ C_HANDLER ];
  st.n_ins = (int64_t)cfg[ C_NINS ];
  st.n_outs = (int64_t)cfg[ C_NOUTS ];
  st.cap = (int64_t)cfg[ C_CAP ];
  st.args = (uint64_t *)cfg[ C_ARGS ];
  st.ctrs = (uint64_t *)cfg[ C_CTRS ];
  st.tspub = (uint32_t)cfg[ C_TSPUB ];
  st.ac = cfg[ C_AC ];
  st.ac_args = (uint64_t *)cfg[ C_AC_ARGS ];
  st.manual = ( cfg[ C_FLAGS ] & FDT_STEM_F_MANUAL ) ? 1 : 0;
  st.need_python = 0;
  if( st.n_ins > FDT_STEM_MAX_INS || st.n_outs > FDT_STEM_MAX_OUTS )
    return -1;
  /* the handlers and hooks this build carries; an unknown id is
     refused before anything is touched */
  if( st.handler != FDT_STEM_H_DEDUP && st.handler != FDT_STEM_H_BANK &&
      st.handler != FDT_STEM_H_PACK && st.handler != FDT_STEM_H_POH &&
      st.handler != FDT_STEM_H_SHRED && st.handler != FDT_STEM_H_NET )
    return -1;
  if( st.ac != 0 && st.ac != FDT_STEM_AC_PACK && st.ac != FDT_STEM_AC_POH &&
      st.ac != FDT_STEM_AC_SHRED && st.ac != FDT_STEM_AC_NET )
    return -1;
  if( max_frags > st.cap ) max_frags = st.cap;

  memset( st.ctrs, 0, FDT_STEM_N_CTRS * sizeof( uint64_t ) );
  for( int64_t i = 0; i < st.n_ins; i++ ) {
    uint64_t * in = in_blk( &st, i );
    in[ I_CONSUMED ] = in[ I_BYTES ] = in[ I_OVR ] = 0UL;
  }
  for( int64_t o = 0; o < st.n_outs; o++ ) {
    uint64_t * ob = out_blk( &st, o );
    ob[ O_PUBLISHED ] = ob[ O_BYTES ] = 0UL;
  }

  int64_t total = 0;
  uint64_t status = FDT_STEM_IDLE;
  uint64_t status_in = 0;

  /* arm the in-burst trace (fdt_trace.h) for this call: every publish
     through stem_emit_common and every handled run below records its
     own per-frag timestamps while the burst runs */
  uint64_t * tr = (uint64_t *)cfg[ C_TRACE ];
  if( tr && tr[ FDT_TRACE_W_MAGIC ] != FDT_TRACE_MAGIC ) tr = 0;
  tls_cfg = cfg;
  tls_trace = tr;
  if( tr ) tr[ FDT_TRACE_W_PUBCNT ] = 0;

  for( ;; ) {
    int progressed = 0;
    int pending_blocked = 0;

    /* per-sweep credit bound: min over outs of cr_avail against the
       slowest reliable consumer — re-read every sweep so a long burst
       tracks consumer progress instead of trusting a stale credit
       count (skipping this re-read would publish past one credit
       computation).  Manual-credit tiles skip the global gate
       (their handlers never publish from the frag path; every publish
       is per-ring gated in the after-credit hook). */
    int64_t cr = st.manual ? st.cap : stem_min_cr( &st );

    uint64_t rot = cfg[ C_ROT ]++;
    for( int64_t k = 0; k < st.n_ins; k++ ) {
      int64_t i =
          (int64_t)( ( rot + (uint64_t)k ) % (uint64_t)st.n_ins );
      if( total >= max_frags ) { status = FDT_STEM_BUDGET; goto done; }
      uint64_t * in = in_blk( &st, i );
      uint64_t prod = fdt_mcache_seq_query( (void *)in[ I_MCACHE ] );
      if( !( in[ I_FLAGS ] & IN_F_NATIVE ) ) {
        /* python-only link: any pending frag hands control back */
        if( seq_delta( in[ I_SEQ ], prod ) < 0 ) {
          status = FDT_STEM_PYTHON;
          status_in = (uint64_t)i;
          goto done;
        }
        continue;
      }
      int64_t budget = max_frags - total;
      int64_t room = st.cap - (int64_t)in[ I_CONSUMED ];
      if( room < budget ) budget = room;
      if( st.n_outs && budget > cr ) budget = cr;
      if( budget <= 0 ) {
        if( st.n_outs && cr <= 0 && seq_delta( in[ I_SEQ ], prod ) < 0 )
          pending_blocked = 1;
        continue;
      }
      fdt_frag_t * buf =
          (fdt_frag_t *)in[ I_FRAGS ] + in[ I_CONSUMED ];
      uint64_t seq = in[ I_SEQ ];
      uint64_t ovr = 0;
      int64_t n = (int64_t)fdt_mcache_drain(
          (void *)in[ I_MCACHE ], &seq, (uint64_t)budget, buf, &ovr );
      in[ I_OVR ] += ovr;
      if( !n ) {
        in[ I_SEQ ] = seq; /* overrun resync may have advanced it */
        continue;
      }
      /* drain-time consume stamps: captured BEFORE the handler runs
         (queue-wait ends when the frag is picked up, not when the
         burst returns to Python) — applied below only for the handled
         prefix, so a handed-back frag is stamped by whichever loop
         actually consumes it.  One clock read per drained RUN: the
         batched fdt_mcache_drain picks the whole run up at one
         instant, so its frags genuinely share a pickup time (the
         Python loop's per-batch t_cons, bit-for-bit) — the burst-
         quantization this removes is the POST-handler application
         across many runs, not intra-run spread.  Publish stamps
         (stem_emit_common) stay truly per frag: emissions spread
         across the handler's work. */
      uint32_t * tsbuf = 0;
      if( tr ) {
        tsbuf = (uint32_t *)tr[ FDT_TRACE_W_TS ];
        uint32_t t_run = fdt_trace_read_clock( tr );
        for( int64_t j = 0; j < n; j++ ) tsbuf[ j ] = t_run;
      }
      int64_t handled;
      switch( st.handler ) {
      case FDT_STEM_H_DEDUP:
        handled = h_dedup( &st, i, buf, n );
        break;
      case FDT_STEM_H_BANK:
        handled = h_bank( &st, i, buf, n );
        break;
      case FDT_STEM_H_PACK:
        handled = h_pack( &st, i, buf, n );
        break;
      case FDT_STEM_H_POH:
        handled = h_poh( &st, i, buf, n );
        break;
      case FDT_STEM_H_SHRED:
        handled = h_shred( &st, i, buf, n );
        break;
      case FDT_STEM_H_NET:
        handled = h_net( &st, i, buf, n );
        break;
      default:
        tls_trace = 0;
        tls_cfg = 0;
        return -1;
      }
      if( tr && handled > 0 )
        stem_trace_apply( tr, i, buf, tsbuf, handled );
      uint64_t bytes = 0;
      for( int64_t j = 0; j < handled; j++ ) bytes += buf[ j ].sz;
      in[ I_BYTES ] += bytes;
      in[ I_CONSUMED ] += (uint64_t)handled;
      total += handled;
      if( handled ) progressed = 1;
      /* consume credits on EVERY path that handled frags — a chunking
         return that skipped this would let the next in-link publish
         against a stale credit count (the stem-burst-over-credit bug
         class) */
      if( st.n_outs ) cr -= handled;
      if( handled < n ) {
        /* rewind the cursor to the first unhandled frag — its copy in
           buf carries its seq; the fseq below never advances past the
           handled prefix, so a reliable producer cannot overwrite it */
        in[ I_SEQ ] = buf[ handled ].seq;
        fdt_fseq_update( (void *)in[ I_FSEQ ], in[ I_SEQ ] );
        if( st.need_python ) {
          status = FDT_STEM_PYTHON;
          status_in = (uint64_t)i;
          goto done;
        }
        /* handler chunking (journal / scan-scratch capacity): keep
           sweeping — the rest re-drains next round */
        continue;
      }
      in[ I_SEQ ] = seq;
      fdt_fseq_update( (void *)in[ I_FSEQ ], seq );
    }
    if( !progressed ) {
      status = pending_blocked ? FDT_STEM_BP : FDT_STEM_IDLE;
      break;
    }
  }

done:
  /* after-credit hook at the burst boundary — the native analog of the
     Python loop's tile.after_credit slot (where producer tiles
     generate work).  Skipped when the burst ends in PYTHON (the Python
     after_credit runs this iteration, so the hook would double-fire)
     and on zero-credit boundaries (the Python loop skips after_credit
     on backpressure iterations — the gate is RE-DERIVED from the live
     consumer fseqs here, never a credit value carried across the hook
     boundary).  Manual-
     credit hooks (shred) run unconditionally and gate per ring inside,
     exactly like the Python manual_credits contract. */
  if( st.ac && status != FDT_STEM_PYTHON && st.ac_args ) {
    int gate = st.manual || !st.n_outs || stem_min_cr( &st ) > 0;
    switch( st.ac ) {
    case FDT_STEM_AC_PACK:
      if( gate ) {
        struct timespec ts;
        clock_gettime( CLOCK_MONOTONIC, &ts );
        int64_t now =
            (int64_t)ts.tv_sec * 1000000000LL + (int64_t)ts.tv_nsec;
        int64_t rc = fdt_pack_sched( st.ac_args, cfg + OUT0, st.n_outs,
                                     st.cap, now, (uint64_t)st.tspub,
                                     st.ctrs + PC_MICROBLOCKS );
        if( rc < 0 ) {
          /* block boundary with zero outstanding: end_block is Python */
          status = FDT_STEM_PYTHON;
          status_in = FDT_STEM_IN_AC;
        }
      }
      break;
    case FDT_STEM_AC_POH:
      if( gate ) {
        struct timespec ts;
        clock_gettime( CLOCK_MONOTONIC, &ts );
        int64_t now =
            (int64_t)ts.tv_sec * 1000000000LL + (int64_t)ts.tv_nsec;
        fdt_poh_tick( st.ac_args, cfg + OUT0, st.cap, now,
                      (uint64_t)st.tspub, st.ctrs );
      }
      break;
    case FDT_STEM_AC_SHRED:
      fdt_shred_drain( st.ac_args, cfg + OUT0, st.n_outs, st.cap,
                       (uint64_t)st.tspub, st.ctrs );
      break;
    case FDT_STEM_AC_NET:
      if( gate )
        fdt_net_rx( st.ac_args, cfg + OUT0, st.n_outs, st.cap,
                    (uint64_t)st.tspub, st.ctrs );
      break;
    default:
      break;
    }
  }
  /* the after-credit hook's publish spans were buffered — flush them
     before control returns to Python (the hook is the batch here) */
  if( tr ) trace_flush_pub( tr );
  tls_trace = 0;
  tls_cfg = 0;
  cfg[ C_STATUS ] = status;
  cfg[ C_STATUS_IN ] = status_in;
  return total;
}
