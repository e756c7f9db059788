/* fdt_bank.c — the port's copy of firedancer_tpu/tango/native/fdt_bank.c.
 * Implementation.  See fdt_bank.h for the design notes and
 * reference citations.  The execution semantics re-state
 * flamenco/runtime.py execute_fast_transfers (this build's authoritative
 * spec for the fast-transfer class, itself differentially pinned to
 * execute_txn); the table is an open-addressing pubkey -> lamports map in
 * shared memory with release-published slots and per-slot funk-sync
 * version words. */

#include "fdt_bank.h"

#include <string.h>

/* ==== geometry ========================================================== */

#define HDR_BYTES 64
#define SPIN_MAX 1000000
#define MAGIC 0x314B4E4142544446UL /* "FDTBANK1" LE */
#define MAGIC_INIT 0x1UL           /* init-in-progress claim */

typedef struct {
  uint64_t magic;
  uint64_t slot_cnt;
  uint64_t mask;
  uint64_t pad[ 5 ];
} bank_hdr_t;

typedef struct {
  uint8_t  key[ 32 ];
  uint64_t state;    /* FDT_BANK_ST_*; claim/publish word */
  uint64_t lamports; /* valid when state == TRIVIAL */
  uint64_t ver;      /* bumped on every mutation */
  uint64_t synced;   /* last version drained to funk */
} bank_slot_t;

static inline uint64_t bld64le( uint8_t const * p ) {
  uint64_t v;
  memcpy( &v, p, 8 );
  return v;
}

/* splitmix64 finalizer over first-8 XOR last-8 (ballet/pack.py
   _hash_acct — the same hash the pack lock tables key on). */
static inline uint64_t bacct_hash( uint8_t const * key ) {
  uint64_t x = bld64le( key ) ^ bld64le( key + 24 );
  x ^= x >> 30; x *= 0xBF58476D1CE4E5B9UL;
  x ^= x >> 27; x *= 0x94D049BB133111EBUL;
  x ^= x >> 31;
  return x;
}

uint64_t fdt_bank_tab_footprint( uint64_t slot_cnt ) {
  if( !slot_cnt || ( slot_cnt & ( slot_cnt - 1 ) ) ) return 0;
  return HDR_BYTES + slot_cnt * sizeof( bank_slot_t );
}

int fdt_bank_tab_new( uint8_t * mem, uint64_t slot_cnt ) {
  bank_hdr_t * h = (bank_hdr_t *)mem;
  if( !slot_cnt || ( slot_cnt & ( slot_cnt - 1 ) ) ) return -1;
  uint64_t expect = 0;
  if( __atomic_compare_exchange_n( &h->magic, &expect, MAGIC_INIT, 0,
                                   __ATOMIC_ACQUIRE, __ATOMIC_ACQUIRE ) ) {
    /* we own init; region is zero-filled at creation (Workspace) */
    h->slot_cnt = slot_cnt;
    h->mask = slot_cnt - 1;
    __atomic_store_n( &h->magic, MAGIC, __ATOMIC_RELEASE );
    return 0;
  }
  /* live table or a concurrent initializer: wait for the header */
  for( int64_t spins = 0; expect != MAGIC; spins++ ) {
    if( spins > SPIN_MAX * 64L ) return -1; /* wedged initializer */
    expect = __atomic_load_n( &h->magic, __ATOMIC_ACQUIRE );
  }
  if( h->slot_cnt != slot_cnt ) return -1; /* geometry mismatch */
  return 1;
}

uint64_t fdt_bank_tab_slots( uint8_t const * mem ) {
  bank_hdr_t const * h = (bank_hdr_t const *)mem;
  if( __atomic_load_n( &h->magic, __ATOMIC_ACQUIRE ) != MAGIC ) return 0;
  return h->slot_cnt;
}

/* ==== slot lookup / claim =============================================== */

static inline bank_slot_t * slots_of( uint8_t * mem ) {
  return (bank_slot_t *)( mem + HDR_BYTES );
}

/* Load a slot's state, waiting out a transient insert.  A slot that
   stays BUSY past the spin bound belongs to a claimer killed mid-insert:
   it never held data, so the caller treats it as not-my-key and keeps
   probing (one dead slot leaks, fail-closed). */
static inline uint64_t slot_state( bank_slot_t * s ) {
  uint64_t st = __atomic_load_n( &s->state, __ATOMIC_ACQUIRE );
  for( int64_t spins = 0; st == FDT_BANK_ST_BUSY && spins < SPIN_MAX;
       spins++ )
    st = __atomic_load_n( &s->state, __ATOMIC_ACQUIRE );
  return st;
}

/* Find the slot holding `key`.  Returns the slot (state via *st_out) or
   NULL with *st_out = EMPTY when the key is not cached. */
static bank_slot_t * tab_find( uint8_t * mem, uint8_t const * key,
                               uint64_t * st_out ) {
  bank_hdr_t * h = (bank_hdr_t *)mem;
  bank_slot_t * slots = slots_of( mem );
  uint64_t mask = h->mask;
  uint64_t i = bacct_hash( key ) & mask;
  for( uint64_t probes = 0; probes <= mask; probes++ ) {
    bank_slot_t * s = &slots[ i ];
    uint64_t st = slot_state( s );
    if( st == FDT_BANK_ST_EMPTY ) { *st_out = FDT_BANK_ST_EMPTY; return 0; }
    if( st != FDT_BANK_ST_BUSY && !memcmp( s->key, key, 32 ) ) {
      *st_out = st;
      return s;
    }
    i = ( i + 1 ) & mask;
  }
  *st_out = FDT_BANK_ST_EMPTY; /* full table: behaves as a miss */
  return 0;
}

int64_t fdt_bank_tab_get( uint8_t const * mem, uint8_t const * key,
                          uint64_t * out_lamports ) {
  uint64_t st;
  bank_slot_t * s = tab_find( (uint8_t *)mem, key, &st );
  if( s && out_lamports )
    *out_lamports = __atomic_load_n( &s->lamports, __ATOMIC_ACQUIRE );
  return (int64_t)st;
}

/* Update an existing slot in place.  dirty=0: the write mirrors funk
   (synced catches up to ver); dirty=1: funk must still be told. */
static inline void slot_store( bank_slot_t * s, uint64_t state,
                               uint64_t lamports, int dirty ) {
  __atomic_store_n( &s->lamports, lamports, __ATOMIC_RELEASE );
  __atomic_store_n( &s->state, state, __ATOMIC_RELEASE );
  uint64_t v =
      __atomic_add_fetch( &s->ver, 1, __ATOMIC_ACQ_REL );
  if( !dirty ) __atomic_store_n( &s->synced, v, __ATOMIC_RELEASE );
}

int64_t fdt_bank_tab_put( uint8_t * mem, uint8_t const * key, int64_t state,
                          uint64_t lamports, int64_t dirty ) {
  bank_hdr_t * h = (bank_hdr_t *)mem;
  bank_slot_t * slots = slots_of( mem );
  uint64_t mask = h->mask;
  uint64_t i = bacct_hash( key ) & mask;
  for( uint64_t probes = 0; probes <= mask; probes++ ) {
    bank_slot_t * s = &slots[ i ];
    uint64_t st = slot_state( s );
    if( st == FDT_BANK_ST_EMPTY ) {
      /* claim: CAS EMPTY -> BUSY makes us the unique writer of this
         slot; publish key + fields, then the final state (release).
         Concurrent same-key inserts cannot happen (pack's account
         locks partition writers), so a lost CAS just advances the
         probe. */
      uint64_t expect = FDT_BANK_ST_EMPTY;
      if( __atomic_compare_exchange_n( &s->state, &expect, FDT_BANK_ST_BUSY,
                                       0, __ATOMIC_ACQ_REL,
                                       __ATOMIC_ACQUIRE ) ) {
        memcpy( s->key, key, 32 );
        s->lamports = lamports;
        s->ver = 1;
        s->synced = dirty ? 0 : 1;
        __atomic_store_n( &s->state, (uint64_t)state, __ATOMIC_RELEASE );
        return 0;
      }
      st = slot_state( s ); /* re-read the winner's publication */
    }
    if( st != FDT_BANK_ST_BUSY && st != FDT_BANK_ST_EMPTY
        && !memcmp( s->key, key, 32 ) ) {
      slot_store( s, (uint64_t)state, lamports, (int)dirty );
      return 0;
    }
    i = ( i + 1 ) & mask;
  }
  return -1; /* full: caller falls back to the funk path (fail closed) */
}

/* ==== undo journal ====================================================== */

/* u64 words: [0] mb_tag, [1] txns done, [2] phase (1 = applying),
   [3] n_undo, [4] done-count BEFORE the in-flight txn (rollback must
   restore it — a kill between the done-advance and the phase-clear
   would otherwise roll the slots back while still counting the txn
   done, silently losing it), then per undo entry: slot index, old
   state, old lamports.  Single writer (the owning bank); SIGKILL
   leaves either a clean record or phase==1 with a complete undo set
   (entries are written before the phase release-store). */

#define J_TAG 0
#define J_DONE 1
#define J_PHASE 2
#define J_NUNDO 3
#define J_DPRE 4
#define J_ENT 5

static void journal_rollback( uint8_t * mem, uint64_t * j ) {
  bank_hdr_t * h = (bank_hdr_t *)mem;
  bank_slot_t * slots = slots_of( mem );
  uint64_t nu = j[ J_NUNDO ];
  if( nu > 3 ) nu = 3;
  for( uint64_t k = 0; k < nu; k++ ) {
    uint64_t idx = j[ J_ENT + 3 * k ];
    if( idx >= h->slot_cnt ) continue;
    bank_slot_t * s = &slots[ idx ];
    __atomic_store_n( &s->lamports, j[ J_ENT + 3 * k + 2 ],
                      __ATOMIC_RELEASE );
    __atomic_store_n( &s->state, j[ J_ENT + 3 * k + 1 ], __ATOMIC_RELEASE );
    /* re-mark dirty: funk may have seen the rolled-back value via a
       concurrent commit; the restored value must be drained over it */
    __atomic_add_fetch( &s->ver, 1, __ATOMIC_ACQ_REL );
  }
  /* the rolled-back txn is NOT done: restore the pre-txn count (a kill
     after the done-advance but before the phase-clear must re-execute) */
  __atomic_store_n( &j[ J_DONE ], j[ J_DPRE ], __ATOMIC_RELEASE );
  __atomic_store_n( &j[ J_PHASE ], 0, __ATOMIC_RELEASE );
}

int64_t fdt_bank_recover( uint8_t * mem, uint8_t * journal,
                          uint64_t * out_tag_done ) {
  uint64_t * j = (uint64_t *)journal;
  int64_t rolled = 0;
  if( j[ J_PHASE ] == 1 ) {
    journal_rollback( mem, j );
    rolled = 1;
  }
  if( out_tag_done ) {
    out_tag_done[ 0 ] = j[ J_TAG ];
    out_tag_done[ 1 ] = j[ J_DONE ];
  }
  return rolled;
}

/* ==== batch execute ===================================================== */

/* per-txn overlay: <=3 distinct slots (payer, src, dst) */
typedef struct {
  bank_slot_t * slot[ 3 ];
  uint64_t val[ 3 ];
  uint64_t new_state[ 3 ];
  int n;
} overlay_t;

static inline int ov_idx( overlay_t * ov, bank_slot_t * s ) {
  for( int k = 0; k < ov->n; k++ )
    if( ov->slot[ k ] == s ) return k;
  return -1;
}

static inline void ov_set( overlay_t * ov, bank_slot_t * s, uint64_t v,
                           uint64_t state ) {
  int k = ov_idx( ov, s );
  if( k < 0 ) { k = ov->n++; ov->slot[ k ] = s; }
  ov->val[ k ] = v;
  ov->new_state[ k ] = state;
}

/* Commit one txn's overlay atomically-across-SIGKILL: undo record first
   (complete before the phase release-store), then the slot writes, then
   done-count advance and phase clear. */
static void ov_apply( uint8_t * mem, uint64_t * j, overlay_t * ov,
                      int64_t t_done ) {
  bank_slot_t * slots = slots_of( mem );
  for( int k = 0; k < ov->n; k++ ) {
    bank_slot_t * s = ov->slot[ k ];
    j[ J_ENT + 3 * k ] = (uint64_t)( s - slots );
    j[ J_ENT + 3 * k + 1 ] = s->state;
    j[ J_ENT + 3 * k + 2 ] = s->lamports;
  }
  j[ J_NUNDO ] = (uint64_t)ov->n;
  j[ J_DPRE ] = (uint64_t)( t_done - 1 );
  __atomic_store_n( &j[ J_PHASE ], 1, __ATOMIC_RELEASE );
  for( int k = 0; k < ov->n; k++ )
    slot_store( ov->slot[ k ], ov->new_state[ k ], ov->val[ k ], 1 );
  __atomic_store_n( &j[ J_DONE ], (uint64_t)t_done, __ATOMIC_RELEASE );
  __atomic_store_n( &j[ J_PHASE ], 0, __ATOMIC_RELEASE );
}

int64_t fdt_bank_exec( uint8_t const * rows, int64_t stride,
                       int64_t const * idx, int64_t start, int64_t n,
                       uint32_t const * payer_off, uint32_t const * src_off,
                       uint32_t const * dst_off, uint32_t const * fee,
                       uint64_t const * amount, uint8_t * mem,
                       uint8_t * journal, uint64_t mb_tag,
                       int64_t zero_check, uint8_t * status,
                       uint64_t * out_fees ) {
  uint64_t * j = (uint64_t *)journal;
  if( j[ J_PHASE ] == 1 ) journal_rollback( mem, j ); /* defensive */
  if( j[ J_TAG ] != mb_tag ) {
    /* done first, tag last: a kill between the stores must never leave
       (new tag, stale done) — that resume would skip unexecuted txns */
    __atomic_store_n( &j[ J_DONE ], (uint64_t)start, __ATOMIC_RELEASE );
    __atomic_store_n( &j[ J_TAG ], mb_tag, __ATOMIC_RELEASE );
  } else if( (int64_t)j[ J_DONE ] > start ) {
    /* resumed mid-microblock: the shm journal outranks the caller */
    start = (int64_t)j[ J_DONE ];
    if( start > n ) start = n;
  }

  for( int64_t t = start; t < n; t++ ) {
    int64_t s = idx[ t ];
    uint8_t const * p = rows + s * stride;
    uint64_t fee_t = (uint64_t)fee[ s ];
    uint64_t amt = amount[ s ];
    status[ t ] = FDT_BANK_OK;
    out_fees[ t ] = 0;

    uint8_t const * payer_k = p + payer_off[ s ];
    uint64_t pst;
    bank_slot_t * payer_s = tab_find( mem, payer_k, &pst );
    if( pst == FDT_BANK_ST_EMPTY ) { status[ t ] = FDT_BANK_MISS; return t; }
    if( pst == FDT_BANK_ST_NONTRIVIAL ) {
      status[ t ] = FDT_BANK_NONTRIV;
      return t;
    }
    uint64_t pl =
        pst == FDT_BANK_ST_TRIVIAL
            ? __atomic_load_n( &payer_s->lamports, __ATOMIC_ACQUIRE )
            : 0;
    if( pst == FDT_BANK_ST_ABSENT || pl < fee_t ) {
      /* rejected outright: no fee, no writes (runtime: absent or
         underfunded payer cannot pay) */
      status[ t ] = FDT_BANK_REJECT;
      __atomic_store_n( &j[ J_DONE ], (uint64_t)( t + 1 ),
                        __ATOMIC_RELEASE );
      continue;
    }

    overlay_t ov = { { 0, 0, 0 }, { 0, 0, 0 }, { 0, 0, 0 }, 0 };
    ov_set( &ov, payer_s, pl - fee_t, FDT_BANK_ST_TRIVIAL );
    out_fees[ t ] = fee_t;

    /* src: the fast class guarantees a writable signer; it may alias
       the payer by offset or by content (same slot either way) */
    uint8_t const * src_k = p + src_off[ s ];
    bank_slot_t * src_s = payer_s;
    uint64_t sst = FDT_BANK_ST_TRIVIAL;
    if( src_off[ s ] != payer_off[ s ] && memcmp( src_k, payer_k, 32 ) ) {
      src_s = tab_find( mem, src_k, &sst );
      if( sst == FDT_BANK_ST_EMPTY ) { status[ t ] = FDT_BANK_MISS; return t; }
      if( sst == FDT_BANK_ST_NONTRIVIAL ) {
        status[ t ] = FDT_BANK_NONTRIV;
        return t;
      }
    } else {
      src_k = payer_k;
    }
    if( sst == FDT_BANK_ST_ABSENT ) {
      /* missing source: pre-feature a 0-lamport transfer is a silent
         no-op; post-feature it is "insufficient funds" — either way
         the fee stands */
      if( !( amt == 0 && !zero_check ) ) status[ t ] = FDT_BANK_FAIL;
      ov_apply( mem, j, &ov, t + 1 );
      continue;
    }
    int sk = ov_idx( &ov, src_s );
    uint64_t sl = sk >= 0
                      ? ov.val[ sk ]
                      : __atomic_load_n( &src_s->lamports, __ATOMIC_ACQUIRE );
    if( sl < amt ) {
      status[ t ] = FDT_BANK_FAIL;
      ov_apply( mem, j, &ov, t + 1 );
      continue;
    }
    uint8_t const * dst_k = p + dst_off[ s ];
    if( !memcmp( src_k, dst_k, 32 ) ) {
      /* self-transfer no-op; the fee still applies */
      ov_apply( mem, j, &ov, t + 1 );
      continue;
    }
    ov_set( &ov, src_s, sl - amt, FDT_BANK_ST_TRIVIAL );
    uint64_t dst_st;
    bank_slot_t * dst_s = tab_find( mem, dst_k, &dst_st );
    if( dst_st == FDT_BANK_ST_EMPTY ) { status[ t ] = FDT_BANK_MISS; return t; }
    if( dst_st == FDT_BANK_ST_NONTRIVIAL ) {
      status[ t ] = FDT_BANK_NONTRIV;
      return t;
    }
    int dk = ov_idx( &ov, dst_s );
    uint64_t dl = dk >= 0 ? ov.val[ dk ]
                : dst_st == FDT_BANK_ST_ABSENT
                      ? 0
                      : __atomic_load_n( &dst_s->lamports, __ATOMIC_ACQUIRE );
    if( dl + amt < dl ) { /* u64 overflow: not representable here */
      status[ t ] = FDT_BANK_NONTRIV;
      return t;
    }
    ov_set( &ov, dst_s, dl + amt, FDT_BANK_ST_TRIVIAL );
    ov_apply( mem, j, &ov, t + 1 );
  }
  return n;
}

/* ==== funk write-back =================================================== */

int64_t fdt_bank_commit( uint8_t * mem, uint8_t * out_keys,
                         uint64_t * out_lams, uint8_t * out_states,
                         uint64_t * out_slots, uint64_t * out_vers,
                         int64_t max_n ) {
  bank_hdr_t * h = (bank_hdr_t *)mem;
  bank_slot_t * slots = slots_of( mem );
  int64_t cnt = 0;
  for( uint64_t i = 0; i < h->slot_cnt && cnt < max_n; i++ ) {
    bank_slot_t * s = &slots[ i ];
    uint64_t st = __atomic_load_n( &s->state, __ATOMIC_ACQUIRE );
    if( st != FDT_BANK_ST_TRIVIAL && st != FDT_BANK_ST_ABSENT
        && st != FDT_BANK_ST_NONTRIVIAL )
      continue;
    uint64_t v = __atomic_load_n( &s->ver, __ATOMIC_ACQUIRE );
    uint64_t sy = __atomic_load_n( &s->synced, __ATOMIC_ACQUIRE );
    if( v == sy ) continue;
    if( st == FDT_BANK_ST_NONTRIVIAL ) {
      /* NONTRIVIAL entries never drain (funk is written directly by
         the slow path): retire them immediately */
      while( sy < v
             && !__atomic_compare_exchange_n( &s->synced, &sy, v, 0,
                                              __ATOMIC_ACQ_REL,
                                              __ATOMIC_ACQUIRE ) ) {}
      continue;
    }
    /* TRIVIAL drains the record, ABSENT removes it.  synced is NOT
       advanced here: a caller killed between this drain and its funk
       write must find the entry still pending — it acknowledges each
       landed write via fdt_bank_commit_ack with the version observed
       below, so a crash re-drains instead of orphaning the balance. */
    memcpy( out_keys + 32 * cnt, s->key, 32 );
    out_lams[ cnt ] = __atomic_load_n( &s->lamports, __ATOMIC_ACQUIRE );
    out_states[ cnt ] = (uint8_t)st;
    out_slots[ cnt ] = i;
    out_vers[ cnt ] = v;
    cnt++;
  }
  return cnt;
}

void fdt_bank_commit_ack( uint8_t * mem, uint64_t const * slot_idx,
                          uint64_t const * vers, int64_t n ) {
  bank_hdr_t * h = (bank_hdr_t *)mem;
  bank_slot_t * slots = slots_of( mem );
  for( int64_t i = 0; i < n; i++ ) {
    if( slot_idx[ i ] >= h->slot_cnt ) continue;
    bank_slot_t * s = &slots[ slot_idx[ i ] ];
    uint64_t v = vers[ i ];
    uint64_t sy = __atomic_load_n( &s->synced, __ATOMIC_ACQUIRE );
    /* advance synced to the drained version only; a concurrent
       mutation past v stays pending for the next drain */
    while( sy < v
           && !__atomic_compare_exchange_n( &s->synced, &sy, v, 0,
                                            __ATOMIC_ACQ_REL,
                                            __ATOMIC_ACQUIRE ) ) {}
  }
}
