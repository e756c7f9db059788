/* fdt_pack.c — the port's copy of firedancer_tpu/tango/native/fdt_pack.c.
 *
 * Kept: the consensus-constant injection (fdt_pack_init_consts), the batch
 * txn scan (fdt_txn_scan), the exact-lock greedy select and release
 * (fdt_pack_select_x, fdt_pack_release_x) and the microblock codec
 * (fdt_mb_encode, fdt_mb_decode), unchanged.  Left out: the hashed-bitset
 * select/release (fdt_pack_select, fdt_pack_release; the engine no longer
 * calls them), the native stem's after-credit hook (fdt_pack_sched) and the
 * burst UDP I/O (fdt_udp_recv_burst, fdt_udp_send_burst), which belong to
 * the native stem and the net tile.  See fdt_pack.h for the design notes. */

#include "fdt_pack.h"

#include <string.h>

/* ==== consensus constants (injected from Python at load) ================ */

#define MAX_BUILTINS 16

static uint8_t  g_cb_pid[ 32 ];
static uint8_t  g_vote_pid[ 32 ];
static uint8_t  g_builtin_pids[ MAX_BUILTINS ][ 32 ];
static uint64_t g_builtin_costs[ MAX_BUILTINS ];
static int64_t  g_builtin_cnt = 0;

void fdt_pack_init_consts( uint8_t const * cb_pid, uint8_t const * vote_pid,
                           uint8_t const * builtin_pids,
                           uint64_t const * builtin_costs, int64_t k ) {
  memcpy( g_cb_pid, cb_pid, 32 );
  memcpy( g_vote_pid, vote_pid, 32 );
  if( k > MAX_BUILTINS ) k = MAX_BUILTINS;
  for( int64_t i = 0; i < k; i++ ) {
    memcpy( g_builtin_pids[ i ], builtin_pids + 32 * i, 32 );
    g_builtin_costs[ i ] = builtin_costs[ i ];
  }
  g_builtin_cnt = k;
}

/* ==== txn scan ========================================================== */

/* compact-u16 with minimal-encoding enforcement (ballet/txn.py
   cu16_decode).  Returns value or -1; *io advances. */
static inline int32_t cu16( uint8_t const * p, int64_t n, int64_t * io ) {
  int64_t i = *io;
  if( i < n && !( p[ i ] & 0x80 ) ) { *io = i + 1; return p[ i ]; }
  if( i + 1 < n && !( p[ i + 1 ] & 0x80 ) ) {
    if( !p[ i + 1 ] ) return -1;
    *io = i + 2;
    return ( p[ i ] & 0x7F ) | ( (int32_t)p[ i + 1 ] << 7 );
  }
  if( i + 2 < n && !( p[ i + 2 ] & 0xFC ) ) {
    if( !p[ i + 2 ] ) return -1;
    *io = i + 3;
    return ( p[ i ] & 0x7F ) | ( ( (int32_t)p[ i + 1 ] & 0x7F ) << 7 )
         | ( (int32_t)p[ i + 2 ] << 14 );
  }
  return -1;
}

static inline uint64_t ld64le( uint8_t const * p ) {
  uint64_t v;
  memcpy( &v, p, 8 ); /* little-endian host */
  return v;
}
static inline uint32_t ld32le( uint8_t const * p ) {
  uint32_t v;
  memcpy( &v, p, 4 );
  return v;
}

/* Account pubkey -> 64-bit hash (ballet/pack.py _hash_acct: splitmix64
   finalizer over first-8 XOR last-8). */
static inline uint64_t acct_hash( uint8_t const * key ) {
  uint64_t x = ld64le( key ) ^ ld64le( key + 24 );
  x ^= x >> 30; x *= 0xBF58476D1CE4E5B9UL;
  x ^= x >> 27; x *= 0x94D049BB133111EBUL;
  x ^= x >> 31;
  return x;
}

#define TXN_MTU 1232
#define MIN_SERIALIZED 134
#define U32_MAX 0xFFFFFFFFUL

/* compute-budget state flags (ballet/compute_budget.py) */
#define CB_SET_CU 1
#define CB_SET_FEE 2
#define CB_SET_HEAP 4
#define CB_SET_TOTAL 8

int64_t fdt_txn_scan( uint8_t const * rows, int64_t stride, int64_t in_off,
                      uint32_t const * szs, int64_t n, int64_t nbits,
                      uint8_t * ok_out, uint8_t * is_vote, uint8_t * fast,
                      uint32_t * cost_out, uint64_t * rewards_out,
                      uint32_t * cu_limit_out, uint64_t * tags,
                      uint64_t * lamports, uint32_t * payer_off,
                      uint32_t * src_off, uint32_t * dst_off, uint32_t * fee,
                      uint64_t * bs_rw, uint64_t * bs_w,
                      uint64_t * whash, uint8_t * w_cnt, int64_t max_w,
                      uint64_t * rhash, uint8_t * r_cnt, int64_t max_r,
                      uint8_t * trows, int64_t tstride, uint32_t * tszs ) {
  int64_t W = nbits / 64;
  int64_t n_ok = 0;
  for( int64_t t = 0; t < n; t++ ) {
    uint8_t const * p = rows + t * stride + in_off;
    int64_t sz = (int64_t)szs[ t ];
    ok_out[ t ] = 0;
    if( is_vote ) is_vote[ t ] = 0;
    if( fast ) fast[ t ] = 0;
    if( tags ) tags[ t ] = 0;
    if( w_cnt ) w_cnt[ t ] = 0;
    if( r_cnt ) r_cnt[ t ] = 0;
    if( bs_rw ) memset( bs_rw + t * W, 0, (size_t)W * 8 );
    if( bs_w ) memset( bs_w + t * W, 0, (size_t)W * 8 );
    if( tszs ) tszs[ t ] = 0;
    if( sz > TXN_MTU || sz < MIN_SERIALIZED ) continue;

    int64_t i = 0;
    int32_t sig_cnt = p[ i++ ];
    if( sig_cnt < 1 || sig_cnt > 127 ) continue;
    if( 64 * sig_cnt > sz - i ) continue;
    int64_t sig_off = i;
    i += 64 * sig_cnt;

    int64_t msg_off = i;
    if( sz - i < 1 ) continue;
    uint8_t b0 = p[ i++ ];
    int32_t version; /* 0xFF legacy, 0 v0 */
    if( b0 & 0x80 ) {
      version = b0 & 0x7F;
      if( version != 0 ) continue;
      if( sz - i < 1 || p[ i ] != sig_cnt ) continue;
      i++;
    } else {
      version = 0xFF;
      if( b0 != sig_cnt ) continue;
    }
    if( sz - i < 2 ) continue;
    int32_t ro_signed = p[ i++ ];
    if( ro_signed >= sig_cnt ) continue;
    int32_t ro_unsigned = p[ i++ ];
    int32_t acct_cnt = cu16( p, sz, &i );
    if( acct_cnt < 0 || acct_cnt < sig_cnt || acct_cnt > 128 ) continue;
    if( sig_cnt + ro_unsigned > acct_cnt ) continue;
    if( 32 * acct_cnt > sz - i ) continue;
    int64_t acct_off = i;
    i += 32 * acct_cnt;
    if( 32 > sz - i ) continue;
    int64_t bh_off = i;
    i += 32;

    int32_t instr_cnt = cu16( p, sz, &i );
    if( instr_cnt < 0 || instr_cnt > 64 ) continue;
    if( 3 * instr_cnt > sz - i ) continue;
    if( instr_cnt && acct_cnt <= 1 ) continue;

    /* one pass over instructions: validity + cost estimate + fast shape */
    int32_t  max_acct = 0;
    int64_t  data_bytes = 0;
    uint64_t builtin_cost = 0;
    int      bpf = 0;
    uint32_t cb_flags = 0;
    int32_t  cb_instr_cnt = 0;
    uint32_t cb_cu = 0;
    uint64_t cb_total_fee = 0, cb_price = 0;
    int      est_ok = 1;
    int      xfer_cnt = 0, other_cnt = 0;
    int32_t  xfer_src = -1, xfer_dst = -1;
    uint64_t xfer_lamports = 0;
    for( int32_t k = 0; k < instr_cnt; k++ ) {
      if( 3 > sz - i ) { est_ok = -1; break; }
      int32_t prog_idx = p[ i++ ];
      int32_t a_cnt = cu16( p, sz, &i );
      if( a_cnt < 0 || a_cnt > sz - i ) { est_ok = -1; break; }
      int64_t a_off = i;
      for( int32_t j = 0; j < a_cnt; j++ )
        if( p[ a_off + j ] > max_acct ) max_acct = p[ a_off + j ];
      i += a_cnt;
      int32_t d_sz = cu16( p, sz, &i );
      if( d_sz < 0 || d_sz > sz - i ) { est_ok = -1; break; }
      int64_t d_off = i;
      i += d_sz;
      if( prog_idx <= 0 || prog_idx >= acct_cnt ) { est_ok = -1; break; }
      data_bytes += d_sz;
      uint8_t const * prog = p + acct_off + 32 * prog_idx;
      if( !memcmp( prog, g_cb_pid, 32 ) ) {
        /* ComputeBudgetProgram instruction (each kind at most once) */
        uint8_t const * d = p + d_off;
        if( d_sz < 5 ) { est_ok = 0; }
        else {
          uint8_t kind = d[ 0 ];
          if( kind == 0 ) {
            if( d_sz != 9 || ( cb_flags & ( CB_SET_CU | CB_SET_FEE ) ) )
              est_ok = 0;
            else {
              cb_cu = ld32le( d + 1 );
              cb_total_fee = ld32le( d + 5 );
              if( cb_cu > 1400000U ) est_ok = 0;
              cb_flags |= CB_SET_CU | CB_SET_FEE | CB_SET_TOTAL;
            }
          } else if( kind == 1 ) {
            if( d_sz != 5 || ( cb_flags & CB_SET_HEAP ) ) est_ok = 0;
            else {
              uint32_t heap = ld32le( d + 1 );
              if( heap % 1024U ) est_ok = 0;
              cb_flags |= CB_SET_HEAP;
            }
          } else if( kind == 2 ) {
            if( d_sz != 5 || ( cb_flags & CB_SET_CU ) ) est_ok = 0;
            else {
              cb_cu = ld32le( d + 1 );
              if( cb_cu > 1400000U ) est_ok = 0;
              cb_flags |= CB_SET_CU;
            }
          } else if( kind == 3 ) {
            if( d_sz != 9 || ( cb_flags & CB_SET_FEE ) ) est_ok = 0;
            else {
              cb_price = ld64le( d + 1 );
              cb_flags |= CB_SET_FEE;
            }
          } else est_ok = 0;
          if( est_ok ) cb_instr_cnt++;
        }
        builtin_cost += 150; /* compute-budget builtin cost */
        other_cnt++; /* CB instrs don't break the fast-transfer shape */
        continue;
      }
      int found = -1;
      for( int64_t b = 0; b < g_builtin_cnt; b++ )
        if( !memcmp( prog, g_builtin_pids[ b ], 32 ) ) { found = (int)b; break; }
      if( found >= 0 ) builtin_cost += g_builtin_costs[ found ];
      else bpf = 1;
      /* fast-transfer shape: the ONLY non-CB instruction is a system
         transfer (owner key all-zero, disc 2, >= 2 accounts, 12B data) */
      int is_sys = 1;
      for( int z = 0; z < 32; z++ )
        if( prog[ z ] ) { is_sys = 0; break; }
      if( is_sys && d_sz >= 12 && a_cnt >= 2 && ld32le( p + d_off ) == 2U ) {
        xfer_cnt++;
        xfer_src = p[ a_off ];
        xfer_dst = p[ a_off + 1 ];
        xfer_lamports = ld64le( p + d_off + 4 );
      } else {
        other_cnt++;
        if( is_vote && instr_cnt == 1 && !memcmp( prog, g_vote_pid, 32 ) )
          is_vote[ t ] = 1;
      }
    }
    if( est_ok < 0 ) continue; /* structural parse failure */

    /* v0 address-table lookups */
    int32_t adtl = 0, adtl_w = 0;
    if( version == 0 ) {
      int32_t lut_cnt = cu16( p, sz, &i );
      if( lut_cnt < 0 || lut_cnt > 127 ) continue;
      if( 34 * lut_cnt > sz - i ) continue;
      int bad = 0;
      for( int32_t k = 0; k < lut_cnt; k++ ) {
        if( 32 > sz - i ) { bad = 1; break; }
        i += 32;
        int32_t wc = cu16( p, sz, &i );
        if( wc < 0 || wc > sz - i ) { bad = 1; break; }
        i += wc;
        int32_t rc = cu16( p, sz, &i );
        if( rc < 0 || rc > sz - i ) { bad = 1; break; }
        i += rc;
        if( wc > 128 - acct_cnt || rc > 128 - acct_cnt || wc + rc < 1 ) {
          bad = 1; break;
        }
        adtl_w += wc;
        adtl += wc + rc;
      }
      if( bad ) continue;
    }
    if( i != sz ) continue; /* trailing bytes */
    if( acct_cnt + adtl > 128 ) continue;
    if( max_acct >= acct_cnt + adtl ) continue;
    if( !est_ok ) continue; /* compute-budget violation: parse ok, est fail */

    /* cost model finalize (ballet/compute_budget.py) */
    uint64_t cu_limit;
    if( cb_flags & CB_SET_CU ) cu_limit = cb_cu;
    else cu_limit = (uint64_t)( instr_cnt - cb_instr_cnt ) * 200000UL;
    if( cu_limit > 1400000UL ) cu_limit = 1400000UL;
    uint64_t adtl_rewards;
    if( cb_flags & CB_SET_TOTAL ) adtl_rewards = cb_total_fee;
    else {
      /* ceil(cu_limit * price / 1e6), saturating: cu_limit <= 1.4e6 so
         the product fits unsigned 128-bit comfortably via long division */
      __uint128_t r = ( (__uint128_t)cu_limit * cb_price + 999999UL ) / 1000000UL;
      adtl_rewards = r > (__uint128_t)0xFFFFFFFFFFFFFFFFUL
                   ? 0xFFFFFFFFFFFFFFFFUL : (uint64_t)r;
    }
    uint64_t sig_rewards = 5000UL * (uint64_t)sig_cnt;
    uint64_t rewards = sig_rewards + adtl_rewards;
    if( rewards > U32_MAX || rewards < sig_rewards ) rewards = U32_MAX;
    /* static writable idxs: j < sig_cnt-ro_signed or
       sig_cnt <= j < acct_cnt-ro_unsigned */
    int32_t w_static = ( sig_cnt - ro_signed )
                     + ( acct_cnt - ro_unsigned - sig_cnt );
    uint64_t cost = 720UL * (uint64_t)sig_cnt
                  + 300UL * (uint64_t)( w_static + adtl_w )
                  + (uint64_t)data_bytes / 4UL
                  + builtin_cost + ( bpf ? cu_limit : 0UL );
    if( !cost ) continue; /* estimate-zero reject (insert 'estimate') */

    ok_out[ t ] = 1;
    n_ok++;
    if( cost_out ) cost_out[ t ] = cost > U32_MAX ? U32_MAX : (uint32_t)cost;
    if( rewards_out ) rewards_out[ t ] = rewards;
    if( cu_limit_out ) cu_limit_out[ t ] = (uint32_t)cu_limit;
    if( tags ) tags[ t ] = ld64le( p + sig_off );

    /* conflict bitsets + exact key hashes over STATIC keys (pack sees
       no bank state to resolve ALTs; matches ballet/pack.py): writable
       hashes feed the writer-cost caps AND the exact lock tables;
       readonly hashes feed read-vs-write exact conflicts */
    if( bs_rw || bs_w || whash || rhash ) {
      uint64_t * rw = bs_rw ? bs_rw + t * W : 0;
      uint64_t * w  = bs_w ? bs_w + t * W : 0;
      int32_t wn = 0, rn = 0;
      for( int32_t j = 0; j < acct_cnt; j++ ) {
        uint64_t h = acct_hash( p + acct_off + 32 * j );
        if( nbits ) {
          uint64_t b = h % (uint64_t)nbits;
          if( rw ) rw[ b >> 6 ] |= 1UL << ( b & 63 );
          int writable0 = ( j < sig_cnt - ro_signed )
                        || ( j >= sig_cnt && j < acct_cnt - ro_unsigned );
          if( writable0 && w ) w[ b >> 6 ] |= 1UL << ( b & 63 );
        }
        int writable = ( j < sig_cnt - ro_signed )
                     || ( j >= sig_cnt && j < acct_cnt - ro_unsigned );
        if( writable ) {
          if( whash && wn < max_w ) whash[ t * max_w + wn ] = h;
          wn++;
        } else {
          if( rhash && rn < max_r ) rhash[ t * max_r + rn ] = h;
          rn++;
        }
      }
      /* overflow past the hash-row width FAILS CLOSED: 0xFF marks the
         txn untrackable so fdt_pack_select_x never co-schedules it on
         conflict state it cannot see (acct_cnt <= 128 < 0xFF, so the
         sentinel is unambiguous).  Unreachable for MTU payloads
         (<= 35 static keys fit) but a consensus guard regardless. */
      if( w_cnt ) w_cnt[ t ] = wn > max_w ? 0xFF : (uint8_t)wn;
      if( r_cnt ) r_cnt[ t ] = rn > max_r ? 0xFF : (uint8_t)rn;
    }

    /* fast path: legacy, exactly one transfer, nothing else but CB
       instructions, no BPF cost ambiguity, src is a writable signer and
       dst is writable (runtime _system transfer privilege rules) */
    if( fast && version == 0xFF && xfer_cnt == 1 && other_cnt == cb_instr_cnt ) {
      int32_t s = xfer_src, d = xfer_dst;
      int s_writable = s < sig_cnt - ro_signed;
      int d_writable = ( d < sig_cnt - ro_signed )
                     || ( d >= sig_cnt && d < acct_cnt - ro_unsigned );
      if( s < sig_cnt && s_writable && d_writable ) {
        fast[ t ] = 1;
        if( lamports ) lamports[ t ] = xfer_lamports;
        if( payer_off ) payer_off[ t ] = (uint32_t)acct_off;
        if( src_off ) src_off[ t ] = (uint32_t)( acct_off + 32 * s );
        if( dst_off ) dst_off[ t ] = (uint32_t)( acct_off + 32 * d );
        if( fee ) fee[ t ] = 5000U * (uint32_t)sig_cnt;
      }
    }

    /* wire trailer (tiles/wire.py): txn + 16-byte parse summary */
    if( trows && tszs ) {
      uint8_t * o = trows + t * tstride;
      if( o != p ) memcpy( o, p, (size_t)sz );
      uint8_t * tr = o + sz;
      uint32_t msg_len = (uint32_t)( sz - msg_off );
      tr[ 0 ] = (uint8_t)sig_off;        tr[ 1 ] = (uint8_t)( sig_off >> 8 );
      tr[ 2 ] = (uint8_t)acct_off;       tr[ 3 ] = (uint8_t)( acct_off >> 8 );
      tr[ 4 ] = (uint8_t)msg_off;        tr[ 5 ] = (uint8_t)( msg_off >> 8 );
      tr[ 6 ] = (uint8_t)msg_len;        tr[ 7 ] = (uint8_t)( msg_len >> 8 );
      tr[ 8 ] = (uint8_t)sz;             tr[ 9 ] = (uint8_t)( sz >> 8 );
      tr[ 10 ] = (uint8_t)sig_cnt;
      tr[ 11 ] = (uint8_t)acct_cnt;
      tr[ 12 ] = (uint8_t)ro_signed;
      tr[ 13 ] = (uint8_t)ro_unsigned;
      tr[ 14 ] = (uint8_t)bh_off;        tr[ 15 ] = (uint8_t)( bh_off >> 8 );
      tszs[ t ] = (uint32_t)sz + 16U;
    }
  }
  return n_ok;
}

/* ==== pack select / release ============================================= */

/* writer-cost map: open addressing, keys[] 0 = empty (a real hash of 0 is
   remapped to 1 — merges with hash-1 keys, conservative like any other
   collision).  Probes are bounded: a miss after mask probes (map
   effectively full — unreachable when the caller sizes the map from the
   block's txn capacity) reports the cap as exceeded, so a full map can
   only UNDER-admit, never hang or overshoot the cap. */
static inline int64_t wc_get( uint64_t const * keys, int64_t const * vals,
                              int64_t mask, uint64_t h, int64_t cap ) {
  if( !h ) h = 1;
  int64_t i = (int64_t)( h & (uint64_t)mask );
  for( int64_t probes = 0; probes <= mask; probes++ ) {
    uint64_t k = keys[ i ];
    if( k == h ) return vals[ i ];
    if( !k ) return 0;
    i = ( i + 1 ) & mask;
  }
  return cap; /* full map: treat as at-cap (conservative) */
}

static inline void wc_add( uint64_t * keys, int64_t * vals, int64_t mask,
                           uint64_t h, int64_t delta ) {
  if( !h ) h = 1;
  int64_t i = (int64_t)( h & (uint64_t)mask );
  int64_t probes = 0;
  for(;;) {
    uint64_t k = keys[ i ];
    if( k == h ) { vals[ i ] += delta; return; }
    if( !k ) { keys[ i ] = h; vals[ i ] = delta; return; }
    i = ( i + 1 ) & mask;
    if( ++probes > mask ) return; /* full: drop the update (never wedge) */
  }
}

/* ==== exact account locks =============================================== */

/* Exact lock tables replace the hashed-bitset conflict check on the
   authoritative schedule path: a 1024-bit bloom saturates once a few
   thousand account locks are outstanding (64 in-flight microblocks x
   ~250 txns x 2-3 accounts), collapsing microblock fill to hash noise
   (measured round 5: 47 of 256).  The reference keeps exact per-account
   structures for the same reason (fd_pack.c acct_in_use map).

   Tables are open-addressing u64-hash -> refcount; deletion is
   backward-shift (linear-probing invariant repair), so a long-lived
   table never accumulates tombstones.  A FULL table fails CLOSED:
   lookups report "held" and inserts report failure, so over-admission
   is impossible; the caller sizes tables so this is unreachable. */

static inline int lock_held( uint64_t const * keys, int64_t mask,
                             uint64_t h ) {
  if( !h ) h = 1;
  int64_t i = (int64_t)( h & (uint64_t)mask );
  for( int64_t probes = 0; probes <= mask; probes++ ) {
    uint64_t k = keys[ i ];
    if( k == h ) return 1;
    if( !k ) return 0;
    i = ( i + 1 ) & mask;
  }
  return 1; /* full table: conservative */
}

static inline int lock_add( uint64_t * keys, int64_t * vals, int64_t mask,
                            uint64_t h ) {
  if( !h ) h = 1;
  int64_t i = (int64_t)( h & (uint64_t)mask );
  for( int64_t probes = 0; probes <= mask; probes++ ) {
    uint64_t k = keys[ i ];
    if( k == h ) { vals[ i ]++; return 1; }
    if( !k ) { keys[ i ] = h; vals[ i ] = 1; return 1; }
    i = ( i + 1 ) & mask;
  }
  return 0; /* full: caller treats the txn as conflicting */
}

static inline void lock_del( uint64_t * keys, int64_t * vals, int64_t mask,
                             uint64_t h ) {
  if( !h ) h = 1;
  int64_t i = (int64_t)( h & (uint64_t)mask );
  int64_t probes = 0;
  for( ; probes <= mask; probes++ ) {
    if( keys[ i ] == h ) break;
    if( !keys[ i ] ) return;
    i = ( i + 1 ) & mask;
  }
  if( probes > mask ) return;
  if( --vals[ i ] > 0 ) return;
  /* backward-shift deletion: pull displaced entries into the hole so
     probe chains stay unbroken without tombstones */
  int64_t j = i;
  for(;;) {
    keys[ i ] = 0; vals[ i ] = 0;
    for(;;) {
      j = ( j + 1 ) & mask;
      if( !keys[ j ] ) return;
      uint64_t kh = keys[ j ] ? keys[ j ] : 1;
      int64_t home = (int64_t)( kh & (uint64_t)mask );
      /* movable iff the hole i is cyclically within [home, j) */
      if( i <= j ? ( home <= i || home > j ) : ( home <= i && home > j ) )
        break;
    }
    keys[ i ] = keys[ j ]; vals[ i ] = vals[ j ];
    i = j;
  }
}

int64_t fdt_pack_select_x( int64_t const * order, int64_t n_cand,
                           uint64_t const * whash, uint8_t const * w_cnt,
                           int64_t max_w, uint64_t const * rhash,
                           uint8_t const * r_cnt, int64_t max_r,
                           uint64_t * lw_keys, int64_t * lw_vals,
                           int64_t lw_mask, uint64_t * lr_keys,
                           int64_t * lr_vals, int64_t lr_mask,
                           uint32_t const * cost, uint16_t const * szs,
                           int64_t byte_limit, uint64_t * wc_keys,
                           int64_t * wc_vals, int64_t wc_mask,
                           int64_t writer_cap, int64_t cu_limit,
                           int64_t txn_limit, int64_t * picks,
                           int64_t * cu_used_out ) {
  int64_t n_picked = 0;
  int64_t cu_used = 0;
  int64_t bytes_used = 0;
  for( int64_t c = 0; c < n_cand && n_picked < txn_limit; c++ ) {
    int64_t s = order[ c ];
    int64_t cst = (int64_t)cost[ s ];
    if( cu_used + cst > cu_limit ) continue;
    if( byte_limit > 0 && bytes_used + (int64_t)szs[ s ] + 2 > byte_limit )
      continue;
    int64_t wn = (int64_t)w_cnt[ s ];
    int64_t rn = (int64_t)r_cnt[ s ];
    /* 0xFF: key hashes overflowed the scan row — conflict state is
       unknowable, never schedule (fail closed) */
    if( wn == 0xFF || rn == 0xFF ) continue;
    int conflict = 0;
    /* my writes vs anyone's read or write; my reads vs anyone's write */
    for( int64_t j = 0; j < wn; j++ ) {
      uint64_t h = whash[ s * max_w + j ];
      if( lock_held( lw_keys, lw_mask, h )
        | lock_held( lr_keys, lr_mask, h ) ) { conflict = 1; break; }
    }
    for( int64_t j = 0; !conflict && j < rn; j++ )
      if( lock_held( lw_keys, lw_mask, rhash[ s * max_r + j ] ) )
        conflict = 1;
    if( conflict ) continue;
    int over = 0;
    for( int64_t j = 0; j < wn; j++ )
      if( wc_get( wc_keys, wc_vals, wc_mask, whash[ s * max_w + j ],
                  writer_cap ) + cst
          > writer_cap ) { over = 1; break; }
    if( over ) continue;
    /* commit: take locks; a full lock table rolls back and skips */
    int64_t wt = 0, rt = 0;
    int full = 0;
    for( ; wt < wn; wt++ )
      if( !lock_add( lw_keys, lw_vals, lw_mask, whash[ s * max_w + wt ] ) ) {
        full = 1; break;
      }
    for( ; !full && rt < rn; rt++ )
      if( !lock_add( lr_keys, lr_vals, lr_mask, rhash[ s * max_r + rt ] ) ) {
        full = 1; break;
      }
    if( full ) {
      for( int64_t j = 0; j < wt; j++ )
        lock_del( lw_keys, lw_vals, lw_mask, whash[ s * max_w + j ] );
      for( int64_t j = 0; j < rt; j++ )
        lock_del( lr_keys, lr_vals, lr_mask, rhash[ s * max_r + j ] );
      continue;
    }
    for( int64_t j = 0; j < wn; j++ )
      wc_add( wc_keys, wc_vals, wc_mask, whash[ s * max_w + j ], cst );
    picks[ n_picked++ ] = s;
    cu_used += cst;
    bytes_used += (int64_t)szs[ s ] + 2;
  }
  if( cu_used_out ) *cu_used_out += cu_used;
  return n_picked;
}

void fdt_pack_release_x( int64_t const * idx, int64_t n,
                         uint64_t const * whash, uint8_t const * w_cnt,
                         int64_t max_w, uint64_t const * rhash,
                         uint8_t const * r_cnt, int64_t max_r,
                         uint64_t * lw_keys, int64_t * lw_vals,
                         int64_t lw_mask, uint64_t * lr_keys,
                         int64_t * lr_vals, int64_t lr_mask ) {
  for( int64_t t = 0; t < n; t++ ) {
    int64_t s = idx[ t ];
    int64_t wn = (int64_t)w_cnt[ s ];
    int64_t rn = (int64_t)r_cnt[ s ];
    /* overflow-sentinel txns are never scheduled; clamp defensively so
       a stray release cannot read past the hash rows */
    if( wn > max_w ) wn = max_w;
    if( rn > max_r ) rn = max_r;
    for( int64_t j = 0; j < wn; j++ )
      lock_del( lw_keys, lw_vals, lw_mask, whash[ s * max_w + j ] );
    for( int64_t j = 0; j < rn; j++ )
      lock_del( lr_keys, lr_vals, lr_mask, rhash[ s * max_r + j ] );
  }
}

/* ==== microblock codec ================================================== */

int64_t fdt_mb_encode( uint8_t const * rows, int64_t stride,
                       uint16_t const * szs, int64_t const * idx, int64_t n,
                       uint32_t handle, uint32_t bank,
                       uint8_t * out, int64_t cap ) {
  int64_t off = 8;
  if( cap < 8 ) return -1;
  memcpy( out, &handle, 4 );
  uint16_t b16 = (uint16_t)bank, n16 = (uint16_t)n;
  memcpy( out + 4, &b16, 2 );
  memcpy( out + 6, &n16, 2 );
  for( int64_t t = 0; t < n; t++ ) {
    int64_t s = idx[ t ];
    uint16_t sz = szs[ s ];
    if( off + 2 + (int64_t)sz > cap ) return -1;
    memcpy( out + off, &sz, 2 );
    memcpy( out + off + 2, rows + s * stride, sz );
    off += 2 + sz;
  }
  return off;
}

int64_t fdt_mb_decode( uint8_t const * buf, int64_t sz,
                       uint8_t * rows, int64_t stride, uint32_t * szs,
                       int64_t max_n ) {
  if( sz < 8 ) return -1;
  uint16_t n16;
  memcpy( &n16, buf + 6, 2 );
  int64_t n = n16;
  if( n > max_n ) return -1;
  int64_t off = 8;
  for( int64_t t = 0; t < n; t++ ) {
    if( off + 2 > sz ) return -1;
    uint16_t tsz;
    memcpy( &tsz, buf + off, 2 );
    off += 2;
    if( off + (int64_t)tsz > sz || (int64_t)tsz > stride ) return -1;
    memcpy( rows + t * stride, buf + off, tsz );
    szs[ t ] = tsz;
    off += tsz;
  }
  return n;
}
