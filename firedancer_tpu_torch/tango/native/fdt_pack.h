/* fdt_pack.h — the port's copy of firedancer_tpu/tango/native/fdt_pack.h,
 * trimmed to what the port's pack engine, pack tile and bank tile call:
 * fdt_pack_init_consts, fdt_txn_scan, fdt_pack_select_x,
 * fdt_pack_release_x and the microblock codec.  The native stem's
 * after-credit hook (fdt_pack_sched), the hashed-bitset select/release and
 * the burst UDP I/O are not carried.
 *
 * Reference models (behavior contracts only; implementation original):
 *   - txn wire parse:  src/ballet/txn/fd_txn_parse.c
 *     (the validation rules are re-stated in ballet/txn.py; fdt_txn_scan
 *     must agree with it bit for bit)
 *   - cost estimate:   src/ballet/pack/fd_pack.c:541-580
 *     + fd_compute_budget_program.h + fd_pack_cost.h (consensus constants
 *     injected from ballet/compute_budget.py at load)
 *   - greedy select:   fd_pack_schedule_microblock_impl, fd_pack.c:742-953
 *     (dense-array redesign per ballet/pack.py's essay; writer cost caps
 *     are keyed by 64-bit account hashes here — hash collisions merge cost
 *     buckets, which can only UNDER-admit, never violate the cap)
 *
 * Everything is plain buffers + scalar args so ctypes can call straight in
 * (and the GIL is released for the duration of every call). */

#ifndef FDT_PACK_H
#define FDT_PACK_H

#include <stdint.h>

/* Install consensus constants: the ComputeBudget + Vote program ids and
   the builtin-cost table (pids: k 32-byte ids, costs[k]). */
void fdt_pack_init_consts( uint8_t const * cb_pid, uint8_t const * vote_pid,
                           uint8_t const * builtin_pids,
                           uint64_t const * builtin_costs, int64_t k );

/* Batch scan: parse + validate + estimate + conflict bitsets + fast-path
   extraction for n txns.  rows[i*stride + in_off .. + szs[i]) is payload i.
   All outputs length n (pointers may be NULL to skip that output group):
     ok[i]        1 if the txn parses + estimates clean
     is_vote[i]   single-instruction Vote-program txn
     fast[i]      simple-transfer fast path (see fdt_pack.c for the shape)
     cost[i], rewards[i], cu_limit_out[i]   pack cost model outputs
     tags[i]      first 8 bytes of the first signature, LE (dedup key)
     lamports[i], src_off[i], dst_off[i], fee[i]  fast-path operands
       (src_off/dst_off/payer_off are byte offsets of 32-byte keys
        INTO THE PAYLOAD, i.e. relative to rows[i*stride + in_off])
     bs_rw, bs_w  (n x nbits/64) hashed account conflict bitsets
     whash (n x max_w) + w_cnt[i]  64-bit hashes of writable static keys
     rhash (n x max_r) + r_cnt[i]  64-bit hashes of readonly static keys
       (exact read-vs-write conflict input for fdt_pack_select_x)
     trows + tszs: payload + 16-byte wire trailer (tiles/wire.py format)
       written at trows[i*tstride]; tszs[i] = txn_sz + 16
   Returns number of ok txns. */
int64_t fdt_txn_scan( uint8_t const * rows, int64_t stride, int64_t in_off,
                      uint32_t const * szs, int64_t n, int64_t nbits,
                      uint8_t * ok, uint8_t * is_vote, uint8_t * fast,
                      uint32_t * cost, uint64_t * rewards,
                      uint32_t * cu_limit_out, uint64_t * tags,
                      uint64_t * lamports, uint32_t * payer_off,
                      uint32_t * src_off, uint32_t * dst_off, uint32_t * fee,
                      uint64_t * bs_rw, uint64_t * bs_w,
                      uint64_t * whash, uint8_t * w_cnt, int64_t max_w,
                      uint64_t * rhash, uint8_t * r_cnt, int64_t max_r,
                      uint8_t * trows, int64_t tstride, uint32_t * tszs );

/* EXACT-lock select + release: a greedy walk over `order` (pool slot ids,
   priority-sorted) taking non-conflicting txns until cu_limit/txn_limit,
   each take committing at once (writer-cost map update, lock acquire);
   conflicts are checked against exact refcounted account-hash lock
   tables (lw = writable locks, lr = readonly locks) instead of the
   hashed bitsets, which saturate under deep microblock pipelining (the
   reference's acct_in_use map is exact for the same reason).  Tables
   are open-addressing u64->refcount with backward-shift deletion; a
   full table fails closed (conflict).  lw_mask/lr_mask = table_size-1,
   power of two. */
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
                           int64_t * cu_used_out );
void fdt_pack_release_x( int64_t const * idx, int64_t n,
                         uint64_t const * whash, uint8_t const * w_cnt,
                         int64_t max_w, uint64_t const * rhash,
                         uint8_t const * r_cnt, int64_t max_r,
                         uint64_t * lw_keys, int64_t * lw_vals,
                         int64_t lw_mask, uint64_t * lr_keys,
                         int64_t * lr_vals, int64_t lr_mask );

/* Microblock wire codec (tiles/pack.py format:
   u32 handle | u16 bank | u16 txn_cnt | txn_cnt * ( u16 sz | sz bytes )).
   Encode gathers pool rows[idx[i]]; returns total bytes (or -1 if > cap).
   Decode scatters into (max_n x stride) rows + szs; returns txn_cnt. */
int64_t fdt_mb_encode( uint8_t const * rows, int64_t stride,
                       uint16_t const * szs, int64_t const * idx, int64_t n,
                       uint32_t handle, uint32_t bank,
                       uint8_t * out, int64_t cap );
int64_t fdt_mb_decode( uint8_t const * buf, int64_t sz,
                       uint8_t * rows, int64_t stride, uint32_t * szs,
                       int64_t max_n );

#endif /* FDT_PACK_H */
