/* fdt_bank.h — GIL-released batch executor for scan-classified fast
 * transfers over a shared-memory account table.  The port's copy of
 * firedancer_tpu/tango/native/fdt_bank.h.
 *
 * Reference model (behavior contract only; implementation original):
 * fd_bank.c:100-104 hands each whole microblock to a batched external
 * engine (fd_ext_bank_load_and_execute_txns) — the bank tile's
 * interpreter never executes transactions one at a time.  Here the
 * "external engine" is this module: one ctypes call applies a whole
 * microblock's fast-transfer txns against a native open-addressing
 * account table (32-byte pubkey -> lamports, TRIVIAL system accounts
 * only), with semantics bit-identical to the Python reference
 * (flamenco/runtime.py execute_fast_transfers, itself differentially
 * pinned to execute_txn): fee-then-execute, absent/underfunded payer
 * rejected without fee, self-transfer no-op with fee, destination
 * creation, duplicate-key aliasing via strictly sequential
 * application, and the system_transfer_zero_check feature flag.
 *
 * The table lives in WORKSPACE SHARED MEMORY so it is shared by every
 * bank tile (thread or process runtime) and survives SIGKILL restart:
 *
 *   - slot writes are published with release stores; lookups skip
 *     in-claim (BUSY) slots after a bounded spin, which is always safe
 *     because a claimed-but-unpublished slot has never held data (a
 *     claimer killed mid-insert leaks one dead slot, fail-closed);
 *   - concurrent bank processes never mutate the same account: pack's
 *     exact account-lock tables (fdt_pack_select_x) already guarantee
 *     no two in-flight microblocks share a writable account;
 *   - per-slot (ver, synced) version words track which entries funk
 *     has not yet seen; fdt_bank_commit drains them as (key, lamports)
 *     arrays for Python write-back, and is what makes a SIGKILL
 *     between execute and write-back lossless;
 *   - a tiny per-bank undo journal makes each txn's <=3 slot writes
 *     atomic across SIGKILL: fdt_bank_recover rolls back a half-
 *     applied txn and reports (microblock tag, txns done) so the
 *     restarted bank resumes mid-microblock exactly once.
 *
 * Anything the table cannot represent (NONTRIVIAL accounts: data,
 * non-system owner, executable/rent-epoch bits) stops the batch with a
 * per-txn status so Python falls back to the general executor for that
 * one txn and resumes the batch after it. */

#ifndef FDT_BANK_H
#define FDT_BANK_H

#include <stdint.h>

/* slot states (u64 state word) */
#define FDT_BANK_ST_EMPTY 0      /* never used: key unknown to the table */
#define FDT_BANK_ST_BUSY 1       /* insert in progress (transient) */
#define FDT_BANK_ST_TRIVIAL 2    /* trivial system account: lamports valid */
#define FDT_BANK_ST_NONTRIVIAL 3 /* exists in funk but not table-executable */
#define FDT_BANK_ST_ABSENT 4     /* known absent from funk */

/* per-txn exec status */
#define FDT_BANK_OK 0      /* executed: fee charged, transfer landed */
#define FDT_BANK_FAIL 1    /* executed: fee charged, transfer failed */
#define FDT_BANK_REJECT 2  /* payer absent/underfunded: rejected, no fee */
#define FDT_BANK_MISS 3    /* stopped: a key is not cached — resolve+retry */
#define FDT_BANK_NONTRIV 4 /* stopped: NONTRIVIAL account — python fallback */

/* Table region size for slot_cnt slots (power of two; 0 if not). */
uint64_t fdt_bank_tab_footprint( uint64_t slot_cnt );

/* Initialize-or-rejoin a table region (zero-filled on first use).  The
   first caller wins an atomic init race; others spin until the header
   is published.  Returns 0 (initialized), 1 (rejoined a live table), or
   -1 (bad slot_cnt / geometry mismatch / wedged initializer). */
int fdt_bank_tab_new( uint8_t * mem, uint64_t slot_cnt );

uint64_t fdt_bank_tab_slots( uint8_t const * mem );

/* Upsert one key.  state is FDT_BANK_ST_{TRIVIAL,NONTRIVIAL,ABSENT};
   dirty=0 marks the entry funk-synced (a resolve/resync mirroring funk),
   dirty=1 leaves it pending write-back.  Returns 0, or -1 table full. */
int64_t fdt_bank_tab_put( uint8_t * mem, uint8_t const * key, int64_t state,
                          uint64_t lamports, int64_t dirty );

/* Lookup one key: returns the slot state (FDT_BANK_ST_EMPTY = not
   cached) and writes lamports for TRIVIAL entries. */
int64_t fdt_bank_tab_get( uint8_t const * mem, uint8_t const * key,
                          uint64_t * out_lamports );

/* Execute fast-transfer txns idx[start..n) strictly sequentially.
   rows/stride + per-ORIGINAL-ROW operand arrays come straight from
   fdt_txn_scan (payer/src/dst offsets into the payload, fee, amount).
   journal is this bank's 256-byte undo-journal region; mb_tag names the
   microblock (the frag seq) so a restarted bank resumes exactly once.
   status[t]/out_fees[t] are written per SUBSET position t.  Returns the
   index of the first unprocessed txn: == n when the batch completed,
   else status[ret] says why it stopped (MISS/NONTRIV). */
int64_t fdt_bank_exec( uint8_t const * rows, int64_t stride,
                       int64_t const * idx, int64_t start, int64_t n,
                       uint32_t const * payer_off, uint32_t const * src_off,
                       uint32_t const * dst_off, uint32_t const * fee,
                       uint64_t const * amount, uint8_t * mem,
                       uint8_t * journal, uint64_t mb_tag,
                       int64_t zero_check, uint8_t * status,
                       uint64_t * out_fees );

/* Drain entries funk has not seen (ver != synced) into dense arrays for
   Python write-back: out_keys (max_n x 32), out_lams, out_states
   (TRIVIAL = write record, ABSENT = remove record), plus out_slots /
   out_vers naming what was observed.  synced is NOT advanced by the
   drain — the caller writes funk, then acknowledges via
   fdt_bank_commit_ack(slots, vers), so a kill between drain and funk
   write re-drains instead of orphaning balances.  Returns entries
   written; drain+write+ack in a loop while the return == max_n. */
int64_t fdt_bank_commit( uint8_t * mem, uint8_t * out_keys,
                         uint64_t * out_lams, uint8_t * out_states,
                         uint64_t * out_slots, uint64_t * out_vers,
                         int64_t max_n );
void fdt_bank_commit_ack( uint8_t * mem, uint64_t const * slot_idx,
                          uint64_t const * vers, int64_t n );

/* Crash recovery: roll back a half-applied txn recorded in the journal
   (restoring the <=3 touched slots and re-marking them dirty) and
   report out_tag_done[2] = {microblock tag, txns completed}.  Returns 1
   if a rollback happened, else 0. */
int64_t fdt_bank_recover( uint8_t * mem, uint8_t * journal,
                          uint64_t * out_tag_done );

#endif /* FDT_BANK_H */
