"""Bank tile: executes scheduled microblocks and reports completion.

A copy of firedancer_tpu/tiles/bank.py without the elastic drain
(`elastic_drained`, which waits for the elastic shard module).  With
`funk=None` the bank is the fee-only executor (`execute_txns`); with a
funk it executes every txn against the account store through
flamenco/runtime.py's `Executor`, the fast transfers batched over the
shared account table (tango/native/fdt_bank.c) under a per-bank undo
journal, and on the native stem through the bank handler
(`fdt_bank_pipeline`, one GIL-released call per microblock).

Reference model: src/app/fdctl/run/tiles/fd_bank.c — receives microblocks
from pack, executes them (in the reference via Rust FFI into Agave:
fd_ext_bank_load_and_execute_txns, fd_bank.c:100-104), flags itself free
through the busy fseq, and forwards the executed microblock to the poh
tile for mixin.

Execution is BATCHED end to end: one native call (fdt_mb_decode +
fdt_txn_scan) parses and classifies the whole microblock, and the
dominant txn class (simple system transfers) executes through ONE
GIL-released native call per microblock (fdt_bank_exec) against a
shared-memory account table that every bank maps.  Only NONTRIVIAL
accounts (data, non-system owner) fall back to the general per-txn
executor, in sequence, and the table<->funk coherence protocol in
flamenco/runtime.py keeps both views identical.  The per-bank undo
journal and the per-slot version words make a restart lossless: on_boot
rolls back a half-applied txn, drains pending funk write-backs, and a
redelivered microblock resumes at the exact txn it had reached.

Completion travels as a frag on the bank→pack ring (sig = bank<<32 |
handle); the executed microblock is forwarded on the bank→poh ring.
A malformed microblock is a metered drop (`malformed_microblocks`) that
still frees the bank at pack — one bad frag must not take the bank
down, matching the slow path's one-bad-txn rule.
"""

from __future__ import annotations

import numpy as np

from ..ballet import compute_budget as CB
from ..ballet import pack as P
from ..ballet import txn as T
from ..disco.metrics import MetricsSchema
from ..disco.mux import MuxCtx, Tile
from ..tango import rings as R


def execute_txns(txns: list[np.ndarray]) -> int:
    """Fee-only fallback executor.  Returns lamports collected."""
    fees = 0
    for t in txns:
        d = T.parse(bytes(t))
        if d is None:
            continue
        fees += CB.FEE_PER_SIGNATURE * d.signature_cnt
    return fees


class BankTile(Tile):
    """ins[0] = pack_bank microblocks; outs[0] = bank_pack completions,
    outs[1] = bank_poh executed microblocks."""

    schema = MetricsSchema(
        counters=(
            "executed_microblocks",
            "executed_txns",
            "failed_txns",
            "fast_txns",
            "fees_lamports",
            "malformed_microblocks",
            "native_txns",
            "committed_accounts",
        ),
    )

    #: default shared account-table slots (64 B each; all bank shards
    #: must agree — the topology asserts it)
    TABLE_SLOTS = 1 << 14

    #: funk write-back cadence: the table is authoritative (fallback
    #: txns flush per-key, restarts drain via recover), so the batched
    #: commit amortizes over microblocks — hot payers are written once
    #: per window instead of once per microblock.  Housekeeping ticks
    #: bound the staleness funk observers (RPC) can see.
    COMMIT_EVERY = 16

    def __init__(self, bank_id: int, name: str | None = None, *, funk=None,
                 native: bool = True, table_slots: int | None = None,
                 commit_every: int | None = None):
        self.bank_id = bank_id
        self.name = name or f"bank{bank_id}"
        self.funk = funk
        self.native = native
        self.table_slots = table_slots or self.TABLE_SLOTS
        self.commit_every = commit_every or self.COMMIT_EVERY
        self._executor = None
        self._table = None
        self._mb_uncommitted = 0
        # native-decode scratch (grown on demand)
        self._srows = np.zeros((256, T.MTU), np.uint8)
        self._sszs = np.zeros(256, np.uint32)

    def _use_native(self) -> bool:
        return self.native and self.funk is not None

    def shared_wksp_footprints(self) -> dict[str, int]:
        if not self._use_native():
            return {}
        from ..flamenco.runtime import BankTable

        return {"banktab": BankTable.footprint(self.table_slots)}

    def wksp_footprint(self) -> int:
        # per-bank undo journal (a restarted incarnation resumes a
        # half-applied microblock from it)
        return 512

    def on_boot(self, ctx: MuxCtx) -> None:
        if self.funk is not None:
            from ..flamenco.runtime import BankTable, Executor

            self._executor = Executor(self.funk)
            # sysvar accounts (clock/rent/epoch schedule) materialize at
            # slot start so programs can read them like any account
            self._executor.begin_slot(0)
            if self.native:
                mem = ctx.shared(
                    "banktab", BankTable.footprint(self.table_slots)
                )
                jnl = ctx.alloc("bankjnl", BankTable.JOURNAL_BYTES)
                self._table = BankTable(
                    mem, self.table_slots, journal=jnl
                )
                # restart protocol: roll back a half-applied txn and
                # drain pending write-backs BEFORE any new microblock;
                # the journal keeps (tag, txns done) so a redelivered
                # microblock resumes exactly once (see _execute)
                self._table.recover(self.funk, self._executor.xid)

    #: native stem decode/scan scratch rows (fixed; a microblock with
    #: more txns hands back to the Python path's growable scratch)
    STEM_TXN_CAP = 1024

    def native_handler(self, ctx: MuxCtx):
        """Native stem fast path: fdt_bank_pipeline fuses
        fdt_mb_decode + fdt_txn_scan + fdt_bank_exec into one call per
        microblock — the last per-microblock Python is gone.  Anything
        the shared table cannot express (a non-fast txn, a cold key, a
        NONTRIVIAL account) hands the frag back UNCONSUMED to the
        Python on_frags path, whose journal-keyed resume keeps the
        already-executed fast prefix exactly-once.  The deferred funk
        commit keeps its cadence via the after-burst hook."""
        if (
            self._table is None
            or len(ctx.outs) != 2
            or ctx.outs[1].dcache is None
            or any(il.dcache is None for il in ctx.ins)
        ):
            return None
        cap = self.STEM_TXN_CAP
        tbl = self._table
        ex = self._executor
        s = (
            np.zeros((cap, T.MTU), np.uint8),  # 0 decode rows
            np.zeros(cap, np.uint32),  # 1 szs
            np.zeros(cap, np.uint8),  # 2 ok
            np.zeros(cap, np.uint8),  # 3 is_vote
            np.zeros(cap, np.uint8),  # 4 fast
            np.zeros(cap, np.uint32),  # 5 cost
            np.zeros(cap, np.uint64),  # 6 rewards
            np.zeros(cap, np.uint32),  # 7 cu_limit
            np.zeros(cap, np.uint64),  # 8 tags
            np.zeros(cap, np.uint64),  # 9 lamports
            np.zeros(cap, np.uint32),  # 10 payer_off
            np.zeros(cap, np.uint32),  # 11 src_off
            np.zeros(cap, np.uint32),  # 12 dst_off
            np.zeros(cap, np.uint32),  # 13 fee
            np.zeros(cap, np.int64),  # 14 idx
            np.zeros(cap, np.uint8),  # 15 status
            np.zeros(cap, np.uint64),  # 16 ofees
        )
        args = np.zeros(24, np.uint64)
        args[0] = s[0].ctypes.data
        args[1] = T.MTU
        args[2] = s[1].ctypes.data
        args[3] = cap
        for k in range(2, 17):  # BH_OK .. BH_OFEES are contiguous
            args[2 + k] = s[k].ctypes.data
        args[19] = tbl.mem.ctypes.data
        args[20] = tbl.journal.ctypes.data
        args[22] = self.bank_id

        def _refresh_features() -> bool:
            # the Python fallback re-evaluates the feature flag per
            # execution (flamenco/runtime.py); refresh the baked word
            # every iteration so a slot advance / activation epoch can
            # never diverge the native path from the fallback path
            args[21] = int(
                ex.features.active("system_transfer_zero_check", ex.slot)
            )
            return True

        _refresh_features()
        return R.StemSpec(
            R.STEM_H_BANK, args,
            ready=_refresh_features,
            counters=(
                "executed_microblocks", "executed_txns", "failed_txns",
                "fast_txns", "fees_lamports", "malformed_microblocks",
                "native_txns",
            ),
            keepalive=(s, args),
            after_burst=self._stem_after_burst,
        )

    def _stem_after_burst(self, ctx: MuxCtx, ctrs) -> None:
        # the deferred-commit cadence, fed by the burst's
        # executed_microblocks delta (counter scratch slot 0)
        n_mb = int(ctrs[0])
        if n_mb:
            self._mb_uncommitted += n_mb
            if self._mb_uncommitted >= self.commit_every:
                self._commit(ctx)

    def _decode(self, buf: np.ndarray):
        """Native microblock decode -> (rows view, szs view) scratch, or
        None on a malformed microblock (metered drop at the caller)."""
        if len(buf) < 8:
            return None
        n = int(buf[6:8].view("<u2")[0])
        if n > len(self._sszs):
            cap = 1 << (n - 1).bit_length()
            self._srows = np.zeros((cap, T.MTU), np.uint8)
            self._sszs = np.zeros(cap, np.uint32)
        got = R._lib.fdt_mb_decode(
            np.ascontiguousarray(buf).ctypes.data, len(buf),
            self._srows.ctypes.data, self._srows.shape[1],
            self._sszs.ctypes.data, len(self._sszs),
        )
        if got != n:
            return None
        return self._srows[:n], self._sszs[:n]

    def _execute(self, ctx: MuxCtx, rows: np.ndarray, szs: np.ndarray,
                 tag: int) -> int | None:
        """Execute one decoded microblock; returns fees collected, or
        None when a previous incarnation already applied it in full (a
        replayed frag must re-publish but never re-execute).  `tag` is
        the carrying frag's seq — the crash-resume journal key."""
        ex = self._executor
        n = len(rows)
        if ex is None:
            return execute_txns([rows[i, : szs[i]] for i in range(n)])
        tbl = self._table
        if tbl is not None and tbl.already_complete(tag):
            # a replay window can span many microblocks; ones below the
            # completed-seq mark were fully applied (and counted) by an
            # earlier incarnation — re-executing them against the
            # surviving table would double-apply every transfer
            return None
        scan = P.txn_scan(rows, szs)
        fast_idx = np.flatnonzero(scan.fast)
        slow_idx = np.flatnonzero(~scan.fast.astype(bool))
        nf = len(fast_idx)
        # txns a dead incarnation already applied under this tag (fast
        # subset positions [0, nf), then slow positions [nf, n)) — their
        # metrics were counted by that incarnation (shm), so skip silently
        resume = tbl.begin(tag) if tbl is not None else 0
        fees = 0
        if nf:
            if tbl is not None:
                # one GIL-released native call for the whole fast run;
                # scratch rows feed C directly (no per-txn .tobytes());
                # metrics count what THIS incarnation executed, so a
                # mid-microblock resume never double-counts
                f, executed, failed = ex.execute_fast_transfers_native(
                    tbl, rows, szs, fast_idx, scan,
                    tag=tag, start=min(resume, nf),
                )
                ctx.metrics.inc(
                    "native_txns", executed - ex.last_fallbacks
                )
            else:
                payloads = [rows[i, : szs[i]].tobytes() for i in fast_idx]
                f, executed, failed = ex.execute_fast_transfers(
                    payloads,
                    scan.fee[fast_idx].tolist(),
                    scan.lamports[fast_idx].tolist(),
                    scan.payer_off[fast_idx].tolist(),
                    scan.src_off[fast_idx].tolist(),
                    scan.dst_off[fast_idx].tolist(),
                )
            fees += f
            ctx.metrics.inc("fast_txns", executed)
            if failed:
                ctx.metrics.inc("failed_txns", failed)
        for k in range(len(slow_idx)):
            pos = nf + k
            if pos < resume:
                continue
            i = slow_idx[k]
            # one malformed txn must not take the bank down: record it as
            # failed and keep executing the microblock
            try:
                payload = rows[i, : szs[i]].tobytes()
                res = (
                    ex.execute_txn_with_table(tbl, payload)
                    if tbl is not None
                    else ex.execute_txn(payload)
                )
            except Exception:
                ctx.metrics.inc("failed_txns")
                if tbl is not None:
                    tbl.mark_done(tag, pos + 1)
                continue
            fees += res.fee
            if not res.ok:
                ctx.metrics.inc("failed_txns")
            if tbl is not None:
                tbl.mark_done(tag, pos + 1)
        if tbl is not None:
            tbl.mark_complete(tag)
            self._mb_uncommitted += 1
            if self._mb_uncommitted >= self.commit_every:
                self._commit(ctx)
        return fees

    def _commit(self, ctx: MuxCtx) -> None:
        """Batched funk write-back of everything the window dirtied (and
        anything a crashed sibling left pending)."""
        self._mb_uncommitted = 0
        ncom = self._table.commit(self._executor.funk, self._executor.xid)
        if ncom:
            ctx.metrics.inc("committed_accounts", ncom)

    def during_housekeeping(self, ctx: MuxCtx) -> None:
        # bound funk staleness for observers (RPC txn counts read
        # metrics, but balances read funk): a clean table makes this a
        # single native scan
        if self._table is not None and self._mb_uncommitted:
            self._commit(ctx)

    def on_halt(self, ctx: MuxCtx) -> None:
        if self._table is not None:
            self._commit(ctx)

    def on_frags(self, ctx: MuxCtx, in_idx: int, frags: np.ndarray) -> None:
        il = ctx.ins[in_idx]
        rows = il.gather(frags)
        for i in range(len(rows)):
            buf = rows[i, : frags["sz"][i]]
            handle = int(buf[0:4].view("<u4")[0])
            bank = int(buf[4:6].view("<u2")[0])
            if bank != self.bank_id:
                raise RuntimeError(
                    f"{self.name}: microblock for bank {bank} on bank "
                    f"{self.bank_id}'s ring"
                )
            tag = np.array([(bank << 32) | handle], dtype=np.uint64)
            dec = self._decode(buf)
            if dec is None:
                # malformed microblock: metered drop — but the bank MUST
                # still complete at pack or its handle and account locks
                # leak; nothing is forwarded to poh
                ctx.metrics.inc("malformed_microblocks")
                ctx.outs[0].publish(tag)
                continue
            trows, tszs = dec
            fees = self._execute(ctx, trows, tszs, int(frags["seq"][i]))
            if fees is not None:
                ctx.metrics.inc("executed_microblocks")
                ctx.metrics.inc("executed_txns", len(trows))
                ctx.metrics.inc("fees_lamports", fees)
            # forward to poh first, then free the bank at pack
            ctx.outs[1].publish(
                tag, buf[None, :], np.array([len(buf)], dtype=np.uint16)
            )
            ctx.outs[0].publish(tag)
