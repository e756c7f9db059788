"""Block-packing scheduler — the dense-array redesign of ballet/pack.

A copy of firedancer_tpu/ballet/pack.py (the `Pack` engine, `txn_scan`,
`ScanResult`, `is_simple_vote` and the constants) over the port's
tango/rings.py, whose library carries the copy of fdt_pack.c.  The greedy
select's device prefilter is the port's ops/pack_select.py: on a CUDA
card the hand-written kernel csrc/pack_select.cu.

Reference model: src/ballet/pack/fd_pack.c — a treap of
pending txns ordered by reward/cost priority, account-conflict detection
via a hybrid bitset/hashmap (fd_pack_bitset.h), per-account write cost
caps, block CU budgets, and greedy microblock scheduling
(fd_pack_schedule_microblock_impl, fd_pack.c:742-953).

Deliberate redesign (SURVEY.md §7 phase 8): the data structures are dense
numpy arrays instead of intrusive treaps/maps —
  * priority ordering: argsort over the pending set per scheduling pass
    (pack emits microblocks every ~2ms; an O(P log P) vector sort at that
    cadence is cheaper than maintaining pointer structures in Python, and
    is batch/device-friendly)
  * conflict detection: pure bitset over `nbits` hashed account bits with
    NO exact-account fallback — hash collisions cause false-positive
    conflicts, never false negatives, so schedules stay correct and at
    worst a colliding txn waits for the next microblock (the reference's
    own bitset fast path has the same one-sided property; divergence: we
    skip its exact slow path entirely, trading rare spurious delay for a
    data-parallel test)
  * per-account writer cost caps are keyed by 64-bit account-key hashes
    (fdt_pack.c wc map), not exact keys — collisions merge cost buckets,
    which can only UNDER-admit (never violate the consensus cap); the
    reference keeps exact keys in a treap-side map
  * the hot paths (batch parse + estimate, greedy select + commit, lock
    release) are ONE native call each (tango/native/fdt_pack.c, GIL
    released): the Python layer does slot bookkeeping and policy only
  * the greedy select can also run on the device as a prefilter over
    the top-K candidates (ops/pack_select.py); this engine commits the
    device's speculative picks through the same native commit path

Consensus constants (fd_pack.h:17-23) are preserved exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops import pack_select
from ..tango import rings as R

from . import compute_budget as CB
from . import txn as T

MAX_COST_PER_BLOCK = 48_000_000
MAX_VOTE_COST_PER_BLOCK = 36_000_000
MAX_WRITE_COST_PER_ACCT = 12_000_000
FEE_PER_SIGNATURE = 5000
MAX_BANK_TILES = 62

#: max static writable keys an MTU payload can carry: 1232 - 65 (1 sig)
#: - 3 (header) - 1 (acct cu16) - 32 (blockhash) - 1 (instr cu16) leaves
#: 1130 bytes = 35 addresses.  The row must cover the true maximum:
#: fdt_txn_scan truncates hashes past this width, and a truncated
#: writable key would escape the per-account writer cost cap
#: (MAX_WRITE_COST_PER_ACCT, a consensus limit) -> over-admission
MAX_WRITERS = 35
#: same bound applies to readonly static keys (exact lock conflicts)
MAX_READERS = 35

_FREE, _PENDING, _INFLIGHT = 0, 1, 2

from . import base58 as _b58  # noqa: E402

#: the on-chain Vote program id (reference: fd_pack classifies txns whose
#: single instruction targets this program as "simple votes" and schedules
#: them through the dedicated vote lane, fd_pack.c pending_votes treap)
VOTE_PROGRAM_ID = _b58.decode("Vote111111111111111111111111111111111111111")
assert VOTE_PROGRAM_ID is not None and len(VOTE_PROGRAM_ID) == 32


def is_simple_vote(payload: bytes, desc: T.TxnDesc) -> bool:
    """Single-instruction txn invoking the Vote program (the reference's
    is_simple_vote_transaction shape test)."""
    if desc.instr_cnt != 1:
        return False
    ins = desc.instr[0]
    if ins.program_id >= desc.acct_addr_cnt:
        return False
    return bytes(desc.acct_addr(payload, ins.program_id)) == VOTE_PROGRAM_ID


def _hash_acct(key: bytes) -> int:
    """Account pubkey -> stable 64-bit hash (splitmix64 finalizer over the
    first 8 bytes XOR the last 8; must agree with fdt_pack.c acct_hash)."""
    x = int.from_bytes(key[:8], "little") ^ int.from_bytes(key[24:], "little")
    x &= (1 << 64) - 1
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & ((1 << 64) - 1)
    x ^= x >> 31
    return x


@dataclass
class ScanResult:
    """Per-txn outputs of one fdt_txn_scan call (views, length n)."""

    ok: np.ndarray
    is_vote: np.ndarray
    fast: np.ndarray
    cost: np.ndarray
    rewards: np.ndarray
    cu_limit: np.ndarray
    tags: np.ndarray
    lamports: np.ndarray
    payer_off: np.ndarray
    src_off: np.ndarray
    dst_off: np.ndarray
    fee: np.ndarray
    bs_rw: np.ndarray | None = None
    bs_w: np.ndarray | None = None
    whash: np.ndarray | None = None
    w_cnt: np.ndarray | None = None
    rhash: np.ndarray | None = None
    r_cnt: np.ndarray | None = None
    trows: np.ndarray | None = None
    tszs: np.ndarray | None = None
    n_ok: int = 0


def txn_scan(
    rows: np.ndarray,
    szs: np.ndarray,
    *,
    in_off: int = 0,
    nbits: int = 0,
    with_bitsets: bool = False,
    with_trailer: bool = False,
    trows: np.ndarray | None = None,
) -> ScanResult:
    """Batch parse + validate + estimate n txns in one native call
    (fdt_txn_scan).  rows (n, width) u8; szs (n,) payload sizes.

    with_bitsets: also produce the pack conflict bitsets + writable-key
    hashes (requires nbits).  with_trailer: write payload+trailer into
    `trows` (defaults to in-place when rows has 16 bytes of slack)."""
    n, width = rows.shape
    szs32 = np.ascontiguousarray(szs, np.uint32)
    out = ScanResult(
        ok=np.zeros(n, np.uint8),
        is_vote=np.zeros(n, np.uint8),
        fast=np.zeros(n, np.uint8),
        cost=np.zeros(n, np.uint32),
        rewards=np.zeros(n, np.uint64),
        cu_limit=np.zeros(n, np.uint32),
        tags=np.zeros(n, np.uint64),
        lamports=np.zeros(n, np.uint64),
        payer_off=np.zeros(n, np.uint32),
        src_off=np.zeros(n, np.uint32),
        dst_off=np.zeros(n, np.uint32),
        fee=np.zeros(n, np.uint32),
    )
    W = nbits // 64 if with_bitsets else 0
    if with_bitsets:
        out.bs_rw = np.zeros((n, W), np.uint64)
        out.bs_w = np.zeros((n, W), np.uint64)
        out.whash = np.zeros((n, MAX_WRITERS), np.uint64)
        out.w_cnt = np.zeros(n, np.uint8)
        out.rhash = np.zeros((n, MAX_READERS), np.uint64)
        out.r_cnt = np.zeros(n, np.uint8)
    if with_trailer:
        out.trows = rows if trows is None else trows
        out.tszs = np.zeros(n, np.uint32)
    assert rows.flags.c_contiguous
    out.n_ok = int(
        R._lib.fdt_txn_scan(
            rows.ctypes.data, width, in_off, szs32.ctypes.data, n,
            nbits if with_bitsets else 0,
            out.ok.ctypes.data, out.is_vote.ctypes.data,
            out.fast.ctypes.data, out.cost.ctypes.data,
            out.rewards.ctypes.data, out.cu_limit.ctypes.data,
            out.tags.ctypes.data, out.lamports.ctypes.data,
            out.payer_off.ctypes.data, out.src_off.ctypes.data,
            out.dst_off.ctypes.data, out.fee.ctypes.data,
            out.bs_rw.ctypes.data if with_bitsets else None,
            out.bs_w.ctypes.data if with_bitsets else None,
            out.whash.ctypes.data if with_bitsets else None,
            out.w_cnt.ctypes.data if with_bitsets else None,
            MAX_WRITERS,
            out.rhash.ctypes.data if with_bitsets else None,
            out.r_cnt.ctypes.data if with_bitsets else None,
            MAX_READERS,
            out.trows.ctypes.data if with_trailer else None,
            out.trows.shape[1] if with_trailer else 0,
            out.tszs.ctypes.data if with_trailer else None,
        )
    )
    return out


@dataclass
class _Microblock:
    handle: int
    txn_idx: np.ndarray  # pool indices
    total_cost: int


class Pack:
    """Dense-array pack engine.  Single-writer (the pack tile)."""

    def __init__(
        self,
        depth: int,
        *,
        nbits: int = 1024,
        payload_width: int = T.MTU + 16,
        max_banks: int = 8,
        block_cost_limit: int = MAX_COST_PER_BLOCK,
        writer_cost_cap: int = MAX_WRITE_COST_PER_ACCT,
    ):
        assert nbits % 64 == 0
        self.depth = depth
        self.nbits = nbits
        self.W = nbits // 64
        self.max_banks = max_banks
        self.block_cost_limit = block_cost_limit
        self.writer_cost_cap = writer_cost_cap

        P = depth
        self.rows = np.zeros((P, payload_width), dtype=np.uint8)
        self.szs = np.zeros(P, dtype=np.uint16)
        self.rewards = np.zeros(P, dtype=np.uint64)
        self.cost = np.zeros(P, dtype=np.uint32)
        self.expires_at = np.zeros(P, dtype=np.uint64)
        self.state = np.zeros(P, dtype=np.uint8)
        self.sig_tag = np.zeros(P, dtype=np.uint64)
        self.is_vote = np.zeros(P, dtype=bool)
        # hashed account-conflict bitsets
        self.bs_rw = np.zeros((P, self.W), dtype=np.uint64)
        self.bs_w = np.zeros((P, self.W), dtype=np.uint64)
        # hashed writable/readonly account keys per txn (writer cost
        # caps + exact lock tables)
        self.whash = np.zeros((P, MAX_WRITERS), dtype=np.uint64)
        self.w_cnt = np.zeros(P, dtype=np.uint8)
        self.rhash = np.zeros((P, MAX_READERS), dtype=np.uint64)
        self.r_cnt = np.zeros(P, dtype=np.uint8)

        # hashed-bitset in-use state: kept ONLY for the speculative
        # device prefilter (ops/pack_select); the authoritative conflict
        # check is the exact lock tables below — a 1024-bit bloom
        # saturates under deep microblock pipelining and collapses fill
        # (measured round 5: 47 of 256 txns/microblock).  The in_use
        # masks stay zero now (nothing maintains them), so the prefilter
        # only resolves candidate-vs-candidate conflicts; the exact
        # commit re-checks everything it admits.
        self.in_use_rw = np.zeros(self.W, dtype=np.uint64)
        self.in_use_w = np.zeros(self.W, dtype=np.uint64)
        self.bit_ref_rw = np.zeros(nbits, dtype=np.int32)
        self.bit_ref_w = np.zeros(nbits, dtype=np.int32)

        # EXACT account locks across outstanding microblocks (reference:
        # fd_pack's acct_in_use map): open-addressing u64-hash ->
        # refcount, writable + readonly tables.  4*depth entries covers
        # realistic workloads (a few distinct keys per inflight txn) at
        # low load factor; a pathological many-account workload (up to
        # 35+35 keys/txn) can fill it, in which case lock_add FAILS
        # CLOSED — fill degrades, over-admission is impossible
        # (lock_table_load() exposes occupancy for monitors/tests).
        lock_cnt = 1 << max(14, (4 * depth - 1).bit_length())
        self._lock_mask = lock_cnt - 1
        self.lw_keys = np.zeros(lock_cnt, dtype=np.uint64)
        self.lw_vals = np.zeros(lock_cnt, dtype=np.int64)
        self.lr_keys = np.zeros(lock_cnt, dtype=np.uint64)
        self.lr_vals = np.zeros(lock_cnt, dtype=np.int64)

        # writer-cost map (hash-keyed open addressing, fdt_pack.c wc_*):
        # sized for a full block of minimum-cost txns' writable keys —
        # ~block_cost_limit/1500 CU admits ~32K txns, each with up to a
        # few writable keys, so 4x that keeps the load factor low (a full
        # map degrades to at-cap rejections, never a hang — wc_get bound)
        block_txn_cap = max(block_cost_limit // 1500, depth)
        map_cnt = 1 << max(14, (4 * block_txn_cap - 1).bit_length())
        self._wc_mask = map_cnt - 1
        self.wc_keys = np.zeros(map_cnt, dtype=np.uint64)
        self.wc_vals = np.zeros(map_cnt, dtype=np.int64)

        self.vote_cost_limit = MAX_VOTE_COST_PER_BLOCK

        # scheduler words (i64), laid out as the JAX engine's, which
        # shares them with its native after-credit hook (not carried
        # here):
        #   [0] cumulative block cost   [1] cumulative vote cost
        #   [2] next microblock handle  [3] outstanding microblock count
        # [3] is also the O(1) answer to "any outstanding?" the block-
        # boundary check needs (the old dict scan was O(banks + mbs)
        # per after_credit call).
        self._sched_words = np.zeros(4, np.int64)

        # outstanding-microblock registry, dense + native-visible: one
        # entry per in-flight microblock (capacity P: every microblock
        # holds >= 1 distinct pool slot, so the registry can never
        # fill), with the pick-ORDERED txn list stored as a linked
        # chain through the pool slots themselves (mb_next) — exact
        # release order is part of the lock-table bit-parity contract.
        self.mb_used = np.zeros(P, np.uint8)
        self.mb_bank = np.zeros(P, np.int64)
        self.mb_handle = np.zeros(P, np.uint64)
        self.mb_head = np.full(P, -1, np.int64)
        self.mb_cnt = np.zeros(P, np.int64)
        self.mb_cost = np.zeros(P, np.int64)
        self.mb_next = np.full(P, -1, np.int64)

    # ---- queries --------------------------------------------------------

    @property
    def pending_cnt(self) -> int:
        return int((self.state == _PENDING).sum())

    @property
    def inflight_cnt(self) -> int:
        return int((self.state == _INFLIGHT).sum())

    # -- shared scheduler words (native/Python interchangeable state) --

    @property
    def cumulative_block_cost(self) -> int:
        return int(self._sched_words[0])

    @cumulative_block_cost.setter
    def cumulative_block_cost(self, v: int) -> None:
        self._sched_words[0] = v

    @property
    def cumulative_vote_cost(self) -> int:
        return int(self._sched_words[1])

    @cumulative_vote_cost.setter
    def cumulative_vote_cost(self, v: int) -> None:
        self._sched_words[1] = v

    @property
    def outstanding_cnt(self) -> int:
        """O(1) outstanding-microblock count, maintained by schedule /
        complete — the block-boundary check reads this every
        after_credit call (it used to scan the whole per-bank dict)."""
        return int(self._sched_words[3])

    def _mb_txns(self, m: int) -> np.ndarray:
        """Pick-ordered pool slots of registry entry m (chain walk)."""
        cnt = int(self.mb_cnt[m])
        idx = np.empty(cnt, np.int64)
        s = int(self.mb_head[m])
        for k in range(cnt):
            idx[k] = s
            s = int(self.mb_next[s])
        return idx

    @property
    def outstanding(self) -> dict[int, list[_Microblock]]:
        """Compat view of the registry: {bank: [_Microblock, ...]}.
        Materialized per access (registry-slot order); the O(1)
        existence check is `outstanding_cnt`."""
        obs: dict[int, list[_Microblock]] = {
            b: [] for b in range(self.max_banks)
        }
        for m in np.flatnonzero(self.mb_used != 0):
            obs[int(self.mb_bank[m])].append(
                _Microblock(
                    int(self.mb_handle[m]), self._mb_txns(int(m)),
                    int(self.mb_cost[m]),
                )
            )
        return obs

    def lock_table_load(self) -> float:
        """Occupancy of the fuller exact-lock table (0..1); near 1.0
        means lock_add is failing closed and fill is degrading."""
        cap = self._lock_mask + 1
        return max(
            int((self.lw_keys != 0).sum()), int((self.lr_keys != 0).sum())
        ) / cap

    def writer_cost(self, key: bytes) -> int:
        """Committed write cost against `key`'s hash bucket this block."""
        h = _hash_acct(key) or 1
        i = h & self._wc_mask
        for _ in range(self._wc_mask + 1):
            k = int(self.wc_keys[i])
            if k == h:
                return int(self.wc_vals[i])
            if k == 0:
                return 0
            i = (i + 1) & self._wc_mask
        return self.writer_cost_cap  # full map: at-cap (matches wc_get)

    # ---- insert ---------------------------------------------------------

    def insert_batch(
        self,
        rows: np.ndarray,
        szs: np.ndarray,
        *,
        expires_at: int = 0,
        scan: ScanResult | None = None,
    ) -> int:
        """Insert a batch of raw txns ((n, width) u8 + payload sizes) in
        one native scan + vectorized slot scatter.  Returns txns accepted
        (rejects: parse/estimate failures, pool full after the
        better-priority eviction policy).  `scan` reuses a caller's
        fdt_txn_scan result (must include bitsets)."""
        if scan is None:
            scan = txn_scan(rows, szs, nbits=self.nbits, with_bitsets=True)
        ok_idx = np.flatnonzero(scan.ok)
        if not len(ok_idx):
            return 0
        free = np.flatnonzero(self.state == _FREE)
        n_place = min(len(ok_idx), len(free))
        placed = n_place
        if n_place < len(ok_idx):
            # pool full: evict strictly-worse pending txns for the best of
            # the remainder (fd_pack_insert_txn_fini's priority eviction,
            # batch-generalized: best incoming paired with worst pending —
            # the pairing comparison is prefix-monotone, so the accepted
            # set is exactly the evictions the one-at-a-time policy makes)
            extra = ok_idx[n_place:]
            pr_new = scan.rewards[extra].astype(np.float64) / np.maximum(
                scan.cost[extra].astype(np.float64), 1.0
            )
            new_order = np.argsort(-pr_new, kind="stable")
            extra = extra[new_order]
            pending = np.flatnonzero(self.state == _PENDING)
            if len(pending):
                pr_old = self.rewards[pending].astype(
                    np.float64
                ) / np.maximum(self.cost[pending].astype(np.float64), 1.0)
                worst_order = pending[np.argsort(pr_old, kind="stable")]
                pr_old_sorted = np.sort(pr_old, kind="stable")
                k = min(len(extra), len(worst_order))
                take = np.flatnonzero(
                    pr_new[new_order][:k] > pr_old_sorted[:k]
                )
                if len(take):
                    slots = worst_order[take]
                    self.state[slots] = _FREE
                    self._scatter(
                        slots, rows, szs, extra[take], scan, expires_at
                    )
                    placed += len(take)
            ok_idx = ok_idx[:n_place]
        if n_place:
            self._scatter(free[:n_place], rows, szs, ok_idx, scan, expires_at)
        return placed

    def _scatter(self, slots, rows, szs, src, scan: ScanResult, expires_at):
        w = min(rows.shape[1], self.rows.shape[1])
        self.rows[slots, :w] = rows[src][:, :w]
        self.szs[slots] = szs[src]
        self.rewards[slots] = np.minimum(
            scan.rewards[src], np.uint64(0xFFFFFFFF)
        )
        self.cost[slots] = scan.cost[src]
        self.expires_at[slots] = expires_at
        self.sig_tag[slots] = scan.tags[src]
        self.is_vote[slots] = scan.is_vote[src].astype(bool)
        self.bs_rw[slots] = scan.bs_rw[src]
        self.bs_w[slots] = scan.bs_w[src]
        self.whash[slots] = scan.whash[src]
        self.w_cnt[slots] = scan.w_cnt[src]
        self.rhash[slots] = scan.rhash[src]
        self.r_cnt[slots] = scan.r_cnt[src]
        self.state[slots] = _PENDING

    def insert(
        self, payload: bytes, *, expires_at: int = 0, sig_tag: int = 0
    ) -> str:
        """Insert one txn.  Returns 'ok', 'parse', 'estimate', or 'full'
        (mirrors fd_pack_insert_txn_fini's reject reasons)."""
        row = np.zeros((1, len(payload)), np.uint8)
        row[0] = np.frombuffer(payload, np.uint8)
        szs = np.array([len(payload)], np.uint32)
        scan = txn_scan(row, szs, nbits=self.nbits, with_bitsets=True)
        if not scan.ok[0]:
            # distinguish the reject reason for the caller (one extra
            # Python parse on the cold path only)
            desc = T.parse(payload)
            if desc is None:
                return "parse"
            return "estimate"
        if sig_tag:
            scan.tags[0] = sig_tag
        placed = self.insert_batch(row, szs, expires_at=expires_at, scan=scan)
        return "ok" if placed else "full"

    # ---- scheduling -----------------------------------------------------

    def _order(self, cands: np.ndarray, scan_limit: int) -> np.ndarray:
        pr = self.rewards[cands].astype(np.float64) / np.maximum(
            self.cost[cands].astype(np.float64), 1.0
        )
        return np.ascontiguousarray(
            cands[np.argsort(-pr, kind="stable")][:scan_limit], np.int64
        )

    def _commit(
        self, order: np.ndarray, cu_limit: int, txn_limit: int,
        byte_limit: int,
    ) -> tuple[np.ndarray, int]:
        """Greedy select + commit (native, EXACT account locks):
        returns (picks, cu_used)."""
        if cu_limit <= 0 or txn_limit <= 0 or not len(order):
            return np.zeros(0, np.int64), 0
        picks = np.empty(min(len(order), txn_limit), np.int64)
        cu_used = np.zeros(1, np.int64)
        n = R._lib.fdt_pack_select_x(
            order.ctypes.data, len(order),
            self.whash.ctypes.data, self.w_cnt.ctypes.data, MAX_WRITERS,
            self.rhash.ctypes.data, self.r_cnt.ctypes.data, MAX_READERS,
            self.lw_keys.ctypes.data, self.lw_vals.ctypes.data,
            self._lock_mask,
            self.lr_keys.ctypes.data, self.lr_vals.ctypes.data,
            self._lock_mask,
            self.cost.ctypes.data, self.szs.ctypes.data, byte_limit,
            self.wc_keys.ctypes.data, self.wc_vals.ctypes.data,
            self._wc_mask, self.writer_cost_cap, cu_limit, txn_limit,
            picks.ctypes.data, cu_used.ctypes.data,
        )
        return picks[:n], int(cu_used[0])

    def _select_speculative(
        self, cands, cu_limit, txn_limit, scan_limit, device_select,
        sel_rw, sel_w,
    ) -> np.ndarray:
        """Device-speculative selection (ops/pack_select): returns a
        candidate pick ORDER; the native commit path re-enforces every
        exact budget before committing."""
        order = self._order(cands, scan_limit)
        cand_rw = self.bs_rw[order]
        cand_w = self.bs_w[order]
        costs = self.cost[order].astype(np.int64)
        K = len(order)
        if K < scan_limit:
            pad = scan_limit - K
            cand_rw = np.concatenate(
                [cand_rw, np.zeros((pad, self.W), np.uint64)]
            )
            cand_w = np.concatenate(
                [cand_w, np.zeros((pad, self.W), np.uint64)]
            )
            costs = np.concatenate(
                [costs, np.full(pad, pack_select.PAD_COST, np.int64)]
            )
        take = np.asarray(
            device_select(
                cand_rw, cand_w, sel_rw.copy(), sel_w.copy(), costs,
                cu_limit, txn_limit,
            )
        )[:K]
        return np.ascontiguousarray(order[take], np.int64)

    def schedule_microblock(
        self,
        bank: int,
        *,
        cu_limit: int = 1_500_000,
        txn_limit: int = 31,
        vote_fraction: float = 0.25,
        now: int = 0,
        scan_limit: int = 1024,
        byte_limit: int = 0,
        device_select=None,
    ) -> _Microblock | None:
        """Greedy-select a non-conflicting microblock for `bank`
        (fd_pack_schedule_next_microblock behavior, fd_pack.c:1029 /
        742-953): VOTES FIRST with `vote_fraction` of the CU budget,
        capped by the per-block vote cost limit (MAX_VOTE_COST_PER_BLOCK,
        fd_pack.h:20), then non-votes with the remainder.  device_select,
        when given, is the device prefilter (ops/pack_select.select_noconflict)
        used speculatively; the native commit still enforces writer-cost
        caps and budgets exactly.  byte_limit bounds the encoded
        microblock size (0 = unbounded)."""
        if self.cumulative_block_cost >= self.block_cost_limit:
            return None
        cu_limit = min(
            cu_limit, self.block_cost_limit - self.cumulative_block_cost
        )
        pending = np.flatnonzero(self.state == _PENDING)
        if now:
            # expires_at == 0 means "no expiry requested"
            exp = self.expires_at[pending]
            live = (exp >= now) | (exp == 0)
            expired = pending[~live]
            if len(expired):
                self._release_slots(expired)
            pending = pending[live]
        if not len(pending):
            return None

        votes = pending[self.is_vote[pending]]
        nonvotes = pending[~self.is_vote[pending]]
        vote_budget = min(
            int(cu_limit * vote_fraction),
            self.vote_cost_limit - self.cumulative_vote_cost,
        )
        # votes also get only a vote_fraction share of the txn SLOTS while
        # non-votes are pending: cheap votes must not be able to fill all
        # 31 slots of every microblock on txn count alone (divergence note:
        # the reference splits CUs only; its slot pressure differs because
        # votes and non-votes come from separate treaps per call)
        vote_txn_limit = txn_limit
        if len(nonvotes):
            vote_txn_limit = max(1, int(txn_limit * vote_fraction))
        # vote lane always uses the host order: the candidate set is tiny
        vote_picks, vote_used = self._commit(
            self._order(votes, scan_limit), vote_budget, vote_txn_limit,
            byte_limit,
        ) if len(votes) else (np.zeros(0, np.int64), 0)
        # the byte budget spans the WHOLE microblock: the nonvote pass
        # only gets what the vote pass left (each txn costs sz + a
        # 2-byte length prefix on the wire)
        nv_byte_limit = byte_limit
        if byte_limit > 0 and len(vote_picks):
            nv_byte_limit = max(
                1,
                byte_limit - int(self.szs[vote_picks].sum())
                - 2 * len(vote_picks),
            )
        if device_select is not None and len(nonvotes):
            nv_order = self._select_speculative(
                nonvotes, cu_limit - vote_used, txn_limit, scan_limit,
                device_select, self.in_use_rw, self.in_use_w,
            )
        else:
            nv_order = self._order(nonvotes, scan_limit)
        nv_picks, nv_used = self._commit(
            nv_order, cu_limit - vote_used,
            txn_limit - len(vote_picks), nv_byte_limit,
        )
        picks = np.concatenate([vote_picks, nv_picks])
        if not len(picks):
            return None
        self.cumulative_vote_cost += vote_used
        total = vote_used + nv_used
        self.cumulative_block_cost += total
        self.state[picks] = _INFLIGHT
        # handles live in the u32 domain end to end: the completion sig
        # carries only 32 bits ((bank << 32) | handle), so the registry
        # stores and matches MASKED handles — a wrap can never strand an
        # outstanding microblock as unmatchable (collision would need
        # 2^32 simultaneous outstanding handles; the registry holds at
        # most P)
        handle = int(self._sched_words[2]) & 0xFFFFFFFF
        self._sched_words[2] += 1
        # registry record: lowest free entry, pick-ordered slot chain
        m = int(np.flatnonzero(self.mb_used == 0)[0])
        self.mb_bank[m] = bank
        self.mb_handle[m] = np.uint64(handle)
        self.mb_head[m] = picks[0]
        self.mb_cnt[m] = len(picks)
        self.mb_cost[m] = total
        if len(picks) > 1:
            self.mb_next[picks[:-1]] = picks[1:]
        self.mb_next[picks[-1]] = -1
        self.mb_used[m] = 1
        self._sched_words[3] += 1
        return _Microblock(handle, picks, total)

    def microblock_complete(self, bank: int, handle: int) -> None:
        """Bank finished executing a microblock: release account locks and
        free the slots (fd_pack_microblock_complete, fd_pack.c:956)."""
        m = np.flatnonzero(
            (self.mb_used != 0)
            & (self.mb_bank == bank)
            & (self.mb_handle == np.uint64(handle & 0xFFFFFFFF))
        )
        if not len(m):
            raise KeyError(f"no outstanding microblock {handle} on bank {bank}")
        m = int(m[0])
        idx = self._mb_txns(m)
        self.mb_used[m] = 0
        self._sched_words[3] -= 1
        R._lib.fdt_pack_release_x(
            idx.ctypes.data, len(idx),
            self.whash.ctypes.data, self.w_cnt.ctypes.data, MAX_WRITERS,
            self.rhash.ctypes.data, self.r_cnt.ctypes.data, MAX_READERS,
            self.lw_keys.ctypes.data, self.lw_vals.ctypes.data,
            self._lock_mask,
            self.lr_keys.ctypes.data, self.lr_vals.ctypes.data,
            self._lock_mask,
        )
        self._release_slots(idx)

    def _release_slots(self, idx: np.ndarray) -> None:
        self.state[idx] = _FREE

    def end_block(self) -> None:
        """Slot boundary: reset block budgets and per-account write costs
        (fd_pack_end_block).  Outstanding microblocks must be completed
        first; pending txns carry over."""
        assert self.outstanding_cnt == 0
        self.wc_keys.fill(0)
        self.wc_vals.fill(0)
        self.cumulative_block_cost = 0
        self.cumulative_vote_cost = 0
