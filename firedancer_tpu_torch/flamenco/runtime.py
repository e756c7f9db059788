"""Transaction execution runtime — the bank tile's executor.

A copy of firedancer_tpu/flamenco/runtime.py.

Reference model: src/flamenco/runtime/fd_executor.c (dispatch txn ->
program), runtime/program/fd_system_program.c (transfer / create_account /
assign / allocate with the bincode u32-discriminant instruction encoding),
and the BPF loader path into the VM (fd_vm_interp).  Accounts live in funk
via flamenco.accounts; each executed batch runs inside a funk transaction
so a failed block can be cancelled wholesale (the fork model the reference
gets from funk too).

Execution semantics implemented:
  * fee collection: FEE_PER_SIGNATURE lamports per signature, debited
    from the fee payer (first signer) BEFORE execution; txn rejected
    outright if the payer cannot cover fees
  * per-instruction dispatch by owner/program id: system program native
    impl; programs owned by the BPF loader execute in the sBPF VM
  * failed txns roll back their own writes but still pay fees (matching
    the reference's fee-then-execute ordering)
  * rent: create_account requires the rent-exempt minimum for the
    requested space (simplified linear model; reference sysvar rent)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import struct

from ..ballet import txn as T
from ..ballet.base58 import decode_32
from ..flamenco.accounts import (
    _HDR, Account, AccountMgr, SYSTEM_PROGRAM_ID,
)
from ..funk.funk import Funk, ROOT_XID

FEE_PER_SIGNATURE = 5000

#: address-lookup-table native program
#: (reference: runtime/program/fd_address_lookup_table_program.c)
ALT_PROGRAM_ID = decode_32("AddressLookupTab1e1111111111111111111111111")
#: config native program (reference: fd_config_program.c)
CONFIG_PROGRAM_ID = decode_32("Config1111111111111111111111111111111111111")
#: ed25519 signature-verification precompile (fd_ed25519_program.c)
ED25519_PROGRAM_ID = decode_32("Ed25519SigVerify111111111111111111111111111")
#: keccak-secp256k1 precompile (eth-style ecrecover verification; the
#: sibling of the ed25519 precompile)
SECP256K1_PROGRAM_ID = decode_32(
    "KeccakSecp256k11111111111111111111111111111"
)

#: ALT account layout: 56-byte header then packed 32-byte addresses
_ALT_HDR = struct.Struct("<IQQBB32sH")
ALT_HEADER_SZ = 56
_ALT_DISC_TABLE = 1
ALT_DEACT_NONE = (1 << 64) - 1
#: slots a deactivating table keeps serving lookups (reference: table is
#: usable until its deactivation slot ages out of slot-hashes, ~512 slots)
ALT_DEACT_COOLDOWN = 513

# ALT instruction discriminants (bincode u32le)
_ALT_CREATE = 0
_ALT_FREEZE = 1
_ALT_EXTEND = 2
_ALT_DEACTIVATE = 3

#: simplified rent-exempt minimum: lamports per byte-year * 2 years
RENT_PER_BYTE = 3480 * 2
RENT_BASE = 890_880

#: consensus cap on account data size (10 MiB, MAX_PERMITTED_DATA_LENGTH)
MAX_DATA_LEN = 10 * 1024 * 1024
#: spare bytes after each account's data in the VM input region — the
#: realloc headroom of Solana's aligned serializer (10 KiB)
MAX_PERMITTED_DATA_INCREASE = 10 * 1024

BPF_LOADER_ID = b"BPFLoader" + bytes(23)

#: BPF loader v4 (reference: runtime/program/fd_bpf_loader_v4_program.c)
LOADER_V4_ID = decode_32("LoaderV411111111111111111111111111111111111")
#: loader-v4 account state header: u64 slot | authority[32] | u64 status
LOADER_V4_STATE_SZ = 48
_V4_RETRACTED, _V4_DEPLOYED, _V4_FINALIZED = 0, 1, 2
#: slots between deploy/retract status flips (fd_bpf_loader_v4_program.c
#: DEPLOYMENT_COOLDOWN_IN_SLOTS)
V4_DEPLOYMENT_COOLDOWN = 750
# loader-v4 instruction discriminants (bincode u32le)
_V4_WRITE, _V4_TRUNCATE, _V4_DEPLOY, _V4_RETRACT, _V4_XFER_AUTH = range(5)

# system instruction discriminants (bincode u32le)
_SYS_CREATE = 0
_SYS_ASSIGN = 1
_SYS_TRANSFER = 2
_SYS_ADVANCE_NONCE = 4
_SYS_WITHDRAW_NONCE = 5
_SYS_INIT_NONCE = 6
_SYS_AUTHORIZE_NONCE = 7
_SYS_ALLOCATE = 8

#: nonce account data: Versions(u32) + State(u32) + authority(32) +
#: durable_nonce(32) + fee_calculator.lamports_per_signature(u64)
NONCE_STATE_SZ = 80
_NONCE_VERSION_LEGACY = 0
_NONCE_VERSION_CURRENT = 1
_NONCE_UNINITIALIZED = 0
_NONCE_INITIALIZED = 1


def durable_nonce_from_blockhash(blockhash: bytes) -> bytes:
    """sha256("DURABLE_NONCE" || blockhash) — the domain-separated nonce
    value (reference: fd_durable_nonce_from_blockhash,
    fd_system_program_nonce.c:67-72)."""
    import hashlib

    return hashlib.sha256(b"DURABLE_NONCE" + blockhash).digest()


def _nonce_decode(data: bytes):
    """-> (state, authority, durable, fee) with state in
    {_NONCE_UNINITIALIZED, _NONCE_INITIALIZED}, or None on malformed
    data.  Accepts both Legacy and Current versions (reference decode
    switch, fd_system_program_nonce.c:155-168)."""
    if len(data) < 8:
        return None
    version = int.from_bytes(data[:4], "little")
    if version not in (_NONCE_VERSION_LEGACY, _NONCE_VERSION_CURRENT):
        return None
    state = int.from_bytes(data[4:8], "little")
    if state == _NONCE_UNINITIALIZED:
        return (_NONCE_UNINITIALIZED, None, None, 0)
    if state != _NONCE_INITIALIZED or len(data) < NONCE_STATE_SZ:
        return None
    return (
        _NONCE_INITIALIZED,
        bytes(data[8:40]),
        bytes(data[40:72]),
        int.from_bytes(data[72:80], "little"),
    )


def _nonce_encode(state: int, authority: bytes = bytes(32),
                  durable: bytes = bytes(32), fee: int = 0) -> bytes:
    return (
        _NONCE_VERSION_CURRENT.to_bytes(4, "little")
        + state.to_bytes(4, "little")
        + authority
        + durable
        + fee.to_bytes(8, "little")
    )


def rent_exempt_minimum(space: int) -> int:
    return RENT_BASE + RENT_PER_BYTE * space


def _v4_state(data: bytes):
    """Loader-v4 state header -> (slot, authority, status) or None."""
    if len(data) < LOADER_V4_STATE_SZ:
        return None
    return (
        int.from_bytes(data[0:8], "little"),
        bytes(data[8:40]),
        int.from_bytes(data[40:48], "little"),
    )


def _v4_state_encode(slot: int, authority: bytes, status: int) -> bytes:
    return (
        slot.to_bytes(8, "little") + authority
        + status.to_bytes(8, "little")
    )


def alt_addresses(table_data: bytes) -> list[bytes] | None:
    """Addresses held by an ALT account (None on malformation)."""
    if len(table_data) < ALT_HEADER_SZ:
        return None
    disc = int.from_bytes(table_data[:4], "little")
    if disc != _ALT_DISC_TABLE:
        return None
    body = table_data[ALT_HEADER_SZ:]
    if len(body) % 32:
        return None
    return [body[i : i + 32] for i in range(0, len(body), 32)]


@dataclass
class TxnResult:
    ok: bool
    err: str = ""
    fee: int = 0
    logs: list = field(default_factory=list)
    cu_used: int = 0


#: reference: max instruction stack height 5 (top-level is height 1), so
#: CPI may nest 4 deep (fd_vm_syscall_cpi max invoke depth behavior)
MAX_INVOKE_STACK = 5
#: per-txn compute budget shared across every instruction + CPI callee
TXN_CU_BUDGET = 1_400_000
#: CPI flat cost (reference: vm syscall cost model for sol_invoke_*)
CPI_BASE_CU = 1_000
#: PDA seed constraints (reference: fd_pubkey_create_program_address)
MAX_SEEDS = 16
MAX_SEED_LEN = 32


@dataclass(frozen=True)
class InstrCtx:
    """Per-instruction execution context: the privilege sets the reference
    carries in fd_instr_info (signer/writable flags per account), the
    invoke stack for re-entrancy rules, and the shared CU meter.

    `signers` includes txn signers and, under CPI, caller-granted signer
    privileges + PDA signers; `writables` is the writable-privilege set
    granted by the caller (top level: the txn message header flags).
    `stack` holds the program ids of active invocations, outermost first.
    `meter` is a 1-element mutable list: remaining CUs for the whole txn.
    """

    signers: frozenset
    writables: frozenset
    stack: tuple = ()
    meter: list = field(default_factory=lambda: [TXN_CU_BUDGET])
    #: (payload, desc) of the enclosing transaction — precompiles read
    #: sibling instructions' data through it (fd_ed25519_program.c
    #: _get_instr_data)
    txn: tuple | None = None

    @property
    def depth(self) -> int:
        return len(self.stack)

    def child(self, signers, writables) -> "InstrCtx":
        """Privilege-restricted context for a CPI callee.  The invoke
        stack is NOT pushed here — _dispatch pushes the callee program id
        when it runs the instruction."""
        return InstrCtx(
            frozenset(signers), frozenset(writables), self.stack,
            self.meter, self.txn,
        )


def create_program_address(seeds, program_id: bytes):
    """PDA derivation: sha256(seeds.. || program_id || marker), rejected
    when the digest decodes to a curve point (reference:
    fd_pubkey_create_program_address)."""
    import hashlib

    if len(seeds) > MAX_SEEDS:
        return None
    h = hashlib.sha256()
    for s in seeds:
        if len(s) > MAX_SEED_LEN:
            return None
        h.update(s)
    h.update(program_id)
    h.update(b"ProgramDerivedAddress")
    out = h.digest()
    from ..ops.ed25519 import golden

    if golden.point_decompress(out) is not None:
        return None  # on-curve: not a valid PDA
    return out


def find_program_address(seeds, program_id: bytes):
    """(address, bump) with the canonical descending bump search."""
    for bump in range(255, -1, -1):
        pda = create_program_address(list(seeds) + [bytes([bump])], program_id)
        if pda is not None:
            return pda, bump
    return None


def classify_record(raw: bytes | None) -> tuple[int, int]:
    """THE table-executability rule, shared by every fast path:
    -> (BankTable.ST_*, lamports).  TRIVIAL means a header-only
    system-owned account with no executable/rent bits — exactly what
    the native table (and the python fast path's lamports cache) may
    hold; anything else is NONTRIVIAL and must execute generally."""
    if raw is None:
        return BankTable.ST_ABSENT, 0
    if len(raw) != _HDR.size:
        return BankTable.ST_NONTRIVIAL, 0
    lam, owner, execu, rent = _HDR.unpack(raw)
    if owner != SYSTEM_PROGRAM_ID or execu or rent:
        return BankTable.ST_NONTRIVIAL, 0
    return BankTable.ST_TRIVIAL, lam


class BankTable:
    """Shared-memory native account table + per-bank undo journal — the
    host-side handle on tango/native/fdt_bank.c.

    The table region lives in the topology workspace so every bank tile
    (thread or process) shards over ONE table and it survives SIGKILL
    restarts; the 256-byte journal region is per-bank (tile arena) and
    makes each txn's slot writes atomic across a crash.  Funk remains
    the system of record: `commit()` drains entries funk has not seen
    yet (per-slot version words) with the existing lam_cache
    invalidation discipline, and `recover()` is the restart protocol
    (roll back a half-applied txn, then drain everything pending).

    Only TRIVIAL system accounts (header-only, system-owned, no
    executable/rent bits) are table-executable; other accounts are
    cached as NONTRIVIAL markers so the executor can stop and fall back
    per txn.  See Executor.execute_fast_transfers_native."""

    ST_EMPTY, ST_BUSY, ST_TRIVIAL, ST_NONTRIVIAL, ST_ABSENT = range(5)
    #: per-txn exec statuses (fdt_bank.h FDT_BANK_*)
    OK, FAIL, REJECT, MISS, NONTRIV = range(5)
    JOURNAL_BYTES = 256
    _DRAIN_MAX = 4096

    def __init__(self, mem, slot_cnt: int, journal=None):
        import numpy as np

        from ..tango import rings as R

        self.lib = R._lib
        self.mem = mem
        assert mem.flags["C_CONTIGUOUS"]
        rc = self.lib.fdt_bank_tab_new(mem.ctypes.data, slot_cnt)
        if rc < 0:
            raise ValueError(
                f"fdt_bank table init failed (slot_cnt={slot_cnt}; power "
                f"of two, geometry must match an existing table)"
            )
        self.rejoined = bool(rc)
        self.slot_cnt = slot_cnt
        if journal is None:
            journal = np.zeros(self.JOURNAL_BYTES, np.uint8)
        self.journal = journal
        self._jw = journal[: self.JOURNAL_BYTES].view(np.uint64)
        # commit drain scratch (reused across calls)
        self._dk = np.zeros((self._DRAIN_MAX, 32), np.uint8)
        self._dl = np.zeros(self._DRAIN_MAX, np.uint64)
        self._ds = np.zeros(self._DRAIN_MAX, np.uint8)
        self._dslot = np.zeros(self._DRAIN_MAX, np.uint64)
        self._dver = np.zeros(self._DRAIN_MAX, np.uint64)
        self._g1 = np.zeros(1, np.uint64)  # get() out scratch

    @classmethod
    def footprint(cls, slot_cnt: int) -> int:
        from ..tango import rings as R

        fp = int(R._lib.fdt_bank_tab_footprint(slot_cnt))
        if not fp:
            raise ValueError(f"bad bank table slot_cnt {slot_cnt}")
        return fp

    # -- key ops ----------------------------------------------------------
    # key bytes pass straight through the c_void_p args (no per-call
    # numpy marshalling — the batch cold-resolve path calls these for
    # every key of every remaining txn)

    def get(self, key: bytes) -> tuple[int, int]:
        """-> (state, lamports); lamports meaningful for ST_TRIVIAL."""
        st = self.lib.fdt_bank_tab_get(
            self.mem.ctypes.data, key, self._g1.ctypes.data
        )
        return int(st), int(self._g1[0])

    def put(self, key: bytes, state: int, lamports: int = 0,
            dirty: bool = False) -> bool:
        """Upsert; False when the table is full (caller falls back)."""
        return (
            self.lib.fdt_bank_tab_put(
                self.mem.ctypes.data, key, state, lamports, int(dirty)
            )
            == 0
        )

    def resolve(self, funk, xid: bytes, key: bytes) -> int:
        """Classify the funk record for `key` into the table (marked
        funk-synced).  Returns the state cached, or ST_EMPTY when the
        table is full."""
        st, lam = classify_record(funk.rec_read(xid, key))
        if not self.put(key, st, lam):
            return self.ST_EMPTY
        return st

    # -- microblock journal ----------------------------------------------

    #: python-owned journal word (past the C undo area): seq AFTER the
    #: last fully-completed microblock tag, 0 = none yet.  Frag seqs are
    #: monotonic per link, so a redelivered microblock below this mark
    #: was applied in full by a previous incarnation and must be SKIPPED
    #: — the supervisor replay window spans many microblocks, and the
    #: (tag, done) pair above only protects the last one.
    _JW_COMPLETED = 31

    def begin(self, tag: int) -> int:
        """Adopt a microblock: returns the txns a previous incarnation
        already applied under this tag (0 for a fresh microblock)."""
        if int(self._jw[0]) == tag:
            return int(self._jw[1])
        # done first, tag last: a kill between the stores must never
        # leave (new tag, stale done) — that resume would skip txns
        self._jw[1] = 0
        self._jw[0] = tag
        return 0

    def mark_done(self, tag: int, done: int) -> None:
        """Record python-side (fallback/slow) txn completion so a
        restart resumes after it."""
        if int(self._jw[0]) == tag:
            self._jw[1] = done

    def mark_complete(self, tag: int) -> None:
        """Record a fully-executed microblock: replay below this seq
        re-publishes (completion frees pack) but never re-executes."""
        from ..tango.rings import seq_u64

        self._jw[self._JW_COMPLETED] = seq_u64(tag + 1)

    def already_complete(self, tag: int) -> bool:
        from ..tango.rings import seq_lt

        v = int(self._jw[self._JW_COMPLETED])
        return v != 0 and seq_lt(tag, v)

    # -- funk write-back --------------------------------------------------

    def commit(self, funk, xid: bytes = ROOT_XID) -> int:
        """Drain every entry funk has not seen into funk records, with
        the lam_cache discipline the python fast path keeps (rec_write
        invalidates; the fresh decode is re-cached).  Returns entries
        written back."""
        pack = _HDR.pack
        absent = self.ST_ABSENT
        total = 0
        while True:
            got = int(
                self.lib.fdt_bank_commit(
                    self.mem.ctypes.data, self._dk.ctypes.data,
                    self._dl.ctypes.data, self._ds.ctypes.data,
                    self._dslot.ctypes.data, self._dver.ctypes.data,
                    self._DRAIN_MAX,
                )
            )
            if got:
                keys = [self._dk[m].tobytes() for m in range(got)]
                lams = self._dl[:got].tolist()
                sts = self._ds[:got].tolist()
                funk.rec_write_many(
                    xid,
                    (
                        (
                            keys[m],
                            None if sts[m] == absent
                            else pack(lams[m], SYSTEM_PROGRAM_ID, 0, 0),
                        )
                        for m in range(got)
                    ),
                )
                if xid == ROOT_XID:
                    # re-warm the cache the write-back just invalidated
                    funk.lam_cache.update(
                        (keys[m], lams[m])
                        for m in range(got)
                        if sts[m] != absent
                    )
                # funk has the records: NOW retire the drained versions
                # (a kill before this ack re-drains them — funk write-
                # back is idempotent, so at-least-once is lossless)
                self.lib.fdt_bank_commit_ack(
                    self.mem.ctypes.data, self._dslot.ctypes.data,
                    self._dver.ctypes.data, got,
                )
            total += got
            if got < self._DRAIN_MAX:
                return total

    def recover(self, funk, xid: bytes = ROOT_XID) -> tuple[int, int, bool]:
        """Restart protocol: roll back a half-applied txn (undo journal)
        and drain everything pending into funk.  Returns (microblock
        tag, txns done under it, rolled_back) so the tile can resume a
        redelivered microblock exactly once."""
        import numpy as np

        out = np.zeros(2, np.uint64)
        rolled = bool(
            self.lib.fdt_bank_recover(
                self.mem.ctypes.data, self.journal.ctypes.data,
                out.ctypes.data,
            )
        )
        self.commit(funk, xid)
        return int(out[0]), int(out[1]), rolled


class Executor:
    """Executes parsed transactions against a funk fork."""

    def __init__(self, funk: Funk, xid: bytes = ROOT_XID):
        from ..flamenco.features import Features

        self.funk = funk
        self.xid = xid
        self.mgr = AccountMgr(funk, xid)
        self.slot = 0  # bank slot (ALT create derivation, deactivation)
        #: runtime behavior switches (reference: fd_features_t); dev
        #: default is all-enabled, overridden by on-chain feature
        #: accounts at each slot boundary
        self.features = Features.all_enabled()
        #: most recent blockhash (durable-nonce derivation; the bank
        #: feeds the PoH state in via begin_slot)
        self.recent_blockhash = bytes(32)
        #: lamports/sig recorded into initialized nonce accounts
        self.lamports_per_signature = FEE_PER_SIGNATURE
        self._slot_hashes = None  # sysvar.SlotHashes, built lazily
        #: static + ALT-resolved keys of the last execute_txn call — the
        #: bank's table<->funk resync reads it (execute_txn_with_table)
        self.last_touched: list[bytes] = []
        #: txns of the last execute_fast_transfers_native call that ran
        #: through the per-txn general-executor fallback (the bank tile
        #: subtracts these from its native_txns metric)
        self.last_fallbacks = 0

    def begin_slot(self, slot: int, unix_timestamp: int = 0,
                   blockhash: bytes | None = None) -> None:
        """Advance the bank slot: refresh the sysvar accounts
        (reference: fd_sysvar_clock_update at slot start).  blockhash
        is the previous slot's bank/PoH hash; it extends the slot-hashes
        history (fd_sysvar_slot_hashes.c slot_hashes_update) and drives
        durable-nonce derivation."""
        import hashlib

        from ..flamenco import sysvar
        from ..flamenco.features import Features

        if self._slot_hashes is None:
            self._slot_hashes = sysvar.SlotHashes()
        prev = self.slot
        self.slot = slot
        if blockhash is None:
            # deterministic stand-in chain when no PoH state is wired
            blockhash = hashlib.sha256(
                b"fdt-blockhash" + slot.to_bytes(8, "little")
            ).digest()
        if slot > prev:
            # one entry per slot in (prev, slot), newest last-added: the
            # reference's sysvar covers every slot (consecutive on
            # mainnet) — a sparse bank clock must not leave holes, or a
            # table deactivated in a skipped slot would read as expired
            # immediately (fd_sysvar_slot_hashes.c slot_hashes_update)
            lo = max(prev, slot - sysvar.SLOT_HASHES_MAX)
            for s in range(lo, slot):
                h = (
                    self.recent_blockhash if s == prev
                    else hashlib.sha256(
                        b"fdt-slot" + s.to_bytes(8, "little")
                    ).digest()
                )
                self._slot_hashes.add(s, h)
        self.recent_blockhash = blockhash
        sysvar.install(
            self.mgr, slot, unix_timestamp=unix_timestamp,
            slot_hashes=self._slot_hashes,
            recent_blockhashes=sysvar.RecentBlockhashes(
                [(blockhash, self.lamports_per_signature)]
            ),
        )
        # refresh the feature table from the account database
        # (reference: fd_features derive from feature accounts)
        self.features = Features.from_accounts(
            self.mgr.load, default=self.features
        )

    # ---- address lookup tables ------------------------------------------

    def _resolve_alts(self, payload: bytes, desc: T.TxnDesc):
        """-> list of resolved keys (writables then readonlys), or an
        error string.  Reference behavior: fd_runtime load of v0 message
        addresses via the ALT program's on-chain tables."""
        writable: list[bytes] = []
        readonly: list[bytes] = []
        for lut in desc.address_tables:
            table_key = payload[lut.addr_off : lut.addr_off + 32]
            acct = self.mgr.load(table_key)
            if acct is None or acct.owner != ALT_PROGRAM_ID:
                return "alt: table account missing"
            if len(acct.data) >= ALT_HEADER_SZ:
                deact = int.from_bytes(acct.data[4:12], "little")
                if deact != ALT_DEACT_NONE and self._alt_fully_deactivated(
                    deact
                ):
                    return "alt: table deactivated"
            addrs = alt_addresses(acct.data)
            if addrs is None:
                return "alt: malformed table"
            for off, cnt, out in (
                (lut.writable_off, lut.writable_cnt, writable),
                (lut.readonly_off, lut.readonly_cnt, readonly),
            ):
                for j in range(cnt):
                    idx = payload[off + j]
                    if idx >= len(addrs):
                        return "alt: index out of range"
                    out.append(addrs[idx])
        return writable + readonly

    def _alt_fully_deactivated(self, deact_slot: int) -> bool:
        """A deactivating table serves lookups while its deactivation
        slot is still in the slot-hashes history (reference: the table
        status is derived from the SlotHashes sysvar,
        fd_address_lookup_table_program.c); the fixed cooldown is the
        fallback when no history exists yet (early tests, forked
        executors that never ran begin_slot)."""
        from ..flamenco import sysvar

        if deact_slot == self.slot:
            return False  # deactivated this slot: still usable
        acct = self.mgr.load(sysvar.SLOT_HASHES_ID)
        if acct is not None and acct.data:
            return not sysvar.SlotHashes.decode(acct.data).contains_slot(
                deact_slot
            )
        return self.slot >= deact_slot + ALT_DEACT_COOLDOWN

    # ---- entry points ---------------------------------------------------

    def execute_txn(self, payload: bytes, desc: T.TxnDesc | None = None) -> TxnResult:
        desc = desc or T.parse(payload)
        if desc is None:
            return TxnResult(False, "parse")
        if desc.transaction_version != T.VLEGACY and not self.features.active(
            "versioned_tx_message_enabled", self.slot
        ):
            return TxnResult(False, "versioned transactions not enabled")
        keys = [
            bytes(desc.acct_addr(payload, j))
            for j in range(desc.acct_addr_cnt)
        ]
        if desc.addr_table_adtl_cnt > 0:
            # v0: resolve address-table lookups against on-chain ALT
            # accounts (message ordering: static keys, then all writable
            # lookups, then all readonly lookups)
            resolved = self._resolve_alts(payload, desc)
            if isinstance(resolved, str):
                return TxnResult(False, resolved)
            keys += resolved
        self.last_touched = keys
        fee = FEE_PER_SIGNATURE * desc.signature_cnt

        payer = self.mgr.load(keys[0])
        if payer is None or payer.lamports < fee:
            return TxnResult(False, "insufficient fee payer", fee=0)
        payer.lamports -= fee
        self.mgr.store(keys[0], payer)

        # execute instructions against a scratch overlay so a failed txn
        # rolls back its writes but keeps the fee debit
        overlay: dict[bytes, Account | None] = {}

        def load(k: bytes) -> Account | None:
            if k in overlay:
                a = overlay[k]
                return None if a is None else Account(**vars(a))
            return self.mgr.load(k)

        def store(k: bytes, a: Account) -> None:
            overlay[k] = a

        logs: list = []
        meter = [TXN_CU_BUDGET]
        txn_signers = frozenset(keys[: desc.signature_cnt])
        for ins in desc.instr:
            prog_key = keys[ins.program_id]
            data = payload[ins.data_off : ins.data_off + ins.data_sz]
            ins_idx = [payload[ins.acct_off + j] for j in range(ins.acct_cnt)]
            ins_keys = [keys[j] for j in ins_idx]
            ctx = InstrCtx(
                frozenset(k for k in ins_keys if k in txn_signers),
                frozenset(
                    k for j, k in zip(ins_idx, ins_keys)
                    if desc.is_writable(j)
                ),
                meter=meter,
                txn=(payload, desc),
            )
            err = self._dispatch(prog_key, data, ins_keys, ctx, load, store, logs)
            if err:
                return TxnResult(
                    False, err, fee=fee, logs=logs,
                    cu_used=TXN_CU_BUDGET - meter[0],
                )
        for k, a in overlay.items():
            if a is not None:
                self.mgr.store(k, a)
        return TxnResult(
            True, fee=fee, logs=logs, cu_used=TXN_CU_BUDGET - meter[0]
        )

    # ---- batched fast path ----------------------------------------------

    def execute_fast_transfers(
        self, payloads, fees, amounts, payer_offs, src_offs, dst_offs
    ) -> tuple[int, int, int]:
        """Execute a batch of scan-classified simple transfers (legacy
        txns whose only non-compute-budget instruction is one system
        transfer with a writable-signer source — fdt_txn_scan `fast`)
        against the funk lamports cache, skipping the per-txn overlay
        machinery.  Semantics are EXACTLY execute_txn's for this txn
        class (fee-then-execute, failed transfer keeps the fee,
        self-transfer no-op, dst account creation); any account that is
        not a trivial system account falls back to execute_txn.

        This is the reference's answer to bank throughput, re-shaped: it
        executes via a batched external engine rather than the tile's own
        interpreter loop (fd_bank.c:100-104 fd_ext_bank_load_and_execute
        _txns); here the "external engine" is the native scan + this
        allocation-free loop over the shared lamports cache.

        Returns (fees_collected, executed_cnt, failed_cnt)."""
        funk = self.funk
        # the lamports cache is coherent ONLY over the published root fork
        # (funk invalidates it on every root mutation; writes into in-prep
        # txns bypass that) — a forked executor runs uncached
        cache = funk.lam_cache if self.xid == ROOT_XID else {}
        rec_read = funk.rec_read
        rec_write = funk.rec_write
        xid = self.xid
        hdr_pack = _HDR.pack
        zero_check = self.features.active(
            "system_transfer_zero_check", self.slot
        )
        ABSENT, NONTRIVIAL = -1, -2

        def lam_of(key: bytes) -> int:
            v = cache.get(key)
            if v is not None:
                return v
            # one classification rule for every fast path (the native
            # table's resolve uses the same helper)
            st, lam = classify_record(rec_read(xid, key))
            if st == BankTable.ST_ABSENT:
                return ABSENT
            if st == BankTable.ST_NONTRIVIAL:
                return NONTRIVIAL
            cache[key] = lam
            return lam

        def put(key: bytes, lam: int) -> None:
            rec_write(xid, key, hdr_pack(lam, SYSTEM_PROGRAM_ID, 0, 0))
            cache[key] = lam

        fees_total = 0
        executed = 0
        failed = 0
        for t in range(len(payloads)):
            p = payloads[t]
            po, so, do = payer_offs[t], src_offs[t], dst_offs[t]
            payer = p[po : po + 32]
            fee = fees[t]
            amt = amounts[t]
            pl = lam_of(payer)
            if pl == NONTRIVIAL:
                r = self.execute_txn(p)
                if xid != ROOT_XID:
                    # funk only invalidates its root lam_cache on
                    # writes; the fork-local dict must drop whatever
                    # the general executor just rewrote
                    cache.clear()
                fees_total += r.fee
                executed += 1
                failed += not r.ok
                continue
            if pl < fee:  # ABSENT or underfunded: txn rejected, no fee
                failed += 1
                executed += 1
                continue
            executed += 1
            fees_total += fee
            # per-txn mini-overlay: duplicate keys (dst aliasing the
            # payer, etc.) must observe earlier writes exactly like the
            # slow path's sequential load/store sequence
            vals: dict = {payer: pl - fee}
            src = payer if so == po else p[so : so + 32]
            sl = vals.get(src)
            if sl is None:
                sl = lam_of(src)
            if sl == NONTRIVIAL:
                # fall back BEFORE committing (execute_txn redoes the fee)
                fees_total -= fee
                r = self.execute_txn(p)
                if xid != ROOT_XID:
                    cache.clear()  # see the payer-fallback note above
                fees_total += r.fee
                failed += not r.ok
                continue
            if sl == ABSENT:
                # missing source: pre-feature a 0-lamport transfer is a
                # silent no-op; post-feature it is "insufficient funds"
                if not (amt == 0 and not zero_check):
                    failed += 1
                put(payer, pl - fee)  # fee kept, transfer rolled back
                continue
            if sl < amt:
                failed += 1
                put(payer, pl - fee)
                continue
            dst = p[do : do + 32]
            if src == dst:
                put(payer, pl - fee)  # self-transfer no-op; fee applies
                continue
            vals[src] = sl - amt
            dl = vals.get(dst)
            if dl is None:
                dl = lam_of(dst)
            if dl == NONTRIVIAL:
                # dst holds data/another owner: credit the full record
                # via the account manager, commit the rest as trivials
                a = self.mgr.load(dst)
                a.lamports += amt
                for k, v in vals.items():
                    put(k, v)
                self.mgr.store(dst, a)
                continue
            if dl == ABSENT:
                dl = 0
            vals[dst] = dl + amt
            for k, v in vals.items():
                put(k, v)
        return fees_total, executed, failed

    # ---- native batched fast path (fdt_bank) ----------------------------

    def execute_fast_transfers_native(
        self, table, rows, szs, idx, scan, tag: int = 0, start: int = 0
    ) -> tuple[int, int, int]:
        """Execute the scan-classified fast-transfer subset `idx` of
        `rows` through the native shared-memory executor
        (tango/native/fdt_bank.c fdt_bank_exec): one GIL-released C call
        applies the whole run, stopping only at a txn the table cannot
        represent.  Stops are handled here IN ORDER — a cache MISS
        batch-resolves every remaining key from funk and retries; a
        NONTRIVIAL account runs that one txn through the general
        executor (with table<->funk coherence, execute_txn_with_table)
        and the batch resumes after it — so the observable semantics
        stay exactly execute_fast_transfers', which is pinned to
        execute_txn by tests/test_bank_fast.py + test_bank_native.py.

        `tag` names the microblock (the carrying frag's seq) for the
        crash-resume journal; `start` skips txns a previous incarnation
        already applied.  Returns (fees_collected, executed, failed);
        table mutations stay pending for BankTable.commit()."""
        import numpy as np

        lib = table.lib
        n = len(idx)
        if start >= n:
            return 0, 0, 0
        idx64 = np.ascontiguousarray(idx, np.int64)
        status = np.zeros(n, np.uint8)
        ofees = np.zeros(n, np.uint64)
        zero_check = int(
            self.features.active("system_transfer_zero_check", self.slot)
        )
        fees = executed = failed = 0
        t = int(start)
        resolved = False
        self.last_fallbacks = 0
        while t < n:
            done = lib.fdt_bank_exec(
                rows.ctypes.data, rows.shape[1], idx64.ctypes.data, t, n,
                scan.payer_off.ctypes.data, scan.src_off.ctypes.data,
                scan.dst_off.ctypes.data, scan.fee.ctypes.data,
                scan.lamports.ctypes.data, table.mem.ctypes.data,
                table.journal.ctypes.data, tag, zero_check,
                status.ctypes.data, ofees.ctypes.data,
            )
            if done > t:
                executed += done - t
                failed += int(np.count_nonzero(status[t:done]))
                fees += int(ofees[t:done].sum())
                t = done
            if t >= n:
                break
            st = int(status[t])
            if st == BankTable.MISS and not resolved:
                # cold keys: resolve the whole remaining subset from
                # funk in ONE pass — a later MISS can then only mean the
                # table is full, which falls back below (re-resolving
                # per stop would make a full table O(n^2))
                resolved = True
                self._bank_resolve(table, rows, idx64[t:], scan)
                continue
            # NONTRIVIAL account (or a miss the table could not absorb,
            # e.g. full): the general executor runs this one txn in
            # sequence, then the native batch resumes after it
            i = int(idx64[t])
            r = self.execute_txn_with_table(
                table, rows[i, : szs[i]].tobytes()
            )
            fees += r.fee
            executed += 1
            failed += not r.ok
            self.last_fallbacks += 1
            t += 1
            table.mark_done(tag, t)
        return fees, executed, failed

    def _bank_resolve(self, table, rows, sub_idx, scan) -> None:
        """Classify every uncached payer/src/dst key of the remaining
        subset txns from funk into the table (TRIVIAL lamports,
        NONTRIVIAL marker, or known-ABSENT).  A full table is tolerated:
        the executor stops again and the txn falls back."""
        for t in sub_idx:
            t = int(t)
            for off in (
                int(scan.payer_off[t]), int(scan.src_off[t]),
                int(scan.dst_off[t]),
            ):
                key = rows[t, off : off + 32].tobytes()
                if table.get(key)[0] == BankTable.ST_EMPTY:
                    table.resolve(self.funk, self.xid, key)

    def execute_txn_with_table(self, table, payload: bytes) -> TxnResult:
        """General-executor escape hatch for a txn scheduled into the
        native path: flush the txn's table-held accounts into funk first
        (the table is authoritative for TRIVIAL entries and funk may lag
        a commit), run execute_txn, then resync every touched key back
        into the table (update-only: keys the table never cached stay
        uncached).  Pack's account locks are still held by this
        microblock, so no other bank can race the flush/resync."""
        desc = T.parse(payload)
        if desc is not None:
            keys = [
                bytes(desc.acct_addr(payload, j))
                for j in range(desc.acct_addr_cnt)
            ]
            if desc.addr_table_adtl_cnt > 0:
                # ALT-resolved keys can be trivial table-held accounts
                # too: flushing only the static keys would let the
                # general executor read a stale funk balance (and the
                # resync below would then clobber the table with it)
                resolved = self._resolve_alts(payload, desc)
                if not isinstance(resolved, str):
                    keys += resolved
            for k in keys:
                st, lam = table.get(k)
                if st == BankTable.ST_TRIVIAL:
                    self.funk.rec_write(
                        self.xid, k, _HDR.pack(lam, SYSTEM_PROGRAM_ID, 0, 0)
                    )
                    if self.xid == ROOT_XID:
                        self.funk.lam_cache[k] = lam
                elif st == BankTable.ST_ABSENT:
                    self.funk.rec_remove(self.xid, k)
        self.last_touched = []
        r = self.execute_txn(payload, desc)
        for k in self.last_touched:
            st, _ = table.get(k)
            if st not in (BankTable.ST_EMPTY, BankTable.ST_BUSY):
                table.resolve(self.funk, self.xid, k)
        return r

    # ---- dispatch -------------------------------------------------------

    def _dispatch(self, prog_key, data, ins_keys, ctx: InstrCtx, load, store,
                  logs) -> str:
        if ctx.depth >= MAX_INVOKE_STACK:
            return "max invoke stack depth"
        ctx = InstrCtx(
            ctx.signers, ctx.writables, ctx.stack + (prog_key,),
            ctx.meter, ctx.txn,
        )
        if prog_key == SYSTEM_PROGRAM_ID:
            return self._system(data, ins_keys, ctx, load, store)
        if prog_key == ALT_PROGRAM_ID:
            return self._alt_program(data, ins_keys, ctx, load, store)
        if prog_key == CONFIG_PROGRAM_ID:
            return self._config_program(data, ins_keys, ctx, load, store)
        if prog_key == ED25519_PROGRAM_ID:
            if not self.features.active("ed25519_program_enabled", self.slot):
                return "unknown program"
            return self._ed25519_program(data, ctx)
        if prog_key == SECP256K1_PROGRAM_ID:
            if not self.features.active(
                "secp256k1_program_enabled", self.slot
            ):
                return "unknown program"
            return self._secp256k1_program(data, ctx)
        if prog_key == LOADER_V4_ID:
            return self._loader_v4(data, ins_keys, ctx, load, store)
        prog = load(prog_key)
        if prog is not None and prog.owner == BPF_LOADER_ID and prog.executable:
            return self._bpf(
                prog, prog_key, data, ins_keys, ctx, load, store, logs
            )
        if prog is not None and prog.owner == LOADER_V4_ID:
            # a loader-v4 program account: ELF bytes follow the 48-byte
            # state header; only DEPLOYED programs execute
            st = _v4_state(prog.data)
            if st is None or st[2] == _V4_RETRACTED:
                return "program not deployed"
            return self._bpf(
                prog, prog_key, data, ins_keys, ctx, load, store, logs,
                elf=bytes(prog.data[LOADER_V4_STATE_SZ:]),
            )
        return "unknown program"


    def _alt_program(self, data, ins_keys, ctx: InstrCtx, load, store) -> str:
        """Address-lookup-table native program: create / freeze / extend /
        deactivate (fd_address_lookup_table_program.c behavior, simplified:
        no PDA derivation check — the table address is the account given)."""
        if len(data) < 4:
            return "alt: bad instruction"
        disc = int.from_bytes(data[:4], "little")
        if disc == _ALT_CREATE:
            if len(ins_keys) < 2:
                return "alt: bad create"
            table_k, auth_k = ins_keys[0], ins_keys[1]
            if auth_k not in ctx.signers:
                return "alt: missing authority signature"
            if table_k not in ctx.writables:
                return "alt: table not writable"
            if load(table_k) is not None:
                return "alt: account exists"
            hdr = _ALT_HDR.pack(
                _ALT_DISC_TABLE, ALT_DEACT_NONE, 0, 0, 1, auth_k, 0
            )
            # lamport conservation: the table starts unfunded; rent is the
            # caller's business (system-transfer to it), never minted here
            store(table_k, Account(0, ALT_PROGRAM_ID, False, 0, hdr))
            return ""
        # remaining instructions operate on an existing live table with
        # the authority as the second account
        if len(ins_keys) < 2:
            return "alt: bad instruction accounts"
        table_k, auth_k = ins_keys[0], ins_keys[1]
        if table_k not in ctx.writables:
            return "alt: table not writable"
        acct = load(table_k)
        if acct is None or acct.owner != ALT_PROGRAM_ID:
            return "alt: no table"
        disc0, deact, last_slot, last_idx, has_auth, auth, _pad = (
            _ALT_HDR.unpack_from(acct.data)
        )
        if disc0 != _ALT_DISC_TABLE:
            return "alt: malformed table"
        if not has_auth:
            return "alt: frozen"
        if auth != auth_k or auth_k not in ctx.signers:
            return "alt: bad authority"
        if disc == _ALT_FREEZE:
            if deact != ALT_DEACT_NONE:
                return "alt: deactivated tables cannot be frozen"
            acct.data = (
                _ALT_HDR.pack(
                    _ALT_DISC_TABLE, deact, last_slot, last_idx, 0,
                    bytes(32), 0,
                )
                + acct.data[ALT_HEADER_SZ:]
            )
            store(table_k, acct)
            return ""
        if disc == _ALT_EXTEND:
            if deact != ALT_DEACT_NONE:
                return "alt: deactivated"
            if len(data) < 12:
                return "alt: bad extend"
            n = int.from_bytes(data[4:12], "little")
            if n == 0:
                return "alt: empty extend"
            if len(data) < 12 + 32 * n:
                return "alt: bad extend"
            existing = (len(acct.data) - ALT_HEADER_SZ) // 32
            if existing + n > 256:
                return "alt: table full"
            new_addrs = data[12 : 12 + 32 * n]
            acct.data = (
                _ALT_HDR.pack(
                    _ALT_DISC_TABLE, deact, self.slot, existing, 1, auth, 0
                )
                + acct.data[ALT_HEADER_SZ:]
                + new_addrs
            )
            store(table_k, acct)
            return ""
        if disc == _ALT_DEACTIVATE:
            if deact != ALT_DEACT_NONE:
                return "alt: already deactivated"
            acct.data = (
                _ALT_HDR.pack(
                    _ALT_DISC_TABLE, self.slot, last_slot, last_idx, 1,
                    auth, 0,
                )
                + acct.data[ALT_HEADER_SZ:]
            )
            store(table_k, acct)
            return ""
        return "alt: unsupported instruction"

    def _config_program(self, data, ins_keys, ctx: InstrCtx, load,
                        store) -> str:
        """Config native program (reference fd_config_program.c /
        config_processor.rs): instruction data = short_vec ConfigKeys
        (pubkey, is_signer u8) followed by opaque config payload, stored
        into the config account (no realloc).  Every listed signer key
        must have signed; previously stored signer keys must re-sign
        every update (simplified: the deserialize-and-compare core,
        without the account-data-as-current-signers edge cases)."""
        if len(ins_keys) < 1:
            return "config: missing account"
        cfg_k = ins_keys[0]
        acct = load(cfg_k)
        if acct is None or acct.owner != CONFIG_PROGRAM_ID:
            return "config: bad account owner"
        if cfg_k not in ctx.writables:
            return "config: account not writable"

        def parse_keys(buf):
            if not buf:
                return None
            n, off = buf[0], 1  # short_vec length (single-byte for <128)
            if n & 0x80:
                return None  # >127 keys unsupported (reference caps too)
            out = []
            for _ in range(n):
                if off + 33 > len(buf):
                    return None
                out.append((buf[off:off + 32], buf[off + 32] != 0))
                off += 33
            return out

        new_keys = parse_keys(data)
        if new_keys is None:
            return "config: bad instruction data"
        stored_keys = parse_keys(acct.data) or []
        cfg_signed = cfg_k in ctx.signers
        for pk, is_signer in new_keys:
            if not is_signer:
                continue
            if pk == cfg_k:
                if not cfg_signed:
                    return "config: config account must sign"
            elif pk not in ctx.signers:
                return "config: missing signer " + pk.hex()[:8]
        # stored signers must approve every update (the config account
        # satisfies its own entry only by actually signing)
        for pk, was_signer in stored_keys:
            if not was_signer:
                continue
            if pk == cfg_k:
                if not cfg_signed:
                    return "config: config account must sign"
            elif pk not in ctx.signers:
                return "config: stored signer did not sign"
        if not stored_keys and not cfg_signed:
            return "config: config account must sign"
        if len(data) > len(acct.data):
            return "config: instruction data too large"
        acct.data = bytes(data) + acct.data[len(data):]
        store(cfg_k, acct)
        return ""

    def _ed25519_program(self, data, ctx: InstrCtx) -> str:
        """Ed25519 precompile (reference fd_ed25519_program.c): the
        instruction data carries u8 count + 14-byte offset records
        pointing at sig/pubkey/msg bytes inside this or any other
        instruction's data (0xFFFF = this instruction); every referenced
        signature must verify or the whole txn fails."""
        from ..ops.ed25519 import golden

        if len(data) < 2:
            return "ed25519: bad instruction data"
        count = data[0]

        def instr_data(idx: int):
            if idx == 0xFFFF:
                return data
            if ctx.txn is None:
                return None
            payload, desc = ctx.txn
            if idx >= desc.instr_cnt:
                return None
            ins = desc.instr[idx]
            return payload[ins.data_off : ins.data_off + ins.data_sz]

        off = 2
        for _ in range(count):
            if off + 14 > len(data):
                return "ed25519: bad offsets"
            (sig_off, sig_ix, pk_off, pk_ix, msg_off, msg_sz, msg_ix
             ) = struct.unpack_from("<7H", data, off)
            off += 14
            parts = []
            for d_ix, d_off, d_sz in (
                (sig_ix, sig_off, 64), (pk_ix, pk_off, 32),
                (msg_ix, msg_off, msg_sz),
            ):
                src = instr_data(d_ix)
                if src is None or d_off + d_sz > len(src):
                    return "ed25519: data offsets out of range"
                parts.append(bytes(src[d_off : d_off + d_sz]))
            sig, pk, msg = parts
            if golden.verify(msg, sig, pk) != 0:
                return "ed25519: invalid signature"
        return ""

    def _v4_check_program(self, ins_keys, ctx: InstrCtx, load):
        """check_program_account (fd_bpf_loader_v4_program.c:43-104):
        -> (account, state, authority_key) or an error string."""
        if len(ins_keys) < 2:
            return "v4: not enough accounts"
        prog_k, auth_k = ins_keys[0], ins_keys[1]
        acct = load(prog_k)
        if acct is None or acct.owner != LOADER_V4_ID:
            return "v4: program not owned by loader"
        if len(acct.data) == 0:
            return "v4: program is uninitialized"
        st = _v4_state(acct.data)
        if st is None:
            return "v4: account data too small"
        if prog_k not in ctx.writables:
            return "v4: program account not writable"
        if auth_k not in ctx.signers:
            return "v4: authority did not sign"
        if st[1] != auth_k:
            return "v4: incorrect authority"
        if st[2] == _V4_FINALIZED:
            return "v4: program is finalized"
        return acct, st, auth_k

    def _loader_v4(self, data, ins_keys, ctx: InstrCtx, load, store) -> str:
        """BPF loader v4 meta-instructions: write / truncate / deploy /
        retract / transfer_authority (behavior contract:
        fd_bpf_loader_v4_program.c — write :166-232, truncate :234-264,
        deploy :366-560, retract :560-620, transfer_authority :623-680).
        Program bytes live after the 48-byte state header; deployment
        cooldown and status machine match the reference."""
        if len(data) < 4:
            return "v4: bad instruction"
        disc = int.from_bytes(data[:4], "little")

        if disc == _V4_WRITE:
            if len(data) < 16:
                return "v4: bad write"
            offset = int.from_bytes(data[4:8], "little")
            n = int.from_bytes(data[8:16], "little")
            if len(data) < 16 + n:
                return "v4: bad write"
            chk = self._v4_check_program(ins_keys, ctx, load)
            if isinstance(chk, str):
                return chk
            acct, st, _ = chk
            if st[2] != _V4_RETRACTED:
                return "v4: program is not retracted"
            body_sz = len(acct.data) - LOADER_V4_STATE_SZ
            if offset + n > body_sz:
                return "v4: write out of bounds"
            off = LOADER_V4_STATE_SZ + offset
            acct.data = (
                acct.data[:off] + bytes(data[16 : 16 + n])
                + acct.data[off + n :]
            )
            store(ins_keys[0], acct)
            return ""

        if disc == _V4_TRUNCATE:
            if len(data) < 8 or len(ins_keys) < 2:
                return "v4: bad truncate"
            new_sz = int.from_bytes(data[4:8], "little")
            prog_k, auth_k = ins_keys[0], ins_keys[1]
            acct = load(prog_k)
            if acct is None:
                return "v4: no program account"
            is_init = new_sz > 0 and len(acct.data) < LOADER_V4_STATE_SZ
            if is_init:
                if acct.owner != LOADER_V4_ID:
                    return "v4: program not owned by loader"
                if prog_k not in ctx.writables:
                    return "v4: program account not writable"
                if prog_k not in ctx.signers:
                    return "v4: program did not sign"
                if auth_k not in ctx.signers:
                    return "v4: authority did not sign"
            else:
                chk = self._v4_check_program(ins_keys, ctx, load)
                if isinstance(chk, str):
                    return chk
                acct, st, _ = chk
                if st[2] != _V4_RETRACTED:
                    return "v4: program is not retracted"
            required = (
                0 if new_sz == 0
                else rent_exempt_minimum(LOADER_V4_STATE_SZ + new_sz)
            )
            if acct.lamports < required:
                return "v4: insufficient lamports"
            if acct.lamports > required:
                # excess goes to the recipient account (index 2)
                if len(ins_keys) < 3:
                    return "v4: recipient missing"
                rcpt_k = ins_keys[2]
                if rcpt_k not in ctx.writables:
                    return "v4: recipient not writable"
                excess = acct.lamports - required
                rcpt = load(rcpt_k) or Account(0)
                acct.lamports -= excess
                rcpt.lamports += excess
                store(rcpt_k, rcpt)
            raw_new = (
                0 if new_sz == 0 else LOADER_V4_STATE_SZ + new_sz
            )
            if raw_new > MAX_DATA_LEN:
                return "v4: program too large"
            if raw_new > len(acct.data):
                acct.data = acct.data + bytes(raw_new - len(acct.data))
            else:
                acct.data = acct.data[:raw_new]
            if new_sz and is_init:
                acct.data = (
                    _v4_state_encode(0, auth_k, _V4_RETRACTED)
                    + acct.data[LOADER_V4_STATE_SZ:]
                )
            store(prog_k, acct)
            return ""

        if disc == _V4_DEPLOY:
            chk = self._v4_check_program(ins_keys, ctx, load)
            if isinstance(chk, str):
                return chk
            acct, st, auth_k = chk
            if st[0] + V4_DEPLOYMENT_COOLDOWN > self.slot:
                return "v4: deployment cooldown in effect"
            if st[2] != _V4_RETRACTED:
                return "v4: program is not retracted"
            source_k = ins_keys[2] if len(ins_keys) >= 3 else None
            if source_k is not None:
                src_chk = self._v4_check_program(
                    [source_k, auth_k], ctx, load
                )
                if isinstance(src_chk, str):
                    return src_chk
                src, src_st, _ = src_chk
                if src_st[2] != _V4_RETRACTED:
                    return "v4: source program is not retracted"
                # move the source's data region + top up rent
                transfer = max(
                    0, rent_exempt_minimum(len(src.data)) - acct.lamports
                )
                acct.data = bytes(src.data)
                src.data = b""
                src.lamports -= transfer
                acct.lamports += transfer
                store(source_k, src)
            if len(acct.data) < LOADER_V4_STATE_SZ:
                return "v4: account data too small"
            acct.data = (
                _v4_state_encode(self.slot, st[1], _V4_DEPLOYED)
                + acct.data[LOADER_V4_STATE_SZ:]
            )
            acct.executable = True
            store(ins_keys[0], acct)
            return ""

        if disc == _V4_RETRACT:
            chk = self._v4_check_program(ins_keys, ctx, load)
            if isinstance(chk, str):
                return chk
            acct, st, _ = chk
            if st[0] + V4_DEPLOYMENT_COOLDOWN > self.slot:
                return "v4: deployment cooldown in effect"
            if st[2] == _V4_RETRACTED:
                return "v4: program is not deployed"
            acct.data = (
                _v4_state_encode(st[0], st[1], _V4_RETRACTED)
                + acct.data[LOADER_V4_STATE_SZ:]
            )
            store(ins_keys[0], acct)
            return ""

        if disc == _V4_XFER_AUTH:
            chk = self._v4_check_program(ins_keys, ctx, load)
            if isinstance(chk, str):
                return chk
            acct, st, _ = chk
            new_auth = ins_keys[2] if len(ins_keys) >= 3 else None
            if new_auth is not None:
                if new_auth not in ctx.signers:
                    return "v4: new authority did not sign"
                acct.data = (
                    _v4_state_encode(st[0], new_auth, st[2])
                    + acct.data[LOADER_V4_STATE_SZ:]
                )
            elif st[2] == _V4_DEPLOYED:
                acct.data = (
                    _v4_state_encode(st[0], st[1], _V4_FINALIZED)
                    + acct.data[LOADER_V4_STATE_SZ:]
                )
            else:
                return "v4: program must be deployed to be finalized"
            store(ins_keys[0], acct)
            return ""
        return "v4: unsupported instruction"

    def _secp256k1_program(self, data, ctx: InstrCtx) -> str:
        """Keccak-secp256k1 precompile (the ed25519 precompile's sibling;
        behavior contract: Solana's secp256k1_program, account-less):
        data = u8 count, then count 11-byte offset records
        {sig_off u16, sig_ix u8, eth_addr_off u16, eth_addr_ix u8,
        msg_off u16, msg_sz u16, msg_ix u8}.  The signature field is 65
        bytes (r||s||recovery_id); verification recovers the pubkey from
        keccak256(msg) and compares keccak256(pubkey)[12:] against the
        20-byte eth address."""
        from ..ballet import secp256k1 as K1
        from ..ops.keccak256 import digest_host

        if len(data) < 1:
            return "secp256k1: bad instruction data"
        count = data[0]

        def instr_data(idx: int):
            if idx == 0xFF:
                return data
            if ctx.txn is None:
                return None
            payload, desc = ctx.txn
            if idx >= desc.instr_cnt:
                return None
            ins = desc.instr[idx]
            return payload[ins.data_off : ins.data_off + ins.data_sz]

        off = 1
        for _ in range(count):
            if off + 11 > len(data):
                return "secp256k1: bad offsets"
            sig_off, sig_ix = struct.unpack_from("<HB", data, off)
            ea_off, ea_ix = struct.unpack_from("<HB", data, off + 3)
            msg_off, msg_sz, msg_ix = struct.unpack_from(
                "<HHB", data, off + 6
            )
            off += 11
            parts = []
            for d_ix, d_off, d_sz in (
                (sig_ix, sig_off, 65), (ea_ix, ea_off, 20),
                (msg_ix, msg_off, msg_sz),
            ):
                src = instr_data(d_ix)
                if src is None or d_off + d_sz > len(src):
                    return "secp256k1: data offsets out of range"
                parts.append(bytes(src[d_off : d_off + d_sz]))
            sig65, eth_addr, msg = parts
            pub = K1.recover(digest_host(msg), sig65[:64], sig65[64])
            if pub is None or K1.eth_address(pub) != eth_addr:
                return "secp256k1: invalid signature"
        return ""

    def _system(self, data, ins_keys, ctx: InstrCtx, load, store) -> str:
        if len(data) < 4:
            return "bad system instruction"
        disc = int.from_bytes(data[:4], "little")
        if disc == _SYS_TRANSFER:
            if len(ins_keys) < 2 or len(data) < 12:
                return "bad transfer"
            lamports = int.from_bytes(data[4:12], "little")
            src_k, dst_k = ins_keys[0], ins_keys[1]
            if src_k not in ctx.signers:
                return "missing signature"
            if src_k not in ctx.writables or dst_k not in ctx.writables:
                return "account not writable"
            src = load(src_k)
            if src is None and lamports == 0 and not self.features.active(
                "system_transfer_zero_check", self.slot
            ):
                return ""  # pre-feature: 0-lamport from missing src is ok
            if src is None or src.lamports < lamports:
                return "insufficient funds"
            if src_k == dst_k:
                return ""  # self-transfer is a no-op (never mints)
            dst = load(dst_k) or Account(0)
            src.lamports -= lamports
            dst.lamports += lamports
            store(src_k, src)
            store(dst_k, dst)
            return ""
        if disc == _SYS_CREATE:
            if len(ins_keys) < 2 or len(data) < 52:
                return "bad create_account"
            lamports = int.from_bytes(data[4:12], "little")
            space = int.from_bytes(data[12:20], "little")
            if space > MAX_DATA_LEN:
                return "data length exceeds maximum"
            owner = data[20:52]
            src_k, new_k = ins_keys[0], ins_keys[1]
            if src_k not in ctx.signers or new_k not in ctx.signers:
                return "missing signature"
            if src_k not in ctx.writables or new_k not in ctx.writables:
                return "account not writable"
            if lamports < rent_exempt_minimum(space):
                return "rent: not exempt"
            src = load(src_k)
            if src is None or src.lamports < lamports:
                return "insufficient funds"
            if load(new_k) is not None:
                return "account exists"
            src.lamports -= lamports
            store(src_k, src)
            store(new_k, Account(lamports, owner, False, 0, bytes(space)))
            return ""
        if disc == _SYS_ASSIGN:
            if len(ins_keys) < 1 or len(data) < 36:
                return "bad assign"
            k = ins_keys[0]
            if k not in ctx.signers:
                return "missing signature"
            if k not in ctx.writables:
                return "account not writable"
            a = load(k)
            if a is None:
                return "no account"
            a.owner = data[4:36]
            store(k, a)
            return ""
        if disc in (
            _SYS_ADVANCE_NONCE, _SYS_WITHDRAW_NONCE, _SYS_INIT_NONCE,
            _SYS_AUTHORIZE_NONCE,
        ):
            return self._system_nonce(disc, data, ins_keys, ctx, load, store)
        if disc == _SYS_ALLOCATE:
            if len(ins_keys) < 1 or len(data) < 12:
                return "bad allocate"
            space = int.from_bytes(data[4:12], "little")
            if space > MAX_DATA_LEN:
                return "data length exceeds maximum"
            k = ins_keys[0]
            if k not in ctx.signers:
                return "missing signature"
            if k not in ctx.writables:
                return "account not writable"
            a = load(k)
            if a is None:
                return "no account"
            if a.lamports < rent_exempt_minimum(space):
                return "rent: not exempt"
            a.data = bytes(space)
            store(k, a)
            return ""
        return "unsupported system instruction"

    def _system_nonce(self, disc, data, ins_keys, ctx: InstrCtx, load,
                      store) -> str:
        """Durable-nonce system instructions (behavior contract:
        fd_system_program_nonce.c — advance :121-230, withdraw :277-470,
        initialize :495-600, authorize :700-790; account orders match
        system_processor.rs).

        The "recent blockhashes" the reference reads through the sysvar
        is this executor's recent_blockhash (set by begin_slot from the
        bank's PoH state)."""
        next_durable = durable_nonce_from_blockhash(self.recent_blockhash)
        nonce_k = ins_keys[0] if ins_keys else None
        if nonce_k is None:
            return "nonce: missing account"
        if nonce_k not in ctx.writables:
            return "nonce: account not writable"
        acct = load(nonce_k)
        if acct is None or acct.owner != SYSTEM_PROGRAM_ID:
            return "nonce: bad account"
        st = _nonce_decode(acct.data)
        if st is None:
            return "nonce: invalid account data"
        state, authority, durable, _fee = st

        if disc == _SYS_ADVANCE_NONCE:
            # accounts: [nonce, recent_blockhashes sysvar, authority]
            if len(ins_keys) < 3:
                return "nonce: not enough accounts"
            if state != _NONCE_INITIALIZED:
                return "nonce: uninitialized"
            if authority not in ctx.signers:
                return "nonce: missing authority signature"
            if durable == next_durable:
                return "nonce: can only advance once per slot"
            acct.data = _nonce_encode(
                _NONCE_INITIALIZED, authority, next_durable,
                self.lamports_per_signature,
            )
            store(nonce_k, acct)
            return ""

        if disc == _SYS_WITHDRAW_NONCE:
            # accounts: [nonce, to, recent_blockhashes, rent, authority]
            if len(ins_keys) < 5 or len(data) < 12:
                return "nonce: bad withdraw"
            lamports = int.from_bytes(data[4:12], "little")
            to_k = ins_keys[1]
            if to_k not in ctx.writables:
                return "nonce: destination not writable"
            if state == _NONCE_UNINITIALIZED:
                if lamports > acct.lamports:
                    return "insufficient funds"
                signer = nonce_k
            else:
                if lamports == acct.lamports:
                    # full withdrawal is allowed only once the stored
                    # durable nonce EXPIRED (differs from the current
                    # slot's value): closing a nonce whose stored value
                    # still equals the live durable nonce would let the
                    # protected transaction be replayed (Agave
                    # NonceBlockhashNotExpired; the reference snapshot's
                    # inverted 0 != memcmp at
                    # fd_system_program_nonce.c:366 contradicts the
                    # Agave lines it cites and is not followed here)
                    if durable == next_durable:
                        return "nonce: blockhash not expired"
                    acct.data = _nonce_encode(_NONCE_UNINITIALIZED)
                else:
                    if lamports + rent_exempt_minimum(
                        len(acct.data)
                    ) > acct.lamports:
                        return "insufficient funds"
                signer = authority
            if signer not in ctx.signers:
                return "nonce: missing authority signature"
            if nonce_k == to_k:
                # Agave fails this with an account-borrow error (source
                # and destination cannot be borrowed simultaneously); a
                # silent no-op success would diverge on txn status
                return "nonce: source and destination are the same account"
            acct.lamports -= lamports
            store(nonce_k, acct)
            dst = load(to_k) or Account(0)
            dst.lamports += lamports
            store(to_k, dst)
            return ""

        if disc == _SYS_INIT_NONCE:
            # accounts: [nonce, recent_blockhashes, rent]; data: authority
            if len(ins_keys) < 3 or len(data) < 36:
                return "nonce: bad initialize"
            if state != _NONCE_UNINITIALIZED:
                return "nonce: already initialized"
            if acct.lamports < rent_exempt_minimum(len(acct.data)):
                return "insufficient funds"
            acct.data = _nonce_encode(
                _NONCE_INITIALIZED, bytes(data[4:36]), next_durable,
                self.lamports_per_signature,
            )
            store(nonce_k, acct)
            return ""

        # _SYS_AUTHORIZE_NONCE: accounts [nonce, authority]; data: new auth
        if len(data) < 36:
            return "nonce: bad authorize"
        if state != _NONCE_INITIALIZED:
            return "nonce: uninitialized"
        if authority not in ctx.signers:
            return "nonce: missing authority signature"
        acct.data = _nonce_encode(
            _NONCE_INITIALIZED, bytes(data[4:36]), durable,
            self.lamports_per_signature,
        )
        store(nonce_k, acct)
        return ""

    def _bpf(self, prog: Account, prog_key: bytes, data, ins_keys,
             ctx: InstrCtx, load, store, logs, elf: bytes | None = None
             ) -> str:
        """Execute an sBPF program with the instruction's accounts
        serialized into the VM input region in SOLANA'S aligned input
        layout (the reference implements the same region in
        fd_vm_context.c; layout from the Solana SDK's aligned
        serializer):

          u64 acct_cnt
          per account, first occurrence:
            u8  dup marker = 0xFF
            u8  is_signer | u8 is_writable | u8 executable
            u32 original_data_len
            pubkey[32] | owner[32] | u64 lamports | u64 data_len
            data | 10240 spare bytes (MAX_PERMITTED_DATA_INCREASE)
            pad to 8 | u64 rent_epoch
          per duplicate: u8 index-of-original + 7 pad bytes
          u64 ins_data_len | ins_data | program_id[32]

        Writable accounts commit back lamports, owner, and data — with
        REALLOC honored: the program may rewrite data_len up to
        original + 10240 (and under MAX_DATA_LEN); the spare region is
        what makes in-place growth addressable.

        CPI: sol_invoke_signed_c re-enters _dispatch with caller-granted
        privileges + PDA signers (reference: fd_vm_syscalls.c
        fd_vm_syscall_cpi_c); see _register_cpi for the marshalling."""
        from ..ballet import sbpf
        from ..flamenco.vm import Vm, VmError

        try:
            program = sbpf.load(elf if elf is not None else prog.data)
        except sbpf.SbpfError as e:
            return f"elf: {e}"
        vm = Vm(program, cu_limit=ctx.meter[0])

        buf = bytearray()
        buf += len(ins_keys).to_bytes(8, "little")
        offsets = []  # (key, writable, lam_off, len_off, data_off,
        #               orig_len, owner_off)
        seen: dict[bytes, int] = {}
        for idx, k in enumerate(ins_keys):
            if k in seen:
                buf += bytes([seen[k]]) + bytes(7)
                continue
            seen[k] = idx
            a = load(k) or Account(0)
            writable = k in ctx.writables
            buf += bytes([
                0xFF,
                1 if k in ctx.signers else 0,
                1 if writable else 0,
                1 if a.executable else 0,
            ])
            buf += len(a.data).to_bytes(4, "little")
            buf += k
            owner_off = len(buf)
            buf += a.owner
            lam_off = len(buf)
            buf += a.lamports.to_bytes(8, "little")
            len_off = len(buf)
            buf += len(a.data).to_bytes(8, "little")
            data_off = len(buf)
            buf += a.data
            buf += bytes(MAX_PERMITTED_DATA_INCREASE)
            buf += bytes((-len(a.data)) % 8)
            buf += int(a.rent_epoch).to_bytes(8, "little")
            offsets.append(
                (k, writable, lam_off, len_off, data_off, len(a.data),
                 owner_off)
            )
        buf += len(data).to_bytes(8, "little") + data
        buf += prog_key
        vm.input_mem = bytearray(buf)

        # lamport conservation baseline BEFORE execution: CPI commits into
        # the overlay mid-run, so the post-run overlay is not the baseline
        pre_sum = 0
        for k, *_ in offsets:
            pre_sum += (load(k) or Account(0)).lamports

        self._register_cpi(
            vm, prog_key, ins_keys, offsets, ctx, load, store, logs
        )

        try:
            r0 = vm.run()
        except VmError as e:
            logs.extend(vm.logs)
            ctx.meter[0] = max(vm.cu, 0)
            return f"vm: {e}"
        logs.extend(vm.logs)
        ctx.meter[0] = max(vm.cu, 0)
        if r0 != 0:
            return f"program error {r0}"
        # Lamport conservation (ref fd_instr_info sum check): the sum of
        # lamports across the instruction's unique accounts must not
        # change.  `offsets` holds one entry per unique account (dups
        # serialize as index references).
        post = {}  # key -> (lamports, data | None, owner | None)
        for k, writable, lam_off, len_off, data_off, orig_len, owner_off \
                in offsets:
            if writable:
                new_len = int.from_bytes(
                    vm.input_mem[len_off : len_off + 8], "little"
                )
                if (
                    new_len > orig_len + MAX_PERMITTED_DATA_INCREASE
                    or new_len > MAX_DATA_LEN
                ):
                    return "invalid account data realloc"
                new_owner = bytes(
                    vm.input_mem[owner_off : owner_off + 32]
                )
                cur = load(k) or Account(0)
                new_data = bytes(
                    vm.input_mem[data_off : data_off + new_len]
                )
                if new_owner != cur.owner:
                    # owner reassignment through the input region is
                    # legal only for the account's CURRENT owning
                    # program on a non-executable account (reference:
                    # fd_account_set_owner / Agave ModifiedProgramId)
                    if cur.owner != prog_key or cur.executable:
                        return "instruction illegally modified " \
                               "account owner"
                    # ... and only with all-zero account data
                    # (fd_account_is_zeroed): handing an account with
                    # live crafted bytes to a new owner would let that
                    # owner mistake attacker data for self-initialized
                    # state
                    if any(new_data):
                        return "instruction illegally modified " \
                               "account owner"
                post[k] = (
                    int.from_bytes(
                        vm.input_mem[lam_off : lam_off + 8], "little"
                    ),
                    new_data,
                    new_owner,
                )
            else:
                a = load(k) or Account(0)
                post[k] = (a.lamports, None, None)
        if sum(lam for lam, _, _ in post.values()) != pre_sum:
            return "instruction changed total lamports"
        for k, (lam, new_data, new_owner) in post.items():
            if new_data is None:
                continue
            a = load(k) or Account(0)
            a.lamports = lam
            a.data = new_data
            a.owner = new_owner
            store(k, a)
        return ""

    # ---- cross-program invocation ---------------------------------------

    def _register_cpi(self, vm, prog_key: bytes, ins_keys, offsets,
                      ctx: InstrCtx, load, store, logs) -> None:
        """Install the CPI + PDA syscalls on a VM instance.

        Marshalling follows the reference's C ABI (fd_vm_syscall_cpi_c):
          SolInstruction  { program_id *u64, accounts *u64, accounts_len,
                            data *u64, data_len }          (40 B)
          SolAccountMeta  { pubkey *u64, is_writable u8, is_signer u8 }
                                                           (16 B stride)
          SolSignerSeedsC { addr *u64, len u64 } of SolSignerSeedC pairs
        Account state flows through the runtime's own serialization table
        (`offsets`), which is this build's analog of the reference's
        account-info translation + copy-back."""
        from ..flamenco.vm import VmError

        def _sync_down():
            """Caller's input-region writes -> overlay (callee must see
            the caller's in-flight state, including in-place reallocs)."""
            for k, writable, lam_off, len_off, data_off, orig_len, \
                    owner_off in offsets:
                if not writable:
                    continue
                cur_len = int.from_bytes(
                    vm.input_mem[len_off : len_off + 8], "little"
                )
                if cur_len > orig_len + MAX_PERMITTED_DATA_INCREASE:
                    raise VmError("cpi: invalid account data realloc")
                a = load(k) or Account(0)
                new_owner = bytes(
                    vm.input_mem[owner_off : owner_off + 32]
                )
                new_data = bytes(
                    vm.input_mem[data_off : data_off + cur_len]
                )
                if new_owner != a.owner:
                    # same owner-reassignment rule as the commit path:
                    # current owner only, non-executable, and all-zero
                    # data (fd_account_is_zeroed)
                    if (
                        a.owner != prog_key
                        or a.executable
                        or any(new_data)
                    ):
                        raise VmError(
                            "cpi: instruction illegally modified "
                            "account owner"
                        )
                    a.owner = new_owner
                a.lamports = int.from_bytes(
                    vm.input_mem[lam_off : lam_off + 8], "little"
                )
                a.data = new_data
                store(k, a)

        def _sync_up():
            """Overlay -> caller's input region after the callee ran.
            A callee-side realloc copies back into the caller's spare
            region (reference: CPI copy-back honors resized accounts up
            to the serialized headroom)."""
            for k, writable, lam_off, len_off, data_off, orig_len, \
                    owner_off in offsets:
                if not writable:
                    continue
                a = load(k) or Account(0)
                if len(a.data) > orig_len + MAX_PERMITTED_DATA_INCREASE:
                    raise VmError(
                        "cpi: account grown beyond realloc headroom"
                    )
                vm.input_mem[lam_off : lam_off + 8] = a.lamports.to_bytes(
                    8, "little"
                )
                vm.input_mem[len_off : len_off + 8] = len(a.data).to_bytes(
                    8, "little"
                )
                vm.input_mem[data_off : data_off + len(a.data)] = a.data
                vm.input_mem[owner_off : owner_off + 32] = a.owner

        def _seed_array(addr, count):
            """Read a SolSignerSeedC[count] array -> list of seed bytes,
            or None on constraint violation."""
            if count > MAX_SEEDS:
                return None
            seeds = []
            for j in range(count):
                sa = vm.mem_read(addr + 16 * j, 8)
                sl = vm.mem_read(addr + 16 * j + 8, 8)
                if sl > MAX_SEED_LEN:
                    return None
                seeds.append(vm.mem_read_bytes(sa, sl))
            return seeds

        def _read_seeds(r4, r5):
            if r5 > MAX_SEEDS:
                raise VmError("cpi: too many signer seed sets")
            pdas = []
            for i in range(r5):
                seeds_addr = vm.mem_read(r4 + 16 * i, 8)
                n = vm.mem_read(r4 + 16 * i + 8, 8)
                seeds = _seed_array(seeds_addr, n)
                if seeds is None:
                    raise VmError("cpi: bad signer seeds")
                pda = create_program_address(seeds, prog_key)
                if pda is None:
                    raise VmError("cpi: invalid seeds (no PDA)")
                pdas.append(pda)
            return pdas

        caller_keys = set(ins_keys)

        def sol_invoke_signed_c(vm_, r1, r2, r3, r4, r5):
            vm.consume(CPI_BASE_CU)
            target = vm.mem_read_bytes(vm.mem_read(r1, 8), 32)
            metas_addr = vm.mem_read(r1 + 8, 8)
            metas_len = vm.mem_read(r1 + 16, 8)
            data_addr = vm.mem_read(r1 + 24, 8)
            data_len = vm.mem_read(r1 + 32, 8)
            if metas_len > 64:
                raise VmError("cpi: too many account metas")
            if data_len > 10 * 1024:
                raise VmError("cpi: instruction data too large")
            inner_data = vm.mem_read_bytes(data_addr, data_len)

            # the callee program account must be provided by the caller's
            # instruction context (reference: callee must appear in the
            # caller's account infos)
            if target not in caller_keys:
                raise VmError("cpi: program not in caller context")
            # re-entrancy: a program already on the stack may only be
            # re-entered by direct self-recursion, i.e. when it IS the
            # currently executing program (reference rule)
            if target != ctx.stack[-1] and target in ctx.stack:
                raise VmError("cpi: reentrancy violation")

            pdas = set(_read_seeds(r4, r5))
            inner_keys, inner_signers, inner_writables = [], set(), set()
            for i in range(metas_len):
                base = metas_addr + 16 * i
                k = vm.mem_read_bytes(vm.mem_read(base, 8), 32)
                w = vm.mem_read(base + 8, 1)
                s = vm.mem_read(base + 9, 1)
                if k not in caller_keys:
                    raise VmError("cpi: account not in caller context")
                inner_keys.append(k)
                if w:
                    if k not in ctx.writables:
                        raise VmError("cpi: writable privilege escalation")
                    inner_writables.add(k)
                if s:
                    if k not in ctx.signers and k not in pdas:
                        raise VmError("cpi: signer privilege escalation")
                    inner_signers.add(k)

            _sync_down()
            ctx.meter[0] = max(vm.cu, 0)
            err = self._dispatch(
                target, inner_data, inner_keys,
                ctx.child(inner_signers, inner_writables),
                load, store, logs,
            )
            vm.cu = ctx.meter[0]
            if err:
                raise VmError(f"cpi: {err}")
            _sync_up()
            return 0

        def sol_create_program_address(vm_, r1, r2, r3, r4, r5):
            # r1 = seeds (SolSignerSeedC array), r2 = count,
            # r3 = program id addr, r4 = result addr
            vm.consume(1500)
            seeds = _seed_array(r1, r2)
            if seeds is None:
                return 1
            pid = vm.mem_read_bytes(r3, 32)
            pda = create_program_address(seeds, pid)
            if pda is None:
                return 1
            vm.mem_write_bytes(r4, pda)
            return 0

        def sol_try_find_program_address(vm_, r1, r2, r3, r4, r5):
            # as above + r5 = bump seed out address.  CUs are charged per
            # derivation attempt (reference: create_program_address units
            # per bump iteration), which also bounds the host-side work.
            seeds = _seed_array(r1, r2)
            if seeds is None:
                vm.consume(1500)
                return 1
            pid = vm.mem_read_bytes(r3, 32)
            for bump in range(255, -1, -1):
                vm.consume(1500)
                pda = create_program_address(seeds + [bytes([bump])], pid)
                if pda is not None:
                    vm.mem_write_bytes(r4, pda)
                    vm.mem_write(r5, 1, bump)
                    return 0
            return 1

        vm.register_syscall(b"sol_invoke_signed_c", sol_invoke_signed_c)
        vm.register_syscall(
            b"sol_create_program_address", sol_create_program_address
        )
        vm.register_syscall(
            b"sol_try_find_program_address", sol_try_find_program_address
        )
