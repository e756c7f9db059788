"""Solana transaction wire-format parser and builder (host side).

A copy of firedancer_tpu/ballet/txn.py.

Behavior contract: fd_txn_parse
(reference: src/ballet/txn/fd_txn_parse.c, fd_txn.h, fd_compact_u16.h)
— re-implemented from the wire format spec with the same validation rules:

  * payload <= 1232 bytes (MTU)
  * 1 <= signature_cnt <= 127, stored identically as u8 and compact-u16
  * legacy (no version byte) and v0 (0x80-flagged version byte) messages
  * readonly_signed < signature_cnt (fee payer must be a writable signer)
  * signature_cnt <= acct_addr_cnt <= 128; sig_cnt + ro_unsigned <= acct cnt
  * <= 64 instructions, program_id index nonzero and in static-account range
  * v0 address-table lookups: >= 1 referenced account per table, totals
    bounded so static + looked-up accounts <= 128
  * every instruction account index < total referenced accounts
  * compact-u16 must be minimally encoded; trailing bytes rejected

The parser runs on the ingest host path (verify/dedup/pack tiles).  Batched
fixed-field extraction for the device (signature/pubkey/message slices) is in
`extract_sigverify_batch`, which the verify tile uses to build device batches.

This module is pure Python over bytes/numpy; per-txn parse runs on the
control path only (ingest tiles parse once, then every consumer reads the
trailer fields — tiles/wire.py — with vectorized gathers).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

MTU = 1232
SIGNATURE_SZ = 64
ACCT_ADDR_SZ = 32
BLOCKHASH_SZ = 32
SIG_MAX = 127
ACTUAL_SIG_MAX = 12
ACCT_ADDR_MAX = 128
ADDR_TABLE_LOOKUP_MAX = 127
INSTR_MAX = 64
MIN_SERIALIZED_SZ = 134

VLEGACY = 0xFF
V0 = 0x00


def cu16_decode(buf: bytes, i: int) -> Optional[Tuple[int, int]]:
    """Decode a compact-u16 at offset i -> (value, nbytes) or None.

    Minimal-encoding enforced (0x80 0x00 style paddings rejected), max 3
    bytes, value < 2^16.
    """
    n = len(buf)
    if i < n and not (buf[i] & 0x80):
        return buf[i], 1
    if i + 1 < n and not (buf[i + 1] & 0x80):
        if buf[i + 1] == 0:
            return None
        return (buf[i] & 0x7F) | (buf[i + 1] << 7), 2
    if i + 2 < n and not (buf[i + 2] & 0xFC):
        if buf[i + 2] == 0:
            return None
        return (buf[i] & 0x7F) | ((buf[i + 1] & 0x7F) << 7) | (buf[i + 2] << 14), 3
    return None


def cu16_encode(v: int) -> bytes:
    assert 0 <= v < 1 << 16
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([(v & 0x7F) | 0x80, v >> 7])
    return bytes([(v & 0x7F) | 0x80, ((v >> 7) & 0x7F) | 0x80, v >> 14])


@dataclass(frozen=True)
class Instr:
    program_id: int  # index into static account addrs
    acct_off: int
    acct_cnt: int
    data_off: int
    data_sz: int


@dataclass(frozen=True)
class AddrLut:
    addr_off: int  # offset of the 32-byte table address
    writable_off: int
    writable_cnt: int
    readonly_off: int
    readonly_cnt: int


@dataclass(frozen=True)
class TxnDesc:
    """Offset descriptor into the payload (fd_txn_t equivalent)."""

    transaction_version: int
    signature_cnt: int
    signature_off: int
    message_off: int
    readonly_signed_cnt: int
    readonly_unsigned_cnt: int
    acct_addr_cnt: int
    acct_addr_off: int
    recent_blockhash_off: int
    addr_table_lookup_cnt: int
    addr_table_adtl_writable_cnt: int
    addr_table_adtl_cnt: int
    instr_cnt: int
    instr: Tuple[Instr, ...] = ()
    address_tables: Tuple[AddrLut, ...] = ()
    #: serialized size of the parsed region (== len(payload) unless
    #: allow_trailing was set)
    sz: int = 0

    # -- account-category helpers (fd_txn_acct_iter equivalents) ----------

    @property
    def total_acct_cnt(self) -> int:
        return self.acct_addr_cnt + self.addr_table_adtl_cnt

    def signatures(self, payload: bytes) -> List[bytes]:
        o = self.signature_off
        return [
            payload[o + 64 * j : o + 64 * (j + 1)]
            for j in range(self.signature_cnt)
        ]

    def acct_addr(self, payload: bytes, j: int) -> bytes:
        o = self.acct_addr_off + 32 * j
        return payload[o : o + 32]

    def message(self, payload: bytes) -> bytes:
        return payload[self.message_off :]

    def recent_blockhash(self, payload: bytes) -> bytes:
        o = self.recent_blockhash_off
        return payload[o : o + 32]

    def is_writable(self, j: int) -> bool:
        """Writability of combined account index j: signer section, static
        unsigned section, then ALT lookups (writable section first)."""
        if j < self.signature_cnt:
            return j < self.signature_cnt - self.readonly_signed_cnt
        if j < self.acct_addr_cnt:
            return j < self.acct_addr_cnt - self.readonly_unsigned_cnt
        return j < self.acct_addr_cnt + self.addr_table_adtl_writable_cnt

    def writable_idxs(self) -> List[int]:
        return [j for j in range(self.acct_addr_cnt) if self.is_writable(j)]

    def readonly_idxs(self) -> List[int]:
        return [j for j in range(self.acct_addr_cnt) if not self.is_writable(j)]


def parse(payload: bytes, allow_zero_signatures: bool = False,
          allow_trailing: bool = False) -> Optional[TxnDesc]:
    """Parse + validate one serialized txn.  Returns None on any violation.

    Trailing bytes after the parsed region are rejected (the strict mode the
    ingress tiles use) unless allow_trailing is set (embedded-txn decode,
    e.g. the gossip vote CRDS datum); desc.sz is the consumed size.
    """
    n = len(payload)
    if n > MTU:
        return None
    azs = allow_zero_signatures
    if not azs and n < MIN_SERIALIZED_SZ:
        return None
    i = 0

    if n - i < 1:
        return None
    signature_cnt = payload[i]
    i += 1
    if not azs and not (1 <= signature_cnt <= SIG_MAX):
        return None
    if SIGNATURE_SZ * signature_cnt > n - i:
        return None
    signature_off = i
    i += SIGNATURE_SZ * signature_cnt

    message_off = i
    if n - i < 1:
        return None
    header_b0 = payload[i]
    i += 1
    if header_b0 & 0x80:
        transaction_version = header_b0 & 0x7F
        if transaction_version != V0:
            return None
        if n - i < 1 or payload[i] != signature_cnt:
            return None
        i += 1
    else:
        transaction_version = VLEGACY
        if header_b0 != signature_cnt:
            return None

    if n - i < 1:
        return None
    ro_signed_cnt = payload[i]
    i += 1
    if not azs and not ro_signed_cnt < signature_cnt:
        return None
    if n - i < 1:
        return None
    ro_unsigned_cnt = payload[i]
    i += 1

    dec = cu16_decode(payload, i)
    if dec is None:
        return None
    acct_addr_cnt, sz = dec
    i += sz
    if not (signature_cnt <= acct_addr_cnt <= ACCT_ADDR_MAX):
        return None
    if signature_cnt + ro_unsigned_cnt > acct_addr_cnt:
        return None

    if ACCT_ADDR_SZ * acct_addr_cnt > n - i:
        return None
    acct_addr_off = i
    i += ACCT_ADDR_SZ * acct_addr_cnt
    if BLOCKHASH_SZ > n - i:
        return None
    recent_blockhash_off = i
    i += BLOCKHASH_SZ

    dec = cu16_decode(payload, i)
    if dec is None:
        return None
    instr_cnt, sz = dec
    i += sz
    if instr_cnt > INSTR_MAX:
        return None
    if 3 * instr_cnt > n - i:
        return None
    if not azs and instr_cnt and acct_addr_cnt <= 1:
        return None

    max_acct = 0
    instrs = []
    for _ in range(instr_cnt):
        if 3 > n - i:
            return None
        program_id = payload[i]
        i += 1
        dec = cu16_decode(payload, i)
        if dec is None:
            return None
        acct_cnt, sz = dec
        i += sz
        if acct_cnt > n - i:
            return None
        acct_off = i
        for k in range(acct_cnt):
            max_acct = max(max_acct, payload[i + k])
        i += acct_cnt
        dec = cu16_decode(payload, i)
        if dec is None:
            return None
        data_sz, sz = dec
        i += sz
        if data_sz > n - i:
            return None
        data_off = i
        i += data_sz
        if not azs and not (0 < program_id < acct_addr_cnt):
            return None
        instrs.append(Instr(program_id, acct_off, acct_cnt, data_off, data_sz))

    addr_table_cnt = 0
    adtl_writable = 0
    adtl = 0
    luts = []
    if transaction_version == V0:
        dec = cu16_decode(payload, i)
        if dec is None:
            return None
        addr_table_cnt, sz = dec
        i += sz
        if addr_table_cnt > ADDR_TABLE_LOOKUP_MAX:
            return None
        if 34 * addr_table_cnt > n - i:
            return None
        for _ in range(addr_table_cnt):
            if ACCT_ADDR_SZ > n - i:
                return None
            addr_off = i
            i += ACCT_ADDR_SZ
            dec = cu16_decode(payload, i)
            if dec is None:
                return None
            writable_cnt, sz = dec
            i += sz
            if writable_cnt > n - i:
                return None
            writable_off = i
            i += writable_cnt
            dec = cu16_decode(payload, i)
            if dec is None:
                return None
            readonly_cnt, sz = dec
            i += sz
            if readonly_cnt > n - i:
                return None
            readonly_off = i
            i += readonly_cnt
            if writable_cnt > ACCT_ADDR_MAX - acct_addr_cnt:
                return None
            if readonly_cnt > ACCT_ADDR_MAX - acct_addr_cnt:
                return None
            if writable_cnt + readonly_cnt < 1:
                return None
            luts.append(
                AddrLut(addr_off, writable_off, writable_cnt, readonly_off,
                        readonly_cnt)
            )
            adtl_writable += writable_cnt
            adtl += writable_cnt + readonly_cnt

    if not allow_trailing and i != n:
        return None
    if acct_addr_cnt + adtl > ACCT_ADDR_MAX:
        return None
    # unconditional like the reference: with no instrs max_acct is 0, so a
    # zero-account txn is rejected even under allow_zero_signatures
    if max_acct >= acct_addr_cnt + adtl:
        return None

    return TxnDesc(
        transaction_version=transaction_version,
        signature_cnt=signature_cnt,
        signature_off=signature_off,
        message_off=message_off,
        readonly_signed_cnt=ro_signed_cnt,
        readonly_unsigned_cnt=ro_unsigned_cnt,
        acct_addr_cnt=acct_addr_cnt,
        acct_addr_off=acct_addr_off,
        recent_blockhash_off=recent_blockhash_off,
        addr_table_lookup_cnt=addr_table_cnt,
        addr_table_adtl_writable_cnt=adtl_writable,
        addr_table_adtl_cnt=adtl,
        instr_cnt=instr_cnt,
        instr=tuple(instrs),
        address_tables=tuple(luts),
        sz=i,
    )


# ---------------------------------------------------------------------------
# Builder (tests + synthetic load generation; analog of the reference's
# fddev benchg txn generator, src/app/fddev/tiles/fd_benchg.c behavior)
# ---------------------------------------------------------------------------


def build(
    signatures: Sequence[bytes],
    acct_addrs: Sequence[bytes],
    recent_blockhash: bytes,
    instrs: Sequence[Tuple[int, Sequence[int], bytes]],
    readonly_signed_cnt: int = 0,
    readonly_unsigned_cnt: int = 0,
    version: int = VLEGACY,
    address_tables: Sequence[Tuple[bytes, Sequence[int], Sequence[int]]] = (),
) -> bytes:
    """Serialize a txn.  instrs: (program_id_idx, acct_idxs, data)."""
    # parse() reads the count as a raw u8 (valid range where u8 == cu16)
    assert len(signatures) <= SIG_MAX, "signature count must fit a u8"
    out = bytearray()
    out += cu16_encode(len(signatures))
    for s in signatures:
        assert len(s) == 64
        out += s
    if version == V0:
        out += bytes([0x80, len(signatures)])
    else:
        out += bytes([len(signatures)])
    out += bytes([readonly_signed_cnt, readonly_unsigned_cnt])
    out += cu16_encode(len(acct_addrs))
    for a in acct_addrs:
        assert len(a) == 32
        out += a
    assert len(recent_blockhash) == 32
    out += recent_blockhash
    out += cu16_encode(len(instrs))
    for pid, accts, data in instrs:
        out += bytes([pid])
        out += cu16_encode(len(accts))
        out += bytes(accts)
        out += cu16_encode(len(data))
        out += data
    if version == V0:
        out += cu16_encode(len(address_tables))
        for addr, writable, readonly in address_tables:
            assert len(addr) == 32
            out += addr
            out += cu16_encode(len(writable))
            out += bytes(writable)
            out += cu16_encode(len(readonly))
            out += bytes(readonly)
    return bytes(out)


def message_bounds(desc: TxnDesc, payload_len: int) -> Tuple[int, int]:
    """(offset, length) of the signed message region."""
    return desc.message_off, payload_len - desc.message_off


def extract_sigverify_batch(
    payloads: Sequence[bytes],
    descs: Sequence[TxnDesc],
    max_msg_len: int = MTU,
):
    """Pack parsed txns into the verify kernel's batch arrays.

    Expands each txn into one lane PER SIGNATURE (signer pubkey j signs the
    same message with signature j — fd_txn_verify behavior,
    reference: src/app/fdctl/run/tiles/fd_verify.h:43-88).

    Returns (msgs (N, max_msg_len) u8, lens (N,) i32, sigs (N, 64) u8,
    pubs (N, 32) u8, txn_idx (N,) i32 mapping lanes back to txns).
    """
    msgs, lens, sigs, pubs, idxs = [], [], [], [], []
    for t, (p, d) in enumerate(zip(payloads, descs)):
        m = d.message(p)
        # MTU-constrained bound on sigs any parseable txn can carry
        assert d.signature_cnt <= ACTUAL_SIG_MAX, "unreachable for MTU txns"
        for j in range(d.signature_cnt):
            msgs.append(m)
            lens.append(len(m))
            sigs.append(p[d.signature_off + 64 * j : d.signature_off + 64 * (j + 1)])
            pubs.append(d.acct_addr(p, j))
            idxs.append(t)
    n = len(msgs)
    msg_arr = np.zeros((n, max_msg_len), dtype=np.uint8)
    for k, m in enumerate(msgs):
        msg_arr[k, : len(m)] = np.frombuffer(m, dtype=np.uint8)
    return (
        msg_arr,
        np.asarray(lens, np.int32),
        np.frombuffer(b"".join(sigs), np.uint8).reshape(n, 64),
        np.frombuffer(b"".join(pubs), np.uint8).reshape(n, 32),
        np.asarray(idxs, np.int32),
    )
