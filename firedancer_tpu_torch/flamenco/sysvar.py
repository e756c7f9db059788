"""Sysvars: cluster-state accounts programs read at well-known addresses.

A copy of firedancer_tpu/flamenco/sysvar.py.

Reference model: src/flamenco/runtime/sysvar/ (fd_sysvar_clock.c,
fd_sysvar_rent.c, fd_sysvar_epoch_schedule.c) — the runtime materializes
cluster state (clock, rent parameters, epoch schedule) into accounts
owned by the sysvar program so on-chain programs can read them like any
other account.  Layouts are the bincode wire shapes of the corresponding
Solana types (fixed-width little-endian fields).

The bank installs/refreshes them per slot via `install(mgr, slot, ...)`.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..ballet.base58 import decode_32
from ..flamenco.accounts import Account, AccountMgr

#: the sysvar owner program id ("Sysvar1111...")
SYSVAR_OWNER_ID = decode_32("Sysvar1111111111111111111111111111111111111")
CLOCK_ID = decode_32("SysvarC1ock11111111111111111111111111111111")
RENT_ID = decode_32("SysvarRent111111111111111111111111111111111")
EPOCH_SCHEDULE_ID = decode_32("SysvarEpochSchedu1e111111111111111111111111")
SLOT_HASHES_ID = decode_32("SysvarS1otHashes111111111111111111111111111")
RECENT_BLOCKHASHES_ID = decode_32(
    "SysvarRecentB1ockHashes11111111111111111111"
)

#: SlotHashes capacity (reference: fd_sysvar_slot_hashes.c slot_hashes_max)
SLOT_HASHES_MAX = 512


@dataclass
class Clock:
    slot: int = 0
    epoch_start_timestamp: int = 0
    epoch: int = 0
    leader_schedule_epoch: int = 0
    unix_timestamp: int = 0

    _S = struct.Struct("<QqQQq")

    def encode(self) -> bytes:
        return self._S.pack(
            self.slot, self.epoch_start_timestamp, self.epoch,
            self.leader_schedule_epoch, self.unix_timestamp,
        )

    @classmethod
    def decode(cls, raw: bytes) -> "Clock":
        return cls(*cls._S.unpack_from(raw))


@dataclass
class Rent:
    lamports_per_byte_year: int = 3480
    exemption_threshold: float = 2.0
    burn_percent: int = 50

    _S = struct.Struct("<QdB")

    def encode(self) -> bytes:
        return self._S.pack(
            self.lamports_per_byte_year, self.exemption_threshold,
            self.burn_percent,
        )

    @classmethod
    def decode(cls, raw: bytes) -> "Rent":
        return cls(*cls._S.unpack_from(raw))

    def minimum_balance(self, data_len: int) -> int:
        return int(
            (128 + data_len)
            * self.lamports_per_byte_year
            * self.exemption_threshold
        )


@dataclass
class EpochSchedule:
    slots_per_epoch: int = 432_000
    leader_schedule_slot_offset: int = 432_000
    warmup: bool = False
    first_normal_epoch: int = 0
    first_normal_slot: int = 0

    _S = struct.Struct("<QQBQQ")

    def encode(self) -> bytes:
        return self._S.pack(
            self.slots_per_epoch, self.leader_schedule_slot_offset,
            int(self.warmup), self.first_normal_epoch, self.first_normal_slot,
        )

    @classmethod
    def decode(cls, raw: bytes) -> "EpochSchedule":
        s = cls(*cls._S.unpack_from(raw))
        s.warmup = bool(s.warmup)
        return s

    def epoch_of(self, slot: int) -> int:
        return slot // self.slots_per_epoch  # post-warmup schedule


@dataclass
class SlotHashes:
    """Most-recent-first (slot, hash) pairs, capped at SLOT_HASHES_MAX.

    Layout is the Solana bincode Vec<(u64, [u8;32])> the reference
    serializes in fd_sysvar_slot_hashes.c (u64 count + packed entries).
    Consumers: ALT deactivation cooldown (a deactivating table serves
    lookups while its deactivation slot is still present here).
    """

    entries: list = None  # list[(slot, hash32)]

    def __post_init__(self):
        if self.entries is None:
            self.entries = []

    def add(self, slot: int, h: bytes) -> None:
        self.entries.insert(0, (slot, h))
        del self.entries[SLOT_HASHES_MAX:]

    def contains_slot(self, slot: int) -> bool:
        return any(s == slot for s, _ in self.entries)

    def encode(self) -> bytes:
        out = bytearray(len(self.entries).to_bytes(8, "little"))
        for s, h in self.entries:
            out += s.to_bytes(8, "little") + h
        return bytes(out)

    @classmethod
    def decode(cls, raw: bytes) -> "SlotHashes":
        n = int.from_bytes(raw[:8], "little")
        entries = []
        off = 8
        for _ in range(min(n, SLOT_HASHES_MAX)):
            s = int.from_bytes(raw[off : off + 8], "little")
            entries.append((s, bytes(raw[off + 8 : off + 40])))
            off += 40
        return cls(entries)


@dataclass
class RecentBlockhashes:
    """Vec<(hash, fee_calculator)> newest first (deprecated sysvar the
    nonce instructions still account-check; reference
    fd_sysvar_recent_hashes.c)."""

    entries: list = None  # list[(hash32, lamports_per_signature)]

    def __post_init__(self):
        if self.entries is None:
            self.entries = []

    def encode(self) -> bytes:
        out = bytearray(len(self.entries).to_bytes(8, "little"))
        for h, lps in self.entries:
            out += h + lps.to_bytes(8, "little")
        return bytes(out)

    @classmethod
    def decode(cls, raw: bytes) -> "RecentBlockhashes":
        n = int.from_bytes(raw[:8], "little")
        entries = []
        off = 8
        for _ in range(n):
            entries.append(
                (
                    bytes(raw[off : off + 32]),
                    int.from_bytes(raw[off + 32 : off + 40], "little"),
                )
            )
            off += 40
        return cls(entries)


def install(
    mgr: AccountMgr,
    slot: int,
    *,
    unix_timestamp: int = 0,
    rent: Rent | None = None,
    schedule: EpochSchedule | None = None,
    slot_hashes: SlotHashes | None = None,
    recent_blockhashes: RecentBlockhashes | None = None,
) -> None:
    """Materialize/refresh the sysvar accounts for `slot` (the bank calls
    this at slot start; reference: fd_sysvar_clock_update)."""
    rent = rent or Rent()
    schedule = schedule or EpochSchedule()
    epoch = schedule.epoch_of(slot)
    clock = Clock(
        slot=slot,
        epoch=epoch,
        leader_schedule_epoch=epoch + 1,
        unix_timestamp=unix_timestamp,
    )
    bodies = [
        (CLOCK_ID, clock.encode()),
        (RENT_ID, rent.encode()),
        (EPOCH_SCHEDULE_ID, schedule.encode()),
    ]
    if slot_hashes is not None:
        bodies.append((SLOT_HASHES_ID, slot_hashes.encode()))
    if recent_blockhashes is not None:
        bodies.append(
            (RECENT_BLOCKHASHES_ID, recent_blockhashes.encode())
        )
    for key, body in bodies:
        mgr.store(
            key,
            Account(
                lamports=1_000_000_000,
                owner=SYSVAR_OWNER_ID,
                data=body,
            ),
        )
