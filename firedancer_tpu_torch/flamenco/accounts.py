"""Account store on funk — the runtime's account manager.

A copy of firedancer_tpu/flamenco/accounts.py.

Reference model: src/flamenco/runtime/fd_acc_mgr.c (+ fd_borrowed_account):
accounts are funk records keyed by pubkey, holding the canonical account
shape (lamports, owner, executable, rent epoch, data).  The wire codec is
a fixed little-endian header + data tail; values are opaque to funk.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..funk.funk import Funk, ROOT_XID

_HDR = struct.Struct("<Q32sBQ")  # lamports, owner, executable, rent_epoch

SYSTEM_PROGRAM_ID = bytes(32)


@dataclass
class Account:
    lamports: int
    owner: bytes = SYSTEM_PROGRAM_ID
    executable: bool = False
    rent_epoch: int = 0
    data: bytes = b""

    def encode(self) -> bytes:
        return (
            _HDR.pack(
                self.lamports, self.owner, int(self.executable),
                self.rent_epoch,
            )
            + self.data
        )

    @classmethod
    def decode(cls, raw: bytes) -> "Account":
        lam, owner, execu, rent = _HDR.unpack_from(raw)
        return cls(lam, owner, bool(execu), rent, raw[_HDR.size :])


class AccountMgr:
    """Reads/writes accounts inside one funk transaction (fork)."""

    def __init__(self, funk: Funk, xid: bytes = ROOT_XID):
        self.funk = funk
        self.xid = xid

    def load(self, pubkey: bytes) -> Account | None:
        raw = self.funk.rec_read(self.xid, pubkey)
        return None if raw is None else Account.decode(raw)

    def store(self, pubkey: bytes, acct: Account) -> None:
        self.funk.rec_write(self.xid, pubkey, acct.encode())

    def lamports(self, pubkey: bytes) -> int:
        a = self.load(pubkey)
        return 0 if a is None else a.lamports
