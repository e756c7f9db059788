"""funk — fork-aware record database (the account store).

A copy of firedancer_tpu/funk/funk.py.

Behavior contract: src/funk/fd_funk.h:4-100 and fd_funk_{txn,rec,val}.c —
a flat table of (xid, key) → value records plus a transaction fork tree:

  * txn_prepare(parent, xid): open an in-preparation transaction whose
    unpublished ancestry chains to the last published state (the "root")
  * records written in a txn shadow the same key in its ancestors;
    reads walk txn → parent → ... → root, first hit wins (tombstones
    make removals shadow too)
  * txn_publish(xid): make xid and its in-prep ancestors permanent by
    folding them into the root, cancelling every competing fork
  * txn_cancel(xid): discard a txn and its descendants
  * only "frontier" txns (no in-prep children) may be written — writing
    to a txn that has children would invisibly mutate them
    (fd_funk_txn.h's frozen rule)
  * checkpoint/restore: the whole store round-trips to a file (the
    reference gets this from wksp checkpt, src/util/wksp/fd_wksp.h:966)

Host-side subsystem (the runtime's account manager sits on it); values
are opaque bytes.  The TPU angle is in the consumers: bulk reads return
dense (n, width) matrices ready to ship to device kernels.
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field

import numpy as np

ROOT_XID = b"\x00" * 32

_TOMBSTONE = None  # sentinel stored in rec maps for removed keys


@dataclass
class _Txn:
    xid: bytes
    parent: bytes
    recs: dict[bytes, bytes | None] = field(default_factory=dict)
    children: set[bytes] = field(default_factory=set)


class Funk:
    def __init__(self):
        self.root: dict[bytes, bytes] = {}
        self.txns: dict[bytes, _Txn] = {}
        #: decoded-lamports cache over PUBLISHED (root) records holding
        #: trivial system accounts (the bank's fast transfer path fills
        #: and reads it, flamenco/runtime.py execute_fast_transfers).
        #: Coherence rule: every root mutation below invalidates the
        #: touched key, so a cached entry is always the decode of the
        #: live root record; fast executors on unpublished forks run
        #: uncached (their reads/writes never touch this dict).
        self.lam_cache: dict[bytes, int] = {}

    # ---- transactions ---------------------------------------------------

    def txn_prepare(self, parent_xid: bytes, xid: bytes) -> None:
        assert xid != ROOT_XID and xid not in self.txns, "xid in use"
        if parent_xid != ROOT_XID:
            assert parent_xid in self.txns, "unknown parent"
            self.txns[parent_xid].children.add(xid)
        self.txns[xid] = _Txn(xid, parent_xid)

    def txn_is_frozen(self, xid: bytes) -> bool:
        """A txn with in-prep children must not be written
        (fd_funk_txn frozen rule)."""
        if xid == ROOT_XID:
            return any(t.parent == ROOT_XID for t in self.txns.values())
        return bool(self.txns[xid].children)

    def txn_cancel(self, xid: bytes) -> int:
        """Discard xid and all descendants; returns number cancelled."""
        t = self.txns.get(xid)
        if t is None:
            return 0
        n = 0
        for child in list(t.children):
            n += self.txn_cancel(child)
        if t.parent != ROOT_XID and t.parent in self.txns:
            self.txns[t.parent].children.discard(xid)
        del self.txns[xid]
        return n + 1

    def _ancestry(self, xid: bytes) -> list[bytes]:
        """xid's unpublished chain, oldest first (excluding root)."""
        chain = []
        while xid != ROOT_XID:
            chain.append(xid)
            xid = self.txns[xid].parent
        return list(reversed(chain))

    def txn_publish(self, xid: bytes) -> int:
        """Fold xid's chain into the root; cancel competing forks.
        Returns the number of txns published."""
        chain = self._ancestry(xid)
        for x in chain:
            t = self.txns[x]
            # cancel sibling forks not on the publish path
            for child in list(
                self.txns[t.parent].children if t.parent != ROOT_XID else []
            ):
                if child != x:
                    self.txn_cancel(child)
            for top in [
                y for y, ty in self.txns.items()
                if ty.parent == ROOT_XID and y != chain[0]
            ]:
                self.txn_cancel(top)
            for k, v in t.recs.items():
                if v is _TOMBSTONE:
                    self.root.pop(k, None)
                else:
                    self.root[k] = v
                self.lam_cache.pop(k, None)
        # surviving children of xid re-parent to root
        survivors = list(self.txns[xid].children)
        for child in survivors:
            self.txns[child].parent = ROOT_XID
        for x in chain:
            self.txns.pop(x, None)
        return len(chain)

    # ---- records --------------------------------------------------------

    def rec_write(self, xid: bytes, key: bytes, val: bytes) -> None:
        if xid == ROOT_XID:
            assert not self.txn_is_frozen(ROOT_XID), "root frozen"
            self.root[key] = val
            self.lam_cache.pop(key, None)
            return
        assert not self.txn_is_frozen(xid), "txn frozen (has children)"
        self.txns[xid].recs[key] = val

    def rec_remove(self, xid: bytes, key: bytes) -> None:
        if xid == ROOT_XID:
            assert not self.txn_is_frozen(ROOT_XID), "root frozen"
            self.root.pop(key, None)
            self.lam_cache.pop(key, None)
            return
        assert not self.txn_is_frozen(xid)
        self.txns[xid].recs[key] = _TOMBSTONE

    def rec_write_many(self, xid: bytes, items) -> None:
        """Batch write: items yields (key, value | None) — None removes
        the record.  One frozen check covers the whole batch (a single
        logical mutation from a single writer — the bank table's funk
        write-back, where per-record rec_write overhead measurably
        dominated the native executor's commit path).  The lam_cache
        discipline is rec_write's: every touched key is invalidated."""
        if xid == ROOT_XID:
            assert not self.txn_is_frozen(ROOT_XID), "root frozen"
            root = self.root
            cache = self.lam_cache
            for k, v in items:
                if v is None:
                    root.pop(k, None)
                else:
                    root[k] = v
                cache.pop(k, None)
            return
        assert not self.txn_is_frozen(xid), "txn frozen (has children)"
        recs = self.txns[xid].recs
        for k, v in items:
            recs[k] = v  # None IS the tombstone sentinel

    def rec_read(self, xid: bytes, key: bytes) -> bytes | None:
        while xid != ROOT_XID:
            t = self.txns[xid]
            if key in t.recs:
                return t.recs[key]  # may be tombstone -> None
            xid = t.parent
        return self.root.get(key)

    def rec_read_batch(
        self, xid: bytes, keys: list[bytes], width: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Bulk read into a dense (n, width) u8 matrix (device-ready).

        Returns (rows, lens, found) — rows zero-padded, lens byte counts,
        found False where the key doesn't exist."""
        n = len(keys)
        rows = np.zeros((n, width), np.uint8)
        lens = np.zeros(n, np.int32)
        found = np.zeros(n, bool)
        for i, k in enumerate(keys):
            v = self.rec_read(xid, k)
            if v is not None:
                v = v[:width]
                rows[i, : len(v)] = np.frombuffer(v, np.uint8)
                lens[i] = len(v)
                found[i] = True
        return rows, lens, found

    # ---- checkpoint / restore ------------------------------------------

    _MAGIC = b"FDTFUNK1"

    def checkpoint(self, path: str) -> None:
        """Serialize the PUBLISHED state (root) to a file
        (fd_wksp_checkpt analog; in-prep txns are transient by design)."""
        with open(path, "wb") as f:
            f.write(self._MAGIC)
            f.write(struct.pack("<Q", len(self.root)))
            for k, v in self.root.items():
                f.write(struct.pack("<II", len(k), len(v)))
                f.write(k)
                f.write(v)

    @classmethod
    def restore(cls, path: str) -> "Funk":
        funk = cls()
        with open(path, "rb") as f:
            assert f.read(8) == cls._MAGIC, "bad checkpoint"
            (n,) = struct.unpack("<Q", f.read(8))
            for _ in range(n):
                klen, vlen = struct.unpack("<II", f.read(8))
                k = f.read(klen)
                v = f.read(vlen)
                funk.root[k] = v
        return funk
