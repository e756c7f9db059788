"""Intrusive-style LRU over dense numpy arrays.

A copy of firedancer_tpu/tango/lru.py.

Reference model: src/tango/lru/ — a doubly-linked LRU list + map used by
QUIC connection management.  TPU-native redesign: the list is three
int32 arrays (prev, next, free-list) indexed by slot id, so the steady
state is O(1) touch/evict with zero allocation; the key->slot map is a
plain dict (the Python-host analog of fd_lru's map join).

Used by waltz.quic.QuicServer to evict the least-recently-active
connection when the table is full (instead of refusing new handshakes).
"""

from __future__ import annotations

import numpy as np

_NIL = -1


class Lru:
    """Fixed-capacity LRU of hashable keys.

    acquire(key) -> (slot, evicted_key|None): inserts or touches `key`,
    evicting the LRU key when full.  touch(key) refreshes recency.
    remove(key) frees its slot."""

    def __init__(self, capacity: int):
        assert capacity > 0
        self.capacity = capacity
        self._prev = np.full(capacity, _NIL, np.int32)
        self._next = np.full(capacity, _NIL, np.int32)
        self._key: list = [None] * capacity
        self._map: dict = {}
        self._head = _NIL  # most recent
        self._tail = _NIL  # least recent
        self._free = list(range(capacity - 1, -1, -1))

    def __len__(self) -> int:
        return len(self._map)

    def __contains__(self, key) -> bool:
        return key in self._map

    # -- list plumbing -----------------------------------------------------

    def _unlink(self, s: int) -> None:
        p, n = self._prev[s], self._next[s]
        if p != _NIL:
            self._next[p] = n
        else:
            self._head = n
        if n != _NIL:
            self._prev[n] = p
        else:
            self._tail = p

    def _push_front(self, s: int) -> None:
        self._prev[s] = _NIL
        self._next[s] = self._head
        if self._head != _NIL:
            self._prev[self._head] = s
        self._head = s
        if self._tail == _NIL:
            self._tail = s

    # -- public ------------------------------------------------------------

    def touch(self, key) -> bool:
        s = self._map.get(key)
        if s is None:
            return False
        if self._head != s:
            self._unlink(s)
            self._push_front(s)
        return True

    def acquire(self, key):
        """Insert (or touch) key; returns (slot, evicted_key_or_None)."""
        s = self._map.get(key)
        if s is not None:
            self.touch(key)
            return s, None
        evicted = None
        if self._free:
            s = self._free.pop()
        else:
            s = self._tail
            evicted = self._key[s]
            del self._map[evicted]
            self._unlink(s)
        self._key[s] = key
        self._map[key] = s
        self._push_front(s)
        return s, evicted

    def remove(self, key) -> bool:
        s = self._map.pop(key, None)
        if s is None:
            return False
        self._unlink(s)
        self._key[s] = None
        self._free.append(s)
        return True

    def lru_key(self):
        """Least-recently-used key (None when empty)."""
        return None if self._tail == _NIL else self._key[self._tail]

    def iter_lru(self):
        """Keys from least to most recently used."""
        s = self._tail
        while s != _NIL:
            yield self._key[s]
            s = self._prev[s]
