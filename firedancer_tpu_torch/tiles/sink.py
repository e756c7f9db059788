"""Sink tile: terminal consumer that counts (and optionally records) frags.

A copy of firedancer_tpu/tiles/sink.py.  Two recording surfaces:
  * record=True — host-side lists (sigs/payloads/sizes), readable via
    all_sigs() from the same process.  Thread runtime only: in the
    process runtime the lists fill in the CHILD and the parent's copy
    stays empty.
  * shm_log=N — a sig log IN THE WORKSPACE (ctx.alloc region: cursor
    word + N u64 slots), written by the sink and readable from ANY
    process via Topology.tile_alloc_view(name, SIGLOG_ALLOC) +
    read_siglog().  This is how a parent reads a child sink's survivors.
  * shm_hash=True (port-only, with shm_log=N) — beside the sig log, the
    SHA-256 of each frag's payload (HASHLOG_ALLOC: cursor word + N
    32-byte digests), read back with read_hashlog(): what a parent holds
    a child sink's payloads to (a block's PoH mixins) without copying
    them out.

Test/bench helper — the analog of the rx tiles the reference's multi-tile
concurrency tests spawn (src/disco/dedup/test_dedup.c:654-660).
"""

from __future__ import annotations

import hashlib
import threading

import numpy as np

from ..disco.metrics import MetricsSchema
from ..disco.mux import MuxCtx, Tile, now_ts, ts_diff_arr

SIGLOG_ALLOC = "siglog"
HASHLOG_ALLOC = "hashlog"

#: guards SinkTile's lazy per-instance Lock creation: two threads (the
#: mux loop in on_frags, a caller in all_sigs) racing the first access
#: must end up sharing ONE lock
_LOCK_INIT = threading.Lock()


def siglog_footprint(cap: int) -> int:
    return 8 * (1 + cap)


def read_siglog(mem: np.ndarray) -> np.ndarray:
    """Decode a sink shm sig log region: the first min(cursor, cap)
    recorded sigs (the log is a truncating append, not a ring — parity
    checks need exact prefixes, so overflow drops the tail and the
    cursor keeps counting for the caller to notice)."""
    words = mem[: (len(mem) // 8) * 8].view(np.uint64)
    cap = len(words) - 1
    n = min(int(words[0]), cap)
    return words[1 : 1 + n].copy()


def hashlog_footprint(cap: int) -> int:
    return 8 + 32 * cap


def read_hashlog(mem: np.ndarray) -> list[bytes]:
    """Decode a sink shm hash log: the first min(cursor, cap) payload
    digests, in arrival order (a truncating append, as the sig log)."""
    cap = (len(mem) - 8) // 32
    n = min(int(mem[:8].view(np.uint64)[0]), cap)
    return [mem[8 + 32 * i : 8 + 32 * (i + 1)].tobytes() for i in range(n)]


class SinkTile(Tile):
    schema = MetricsSchema(counters=("sunk_frags",), hists=("latency_us",))

    def __init__(self, *, record: bool = False, shm_log: int = 0,
                 shm_hash: bool = False, name: str = "sink"):
        if shm_hash and not shm_log:
            raise ValueError("shm_hash logs beside shm_log: give shm_log")
        self.name = name
        self.record = record
        self.shm_log = int(shm_log)
        self.shm_hash = shm_hash
        self.sigs: list[np.ndarray] = []
        self.payloads: list[np.ndarray] = []
        self.sizes: list[np.ndarray] = []
        # NOT created here: a Lock captured by the constructor would not
        # survive the process runtime's spawn pickle; made on first use
        self._lock: threading.Lock | None = None
        self._slog: np.ndarray | None = None
        self._hlog: np.ndarray | None = None

    @property
    def lock(self) -> threading.Lock:
        if self._lock is None:
            with _LOCK_INIT:
                if self._lock is None:
                    self._lock = threading.Lock()
        return self._lock

    def wksp_footprint(self) -> int:
        return ((siglog_footprint(self.shm_log) if self.shm_log else 0)
                + (hashlog_footprint(self.shm_log) if self.shm_hash else 0))

    def on_boot(self, ctx: MuxCtx) -> None:
        if self.shm_log:
            mem = ctx.alloc(SIGLOG_ALLOC, siglog_footprint(self.shm_log))
            self._slog = mem[: (len(mem) // 8) * 8].view(np.uint64)
        if self.shm_hash:
            self._hlog = ctx.alloc(HASHLOG_ALLOC, hashlog_footprint(self.shm_log))

    def on_frags(self, ctx: MuxCtx, in_idx: int, frags: np.ndarray) -> None:
        ctx.metrics.inc("sunk_frags", len(frags))
        # end-to-end latency: origin tsorig (stamped at ingress, carried
        # through every relay) to arrival here; sign-extended wrap-safe
        # delta (ts_diff) so a 2^32 µs wrap mid-run cannot turn a small
        # latency into a ~71-minute garbage sample
        lat = np.maximum(ts_diff_arr(now_ts(), frags["tsorig"]), 0)
        ctx.metrics.hist_sample_many("latency_us", lat)
        if self._slog is not None:
            w = self._slog
            cap = len(w) - 1
            cur = int(w[0])
            keep = frags["sig"][: max(cap - cur, 0)]
            if len(keep):
                w[1 + cur : 1 + cur + len(keep)] = keep
            # cursor counts EVERY sig (overflow visible to readers);
            # bumped after the stores so a concurrent reader never sees
            # slots it could misread as live
            w[0] = np.uint64(cur + len(frags))
        rows = (ctx.ins[in_idx].gather(frags)
                if self.record or self._hlog is not None else None)
        if self._hlog is not None:
            h = self._hlog
            cur = int(h[:8].view(np.uint64)[0])
            for i, sz in enumerate(frags["sz"][: max(self.shm_log - cur, 0)]):
                at = 8 + 32 * (cur + i)
                h[at : at + 32] = np.frombuffer(
                    hashlib.sha256(rows[i, :sz].tobytes()).digest(), np.uint8)
            # cursor after the digests, as the sig log's
            h[:8].view(np.uint64)[0] = np.uint64(cur + len(frags))
        if self.record:
            with self.lock:
                self.sigs.append(frags["sig"].copy())
                self.payloads.append(rows)
                self.sizes.append(frags["sz"].copy())

    def all_sigs(self) -> np.ndarray:
        with self.lock:
            return (
                np.concatenate(self.sigs)
                if self.sigs
                else np.zeros(0, dtype=np.uint64)
            )
