"""fdttrace: per-tile span-event rings for end-to-end frag tracing.

A copy of firedancer_tpu/disco/trace.py, without the fault annotation
(the fault injector and the supervisor are not ported yet).

Reference model: the reference carries compressed publish/origin
timestamps in every frag (fd_frag_meta_ts_comp, fd_tango_base.h) and
histogram-samples every mux phase (fd_mux.c:435-444), but never keeps a
per-frag record.  This build adds one: each tile owns a SPAN RING — a
flat u64 region in the workspace with the same storage contract as the
metrics regions (disco/metrics.py): single writer (the tile's mux
thread), lock-free, torn-read-tolerant, readable by any process that
maps the workspace.  The run loop (disco/mux.py) writes span events at
its fixed points (frag ingest, publish, housekeeping, backpressure) and
the verify device pool adds its own (enqueue, dispatch, land, fallback,
quarantine); `scripts/fdttrace.py` drains the rings and assembles
per-frag timelines keyed by (link, seq, sig).

Sampling: 1-in-N by the frag's sig field.  The sig is the dedup tag and
is CARRIED across hops (quic stamps it, verify/dedup forward it), so
`sig % N == 0` selects the SAME frags at every hop — which is what makes
cross-tile timelines assemblable.  N=1 traces everything (tests); large
N keeps the hot path allocation-light; tracing off (no Tracer installed)
costs one `is not None` check per loop phase.

Event layout (4 u64 words, little-endian):
    w0 = kind(u8) << 56 | link(u8) << 48 | aux16(u16) << 32 | ts(u32)
    w1 = seq   (ring seq for frag events; pool seq for device events)
    w2 = sig   (the frag's dedup tag; 0 for tile-scoped events)
    w3 = aux64 (INGEST: tsorig << 32 | tspub; PUBLISH: tsorig;
                others: event-specific payload, e.g. a duration)

ts is the same compressed µs-mod-2^32 domain as the frag meta's
tsorig/tspub (disco.mux.now_ts) — all arithmetic on it must go through
the wrap-safe ts_diff helpers in disco/mux.py.

NATIVE MIRROR: tango/native/fdt_trace.c re-states this
module's storage format in C — the event word packing, the ring
header's reserve-before-store / commit-after-store cursor discipline,
and the 1-in-N sig sampling — so the native stem emits span records a
Python reader drains indistinguishably from Tracer's.  The layout
constants below (_HDR_WORDS, EVENT_WORDS, header word meanings, INGEST/
PUBLISH kinds) are therefore SHARED FORMAT: changing any of them means
changing fdt_trace.c in the same commit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# -- span kinds -------------------------------------------------------------

INGEST = 1      # frags consumed from an in-link (one event per sampled frag)
PUBLISH = 2     # frags published to an out-link (one event per sampled frag)
HK = 3          # housekeeping fired (aux64 = duration ns)
BP = 4          # backpressure streak began (zero credits across outs)
ENQUEUE = 5     # verify pool: batch accepted (seq = pool_seq, aux16 = lanes)
DISPATCH = 6    # verify pool: device dispatch began (aux16 = device idx)
LAND = 7        # verify pool: batch landed (aux16 = device idx)
FALLBACK = 8    # verify pool: batches served by the strict host path
QUARANTINE = 9  # verify pool: a device domain degraded (aux16 = device idx)
FAULT = 10      # fault-injection / supervisor annotation

KIND_NAMES = {
    INGEST: "ingest", PUBLISH: "publish", HK: "hk", BP: "bp",
    ENQUEUE: "enqueue", DISPATCH: "dispatch", LAND: "land",
    FALLBACK: "fallback", QUARANTINE: "quarantine", FAULT: "fault",
}

@dataclass(frozen=True)
class TraceConfig:
    """Topology-level tracing knobs (disco.topo.Topology.enable_trace).

    sample: 1-in-N frag sampling by sig (1 = every frag; 0 disables —
    no tracer is installed and the hot path pays nothing).
    depth: span events retained per tile before the writer laps the
    reader (the reader detects and reports the dropped count)."""

    sample: int = 64
    depth: int = 1 << 14


_HDR_WORDS = 8
EVENT_WORDS = 4


class SpanRing:
    """Lock-free single-writer span-event ring in a u64 workspace region.

    Header: word0 = committed cursor (total events ever written,
    monotone), word1 = depth, word2 = sample (reader metadata),
    word3 = reserve cursor.  Events live at slot (i % depth).  The
    writer bumps the RESERVE cursor first, stores the event words,
    then advances the committed cursor — so a reader can bound every
    slot the writer may currently be storing into (ordering is
    best-effort from Python/numpy, exactly the metrics regions'
    torn-read tolerance): `read` copies [since, committed), then
    re-checks the reserve cursor and discards anything a concurrent
    write_block could have been overwriting during the copy, so no
    torn entry is returned as data (it is counted dropped instead)."""

    def __init__(self, mem_u8: np.ndarray, depth: int = 0, sample: int = 0,
                 join: bool = False):
        self.words = mem_u8[: (len(mem_u8) // 8) * 8].view(np.uint64)
        if join:
            self.depth = int(self.words[1])
            self.sample = int(self.words[2])
        else:
            assert depth > 0 and depth & (depth - 1) == 0, (
                f"span ring depth {depth} must be a power of two"
            )
            self.depth = depth
            self.sample = sample
            self.words[0] = 0
            self.words[1] = depth
            self.words[2] = sample
            self.words[3] = 0
        self.ev = self.words[
            _HDR_WORDS : _HDR_WORDS + self.depth * EVENT_WORDS
        ].reshape(self.depth, EVENT_WORDS)

    @staticmethod
    def footprint(depth: int) -> int:
        return (_HDR_WORDS + depth * EVENT_WORDS) * 8

    # -- writer side (owning tile's mux thread only) ----------------------

    def write_block(self, rows: np.ndarray) -> None:
        """Append a (k, 4) u64 block of events.  A block larger than the
        ring keeps its tail, but the cursor still advances by the full
        block so the reader's lap accounting stays truthful."""
        k = len(rows)
        if k == 0:
            return
        w = int(self.words[0])
        # reserve before storing: a concurrent reader bounds the slots
        # this store may be scribbling over by re-checking word3
        self.words[3] = np.uint64(w + k)
        kept = rows[-self.depth :]
        idx = (w + (k - len(kept)) + np.arange(len(kept))) % self.depth
        self.ev[idx] = kept
        self.words[0] = np.uint64(w + k)

    # -- reader side (any process) ----------------------------------------

    def cursor(self) -> int:
        return int(self.words[0])

    def read(self, since: int = 0) -> tuple[np.ndarray, int, int]:
        """Events [since, cursor) that are still live.  Returns
        (events (k,4) u64 copy, new_since, dropped) where dropped counts
        entries lost to writer laps — including any a write_block COULD
        have been overwriting while we copied (the reserve cursor is
        bumped before the stores, so re-checking it after the copy
        bounds the in-progress write too), so no torn entry is ever
        returned as data."""
        c = int(self.words[0])
        lo = max(since, c - self.depth)
        if lo >= c:
            return np.zeros((0, EVENT_WORDS), np.uint64), c, lo - since
        idx = (lo + np.arange(c - lo)) % self.depth
        out = self.ev[idx].copy()
        r2 = int(self.words[3])  # writer reservations during the copy
        # clamp to c: a writer that laps the WHOLE window mid-copy can
        # push r2 - depth beyond the committed cursor we are reporting —
        # without the clamp the dropped count would cover events beyond
        # [since, c), and the next read (starting at c) would count
        # those same losses AGAIN, double-reporting drops
        safe_lo = min(max(lo, r2 - self.depth), c)
        if safe_lo > lo:
            out = out[safe_lo - lo :]
        return out, c, safe_lo - since


def decode(events: np.ndarray) -> list[dict]:
    """(k, 4) u64 event block -> list of field dicts."""
    out = []
    for w0, w1, w2, w3 in events.tolist():
        out.append(
            {
                "kind": (w0 >> 56) & 0xFF,
                "link": (w0 >> 48) & 0xFF,
                "aux16": (w0 >> 32) & 0xFFFF,
                "ts": w0 & 0xFFFFFFFF,
                "seq": w1,
                "sig": w2,
                "aux64": w3,
            }
        )
    return out


def _pack_w0(kind: int, link: int, aux16, ts) -> np.ndarray:
    return (
        (np.uint64(kind & 0xFF) << np.uint64(56))
        | (np.uint64(link & 0xFF) << np.uint64(48))
        | (np.asarray(aux16, np.uint64) << np.uint64(32))
        | np.asarray(ts, np.uint64)
    )


class Tracer:
    """A tile's span-event writer facade.

    Installed on MuxCtx.tracer by the topology when tracing is enabled;
    every write runs on the tile's mux thread (or, for the supervisor's
    restart annotation, strictly after that thread has been joined), so
    the ring's single-writer contract holds."""

    def __init__(self, ring: SpanRing, sample: int, name: str = ""):
        self.ring = ring
        self.sample = max(int(sample), 1)
        self.name = name

    def _mask(self, sigs: np.ndarray) -> np.ndarray:
        if self.sample == 1:
            return slice(None)
        return sigs % np.uint64(self.sample) == 0

    def ingest(self, link: int, frags: np.ndarray, ts: int) -> None:
        """One INGEST per sampled frag of a drained batch.  aux64 packs
        the frag's own tsorig/tspub so the assembler can attribute
        queue-wait (ts - tspub) and end-to-end (ts - tsorig) offline."""
        sel = frags[self._mask(frags["sig"])]
        n = len(sel)
        if n == 0:
            return
        rows = np.empty((n, EVENT_WORDS), np.uint64)
        rows[:, 0] = _pack_w0(INGEST, link, 0, ts)
        rows[:, 1] = sel["seq"]
        rows[:, 2] = sel["sig"]
        rows[:, 3] = (sel["tsorig"].astype(np.uint64) << np.uint64(32)) | (
            sel["tspub"].astype(np.uint64)
        )
        self.ring.write_block(rows)

    def publish(
        self,
        link: int,
        seq0: int,
        sigs: np.ndarray,
        tspub: int,
        tsorigs: np.ndarray | None,
    ) -> None:
        """One PUBLISH per sampled frag of a published batch."""
        sigs = np.asarray(sigs, np.uint64)
        mask = self._mask(sigs)
        seqs = (np.uint64(seq0) + np.arange(len(sigs), dtype=np.uint64))[mask]
        sel = sigs[mask]
        n = len(sel)
        if n == 0:
            return
        rows = np.empty((n, EVENT_WORDS), np.uint64)
        rows[:, 0] = _pack_w0(PUBLISH, link, 0, tspub & 0xFFFFFFFF)
        rows[:, 1] = seqs
        rows[:, 2] = sel
        if tsorigs is None:
            rows[:, 3] = np.uint64(tspub & 0xFFFFFFFF)
        else:
            rows[:, 3] = np.asarray(tsorigs, np.uint64)[mask]
        self.ring.write_block(rows)

    def point(
        self,
        kind: int,
        *,
        link: int = 0,
        ts: int | None = None,
        seq: int = 0,
        sig: int = 0,
        aux16: int = 0,
        aux64: int = 0,
    ) -> None:
        """One tile-scoped event (HK/BP/pool/fault annotations)."""
        if ts is None:
            from .mux import now_ts

            ts = now_ts()
        row = np.empty((1, EVENT_WORDS), np.uint64)
        row[0, 0] = _pack_w0(kind, link, aux16 & 0xFFFF, ts & 0xFFFFFFFF)
        row[0, 1] = seq & (2**64 - 1)
        row[0, 2] = sig & (2**64 - 1)
        row[0, 3] = aux64 & (2**64 - 1)
        self.ring.write_block(row)
