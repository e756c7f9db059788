"""Sink tile: terminal consumer that counts (and optionally records) frags.

A copy of firedancer_tpu/tiles/sink.py for the thread runtime: the
host-side record (sigs, payloads, sizes), readable via all_sigs() from the
same process.  The shared-memory sig log, which lets another process read
the record, waits for the process runtime.

Test/bench helper — the analog of the rx tiles the reference's multi-tile
concurrency tests spawn (src/disco/dedup/test_dedup.c:654-660).
"""

from __future__ import annotations

import threading

import numpy as np

from ..disco.metrics import MetricsSchema
from ..disco.mux import MuxCtx, Tile, now_ts, ts_diff_arr


class SinkTile(Tile):
    schema = MetricsSchema(counters=("sunk_frags",), hists=("latency_us",))

    def __init__(self, *, record: bool = False, name: str = "sink"):
        self.name = name
        self.record = record
        self.sigs: list[np.ndarray] = []
        self.payloads: list[np.ndarray] = []
        self.sizes: list[np.ndarray] = []
        self.lock = threading.Lock()

    def on_frags(self, ctx: MuxCtx, in_idx: int, frags: np.ndarray) -> None:
        ctx.metrics.inc("sunk_frags", len(frags))
        # end-to-end latency: origin tsorig (stamped at ingress, carried
        # through every relay) to arrival here; sign-extended wrap-safe
        # delta (ts_diff) so a 2^32 µs wrap mid-run cannot turn a small
        # latency into a ~71-minute garbage sample
        lat = np.maximum(ts_diff_arr(now_ts(), frags["tsorig"]), 0)
        ctx.metrics.hist_sample_many("latency_us", lat)
        if self.record:
            rows = ctx.ins[in_idx].gather(frags)
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
