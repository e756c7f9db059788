"""Replay tile: deterministic pcap-driven ingress.

A copy of firedancer_tpu/tiles/replay.py.

Reference model: src/disco/replay/fd_replay_tile.c — feed a captured
packet stream into a topology for reproducible testing and benchmarking.
Loads the pcap at boot (each UDP payload = one raw txn), parses txns once
into dense trailer rows, then streams them at full ring rate exactly like
the synth tile; `repeat` loops the corpus for sustained-load benches.
Replay of the same corpus is bit-identical run to run (the payload stream
carries no timestamps; tsorig is stamped at publish for latency
measurement, not part of the payload)."""

from __future__ import annotations

import numpy as np

from ..ballet import txn as T
from ..disco.metrics import MetricsSchema
from ..disco.mux import MuxCtx, Tile, now_ts
from ..waltz import pcap

from . import wire


def corpus_to_pool(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """pcap -> (rows (n, LINK_MTU) u8, szs (n,) u16, tags (n,) u64).
    Unparseable payloads are dropped (counted by the tile)."""
    rows_l, szs_l, tags_l = [], [], []
    for _ts, payload in pcap.read_udp_payloads(path):
        desc = T.parse(payload)
        if desc is None:
            continue
        full = wire.append_trailer(payload, desc)
        row = np.zeros(wire.LINK_MTU, np.uint8)
        row[: len(full)] = np.frombuffer(full, np.uint8)
        rows_l.append(row)
        szs_l.append(len(full))
        tags_l.append(
            int.from_bytes(
                payload[desc.signature_off : desc.signature_off + 8], "little"
            )
        )
    rows = np.stack(rows_l) if rows_l else np.zeros((0, wire.LINK_MTU), np.uint8)
    return rows, np.asarray(szs_l, np.uint16), np.asarray(tags_l, np.uint64)


class ReplayTile(Tile):
    """Streams a pcap corpus; sig field = first 8 sig bytes (dedup tag)."""

    schema = MetricsSchema(counters=("published_txns", "corpus_txns"))

    def __init__(
        self,
        path: str,
        *,
        total: int | None = None,
        name: str = "replay",
    ):
        """Publish corpus entries in order, looping, up to `total` frags
        (None = one full pass)."""
        self.name = name
        self.path = path
        self.total = total
        self.sent = 0
        self.rows = self.szs = self.tags = None

    def on_boot(self, ctx: MuxCtx) -> None:
        self.rows, self.szs, self.tags = corpus_to_pool(self.path)
        ctx.metrics.inc("corpus_txns", len(self.rows))
        if self.total is None:
            self.total = len(self.rows)

    def after_credit(self, ctx: MuxCtx) -> None:
        budget = min(ctx.credits, self.total - self.sent)
        if budget <= 0 or not len(self.rows):
            return
        idx = np.arange(self.sent, self.sent + budget) % len(self.rows)
        ctx.publish(
            self.tags[idx], self.rows[idx], self.szs[idx],
            tsorigs=np.full(budget, now_ts(), np.uint32),
        )
        self.sent += budget
        ctx.metrics.inc("published_txns", budget)
