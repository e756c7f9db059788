"""Bank tile: executes scheduled microblocks and reports completion.

A copy of firedancer_tpu/tiles/bank.py's funk-less path for the thread
runtime: the fee-only executor (`execute_txns`), the native microblock
decode (`_decode` on fdt_mb_decode), `_execute` with no executor,
`on_frags` and the metric names.  A bank backed by funk (`funk=`; the
shared account table, its undo journal and the batched commit) raises
NotImplementedError until flamenco/ and funk/ are ported; so does the
native stem's fast path, which the port does not have.

Reference model: src/app/fdctl/run/tiles/fd_bank.c — receives microblocks
from pack, executes them (in the reference via Rust FFI into Agave:
fd_ext_bank_load_and_execute_txns, fd_bank.c:100-104), flags itself free
through the busy fseq, and forwards the executed microblock to the poh
tile for mixin.

Completion travels as a frag on the bank→pack ring (sig = bank<<32 |
handle); the executed microblock is forwarded on the bank→poh ring.
A malformed microblock is a metered drop (`malformed_microblocks`) that
still frees the bank at pack — one bad frag must not take the bank down.
"""

from __future__ import annotations

import numpy as np

from ..ballet import compute_budget as CB
from ..ballet import txn as T
from ..disco.metrics import MetricsSchema
from ..disco.mux import MuxCtx, Tile
from ..tango import rings as R


def execute_txns(txns: list[np.ndarray]) -> int:
    """Fee-only executor.  Returns lamports collected."""
    fees = 0
    for t in txns:
        d = T.parse(bytes(t))
        if d is None:
            continue
        fees += CB.FEE_PER_SIGNATURE * d.signature_cnt
    return fees


class BankTile(Tile):
    """ins[0] = pack_bank microblocks; outs[0] = bank_pack completions,
    outs[1] = bank_poh executed microblocks."""

    schema = MetricsSchema(
        counters=(
            "executed_microblocks",
            "executed_txns",
            "failed_txns",
            "fast_txns",
            "fees_lamports",
            "malformed_microblocks",
            "native_txns",
            "committed_accounts",
        ),
    )

    def __init__(self, bank_id: int, name: str | None = None, *, funk=None):
        if funk is not None:
            raise NotImplementedError(
                "funk-backed banks are not ported yet (flamenco/runtime.py, "
                "funk/): the port's bank is the fee-only executor"
            )
        self.bank_id = bank_id
        self.name = name or f"bank{bank_id}"
        # native-decode scratch (grown on demand)
        self._srows = np.zeros((256, T.MTU), np.uint8)
        self._sszs = np.zeros(256, np.uint32)

    def _decode(self, buf: np.ndarray):
        """Native microblock decode -> (rows view, szs view) scratch, or
        None on a malformed microblock (metered drop at the caller)."""
        if len(buf) < 8:
            return None
        n = int(buf[6:8].view("<u2")[0])
        if n > len(self._sszs):
            cap = 1 << (n - 1).bit_length()
            self._srows = np.zeros((cap, T.MTU), np.uint8)
            self._sszs = np.zeros(cap, np.uint32)
        got = R._lib.fdt_mb_decode(
            np.ascontiguousarray(buf).ctypes.data, len(buf),
            self._srows.ctypes.data, self._srows.shape[1],
            self._sszs.ctypes.data, len(self._sszs),
        )
        if got != n:
            return None
        return self._srows[:n], self._sszs[:n]

    def _execute(self, rows: np.ndarray, szs: np.ndarray) -> int:
        """Execute one decoded microblock; returns fees collected."""
        return execute_txns([rows[i, : szs[i]] for i in range(len(rows))])

    def on_frags(self, ctx: MuxCtx, in_idx: int, frags: np.ndarray) -> None:
        il = ctx.ins[in_idx]
        rows = il.gather(frags)
        for i in range(len(rows)):
            buf = rows[i, : frags["sz"][i]]
            handle = int(buf[0:4].view("<u4")[0])
            bank = int(buf[4:6].view("<u2")[0])
            if bank != self.bank_id:
                raise RuntimeError(
                    f"{self.name}: microblock for bank {bank} on bank "
                    f"{self.bank_id}'s ring"
                )
            tag = np.array([(bank << 32) | handle], dtype=np.uint64)
            dec = self._decode(buf)
            if dec is None:
                # malformed microblock: metered drop — but the bank MUST
                # still complete at pack or its handle and account locks
                # leak; nothing is forwarded to poh
                ctx.metrics.inc("malformed_microblocks")
                ctx.outs[0].publish(tag)
                continue
            trows, tszs = dec
            fees = self._execute(trows, tszs)
            ctx.metrics.inc("executed_microblocks")
            ctx.metrics.inc("executed_txns", len(trows))
            ctx.metrics.inc("fees_lamports", fees)
            # forward to poh first, then free the bank at pack
            ctx.outs[1].publish(
                tag, buf[None, :], np.array([len(buf)], dtype=np.uint16)
            )
            ctx.outs[0].publish(tag)
