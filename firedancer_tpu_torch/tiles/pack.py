"""Pack tile: buffers verified txns and schedules microblocks to banks.

A copy of firedancer_tpu/tiles/pack.py for the thread runtime: `mb_encode`,
`mb_decode` and `PackTile` with its insert, completion, halt-drain and
after-credit scheduling paths over the port's pack engine (ballet/pack.py).
With `use_device_select` the engine's greedy prefilter runs on `device`
(default: the CUDA card, through the hand-written kernel
csrc/pack_select.cu; "cpu" runs the plain version) through the tile's own
`ops/pack_select.Selector`: pinned staging and device buffers sized for
`scan_limit` candidates, one copy each way on a high-priority stream of
its own; a CUDA select that fails to build, launch or copy raises, it
never falls back to the host order.
Not carried: the native stem's fast path (`native_handler`, the
fdt_pack_sched after-credit hook) and elastic bank membership
(`on_epoch`; the port's `Topology.declare_shards` raises).

Reference model: src/app/fdctl/run/tiles/fd_pack.c — during_frag inserts
incoming txns into the pack engine; after_credit, when a bank is free and
the microblock cadence (<= 2ms, MICROBLOCK_DURATION_NS fd_pack.c:26) has
elapsed, emits fd_pack_schedule_next_microblock's output to that bank's
ring and tracks completion via the bank-busy backchannel.

Here the completion backchannel is a reliable bank→pack ring carrying
(bank, handle) frags.  Ingress inserts are BATCHED: one fdt_txn_scan over
the drained frag batch then a vectorized slot scatter — no per-txn Python
on the hot path.

Divergence from the reference, by design: `mb_inflight` microblocks may
be outstanding per bank (the reference keeps one per bank tile and relies
on dedicated cores; on a shared-core host the pack→bank→pack round-trip
latency is scheduling-bound, so pipelining depth — not parallel cores —
is what keeps the banks saturated).  Account locks are held per
microblock exactly as in the reference, so conflict safety is unchanged.

Microblock wire format (one frag per microblock on the pack_bank link):
    [ u32 handle | u16 bank | u16 txn_cnt | txn_cnt * ( u16 sz | sz bytes ) ]
"""

from __future__ import annotations

import functools
import time

import numpy as np

from ..ballet import pack as P
from ..disco.metrics import MetricsSchema
from ..disco.mux import MuxCtx, Tile, drain_straggler_ins
from ..tango import rings as R
from ..tango import tempo
from . import wire

MICROBLOCK_DURATION_NS = 2_000_000  # reference cadence: fd_pack.c:26
MB_HDR = 8


def mb_encode(
    handle: int, bank: int, rows: np.ndarray, szs: np.ndarray,
    idx: np.ndarray | None = None,
) -> np.ndarray:
    """Native microblock encode.  idx selects rows (e.g. pool slots);
    None encodes every row in order."""
    szs16 = np.ascontiguousarray(szs, np.uint16)
    if idx is None:
        idx = np.arange(len(szs16), dtype=np.int64)
    idx = np.ascontiguousarray(idx, np.int64)
    n = len(idx)
    total = MB_HDR + int(szs16[idx].sum()) + 2 * n
    out = np.zeros(total, dtype=np.uint8)
    got = R._lib.fdt_mb_encode(
        np.ascontiguousarray(rows).ctypes.data, rows.shape[1],
        szs16.ctypes.data, idx.ctypes.data, n, handle, bank,
        out.ctypes.data, total,
    )
    if got != total:
        raise RuntimeError(f"fdt_mb_encode wrote {got} of {total} bytes")
    return out


def mb_decode(buf: np.ndarray):
    """-> (handle, bank, [txn payload views])."""
    handle = int(buf[0:4].view("<u4")[0])
    bank = int(buf[4:6].view("<u2")[0])
    n = int(buf[6:8].view("<u2")[0])
    txns = []
    off = MB_HDR
    for _ in range(n):
        sz = int(buf[off : off + 2].view("<u2")[0])
        txns.append(buf[off + 2 : off + 2 + sz])
        off += 2 + sz
    return handle, bank, txns


class PackTile(Tile):
    """ins[0] = dedup_pack txns; ins[1..] = bank completion rings;
    outs[i] = pack_bank ring for bank i."""

    schema = MetricsSchema(
        counters=(
            "inserted_txns",
            "insert_rejected",
            "microblocks",
            "microblock_txns",
            "completions",
            "blocks",
            # completion whose (bank, handle) is no longer outstanding:
            # a metered drop, never a crash
            "stale_completions",
        ),
    )

    def __init__(
        self,
        n_banks: int,
        *,
        depth: int = 4096,
        cu_limit: int = 1_500_000,
        txn_limit: int = 31,
        mb_inflight: int = 1,
        microblock_ns: int = MICROBLOCK_DURATION_NS,
        slot_ns: int = 400_000_000,
        use_device_select: bool = False,
        device=None,
        name: str = "pack",
    ):
        """slot_ns: block-budget rollover period.  The reference resets
        pack's block/vote/writer budgets at leader-slot boundaries
        (fd_pack_end_block); this tile approximates the slot clock with
        wall time at the mainnet slot duration — without the rollover the
        48M-CU block budget is consumed exactly once and scheduling
        stops forever.

        mb_inflight: outstanding microblocks per bank (pipelining depth;
        see the module docstring).  use_device_select runs the engine's
        prefilter on `device` (None: the CUDA card, raising "no CUDA
        device" on a host without one; "cpu": the plain version)."""
        self.name = name
        self.n_banks = n_banks
        self.cu_limit = cu_limit
        self.txn_limit = txn_limit
        self.mb_inflight = mb_inflight
        self.microblock_ns = microblock_ns
        self.slot_ns = slot_ns
        self.engine = P.Pack(depth, max_banks=n_banks)
        #: scheduling policy knobs (schedule_microblock defaults)
        self.vote_fraction = 0.25
        self.scan_limit = 1024
        # per-bank busy counts and cadence gates.  Per-BANK cadence, as in
        # the reference (fd_pack.c:193 sets bank_ready_at[i] = now +
        # MICROBLOCK_DURATION_NS per bank) — a global gate would cap the
        # whole tile at 1/cadence regardless of bank count.
        self.bank_busy = np.zeros(n_banks, np.int64)
        self._bank_ready_at = np.zeros(n_banks, np.int64)
        #: block-budget rollover deadline (0 = unarmed); armed on first use
        self._block_deadline = np.zeros(1, np.int64)
        self._byte_limit = 0  # derived from the out-ring MTU at boot
        self._dev_select = None
        self._selector = None
        if use_device_select:
            from ..ops import pack_select

            self._selector = pack_select.Selector(
                self.scan_limit, self.engine.W, device
            )
            self._dev_select = functools.partial(
                pack_select.select_noconflict, selector=self._selector
            )

    def on_boot(self, ctx: MuxCtx) -> None:
        if self._selector is not None:
            # build the kernel, pin the buffers and make the stream at boot,
            # not inside the first schedule call
            self._selector.ready()
        if ctx.outs and ctx.outs[0].dcache is not None:
            # the encoded microblock must fit one frag on the bank ring
            # (frag sz is u16): headroom below both the dcache MTU and
            # the meta field's ceiling
            self._byte_limit = min(ctx.outs[0].dcache.mtu, 0xFFFF) - MB_HDR

    def on_frags(self, ctx: MuxCtx, in_idx: int, frags: np.ndarray) -> None:
        if in_idx == 0:
            rows = ctx.ins[0].gather(frags)
            # payload sizes: frag sz minus the 16-byte wire trailer
            szs = np.maximum(
                frags["sz"].astype(np.int64) - wire.TRAILER_SZ, 0
            ).astype(np.uint32)
            scan = P.txn_scan(
                rows, szs, nbits=self.engine.nbits, with_bitsets=True
            )
            # dedup tags ride the frag sig field; keep them as sig_tag
            scan.tags[:] = frags["sig"]
            n_ok = self.engine.insert_batch(rows, szs, scan=scan)
            ctx.metrics.inc("inserted_txns", n_ok)
            if n_ok != len(rows):
                ctx.metrics.inc("insert_rejected", len(rows) - n_ok)
        else:
            # completion ring: sig field carries (bank << 32) | handle
            for sig in frags["sig"]:
                bank = int(sig) >> 32
                handle = int(sig) & 0xFFFFFFFF
                try:
                    self.engine.microblock_complete(bank, handle)
                except KeyError:
                    ctx.metrics.inc("stale_completions")
                    continue
                self.bank_busy[bank] -= 1
                ctx.metrics.inc("completions")

    def on_halt(self, ctx: MuxCtx) -> None:
        # drain straggler bank completions so a run's final microblocks
        # release their locks and the completion counters settle (banks
        # publish their last completions right up to HALT)
        if len(ctx.ins) <= 1:
            return
        comp_ins = tuple(range(1, len(ctx.ins)))
        deadline = time.monotonic() + 1.0
        while True:
            got = drain_straggler_ins(self, ctx, only=comp_ins, budget=4096)
            if self.engine.outstanding_cnt == 0:
                break
            if got == 0:
                if time.monotonic() >= deadline:
                    break
                time.sleep(1e-3)

    def after_credit(self, ctx: MuxCtx) -> None:
        # loop-body clock reads go through the tick source
        now = tempo.tickcount()
        if self._block_deadline[0] == 0:
            self._block_deadline[0] = now + self.slot_ns
        elif now >= self._block_deadline[0]:
            # block boundary: stop scheduling and let in-flight
            # microblocks complete, then reset the block budgets
            # (end_block requires no outstanding microblocks)
            if self.engine.outstanding_cnt:
                return
            self.engine.end_block()
            self._block_deadline[0] = now + self.slot_ns
            ctx.metrics.inc("blocks")
        for bank in range(self.n_banks):
            if now < self._bank_ready_at[bank]:
                continue
            if self.bank_busy[bank] >= self.mb_inflight:
                continue
            out = ctx.outs[bank]
            if out.cr_avail() < 1:
                continue
            mb = self.engine.schedule_microblock(
                bank,
                cu_limit=self.cu_limit,
                txn_limit=self.txn_limit,
                vote_fraction=self.vote_fraction,
                scan_limit=self.scan_limit,
                byte_limit=self._byte_limit,
                device_select=self._dev_select,
            )
            if mb is None:
                continue
            # encode straight from the pool (no row gather copy)
            idx = mb.txn_idx
            payload = mb_encode(
                mb.handle, bank, self.engine.rows, self.engine.szs, idx=idx
            )
            out.publish(
                np.array([(bank << 32) | mb.handle], dtype=np.uint64),
                payload[None, :],
                np.array([len(payload)], dtype=np.uint16),
            )
            self.bank_busy[bank] += 1
            self._bank_ready_at[bank] = now + self.microblock_ns
            ctx.metrics.inc("microblocks")
            ctx.metrics.inc("microblock_txns", len(idx))
