"""The generic tile run loop — the analog of fd_mux_tile.

A copy of firedancer_tpu/disco/mux.py for the port's thread runtime: the
Python frag path of `run_loop`, the per-link latency attribution and the
span-event trace points, and the post-HALT `drain_straggler_ins`.  Not
ported yet, and refused rather than ignored:
the native stem (`run_loop(stem="native")` raises NotImplementedError).
The hooks of modules the port does not have yet (fault injection, the
run-loop profiler, elastic shard maps) are left out; they come back with
those modules.

Reference model: src/disco/mux/fd_mux.c:90-707 — a loop interleaving
housekeeping events (heartbeat, flow-control publish/receive, metrics
flush, command-and-control), credit checks against the slowest reliable
consumer, and frag polling with overrun detection, invoking a tile's
callback vtable (fd_mux.h:115-260).

Callbacks are batch-first: one loop iteration drains up to `credits` frags
per in-link in ONE native call and hands the whole array to the tile,
which processes it with numpy/native code or ships it to the card.  The
Python interpreter executes O(1) work per batch, not per frag.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

from ..tango import rings as R
from ..tango import tempo
from .metrics import Metrics, MetricsSchema
from .trace import BP as _SPAN_BP
from .trace import HK as _SPAN_HK


class TileInterrupted(RuntimeError):
    """Raised inside a tile loop when its incarnation is abandoned (the
    ctx's `interrupt` event is set): the thread unwinds through the normal
    failure path (CNC_FAIL + fseq finalize)."""


def now_ts() -> int:
    """Frag timestamp: microseconds, truncated to the meta's u32 field
    (wraps every ~71 min; latency deltas use modular arithmetic like the
    reference's compressed tspub, fd_frag_meta_ts_comp)."""
    return (time.monotonic_ns() // 1000) & 0xFFFFFFFF


# -- wrap-safe compressed-timestamp arithmetic ------------------------------
#
# now_ts() values live on a u32 ring (2^32 µs ~ 71 min); a plain Python
# subtraction goes negative-garbage the first time the ring wraps mid-run.
# Every latency delta on frag timestamps must go through these helpers —
# the u32 analog of tango.rings.seq_diff, matching the reference's
# compressed-timestamp decompression (fd_frag_meta_ts_comp sign-extends the
# low bits against a reference clock, fd_tango_base.h).

_TS_MASK = 0xFFFFFFFF
_TS_HALF = 1 << 31


def ts_diff(a: int, b: int) -> int:
    """Signed µs distance a - b mod 2^32 (positive: a is after b).
    Valid while |true distance| < ~35.8 min (2^31 µs)."""
    d = (int(a) - int(b)) & _TS_MASK
    return d - (1 << 32) if d >= _TS_HALF else d


def ts_diff_arr(a, b) -> np.ndarray:
    """Vector ts_diff: i64 signed distances for u32 timestamp arrays."""
    with np.errstate(over="ignore"):
        d = np.asarray(a, np.uint32) - np.asarray(b, np.uint32)
    return d.astype(np.int64) - (
        (d >= np.uint32(_TS_HALF)).astype(np.int64) << 32
    )


#: per-in-link latency attribution hists, appended to every tile's
#: schema by the topology at build time (disco/topo.py): queue-wait =
#: consume-ts - upstream tspub, service = post-callback ts - consume-ts,
#: end-to-end = consume-ts - origin tsorig.  All in the compressed-µs
#: domain, all wrap-safe via ts_diff.
LINK_HIST_KINDS = ("qwait_us", "svc_us", "e2e_us")


def link_hist_names(link: str) -> tuple[str, ...]:
    return tuple(f"{k}_{link}" for k in LINK_HIST_KINDS)


@dataclass
class InLink:
    """This tile's consumer endpoint of one link."""

    name: str
    mcache: R.MCache
    dcache: R.DCache | None
    fseq: R.FSeq  # this consumer's progress backchannel
    reliable: bool = True
    seq: int = 0
    #: observability wiring (set by the topology at build time): the
    #: link's small-int id for span events, and this endpoint's per-link
    #: latency hist names — None when the ctx's metrics schema lacks
    #: them (hand-built tiles in unit tests), which disables recording
    link_id: int = 0
    h_qwait: str | None = None
    h_svc: str | None = None
    h_e2e: str | None = None

    def gather(self, frags: np.ndarray, width: int | None = None) -> np.ndarray:
        """Dense (n, width) u8 payload matrix for a drained frag batch."""
        assert self.dcache is not None
        w = width if width is not None else self.dcache.mtu
        return self.dcache.read_batch(frags["chunk"], frags["sz"], w)


@dataclass
class OutLink:
    """This tile's producer endpoint of one link (single producer)."""

    name: str
    mcache: R.MCache
    dcache: R.DCache | None
    consumer_fseqs: list[R.FSeq] = field(default_factory=list)  # reliable only
    seq: int = 0
    #: span-event wiring (topology build time); tracer None = tracing off
    link_id: int = 0
    tracer: object | None = None

    @property
    def depth(self) -> int:
        return self.mcache.depth

    def cr_avail(self) -> int:
        """Publishes safe without overrunning any reliable consumer
        (reference credit model: src/tango/fctl/fd_fctl.h)."""
        if not self.consumer_fseqs:
            return self.depth
        lo = min(f.query() for f in self.consumer_fseqs)
        return R.cr_avail(self.seq, lo, self.depth)

    def publish(
        self,
        sigs: np.ndarray,
        rows: np.ndarray | None = None,
        szs: np.ndarray | None = None,
        ctls: np.ndarray | None = None,
        tspub: int = 0,
        tsorigs: np.ndarray | None = None,
    ) -> int:
        """Batch-publish len(sigs) frags; payload rows are scattered into
        the dcache first when given.  Returns frags published.

        tspub defaults to now; pass tsorigs = in-frags' tsorig to carry
        origin timestamps through a relay tile (latency observability)."""
        n = len(sigs)
        if n == 0:
            return 0
        chunks = None
        if rows is not None:
            assert self.dcache is not None and szs is not None
            chunks = self.dcache.write_batch(rows, szs)
        if tspub == 0:
            tspub = now_ts()
        seq0 = self.seq
        # run_loop gates every callback round on cr_avail() across outs;
        # OutLink.publish is the one sanctioned wrapper under that gate
        self.seq = self.mcache.publish_batch(
            seq0, sigs, chunks, szs, ctls, tspub, tsorigs
        )
        if self.tracer is not None:
            self.tracer.publish(self.link_id, seq0, sigs, tspub, tsorigs)
        return n


class MuxCtx:
    """Per-tile run context handed to every callback."""

    def __init__(
        self,
        name: str,
        cnc: R.CNC,
        ins: list[InLink],
        outs: list[OutLink],
        metrics: Metrics,
        wksp: R.Workspace | None = None,
    ):
        self.name = name
        self.cnc = cnc
        self.ins = ins
        self.outs = outs
        self.metrics = metrics
        #: the topology's shared workspace — tiles allocate observable
        #: state (tcaches etc.) here
        self.wksp = wksp
        self.credits = 0  # refreshed by the loop before each callback round
        #: set to abandon this incarnation (the loop raises TileInterrupted)
        self.interrupt = threading.Event()
        #: span-event writer (disco/trace.py Tracer), installed by the
        #: topology when tracing is enabled; None keeps every trace
        #: point a single attribute check
        self.tracer = None
        #: counts incarnations so on_boot can distinguish join-vs-init of
        #: workspace state that must survive a crash (dedup's tcache)
        self.incarnation = 0
        #: True once the current incarnation's on_boot completed — lets
        #: the topology distinguish "died during boot" (raise at start)
        #: from "crashed after RUN" (fail-stop via poll_failure)
        self.booted = False
        self._local_allocs: dict[str, np.ndarray] = {}

    def out(self, name: str) -> OutLink:
        for o in self.outs:
            if o.name == name:
                return o
        raise KeyError(name)

    def alloc(self, name: str, footprint: int) -> np.ndarray:
        """Observable tile state: allocated in the shared workspace when
        the topology provides one, else process-local memory (standalone
        tile tests).

        Idempotent by name (Workspace.alloc's contract): a restarted
        incarnation re-running on_boot gets the SAME region back, so
        state that must survive a crash (dedup's tag cache) persists
        across restarts — the tile decides whether to re-init it or
        rejoin it via `ctx.incarnation`."""
        key = f"{self.name}_{name}"
        if self.wksp is not None:
            return self.wksp.alloc(key, footprint)
        buf = self._local_allocs.get(key)
        if buf is None:
            buf = self._local_allocs[key] = np.zeros(footprint, dtype=np.uint8)
        elif len(buf) != footprint:
            raise ValueError(
                f"realloc of {key!r} with footprint {footprint} != "
                f"existing {len(buf)}"
            )
        return buf

    def publish(self, sigs, rows=None, szs=None, ctls=None, tsorigs=None) -> int:
        """Publish to every out link (the common single-out case)."""
        n = 0
        for o in self.outs:
            n = o.publish(sigs, rows, szs, ctls, tsorigs=tsorigs)
        if n:
            self.metrics.inc("out_frags", n)
            if szs is not None:
                self.metrics.inc("out_bytes", int(np.asarray(szs).sum()))
        return n


class Tile:
    """Callback vtable, batch-first (reference: fd_mux_callbacks_t,
    src/disco/mux/fd_mux.h:115-260 — before/during/after_frag collapse
    into one on_frags batch callback here)."""

    name = "tile"
    schema = MetricsSchema()

    def wksp_footprint(self) -> int:
        """Bytes of shared-workspace state this tile allocates in on_boot
        (beyond links/metrics, which the topology accounts for itself)."""
        return 0

    def on_boot(self, ctx: MuxCtx) -> None: ...

    def on_frags(self, ctx: MuxCtx, in_idx: int, frags: np.ndarray) -> None:
        """A batch of frags arrived on ins[in_idx]."""

    def in_budget(self, ctx: MuxCtx) -> int | None:
        """Max in-frags this tile can absorb this iteration (None =
        unlimited).  Tiles with internal queues (async device dispatch)
        return 0 when full so upstream backpressure propagates through
        the rings instead of an unbounded host buffer."""
        return None

    def ack_floor(self, ctx: MuxCtx, in_idx: int) -> int | None:
        """Oldest ins[in_idx] frag seq this tile might still need, or
        None when everything consumed is flushed.  The loop publishes
        min(cursor, floor) as the fseq — so a tile holding consumed
        frags in an internal pipeline (async device dispatch) keeps the
        producer's credit gate protecting them in the ring until their
        results are published downstream.  The floor must be monotone
        between calls (it only advances as the pipeline flushes in frag
        order)."""
        return None

    def after_credit(self, ctx: MuxCtx) -> None:
        """Called every iteration after frag processing while credits
        remain — where producer tiles generate work (reference:
        after_credit, fd_mux.h)."""

    def during_housekeeping(self, ctx: MuxCtx) -> None: ...

    def on_halt(self, ctx: MuxCtx) -> None: ...


def drain_straggler_ins(
    tile: Tile,
    ctx: MuxCtx,
    *,
    only: tuple | None = None,
    budget: int | None = None,
    deadline_s: float | None = None,
    default_budget: int = 4096,
) -> int:
    """Post-HALT straggler drain (the pack tile's on_halt drains its bank
    completion rings with it): sweep the in-links through tile.on_frags
    with the standard overrun accounting (metered + fseq-diag'd), bounded
    per sweep by the outs' credit headroom.

    `only` restricts the sweep to those in-link indices; `budget`
    overrides the credit-derived bound.  With `deadline_s` the sweep
    repeats until a full pass drains nothing or the deadline passes;
    without it one sweep runs.  Returns frags drained by the final sweep."""
    deadline = (
        time.monotonic() + deadline_s if deadline_s is not None else None
    )
    got = 0
    while True:
        got = 0
        idxs = range(len(ctx.ins)) if only is None else only
        for i in idxs:
            il = ctx.ins[i]
            b = budget
            if b is None:
                b = min(
                    (o.cr_avail() for o in ctx.outs),
                    default=default_budget,
                )
            if b <= 0:
                break
            frags, il.seq, ovr = il.mcache.drain(il.seq, b)
            if ovr:
                ctx.metrics.inc("overrun_frags", ovr)
                il.fseq.diag_add(0, ovr)
            if len(frags):
                got += len(frags)
                tile.on_frags(ctx, i, frags)
        if deadline is None or got == 0 or time.monotonic() >= deadline:
            return got


def _publish_fseqs(tile: Tile, ctx: MuxCtx) -> None:
    """Publish every in-link's fseq at min(cursor, the tile's ack floor)."""
    for i, il in enumerate(ctx.ins):
        floor = tile.ack_floor(ctx, i)
        il.fseq.update(il.seq if floor is None else R.seq_min(floor, il.seq))


def run_loop(
    tile: Tile,
    ctx: MuxCtx,
    *,
    batch_max: int = 4096,
    lazy_ns: int | None = None,
    idle_sleep_s: float = 50e-6,
    idle_before_sleep: int = 32,
    stem: str | None = None,
) -> None:
    """Drive one tile until its cnc receives HALT (or on_boot/callbacks
    raise).  Mirrors the fd_mux_tile phase structure: housekeeping →
    credit receive → frag drain → callbacks → idle backoff.

    Housekeeping cadence is time-based via tango.tempo: the interval
    derives from the smallest ring depth (lazy_default) and each firing
    re-arms at a jittered point (async_reload) so tiles decorrelate.

    stem: None or "python" (the only loop the port has); "native" raises
    NotImplementedError until the native stem is ported."""
    if stem not in (None, "python"):
        raise NotImplementedError(
            f"stem={stem!r}: the port has the Python frag path only (the "
            f"native stem is not ported yet)"
        )
    m = ctx.metrics
    cnc = ctx.cnc
    tracer = ctx.tracer
    try:
        tile.on_boot(ctx)
    except Exception:
        # boot failures must still be visible on the cnc (the topology's
        # boot-wait keys off FAIL, not thread liveness)
        cnc.signal(R.CNC_FAIL)
        raise
    ctx.booted = True
    m.set("stem_engaged", 0)
    cnc.signal(R.CNC_RUN)
    if lazy_ns is None:
        depths = [il.mcache.depth for il in ctx.ins] + [
            o.depth for o in ctx.outs
        ]
        lazy_ns = tempo.lazy_default(min(depths) if depths else batch_max)
    next_hk = 0  # fire immediately on the first iteration
    idle = 0
    iters = 0
    try:
        while True:
            if ctx.interrupt.is_set():
                raise TileInterrupted(f"{ctx.name}: abandoned")
            now = time.monotonic_ns()
            # phase durations are histogram-sampled every 16th iteration
            # (the reference histograms every phase, fd_mux.c:435-444; a
            # 1/16 sample keeps the Python-side cost negligible while
            # preserving the distribution)
            sample = (iters & 0xF) == 0
            iters += 1
            if now >= next_hk:
                next_hk = now + tempo.async_reload(lazy_ns)
                cnc.heartbeat(now)
                _publish_fseqs(tile, ctx)
                m.inc("housekeep_iters")
                if cnc.signal_query() == R.CNC_HALT:
                    break
                tile.during_housekeeping(ctx)
                if sample:
                    hk_ns = time.monotonic_ns() - now
                    m.hist_sample("hk_ns", hk_ns)
                    if tracer is not None:
                        tracer.point(_SPAN_HK, aux64=hk_ns)
            m.inc("loop_iters")

            cr = batch_max
            for o in ctx.outs:
                cr = min(cr, o.cr_avail())
            if ctx.outs and cr == 0:
                m.inc("backpressure_iters")
                if tracer is not None and idle == 0:
                    # one BP span per streak start (per-iteration
                    # events would flood the ring with no new info)
                    tracer.point(_SPAN_BP)
                idle += 1
                if idle >= idle_before_sleep:
                    time.sleep(idle_sleep_s)
                continue
            ctx.credits = cr

            out_seq0 = [o.seq for o in ctx.outs]
            got = 0
            t_frag0 = time.monotonic_ns() if sample else 0
            absorb = tile.in_budget(ctx)
            # rotate the drain order so a saturated in-link cannot starve
            # the others of the shared credit budget
            n_ins = len(ctx.ins)
            order = range(n_ins) if n_ins <= 1 else [
                (iters + j) % n_ins for j in range(n_ins)
            ]
            for i in order:
                il = ctx.ins[i]
                # credits are consumed across in-links: a tile republishes
                # at most 1 out-frag per in-frag, so bounding the remaining
                # drain budget by frags already taken this iteration keeps
                # total publishes <= cr even with many in-links
                budget = cr - got
                if absorb is not None:
                    budget = min(budget, absorb - got)
                if budget <= 0:
                    break
                frags, il.seq, ovr = il.mcache.drain(il.seq, budget)
                if ovr:
                    m.inc("overrun_frags", ovr)
                    il.fseq.diag_add(0, ovr)
                if not len(frags):
                    continue
                got += len(frags)
                m.inc("in_frags", len(frags))
                m.inc("in_bytes", int(frags["sz"].sum()))
                m.hist_sample("batch_sz", len(frags))
                # per-hop latency attribution on the compressed-µs clock,
                # per drained batch: queue-wait behind the upstream
                # publish, end-to-end from the origin stamp, and batch
                # service time after the callback
                t_cons = 0
                if il.h_qwait is not None:
                    t_cons = now_ts()
                    m.hist_sample_many(
                        il.h_qwait,
                        np.maximum(ts_diff_arr(t_cons, frags["tspub"]), 0),
                    )
                    m.hist_sample_many(
                        il.h_e2e,
                        np.maximum(ts_diff_arr(t_cons, frags["tsorig"]), 0),
                    )
                if tracer is not None:
                    tracer.ingest(il.link_id, frags, t_cons or now_ts())
                m.inc("py_frags", len(frags))
                tile.on_frags(ctx, i, frags)
                if il.h_svc is not None:
                    m.hist_sample(il.h_svc, max(ts_diff(now_ts(), t_cons), 0))
            ctx.credits = cr - got
            m.inc("py_credit")
            if sample:
                t_credit0 = time.monotonic_ns()
                if got:
                    m.hist_sample("frag_ns", t_credit0 - t_frag0)
                tile.after_credit(ctx)
                t_end = time.monotonic_ns()
                m.hist_sample("credit_ns", t_end - t_credit0)
                m.hist_sample("loop_ns", t_end - now)
            else:
                tile.after_credit(ctx)

            produced = any(o.seq != s0 for o, s0 in zip(ctx.outs, out_seq0))
            if got == 0 and not produced:
                idle += 1
                if idle >= idle_before_sleep:
                    time.sleep(idle_sleep_s)
            else:
                idle = 0
    except Exception:
        cnc.signal(R.CNC_FAIL)
        raise
    finally:
        # crash finalize honors the ack floor: frags still in the
        # tile's internal pipeline stay producer-protected in the ring
        _publish_fseqs(tile, ctx)
        if cnc.signal_query() != R.CNC_FAIL:
            tile.on_halt(ctx)
            # on_halt flushed the pipeline: republish so a completed drain
            # finalizes at the consumed cursor
            _publish_fseqs(tile, ctx)
            cnc.signal(R.CNC_BOOT)  # halt acknowledged (reference protocol)
