"""The generic tile run loop — the analog of fd_mux_tile.

A copy of firedancer_tpu/disco/mux.py for the port's thread and process
runtimes: the Python frag path of `run_loop` (with the manual-credit gate
of a ring cycle, `Tile.manual_credits`), the native stem's branch
(`run_loop(stem="native")`: a tile's `native_handler` runs whole bursts in
one GIL-released fdt_stem_run call, with `_arm_stem_trace` and
`_stem_apply`), the per-link latency attribution and the span-event trace
points, the run-loop profiler's hooks (`MuxCtx.profiler`:
disco/profile.py's phase wall and thread CPU on the 1-in-16 sampled
iterations, the housekeeping lag and the idle sleeps; a stem burst is
timed inside the frag phase), the post-HALT `drain_straggler_ins`, the
topology-wide shared regions (`MuxCtx.shared`,
`Tile.shared_wksp_footprints`), and the process runtime's side of a tile
(`Tile.proc_safe`, and `MuxCtx.arena`, the child's shm sub-allocator
that `MuxCtx.alloc` goes through).  The hooks of modules the port does
not have yet (fault injection and its consult points, elastic shard maps
and the stem's epoch watch) are left out; they come back with those
modules.

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
        #: process runtime: a tile-private shm sub-allocator
        #: (tango.rings.WkspArena) that replaces direct workspace
        #: allocation — an ATTACHED workspace cannot allocate (the bump
        #: cursor is host-side state two children would race), so each
        #: child carves its own pre-sized arena instead.  None in the
        #: thread runtime.
        self.arena = None
        self.credits = 0  # refreshed by the loop before each callback round
        #: set to abandon this incarnation (the loop raises TileInterrupted)
        self.interrupt = threading.Event()
        #: span-event writer (disco/trace.py Tracer), installed by the
        #: topology when tracing is enabled; None keeps every trace
        #: point a single attribute check
        self.tracer = None
        #: run-loop profiler (disco/profile.py TileProfiler), installed
        #: by the topology when profiling is enabled; None keeps every
        #: profile point a single attribute check
        self.profiler = None
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
        rejoin it via `ctx.incarnation`.  In the process runtime the
        allocation comes from the tile's own shm arena (same idempotent
        contract; WkspArena keeps the name table in shared memory so the
        parent and monitors resolve the region by name)."""
        key = f"{self.name}_{name}"
        if self.arena is not None:
            return self.arena.alloc(key, footprint)
        if self.wksp is not None:
            return self.wksp.alloc(key, footprint)
        return self._local_alloc(key, footprint)

    def _local_alloc(self, key: str, footprint: int) -> np.ndarray:
        """Process-local fallback buffer for workspace-less ctx
        (standalone tile tests): idempotent by key, footprint-checked."""
        buf = self._local_allocs.get(key)
        if buf is None:
            buf = self._local_allocs[key] = np.zeros(footprint, dtype=np.uint8)
        elif len(buf) != footprint:
            raise ValueError(
                f"realloc of {key!r} with footprint {footprint} != "
                f"existing {len(buf)}"
            )
        return buf

    def shared(self, name: str, footprint: int) -> np.ndarray:
        """A topology-WIDE shared region: every tile asking for `name`
        gets the SAME memory (the QUIC tile's `shed` region), unlike
        alloc(), which is namespaced per tile.

        The region must be declared via Tile.shared_wksp_footprints()
        so the topology budgets and allocates it once at build;
        Workspace.alloc is idempotent by name, so this call resolves that
        allocation.  Standalone ctx (no workspace): a process-local
        buffer, so direct tile tests still run."""
        key = f"shared_{name}"
        if self.wksp is not None:
            return self.wksp.alloc(key, footprint)
        return self._local_alloc(key, footprint)

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

    #: a manual-credit tile gates each publish on that ring's own
    #: cr_avail() instead of the loop's min-over-all-outs gate.  Needed
    #: when two tiles form a request/response ring CYCLE (shred <->
    #: keyguard): the global gate would stop the tile entirely when one
    #: out ring fills, so it could never drain the response ring that
    #: unblocks the peer — a deadlock.  Manual tiles must bound their
    #: internal queues via in_budget.
    manual_credits = False

    #: False = this tile stays a THREAD in the parent even under the
    #: process runtime (Topology(runtime="process")).  Observer tiles
    #: that close over parent-side state (the metric tile's registry
    #: callable, the rpc tile's counter lambdas) are the intended users:
    #: they only READ shared memory, so keeping them in the parent loses
    #: no isolation, while their closures could never ride a spawn
    #: pickle.  Pipeline tiles must pickle: their constructors hold no
    #: thread, lock, ctypes handle or CUDA tensor (on_boot makes those,
    #: in the child).
    proc_safe = True

    def wksp_footprint(self) -> int:
        """Bytes of shared-workspace state this tile allocates in on_boot
        (beyond links/metrics, which the topology accounts for itself)."""
        return 0

    def shared_wksp_footprints(self) -> dict[str, int]:
        """Topology-WIDE shared regions this tile joins via
        ctx.shared(name, footprint): {name: footprint}.  The topology
        allocates each named region ONCE at build (tiles naming the same
        region must agree on its footprint)."""
        return {}

    def on_boot(self, ctx: MuxCtx) -> None: ...

    def native_handler(self, ctx: MuxCtx) -> "R.StemSpec | None":
        """Opt into the native stem (tango/native/fdt_stem.c): return a
        tango.rings.StemSpec describing this tile's native frag handler
        and the run loop under stem="native" drains, handles and
        publishes whole bursts in ONE GIL-released call, returning to
        Python only at burst boundaries.  Called once, after on_boot
        (handler state pointers must exist).

        None (the default) keeps the Python on_frags loop — the
        bit-identical reference semantics, and the path every frag the
        native handler cannot express is handed back to.  Everything the
        handler touches lives in the args block's native memory."""
        return None

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


def _arm_stem_trace(stem, ctx, m, tracer) -> bool:
    """Arm the native in-burst trace (tango/native/fdt_trace.c) on a
    freshly built stem: wire the tile's per-in-link latency hists and its
    span ring into the stem's trace block, so per-frag drain/publish timestamps, qwait/svc/e2e hist
    updates and span emission all happen INSIDE the GIL-released burst.
    Returns False when the ctx has neither link hists nor a tracer; the
    stem then runs untraced and _stem_apply keeps the burst-boundary
    bookkeeping for whatever hists exist."""
    in_rows = []
    any_h = False
    for il in ctx.ins:
        if il.h_qwait is not None:
            any_h = True
            in_rows.append((il.link_id, m.hist_ref(il.h_qwait),
                            m.hist_ref(il.h_e2e), m.hist_ref(il.h_svc)))
        else:
            in_rows.append((il.link_id, None, None, None))
    ring_addr = 0
    sample = 1
    if tracer is not None:
        ring_addr = tracer.ring.words.ctypes.data
        sample = tracer.sample
    if not any_h and not ring_addr:
        return False
    batch = m.hist_ref("batch_sz") if "batch_sz" in m.schema.hists else None
    stem.arm_trace(
        ring_addr=ring_addr,
        sample=sample,
        in_rows=in_rows,
        out_links=[ol.link_id for ol in ctx.outs],
        batch_hist=batch,
        keepalive=(m.words, None if tracer is None else tracer.ring.words),
    )
    return True


def _stem_apply(ctx, m, stem, spec, tracer, out_seq0, tspub,
                trace_native=False) -> int:
    """Burst-boundary bookkeeping for one native stem call: the stem
    accumulated counter deltas, drained-frag metas and published-sig
    scratch in native memory; apply them to the metrics ONCE per burst
    (the batched per-frag-update contract).

    With the in-burst trace armed (trace_native) this slims to the
    counters: hists and span events were already written per frag inside
    the burst.  Unarmed, the latency hists are applied with the
    post-burst clock, where qwait/e2e carry up to one burst of skew.
    Returns total frags consumed by the burst."""
    total = 0
    for i, il in enumerate(ctx.ins):
        ovr = stem.overruns(i)
        if ovr:
            m.inc("overrun_frags", ovr)
            il.fseq.diag_add(0, ovr)
        n = stem.consumed(i)
        if not n:
            continue
        total += n
        m.inc("in_frags", n)
        m.inc("in_bytes", stem.in_bytes(i))
        if trace_native:
            continue
        m.hist_sample("batch_sz", n)
        frags = stem.frags(i)
        t_cons = 0
        if il.h_qwait is not None:
            t_cons = now_ts()
            m.hist_sample_many(
                il.h_qwait, np.maximum(ts_diff_arr(t_cons, frags["tspub"]), 0)
            )
            m.hist_sample_many(
                il.h_e2e, np.maximum(ts_diff_arr(t_cons, frags["tsorig"]), 0)
            )
            m.hist_sample(il.h_svc, max(ts_diff(t_cons, tspub), 0))
        if tracer is not None:
            tracer.ingest(il.link_id, frags, t_cons or now_ts())
    for o, ol in enumerate(ctx.outs):
        p = stem.published(o)
        if not p:
            continue
        m.inc("out_frags", p)
        m.inc("out_bytes", stem.out_bytes(o))
        if ol.tracer is not None and not trace_native:
            ol.tracer.publish(ol.link_id, out_seq0[o], stem.out_sigs(o),
                              tspub, stem.out_tsorigs(o))
    ctrs = stem.counters
    for idx, name in enumerate(spec.counters):
        v = int(ctrs[idx])
        if v:
            m.inc(name, v)
    if total and spec.after_burst is not None:
        spec.after_burst(ctx, ctrs)
    return total


def _make_stem(tile: Tile, ctx: MuxCtx, batch_max: int):
    """The tile's native stem under stem="native", or (None, None) when it
    registers no handler.  A manual-credit tile (shred <-> keyguard ring
    cycle) engages the stem ONLY when its spec declares the manual
    discipline (handlers never publish from the frag path; the
    after-credit hook gates each ring on its own cr_avail).  A shape the
    stem cannot describe (> 8 ins / outs, > 4 reliable consumers an out)
    keeps the Python loop, as in the JAX package; a library that fails to
    build or load raises."""
    spec = tile.native_handler(ctx)
    if spec is None or (tile.manual_credits and not spec.manual):
        return None, None
    try:
        return R.Stem(ctx.ins, ctx.outs, spec, cap=batch_max), spec
    except ValueError:
        return None, None


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

    stem: None or "python" runs the Python frag path; "native" engages the
    tile's native handler (Tile.native_handler) when it registers one:
    each iteration then runs one GIL-released burst, and falls back to the
    Python drain only when the burst hands back (a frag or a hook the
    handler cannot express) or the handler's `ready` gate is closed."""
    if stem not in (None, "python", "native"):
        raise ValueError(f"unknown stem mode {stem!r} (python|native)")
    m = ctx.metrics
    cnc = ctx.cnc
    tracer = ctx.tracer
    # run-loop profiler (disco/profile.py): wall/CPU phase attribution and
    # scheduler lag on the SAME 1-in-16 sampled iterations as the phase
    # hists; None costs one attribute check per hook point
    prof = ctx.profiler
    idle_sleep_ns = int(idle_sleep_s * 1e9)
    try:
        tile.on_boot(ctx)
        stem_obj, stem_spec = (
            _make_stem(tile, ctx, batch_max) if stem == "native"
            else (None, None)
        )
    except Exception:
        # boot failures (a refused native handler included) must still be
        # visible on the cnc (the topology's boot-wait keys off FAIL, not
        # thread liveness)
        cnc.signal(R.CNC_FAIL)
        raise
    ctx.booted = True
    stem_trace = (
        stem_obj is not None and _arm_stem_trace(stem_obj, ctx, m, tracer)
    )
    m.set("stem_engaged", 1 if stem_obj is not None else 0)
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
            p_cpu0 = (
                time.thread_time_ns() if prof is not None and sample else 0
            )
            p_sleep = 0  # voluntary sleep inside this iteration (ns)
            iters += 1
            if now >= next_hk:
                # scheduler lag: how far past the INTENDED firing point the
                # loop actually got here (GIL/scheduler contention seen
                # from the time-based cadence's side)
                hk_lag_ns = now - next_hk if next_hk else 0
                next_hk = now + tempo.async_reload(lazy_ns)
                cnc.heartbeat(now)
                _publish_fseqs(tile, ctx)
                m.inc("housekeep_iters")
                if cnc.signal_query() == R.CNC_HALT:
                    break
                tile.during_housekeeping(ctx)
                if prof is not None:
                    if hk_lag_ns:
                        prof.sched_lag(hk_lag_ns)
                    if sample:
                        prof.add_phase(
                            "hk",
                            time.monotonic_ns() - now,
                            time.thread_time_ns() - p_cpu0,
                        )
                if sample:
                    hk_ns = time.monotonic_ns() - now
                    m.hist_sample("hk_ns", hk_ns)
                    if tracer is not None:
                        tracer.point(_SPAN_HK, aux64=hk_ns)
            m.inc("loop_iters")

            cr = batch_max
            if not tile.manual_credits:
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
                    if prof is None:
                        time.sleep(idle_sleep_s)
                    else:
                        t0s = time.monotonic_ns()
                        time.sleep(idle_sleep_s)
                        p_sleep = time.monotonic_ns() - t0s
                        prof.add_sleep(p_sleep, idle_sleep_ns)
                if prof is not None and sample:
                    end = time.monotonic_ns()
                    prof.add_bp(max(end - now - p_sleep, 0))
                    prof.add_iter(
                        end - now, time.thread_time_ns() - p_cpu0, p_sleep
                    )
                continue
            ctx.credits = cr

            out_seq0 = [o.seq for o in ctx.outs]
            got = 0
            t_frag0 = time.monotonic_ns() if sample else 0
            p_cpu_frag0 = (
                time.thread_time_ns() if prof is not None and sample else 0
            )
            absorb = tile.in_budget(ctx)
            run_py = True
            # run_ac: whether THIS iteration calls the Python after_credit.
            # A spec with a native after-credit hook schedules inside the
            # burst, so the Python slot is skipped except on PYTHON
            # handbacks (end_block, eviction, a slot boundary)
            run_ac = True
            if (
                stem_obj is not None
                and absorb is None
                and (stem_spec.ready is None or stem_spec.ready())
            ):
                # one GIL-released burst: drain + handle + publish +
                # fseq/credit updates all native; Python resumes here at
                # the burst boundary with the accumulated deltas
                ts_b0 = now_ts()
                s_got, s_stat, _s_in = stem_obj.run(cr, ts_b0)
                got += _stem_apply(ctx, m, stem_obj, stem_spec, tracer,
                                   out_seq0, ts_b0, stem_trace)
                if s_got:
                    m.inc("stem_frags", s_got)
                # STEM_PYTHON: a pending frag needs the slow path (or a
                # python-only in-link has traffic) — fall through to the
                # Python drain with the remaining credit budget.  Any
                # other status (IDLE/BUDGET/BP) already consumed
                # everything this iteration may.
                run_py = s_stat == R.STEM_PYTHON
                if stem_spec.ac_handler:
                    run_ac = run_py
            # rotate the drain order so a saturated in-link cannot starve
            # the others of the shared credit budget
            n_ins = len(ctx.ins)
            order = range(n_ins) if n_ins <= 1 else [
                (iters + j) % n_ins for j in range(n_ins)
            ]
            for i in order if run_py else ():
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
            if sample:
                t_credit0 = time.monotonic_ns()
                p_cpu_credit0 = (
                    time.thread_time_ns() if prof is not None else 0
                )
                if got:
                    m.hist_sample("frag_ns", t_credit0 - t_frag0)
                    if prof is not None:
                        prof.add_phase(
                            "frag",
                            t_credit0 - t_frag0,
                            p_cpu_credit0 - p_cpu_frag0,
                        )
                if run_ac:
                    m.inc("py_credit")
                    tile.after_credit(ctx)
                t_end = time.monotonic_ns()
                m.hist_sample("credit_ns", t_end - t_credit0)
                m.hist_sample("loop_ns", t_end - now)
                if prof is not None:
                    prof.add_phase(
                        "credit",
                        t_end - t_credit0,
                        time.thread_time_ns() - p_cpu_credit0,
                    )
            elif run_ac:
                m.inc("py_credit")
                tile.after_credit(ctx)

            produced = any(o.seq != s0 for o, s0 in zip(ctx.outs, out_seq0))
            if got == 0 and not produced:
                idle += 1
                if idle >= idle_before_sleep:
                    if prof is None:
                        time.sleep(idle_sleep_s)
                    else:
                        t0s = time.monotonic_ns()
                        time.sleep(idle_sleep_s)
                        slept = time.monotonic_ns() - t0s
                        p_sleep += slept
                        prof.add_sleep(slept, idle_sleep_ns)
            else:
                idle = 0
            if prof is not None and sample:
                prof.add_iter(
                    time.monotonic_ns() - now,
                    time.thread_time_ns() - p_cpu0,
                    p_sleep,
                )
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
