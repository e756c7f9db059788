"""The verify tile — the device sig-verify bridge — and its device pool.

The counterpart of firedancer_tpu/tiles/verify.py: `VerifyTile`, its
single-device `FallbackPolicy`, the pool's per-device fault domains
(`DevicePolicy`), one worker thread per device (`_DeviceWorker`) and
in-order landing (`_DevicePool`), with the same names, counters and
semantics.  How the JAX tile maps onto PyTorch:

  * dispatch: a domain's device function is
    ops/ed25519/verify.verify_batch_digest_on(i), one per CUDA ordinal.  It
    launches asynchronously and returns the (B,) bool tensor on card i.
  * land: the one sync is the tensor's host copy (`.cpu()`), where a CUDA
    fault of the batch surfaces, as JAX's np.asarray does.
  * warm-up: the tile runs one full-width zero batch per domain at boot,
    inside that domain's device context, and syncs on its host copy.
  * threads: each worker thread enters torch.cuda.device(i) itself,
    because the current device is per thread.  Two domains on one card
    share its default stream and run one after the other.  The tile
    threads touch no CUDA.
  * host strict path: ops/ed25519/hostpath.verify_batch_digest_host is the
    last resort of host domains only (device="cpu" or "off").  Where JAX
    lands a batch on the host when its device fails, a CUDA domain trips
    and its pool raises DomainsOut: work for the card never moves to the
    CPU because a kernel failed.
  * partial batches: a batch of fewer than max_lanes lanes goes out only
    after a drain of the in-ring came back empty (nothing fuller is
    coming).  JAX sends it at once; waiting one empty drain keeps a
    producer's batch that is still being published from being split.

A sticky CUDA error poisons the context of its card, so a domain
quarantined for one stays quarantined across its backoff re-probes: the
JAX semantics, not a fault of the port.  Host-to-device copies from
pageable numpy inputs are synchronous (pinned staging is later work).
Not ported yet: elastic members (`device_universe` raises) and the fault
injector's device_error hook.
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time

import numpy as np
import torch

from ..disco import trace as SPAN
from ..disco.metrics import MetricsSchema, device_counters
from ..disco.mux import MuxCtx, Tile, TileInterrupted, now_ts
from ..ops.ed25519 import hostpath
from ..tango import rings as R
from ..utils import devices as D
from . import wire

#: reference: VERIFY_TCACHE_DEPTH 16 (fd_verify.h:6) — a tiny per-tile
#: pre-dedup catching back-to-back duplicates before they burn device time
PRE_DEDUP_DEPTH = 16

_STOP = object()

#: DevicePolicy counters summed over a pool's domains
POLICY_COUNTERS = ("fallback_batches", "device_errors", "device_trips",
                   "host_reprobes", "device_stalls")


def _to_host(val) -> np.ndarray:
    """A device result as numpy: the tensor's host copy (the sync point),
    or np.asarray of a host result."""
    if isinstance(val, torch.Tensor):
        return val.cpu().numpy()
    return np.asarray(val)


def _card_of(fn):
    """The CUDA device a device function is pinned to (verify_batch_digest_on
    sets fn.device), or None."""
    dev = getattr(fn, "device", None)
    if isinstance(dev, torch.device) and dev.type == "cuda":
        return dev
    return None


def _domain_device(policy):
    """torch.cuda.device(d) for a policy whose device function is pinned to
    CUDA device d; else a no-op."""
    dev = _card_of(policy.device_fn)
    return contextlib.nullcontext() if dev is None else torch.cuda.device(dev)


class DomainsOut(RuntimeError):
    """Every CUDA domain of the pool is quarantined, stalled or dead, so no
    domain can take the pool's work.  A card's batch lands on its card or
    fails: the pool raises this instead of moving the work to the host.
    `counters` holds the pool's counters (_DevicePool.counters) when it
    was raised."""

    def __init__(self, msg: str, counters: dict):
        super().__init__(msg)
        self.counters = counters


class FallbackPolicy:
    """Graceful degradation for the single-device verify path.

    Wraps the device dispatch in a catch → host-retry → circuit-trip
    state machine: a device error (at dispatch or at the host copy)
    reroutes THAT batch through the strict host verifier
    (ops/ed25519/hostpath.py) instead of killing the tile; `trip_after`
    consecutive device failures latch host-only mode, and every
    `reprobe_every` batches one batch re-probes the device so a recovered
    device is picked back up automatically.

    A domain on a CUDA card has no host path (host_fn must be None): a
    failed batch goes back to the pool, which retries it on the card, and
    `trip_after` consecutive failures take the domain out for good — the
    pool then raises DomainsOut.  `fault_hook()` is the fault-injection
    point, called once per device-batch attempt.

    Counter attributes are mirrored into the tile's shared metrics
    (fallback_batches etc.) by VerifyTile so a monitor sees the
    degradation state live.
    """

    #: set by the pool's stall watchdog (DevicePolicy only: this policy
    #: has no stall patience)
    stalled = False

    def __init__(
        self,
        device_fn,
        host_fn=None,
        *,
        trip_after: int = 3,
        reprobe_every: int = 64,
        fault_hook=None,
    ):
        if host_fn is not None and _card_of(device_fn) is not None:
            raise ValueError("a CUDA domain has no host path: pass host_fn=None")
        self.device_fn = device_fn
        self.host_fn = host_fn
        self.trip_after = max(trip_after, 1)
        self.reprobe_every = max(reprobe_every, 1)
        self.fault_hook = fault_hook
        self.consec_failures = 0
        self.tripped = False  # latched host-only mode
        self._since_trip = 0
        # counters (mirrored into metrics by the owning tile)
        self.fallback_batches = 0
        self.device_errors = 0
        self.device_trips = 0
        self.host_reprobes = 0
        self.device_stalls = 0

    def healthy(self, now: float | None = None) -> bool:
        """Schedulable by the pool: always, while a host path backs the
        domain (it degrades per batch); a tripped card domain is out."""
        return self.host_fn is not None or not self.tripped

    def _try_device(self) -> bool:
        if self.device_fn is None:
            return False
        if not self.tripped:
            return True
        self._since_trip += 1
        if self._since_trip >= self.reprobe_every:
            self._since_trip = 0
            self.host_reprobes += 1
            return True
        return False

    def _device_failed(self) -> None:
        self.device_errors += 1
        self.consec_failures += 1
        if not self.tripped and self.consec_failures >= self.trip_after:
            self.tripped = True
            self.device_trips += 1
            self._since_trip = 0

    def dispatch(self, args):
        """Start a batch.  Device dispatch is async (returns the result
        tensor); the host path defers all work to land()."""
        if self._try_device():
            try:
                if self.fault_hook is not None:
                    self.fault_hook()
                return ("dev", self.device_fn(*args))
            except Exception:
                self._device_failed()
        return ("host", None) if self.host_fn is not None else ("fail", None)

    def land(self, fut, args, lanes: int | None = None):
        """Finish a batch: the device result's host copy (where a fault of
        the batch surfaces) or the host verifier; None hands a card
        domain's failed batch back to the pool."""
        kind, val = fut
        if kind == "dev":
            try:
                out = _to_host(val)
                self.consec_failures = 0
                if self.tripped:
                    self.tripped = False  # re-probe succeeded: recovered
                return out
            except Exception:
                self._device_failed()
        if self.host_fn is None:
            return None
        if self.device_fn is not None:
            # fallback_batches measures DEGRADATION — batches a configured
            # device failed to serve; a host-only tile (device="off") is
            # healthy, not degraded
            self.fallback_batches += 1
        return self.host_fn(*args, lanes=lanes)


class DevicePolicy:
    """One device's FAULT DOMAIN inside a multi-device pool.

    A failed batch goes BACK to the pool (dispatch/land return a failure)
    so the scheduler can resubmit it to a HEALTHY device.  The breaker is
    time-based: `trip_after` consecutive failures quarantine the device
    for a capped-exponential backoff (`backoff_base_s`..`backoff_max_s`),
    after which the next scheduled batch re-probes it.

    `host_fn`, the strict host verifier, is the last resort of a domain
    on the host only (device_fn None, or a CPU function): when every
    domain is out, the pool lands batches through it.  A domain whose
    device_fn is pinned to a CUDA card (verify_batch_digest_on sets
    fn.device) has no host path: its batches land on a card or the pool
    raises DomainsOut, so a broken kernel cannot hide behind the host.

    `stall_patience_s` is a per-device stall patience: a device call
    wedged past the patience degrades only ITS device (the pool marks
    `stalled`, quarantines, and redistributes its in-flight batches); the
    other devices keep verifying.

    `fault_hook(index)` is the fault-injection point: called once per
    device-batch attempt, raising a scripted error that exercises exactly
    the production failure path.
    """

    def __init__(
        self,
        device_fn,
        host_fn=None,
        *,
        index: int = 0,
        trip_after: int = 3,
        backoff_base_s: float = 0.5,
        backoff_max_s: float = 30.0,
        stall_patience_s: float = 120.0,
        fault_hook=None,
    ):
        if host_fn is not None and _card_of(device_fn) is not None:
            raise ValueError("a CUDA domain has no host path: pass host_fn=None")
        self.device_fn = device_fn
        self.host_fn = host_fn
        self.index = index
        self.trip_after = max(trip_after, 1)
        self.fault_hook = fault_hook
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.stall_patience_s = stall_patience_s
        self.consec_failures = 0
        self.tripped = False  # quarantined
        self.backoff_s = 0.0
        self.quarantined_until = 0.0
        self.stalled = False
        # counters
        self.fallback_batches = 0
        self.device_errors = 0
        self.device_trips = 0
        self.host_reprobes = 0
        self.device_stalls = 0

    def healthy(self, now: float | None = None) -> bool:
        if self.stalled or self.device_fn is None:
            return False
        if not self.tripped:
            return True
        if now is None:
            now = time.monotonic()
        return now >= self.quarantined_until  # backoff expired: re-probe

    def _try_device(self) -> bool:
        if self.device_fn is None or self.stalled:
            return False
        if not self.tripped:
            return True
        if time.monotonic() >= self.quarantined_until:
            self.host_reprobes += 1  # (re-)probe of a quarantined device
            return True
        return False

    def _quarantine(self) -> None:
        """Trip the breaker with capped exponential backoff: each failed
        (re-)probe doubles the backoff, a success (in land) resets it."""
        if not self.tripped:
            self.device_trips += 1
        self.tripped = True
        self.backoff_s = (
            self.backoff_base_s
            if not self.backoff_s
            else min(self.backoff_s * 2.0, self.backoff_max_s)
        )
        self.quarantined_until = time.monotonic() + self.backoff_s

    def _device_failed(self) -> None:
        self.device_errors += 1
        self.consec_failures += 1
        if self.consec_failures >= self.trip_after:
            self._quarantine()

    def mark_stalled(self) -> None:
        """Pool stall watchdog: the device call is wedged past patience.
        Quarantine so the scheduler routes around it; the flag clears
        when the wedged call finally returns (the worker owns that)."""
        self.stalled = True
        self.device_stalls += 1
        self._quarantine()

    def dispatch(self, args):
        if self._try_device():
            try:
                if self.fault_hook is not None:
                    self.fault_hook(self.index)
                return ("dev", self.device_fn(*args))
            except Exception:
                self._device_failed()
                return ("fail", None)
        return ("fail", None)  # quarantined: the pool redistributes

    def land(self, fut, args, lanes: int | None = None):
        kind, val = fut
        if kind == "dev":
            try:
                out = _to_host(val)
                self.consec_failures = 0
                self.tripped = False
                self.backoff_s = 0.0
                return out
            except Exception:
                self._device_failed()
                return None  # the pool resubmits elsewhere
        if kind == "host":
            if self.device_fn is not None:
                # degradation: a batch a configured device failed to serve
                self.fallback_batches += 1
            return self.host_fn(*args, lanes=lanes)
        return None  # "fail": never dispatched (quarantine raced)


class _DeviceWorker:
    """Push-request/push-result engine (the wd_f1.c interface shape).

    One dedicated thread owns all interaction with ONE device.  `depth`
    batches ride in flight: the thread dispatches every queued request
    before it blocks on the oldest result's D2H copy, so transfer and
    compute of batch N+1 overlap the sync of batch N (the double
    buffer).  All dispatch/land calls go through the policy, so a device
    failure surfaces to the pool instead of killing this thread.

    Accounting contract: every submitted batch is exactly one of
    landed (a results entry), still queued/in flight (visible in
    `reqq`/`pending`), or drained back by `abort()` — never silently
    dropped.  `pending` entries are appended BEFORE dispatch and popped
    only AFTER their land completes, so a wedge inside a device call
    keeps that batch recoverable.
    """

    def __init__(self, policy: DevicePolicy, depth: int = 3,
                 name: str = "verify-dev"):
        self.policy = policy
        self.depth = depth
        self.reqq: queue.Queue = queue.Queue(maxsize=depth)
        self.results: collections.deque = collections.deque()
        self.pending: collections.deque = collections.deque()
        self.error: BaseException | None = None
        self.aborted = False
        #: single-writer counters: submitted_n by the submitting (mux)
        #: thread, completed_n by this worker thread; the difference is
        #: the in-flight load the scheduler balances on
        self.submitted_n = 0
        self.completed_n = 0
        #: landed batches accepted by the pool (pool/mux thread only)
        self.landed_n = 0
        #: monotonic timestamp while inside a device call — dispatch
        #: (the H2D copy can wedge) or land (the D2H sync)
        #: — read by the pool's stall watchdog; 0.0 = not in a call
        self.land_t0 = 0.0
        self.thread = threading.Thread(
            target=self._main, name=name, daemon=True
        )
        self.thread.start()

    def inflight(self) -> int:
        return self.submitted_n - self.completed_n

    def alive(self) -> bool:
        return self.error is None and self.thread.is_alive()

    def submit(self, meta, args, mode: str = "auto") -> None:
        """Single-submitter (mux thread); the caller checks reqq.full()
        first, so this never blocks."""
        self.reqq.put_nowait((meta, args, mode))
        self.submitted_n += 1

    def stop(self, timeout_s: float | None = None) -> None:
        deadline = (
            None if timeout_s is None else time.monotonic() + timeout_s
        )
        while self.thread.is_alive():
            try:
                self.reqq.put(_STOP, timeout=0.1)
                break
            except queue.Full:
                # a dead worker never drains: is_alive re-checks.  A
                # WEDGED worker never drains either — the deadline must
                # bound this loop too, or a stop under a full queue
                # spins forever and the halt path never returns
                if deadline is not None and time.monotonic() >= deadline:
                    break
        self.thread.join(
            None if deadline is None
            else max(deadline - time.monotonic(), 0.0)
        )

    def abort(self, timeout_s: float = 10.0) -> list[tuple]:
        """Teardown that cannot orphan work: stop (or abandon, if
        wedged) the thread, then drain every batch it never landed —
        queued submissions AND the in-flight `pending` entries (a land
        wedged inside a device call keeps its batch there) — back to
        the caller for resubmission or deliberate discard."""
        self.aborted = True
        try:
            self.reqq.put_nowait(_STOP)
        except queue.Full:
            pass
        self.thread.join(timeout=timeout_s)
        drained: list[tuple] = []
        while True:
            try:
                item = self.reqq.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                drained.append(item)
        # liveness BEFORE the pending snapshot: a slow-but-not-wedged
        # worker can finish its in-flight land right after the join
        # timeout — snapshotting first would count that batch in both
        # completed_n and drained and fire the assert spuriously.  Once
        # dead here, counters and pending are final.  A still-alive
        # thread (wedged, or merely slower than the join timeout) can
        # popleft/append concurrently, so the snapshot retries on the
        # deque's mutated-during-iteration error rather than letting it
        # escape into the crash-recovery path.
        alive = self.thread.is_alive()
        while True:
            try:
                snap = [(m, a, md) for m, a, md, _ in self.pending]
                break
            except RuntimeError:
                continue
        drained.extend(snap)
        if not alive:
            # the thread exited: counters are final — prove no batch
            # was silently dropped (the pre-fix abort lost queued metas
            # when a land wedged)
            assert self.submitted_n == self.completed_n + len(drained), (
                f"device worker dropped batches: submitted "
                f"{self.submitted_n} != landed {self.completed_n} + "
                f"drained {len(drained)}"
            )
        return drained

    def _main(self) -> None:
        # the current CUDA device is per thread: enter the domain's own
        with _domain_device(self.policy):
            self._loop()

    def _loop(self) -> None:
        pending = self.pending
        stopped = False
        try:
            while not (stopped and not pending):
                if self.aborted:
                    return
                while not stopped and len(pending) < self.depth:
                    try:
                        item = self.reqq.get(
                            block=not pending, timeout=0.02
                        )
                    except queue.Empty:
                        break
                    if item is _STOP:
                        stopped = True
                        break
                    meta, args, mode = item
                    # enter the accounting BEFORE dispatch: a dispatch
                    # that wedges must leave the batch recoverable
                    slot = [meta, args, mode, None]
                    pending.append(slot)
                    # span timestamps ride the meta dict (plain writes on
                    # this worker thread); the MUX thread turns them into
                    # DISPATCH/LAND span events when the batch lands —
                    # the span ring itself stays single-writer
                    meta["t_disp"] = now_ts()
                    meta["t_dev"] = getattr(self.policy, "index", 0)
                    if mode == "host":
                        slot[3] = ("host", None)
                    else:
                        # async dispatch: returns after the launch — but
                        # the H2D copy inside it can wedge, so the
                        # watchdog window covers it too
                        self.land_t0 = time.monotonic()
                        slot[3] = self.policy.dispatch(args)
                        self.land_t0 = 0.0
                if pending:
                    meta, args, mode, fut = pending[0]
                    if fut is None:  # pragma: no cover - abort raced
                        fut = ("fail", None)
                    # the result's host copy is the sync point
                    self.land_t0 = time.monotonic()
                    ok = self.policy.land(fut, args, meta["lanes"])
                    self.land_t0 = 0.0
                    meta["t_land"] = now_ts()
                    self.policy.stalled = False  # the call returned
                    self.completed_n += 1
                    pending.popleft()
                    self.results.append((meta, ok))
        except BaseException as e:  # noqa: BLE001 — surfaced by the tile
            self.error = e


class _DevicePool:
    """N per-device workers behind one submit/land facade.

    Scheduler: least-in-flight across healthy domains, ties broken
    round-robin; per-device in-flight cap = the worker queue depth.
    When no device is healthy, batches go out in `mode="host"` — the
    strict host path as last resort — on a responsive host domain; with
    none (a pool of CUDA domains), poll raises DomainsOut.

    Landing is IN ORDER: every batch gets a monotonically increasing
    `pool_seq` at first submit; completed batches park in a reorder
    buffer and `ready` hands them out strictly by seq, so downstream
    publish order is identical to a single serialized stream no matter
    how devices interleave.

    Fault handling: a failed batch (device error) or a quarantined/
    stalled/dead domain's in-flight work is resubmitted — same seq —
    to another domain.  Late results from a domain a batch was moved
    away from are dropped by an assignment check, which is what makes
    "zero lost, zero duplicated" hold through stall recovery races.

    Thread model: submit/poll/abort run on the owning tile's mux
    thread only; workers touch only their own queues/results.
    """

    def __init__(self, policies: list, depth: int = 3, name: str = "verify"):
        self.policies = policies
        self.workers = [
            _DeviceWorker(p, depth, name=f"{name}-dev{i}")
            for i, p in enumerate(policies)
        ]
        self.aborted = False
        self.next_seq = 0
        self.landed_seq = 0
        self.reorder: dict[int, tuple] = {}
        #: seq -> [meta, args, mode, domain_idx]; the live assignment
        self.outstanding: dict[int, list] = {}
        #: evicted batches waiting for a domain with room
        self.retryq: collections.deque = collections.deque()
        #: in-order completed batches, consumed by the tile
        self.ready: collections.deque = collections.deque()
        self.rr = 0
        self.resubmits = 0
        self.late_results = 0
        self._evicted: set[int] = set()
        self._stopping = False

    # ---- scheduling -----------------------------------------------------

    def _domain_ok(self, i: int) -> bool:
        w = self.workers[i]
        return w.alive() and not self.policies[i].stalled

    def _pick(self, peek: bool = False) -> tuple[int | None, str]:
        now = time.monotonic()
        n = len(self.workers)
        cand = [
            i for i in range(n)
            if self._domain_ok(i) and self.policies[i].healthy(now)
        ]
        mode = "auto"
        if not cand:
            # every device quarantined/stalled/dead: the strict host path
            # on a still-responsive host domain is the last resort (a CUDA
            # domain has none: poll raises DomainsOut)
            mode = "host"
            cand = [i for i in range(n) if self._domain_ok(i)
                    and self.policies[i].host_fn is not None]
        open_ = [i for i in cand if not self.workers[i].reqq.full()]
        if not open_:
            return None, mode
        best, best_load = None, None
        for j in range(len(open_)):
            i = open_[(self.rr + j) % len(open_)]
            load = self.workers[i].inflight()
            if best is None or load < best_load:
                best, best_load = i, load
        if not peek:
            self.rr = (self.rr + 1) % max(n, 1)
        return best, mode

    def can_accept(self) -> bool:
        """Room for NEW work: evicted batches retry first (publishing is
        seq-ordered, so head-of-line seqs must not starve)."""
        if self.retryq:
            return False
        return self._pick(peek=True)[0] is not None

    def submit(self, meta, args) -> bool:
        """Schedule one new batch; False = no capacity (caller holds it
        staged and retries — ring backpressure does the rest)."""
        self.pump()
        if self.retryq:
            return False
        tgt, mode = self._pick()
        if tgt is None:
            return False
        seq = self.next_seq
        self.next_seq += 1
        meta["pool_seq"] = seq
        self.outstanding[seq] = [meta, args, mode, tgt]
        self.workers[tgt].submit(meta, args, mode)
        return True

    def pump(self) -> None:
        """Re-place evicted batches as capacity frees up."""
        while self.retryq:
            tgt, mode = self._pick()
            if tgt is None:
                return
            seq = self.retryq.popleft()
            ent = self.outstanding.get(seq)
            if ent is None:  # pragma: no cover - landed while queued
                continue
            ent[2], ent[3] = mode, tgt
            self.workers[tgt].submit(ent[0], ent[1], mode)

    def _resubmit(self, seq: int) -> None:
        ent = self.outstanding[seq]
        self.resubmits += 1
        tgt, mode = self._pick()
        if tgt is None:
            ent[3] = -1  # unassigned: parked until capacity frees
            self.retryq.append(seq)
            return
        ent[2], ent[3] = mode, tgt
        self.workers[tgt].submit(ent[0], ent[1], mode)

    def _evict(self, i: int) -> None:
        """Move every batch assigned to domain i elsewhere (quarantine /
        dead worker).  Late results from i are dropped by the
        assignment check in poll()."""
        for seq, ent in list(self.outstanding.items()):
            if ent[3] == i:
                self._resubmit(seq)

    # ---- landing --------------------------------------------------------

    def _drain_results(self, i: int, w: _DeviceWorker) -> None:
        while w.results:
            meta, ok = w.results.popleft()
            seq = meta["pool_seq"]
            ent = self.outstanding.get(seq)
            if ent is None or ent[3] != i:
                # a batch this domain lost to resubmission landed
                # anyway (stall recovered): first landing won
                self.late_results += 1
                continue
            if ok is None:
                self._resubmit(seq)  # device failed it: try elsewhere
                continue
            del self.outstanding[seq]
            w.landed_n += 1
            self.reorder[seq] = (meta, ok)

    def poll(self) -> None:
        """Drain worker results into the in-order ready queue; watchdog
        stalled/dead domains; resubmit failed batches.  Mux-thread only."""
        now = time.monotonic()
        for i, w in enumerate(self.workers):
            p = self.policies[i]
            # drain completed results BEFORE any eviction below: a
            # worker that landed S1..Sk and then wedged/died on S(k+1)
            # must not have its finished batches reassigned and re-run
            # (eviction-first turned them into dropped late results)
            self._drain_results(i, w)
            patience = getattr(p, "stall_patience_s", 0.0)
            t0 = w.land_t0
            if (
                patience
                and t0
                and now - t0 > patience
                and not p.stalled
            ):
                # the stall patience is per device: only THIS
                # device degrades; its batches move on
                p.mark_stalled()
                self._evict(i)
            if (
                p.stalled
                and not w.land_t0
                and not w.pending
                and w.reqq.empty()
            ):
                # watchdog/return race: the wedged call came back (the
                # worker cleared the flag) and THEN a stale mark_stalled
                # re-set it.  Nothing is in flight on this worker, so no
                # land will ever clear it again — clear it here or the
                # domain is out of the pool forever.  The quarantine
                # backoff from the mark still gates the re-probe.
                p.stalled = False
            if (
                not self._stopping
                and i not in self._evicted
                and (w.error is not None or not w.thread.is_alive())
            ):
                self._evicted.add(i)
                self._evict(i)
        self.pump()
        while self.landed_seq in self.reorder:
            self.ready.append(self.reorder.pop(self.landed_seq))
            self.landed_seq += 1
        if not self._stopping and not any(
            self._domain_ok(i) and (p.healthy(now) or p.host_fn is not None)
            for i, p in enumerate(self.policies)
        ):
            raise DomainsOut(
                "every CUDA domain of the pool is quarantined, stalled or "
                "dead", self.counters())

    def counters(self) -> dict:
        """Batches landed per domain, the POLICY_COUNTERS summed over the
        domains, resubmits and late results."""
        return {
            "landed": [w.landed_n for w in self.workers],
            **{k: sum(getattr(p, k) for p in self.policies)
               for k in POLICY_COUNTERS},
            "resubmits": self.resubmits, "late_results": self.late_results,
        }

    def idle(self) -> bool:
        return not self.outstanding and not self.ready

    def check_fatal(self) -> None:
        """Every domain dead -> surface the first error (the supervisor
        restarts the tile).  A partial failure is handled by eviction."""
        errs = [w.error for w in self.workers]
        if errs and all(e is not None for e in errs):
            raise errs[0]

    # ---- lifecycle ------------------------------------------------------

    def stop(self, timeout_s: float | None = 30.0) -> None:
        self._stopping = True
        for w in self.workers:
            w.stop(timeout_s)

    def abort(self, timeout_s: float = 10.0) -> tuple[list[int], int]:
        """Crash teardown: abort every worker, drain their unlanded
        batches (the caller deliberately discards them — the
        supervisor's ring replay re-delivers), and report which domains
        are wedged zombies (their policies must be detached)."""
        self.aborted = True
        self._stopping = True
        zombies: list[int] = []
        dropped = 0
        for i, w in enumerate(self.workers):
            dropped += len(w.abort(timeout_s))
            if w.thread.is_alive():
                zombies.append(i)
        return zombies, dropped


class VerifyTile(Tile):
    def __init__(
        self,
        *,
        msg_width: int = 1232,
        max_lanes: int = 4096,
        pre_dedup: bool = True,
        pad_full: bool = False,
        shard: tuple[int, int] | None = None,
        async_depth: int = 3,
        device=None,
        device_fn=None,
        devices: int | str | list | None = 1,
        device_universe: list | None = None,
        fallback_trip: int = 3,
        fallback_reprobe: int = 64,
        dev_backoff_base_s: float = 0.5,
        dev_backoff_max_s: float = 30.0,
        stall_patience_s: float = 120.0,
        name: str = "verify",
    ):
        """pad_full: always pad sub-batches to max_lanes (one shape;
        right for steady full-rate ingress).  False pads to power-of-two
        buckets (cheaper on trickle traffic).  The padded lanes' verdicts
        are dropped.

        shard=(idx, cnt): horizontal scaling — this replica only processes
        frags with seq % cnt == idx (reference: round-robin seq sharding
        across verify tiles, fd_verify.c:46); the others are skipped
        without gathering payloads.

        async_depth: device batches in flight PER DEVICE (the wiredancer
        request pipe depth); 1 degenerates to synchronous dispatch.

        device: None (the CUDA card; raises "no CUDA device" on a host
        without one), "cpu" (the plain versions: tests only), or "off"
        (every batch on the strict host path, as in JAX).  device_fn
        overrides the device function outright (fault-injection stubs).
        fallback_trip / fallback_reprobe parameterize the FallbackPolicy.

        devices: the pool width — 1 (default: one serialized stream), an
        int N (domains 0..N-1), an explicit list of CUDA ordinals, or
        "auto" (every local card, counted by local_device_count).  With
        N > 1 each domain is its own fault domain: dev_backoff_base_s /
        dev_backoff_max_s cap the quarantine backoff and stall_patience_s
        is the per-device stall patience.

        device_universe (elastic shard members) raises until the elastic
        topology is ported."""
        assert max_lanes & (max_lanes - 1) == 0, (
            "max_lanes must be a power of two (pad buckets assume it)"
        )
        if device_universe is not None:
            raise NotImplementedError(
                "device_universe: elastic shard members are not ported yet"
            )
        self.name = name
        self.msg_width = msg_width
        self.max_lanes = max_lanes
        self.pre_dedup = pre_dedup
        self.pad_full = pad_full
        self.shard = shard
        self.async_depth = max(async_depth, 1)
        #: the torch device of the domains (None: host only, device="off")
        self._dev = None if device == "off" else D.resolve(device)
        self._device_fn_override = device_fn
        self.device_indices = _resolve_devices(devices, self._dev, device_fn)
        self.n_devices = len(self.device_indices)
        self.fallback_trip = fallback_trip
        self.fallback_reprobe = fallback_reprobe
        self.dev_backoff_base_s = dev_backoff_base_s
        self.dev_backoff_max_s = dev_backoff_max_s
        self.stall_patience_s = stall_patience_s
        # per-instance schema: the per-device health/throughput rows are
        # sized by the pool width at declaration time (the topology
        # allocates the metrics region before boot)
        self.schema = MetricsSchema(
            counters=(
                "verify_fail_txns",
                "dedup_drop_txns",
                "verified_sigs",
                "device_batches",
                # policy state, mirrored each loop so monitors see
                # degradation live (sums across the pool's domains)
                "fallback_batches",
                "device_errors",
                "device_trips",
                "host_reprobes",
                "pool_resubmits",
                "pool_late_results",
            )
            + device_counters(self.n_devices),
            hists=("lane_batch",),
        )
        self._tc: R.TCache | None = None
        self._fns: list | None = None
        self._policies: list | None = None
        self._pool: _DevicePool | None = None
        self._interrupt = None  # ctx.interrupt, bound at boot
        self._tracer = None  # ctx.tracer, bound at boot
        self._prev_fallback = 0  # FALLBACK span edge detector
        self._prev_degraded: dict[int, int] = {}  # QUARANTINE edges
        self._mirror_tick = 0
        #: staged host-prepared lanes not yet submitted (list of dicts)
        self._staged: collections.deque = collections.deque()
        self._staged_lanes = 0
        #: results processed into publish-ready arrays, awaiting credits
        self._outq: collections.deque = collections.deque()
        self._outq_txns = 0
        #: this loop iteration: the drain was open (in_budget let frags
        #: in) and no frag arrived — the in-ring is idle, so a partial
        #: batch may go out
        self._drain_open = False
        self._got = False
        #: (pool_seq, domain, lanes, t_disp, t_land) of the last landed
        #: batches: the dispatch and land stamps of the pool's worker
        self.landed_stamps: collections.deque = collections.deque(maxlen=1 << 16)

    @property
    def _policy(self):
        """Compat view for single-device callers/tests."""
        return self._policies[0] if self._policies else None

    def wksp_footprint(self) -> int:
        if not self.pre_dedup:
            return 0
        return R.TCache.footprint(
            PRE_DEDUP_DEPTH, R.TCache.map_cnt_for(PRE_DEDUP_DEPTH)
        )

    def _make_device_fns(self) -> list:
        """One device function per pool domain, each pinned to its card
        (verify_batch_digest_on), and warmed with one full-width zero
        batch inside its device context, synced on the host copy, so the
        steady state never pays a first call."""
        n = self.n_devices
        if self._device_fn_override is not None:
            return [self._device_fn_override] * n
        if self._dev is None:
            return [None] * n
        if self._fns is None:
            from ..ops.ed25519 import verify as fver

            if self._dev.type == "cuda":
                have = D.local_device_count(default=0)
                bad = [d for d in self.device_indices if d >= have]
                if bad:
                    # aliasing d % have would silently pin two domains to
                    # one card and report N independent devices
                    raise ValueError(
                        f"{self.name}: devices {bad} out of range — host "
                        f"has {have} CUDA device(s)"
                    )
                self._fns = [fver.verify_batch_digest_on(d)
                             for d in self.device_indices]
            else:
                self._fns = [fver.verify_batch_digest_on(self._dev)] * n
            z64 = np.zeros((self.max_lanes, 64), np.uint8)
            z32 = np.zeros((self.max_lanes, 32), np.uint8)
            for f in self._fns:
                _to_host(f(z64, z64, z32))
        return self._fns

    def on_boot(self, ctx: MuxCtx) -> None:
        self._interrupt = ctx.interrupt
        self._tracer = ctx.tracer
        # warm the strict host path once per process: its first call pays
        # table setup that must not land inside the first production
        # batch's tail latency
        hostpath.verify_batch_digest_host(
            np.zeros((1, 64), np.uint8), np.zeros((1, 64), np.uint8),
            np.zeros((1, 32), np.uint8),
        )
        if self.pre_dedup:
            depth = PRE_DEDUP_DEPTH
            map_cnt = R.TCache.map_cnt_for(depth)
            fp = R.TCache.footprint(depth, map_cnt)
            # re-initialized (join=False) even on restart: a replayed
            # frag the dead incarnation consumed but never forwarded must
            # NOT be swallowed by a stale pre-dedup entry — the real dedup
            # tile downstream keeps the durable history
            self._tc = R.TCache(ctx.alloc("tcache", fp), depth, map_cnt)
        if self._policies is None:
            # policies (and their degradation counters) persist across
            # restarts; only the worker threads are per-life
            self._policies = self._build_policies()
        self._pool = _DevicePool(
            self._policies, self.async_depth, name=self.name
        )

    def _build_policies(self) -> list:
        fns = self._make_device_fns()

        def host_fn(fn):
            # a card domain has no host path
            return None if _card_of(fn) is not None else (
                hostpath.verify_batch_digest_host)

        if self.n_devices == 1:
            return [
                FallbackPolicy(
                    fns[0], host_fn(fns[0]),
                    trip_after=self.fallback_trip,
                    reprobe_every=self.fallback_reprobe,
                )
            ]
        return [
            DevicePolicy(
                fns[i], host_fn(fns[i]),
                index=i,
                trip_after=self.fallback_trip,
                backoff_base_s=self.dev_backoff_base_s,
                backoff_max_s=self.dev_backoff_max_s,
                stall_patience_s=self.stall_patience_s,
            )
            for i in range(self.n_devices)
        ]

    # ---- ingress: host prep + staging -----------------------------------

    def on_frags(self, ctx: MuxCtx, in_idx: int, frags: np.ndarray) -> None:
        self._got = True
        il = ctx.ins[in_idx]
        if self.shard is not None:
            idx, cnt = self.shard
            frags = frags[frags["seq"] % cnt == idx]
            if not len(frags):
                return
        if self._tc is not None:
            dup = self._tc.dedup(frags["sig"])
            if dup.any():
                ctx.metrics.inc("dedup_drop_txns", int(dup.sum()))
                frags = frags[~dup]
        if not len(frags):
            return
        # one GIL-released native call: dcache gather + trailer parse +
        # per-sig lane expansion + k-digests + dedup tags; the device
        # gets digests, so the message copy is skipped outright
        b = wire.expand_native(il.dcache, frags, self.msg_width,
                               with_digests=True, with_msgs=False)
        lanes = len(b["sigs"])
        b.pop("txn_idx")
        b["tsorigs"] = frags["tsorig"].copy()
        # ring seq per txn, carried through staging -> device -> publish
        # so ack_floor can hold the fseq at the oldest unflushed frag
        b["seqs"] = frags["seq"].copy()
        self._staged.append(b)
        self._staged_lanes += lanes
        # submit only while the pool has room: a full pool means every
        # device pipe is behind, and the right response is to hold frags
        # in the RING (in_budget -> credit backpressure), not to block
        # this thread past its heartbeat deadline
        while (
            self._staged_lanes >= self.max_lanes
            and self._pool.can_accept()
        ):
            self._submit_front(self.max_lanes)

    def ack_floor(self, ctx: MuxCtx, in_idx: int) -> int | None:
        """Oldest in-ring frag seq still riding the async pipeline
        (staged -> device pool -> credit-gated publish queue).  The mux
        holds the fseq here so the producer cannot overwrite a consumed
        -but-unpublished frag — a crash anywhere in the pipeline is then
        recoverable by rejoin replay (the drop/landing of a txn releases
        its seq, so the floor only ever advances)."""
        floor = None
        batches = [b["seqs"] for q in (self._outq, self._staged) for b in q]
        pool = self._pool
        if pool is not None:
            batches += [ent[0]["seqs"] for ent in pool.outstanding.values()]
            batches += [meta["seqs"] for meta, _ok in pool.reorder.values()]
            batches += [meta["seqs"] for meta, _ok in pool.ready]
        for seqs in batches:
            s = int(seqs[0])
            # wrap-safe min: a plain-int min picks the wrapped-to-tiny seq
            # across a 2^64 crossing
            floor = s if floor is None else R.seq_min(floor, s)
        return floor

    def in_budget(self, ctx: MuxCtx) -> int | None:
        # stop draining the ring when the device pool is full or results
        # are waiting on downstream credits — backpressure flows upstream
        # through the ring's credit model, not an unbounded host buffer
        p = self._pool
        if p is not None and not p.can_accept():
            budget = 0
        elif self._staged_lanes >= 2 * self.max_lanes:
            budget = 0
        elif self._outq_txns >= 4 * self.max_lanes:
            budget = 0
        else:
            budget = None
        # this iteration's drain observation, read by after_credit
        self._drain_open = budget is None
        self._got = False
        return budget

    # ---- device submit ---------------------------------------------------

    def _submit_front(self, lanes_cap: int) -> None:
        """Concatenate staged chunks into one device batch of <= lanes_cap
        lanes (whole txns only) and push it to the pool."""
        take, lanes = [], 0
        while self._staged:
            chunk = self._staged[0]
            n = len(chunk["sigs"])
            if lanes + n > lanes_cap:
                # split the chunk on a txn boundary
                cnt = chunk["sig_cnt"]
                ends = np.cumsum(cnt)
                k = int(np.searchsorted(ends, lanes_cap - lanes, "right"))
                if k == 0:
                    if lanes == 0:
                        # a single txn with more lanes than the cap: take
                        # it alone (the kernel pads to any pow2 bucket) —
                        # never stall with zero progress
                        k = 1
                    else:
                        break
                head, tail = _split_chunk(chunk, k, int(ends[k - 1]))
                take.append(head)
                lanes += int(ends[k - 1])
                if len(tail["sigs"]):
                    self._staged[0] = tail
                else:
                    self._staged.popleft()
                break
            take.append(self._staged.popleft())
            lanes += n
        if not take:
            return
        self._staged_lanes -= lanes
        if len(take) == 1:
            b = take[0]
        else:
            b = {k: np.concatenate([c[k] for c in take]) for k in take[0]}
        pad = (
            self.max_lanes
            if self.pad_full
            else 1 << max(lanes - 1, 0).bit_length()
        )
        meta = dict(
            rows=b["rows"], szs=b["szs"], tsorigs=b["tsorigs"],
            sig_cnt=b["sig_cnt"], tags=b["tags"], seqs=b["seqs"],
            lanes=lanes,
        )
        self._submit(
            meta,
            (
                _pad2(b["digests"], pad),
                _pad2(b["sigs"], pad),
                _pad2(b["pubs"], pad),
            ),
        )

    def _submit(self, meta, args) -> None:
        """Interruptible submit: a full pool behind a slow host path must
        not turn into an unbounded blocking put — the ctx interrupt and
        dead workers both have to be able to unwedge the loop thread."""
        pool = self._pool
        while True:
            pool.check_fatal()
            if pool.aborted:
                return  # crash teardown: ring replay re-delivers
            if self._interrupt is not None and self._interrupt.is_set():
                raise TileInterrupted(f"{self.name}: submit abandoned")
            if pool.submit(meta, args):
                if self._tracer is not None:
                    self._tracer.point(
                        SPAN.ENQUEUE,
                        seq=meta["pool_seq"],
                        aux16=min(meta["lanes"], 0xFFFF),
                    )
                return
            # no capacity anywhere: poll (stall watchdog + retry pump may
            # free a lane) and wait for a worker to make progress
            pool.poll()
            time.sleep(1e-3)

    # ---- egress: results -> publish --------------------------------------

    def _land_results(self, ctx: MuxCtx) -> None:
        pool = self._pool
        pool.check_fatal()
        pool.poll()
        while pool.ready:
            meta, ok = pool.ready.popleft()
            lanes = meta["lanes"]
            ok = ok[:lanes]  # the padded lanes' verdicts are dropped
            dev = int(meta.get("t_dev", 0)) & 0xFF
            seq = meta.get("pool_seq", 0)
            self.landed_stamps.append(
                (seq, dev, lanes, meta.get("t_disp"), meta.get("t_land")))
            if self._tracer is not None:
                # dispatch/land timestamps were stamped into the meta by
                # the worker thread; emitted here so the span ring keeps
                # its single writer (this mux thread)
                if "t_disp" in meta:
                    self._tracer.point(
                        SPAN.DISPATCH, ts=meta["t_disp"], seq=seq, aux16=dev,
                    )
                self._tracer.point(
                    SPAN.LAND, ts=meta.get("t_land"), seq=seq, aux16=dev,
                    aux64=lanes,
                )
            ctx.metrics.inc("verified_sigs", lanes)
            ctx.metrics.inc("device_batches")
            ctx.metrics.hist_sample("lane_batch", lanes)
            cnt = meta["sig_cnt"]
            starts = np.concatenate(([0], np.cumsum(cnt)[:-1]))
            txn_ok = (
                np.logical_and.reduceat(ok, starts)
                if lanes
                else np.zeros(0, bool)
            )
            n_fail = int((~txn_ok).sum())
            if n_fail:
                ctx.metrics.inc("verify_fail_txns", n_fail)
            if not txn_ok.any():
                continue
            # dedup tag: first 8 bytes of the first signature, LE u64
            # (reference: fd_dedup keys the tango sig field,
            # fd_dedup.c:125) — computed by fdt_verify_expand at staging
            self._outq.append(
                dict(
                    tags=meta["tags"][txn_ok],
                    rows=meta["rows"][txn_ok],
                    szs=meta["szs"][txn_ok].astype(np.uint16),
                    tsorigs=meta["tsorigs"][txn_ok],
                    seqs=meta["seqs"][txn_ok],
                )
            )
            self._outq_txns += int(txn_ok.sum())

    def _publish_ready(self, ctx: MuxCtx) -> None:
        while self._outq and ctx.credits > 0:
            b = self._outq[0]
            n = len(b["tags"])
            if n <= ctx.credits:
                self._outq.popleft()
                ctx.publish(b["tags"], b["rows"], b["szs"], tsorigs=b["tsorigs"])
                ctx.credits -= n
                self._outq_txns -= n
            else:
                m = ctx.credits
                ctx.publish(
                    b["tags"][:m], b["rows"][:m], b["szs"][:m],
                    tsorigs=b["tsorigs"][:m],
                )
                for k in ("tags", "rows", "szs", "tsorigs", "seqs"):
                    b[k] = b[k][m:]
                ctx.credits = 0
                self._outq_txns -= m

    def after_credit(self, ctx: MuxCtx) -> None:
        self._land_results(ctx)
        self._publish_ready(ctx)
        # keep the devices fed: a full batch whenever the pool has room;
        # a partial one only once the in-ring came back empty (trickle
        # traffic: nothing fuller is coming)
        if (
            self._staged_lanes
            and (self._staged_lanes >= self.max_lanes
                 or (self._drain_open and not self._got))
            and self._pool.can_accept()
        ):
            self._submit_front(self.max_lanes)
        self._mirror_policy_metrics(ctx)

    def _mirror_policy_metrics(self, ctx: MuxCtx) -> None:
        """Expose the pool's degradation state in the shared metrics
        region (monitors read it live).  Aggregates every iteration;
        per-device rows every 16th (they are O(devices) set calls)."""
        pool = self._pool
        ps = self._policies
        m = ctx.metrics
        fb = sum(p.fallback_batches for p in ps)
        if self._tracer is not None and fb > self._prev_fallback:
            self._tracer.point(SPAN.FALLBACK, aux64=fb - self._prev_fallback)
        self._prev_fallback = fb
        m.set("fallback_batches", fb)
        m.set("device_errors", sum(p.device_errors for p in ps))
        m.set("device_trips", sum(p.device_trips for p in ps))
        m.set("host_reprobes", sum(p.host_reprobes for p in ps))
        m.set("pool_resubmits", pool.resubmits)
        m.set("pool_late_results", pool.late_results)
        self._mirror_tick += 1
        if (self._mirror_tick & 0xF) != 1:
            return
        now = time.monotonic()
        for i, w in enumerate(pool.workers):
            p = ps[i]
            m.set(f"dev{i}_depth", w.reqq.qsize())
            m.set(f"dev{i}_inflight", max(w.inflight(), 0))
            m.set(f"dev{i}_landed", w.landed_n)
            m.set(f"dev{i}_failed", p.device_errors + p.device_stalls)
            degraded = (
                # a cleanly stopped worker (halt) is not a fault; a
                # dead/errored one mid-run is
                (not w.alive() and not pool._stopping)
                or w.error is not None
                or p.stalled
                or (p.tripped and not p.healthy(now))
            )
            if (
                self._tracer is not None
                and degraded
                and not self._prev_degraded.get(i)
            ):
                self._tracer.point(SPAN.QUARANTINE, aux16=i)
            self._prev_degraded[i] = int(degraded)
            m.set(f"dev{i}_degraded", int(degraded))

    def on_crash(self, ctx: MuxCtx) -> None:
        """Restart hook (called after the dead incarnation's thread was
        joined, before on_boot re-runs): drop in-flight host state — a
        ring replay re-delivers anything the dead incarnation consumed
        but never forwarded.  The policy objects (device functions + trip
        state) survive into the next incarnation."""
        if self._pool is not None:
            zombies, _dropped = self._pool.abort()
            for i in zombies:
                # the zombie worker (stuck mid device/host call; threads
                # are unkillable) still holds its old policy — detach a
                # fresh copy so its late dispatch/land calls can't
                # corrupt the live incarnation's degradation state
                self._policies[i] = _clone_policy(
                    self._policies[i],
                    trip_after=self.fallback_trip,
                    reprobe_every=self.fallback_reprobe,
                )
            self._pool = None
        self._staged.clear()
        self._staged_lanes = 0
        self._outq.clear()
        self._outq_txns = 0

    def on_halt(self, ctx: MuxCtx) -> None:
        # drain everything: staged -> devices -> results -> downstream.
        # consumers are still running (the topology halts upstream-first),
        # so credits keep freeing.
        while self._staged_lanes:
            self._submit_front(self.max_lanes)
        pool = self._pool
        deadline = time.monotonic() + 60.0
        while not pool.idle() and time.monotonic() < deadline:
            self._land_results(ctx)
            if pool.outstanding:
                time.sleep(1e-3)
        pool.stop()
        self._land_results(ctx)
        deadline = time.monotonic() + 30.0
        while self._outq and time.monotonic() < deadline:
            cr = min(o.cr_avail() for o in ctx.outs) if ctx.outs else 0
            if cr <= 0:
                time.sleep(100e-6)
                continue
            ctx.credits = cr
            self._publish_ready(ctx)
        self._mirror_tick = 0  # force the per-device rows one last time
        self._mirror_policy_metrics(ctx)


def _resolve_devices(devices, dev, device_fn) -> list[int]:
    """`devices` spec -> device ordinals (pool domains).

    "auto" counts the local CUDA cards ONLY for a real card tile (a host
    tile or a stubbed one never asks); int N = ordinals 0..N-1 (logical
    domains when stubbed or on the CPU); an explicit list is taken
    verbatim (disjoint ordinal sets across seq-sharded replicas — see
    disco.topo.device_assignments)."""
    if devices in (None, 1, "off"):
        return [0]  # "off" mirrors disco.topo.device_assignments
    if devices == "auto":
        if dev is not None and dev.type == "cuda" and device_fn is None:
            return list(range(D.local_device_count()))
        return [0]
    if isinstance(devices, int):
        return list(range(max(devices, 1)))
    out = [int(d) for d in devices]
    return out or [0]


def _clone_policy(old, *, trip_after: int, reprobe_every: int):
    """Fresh policy object carrying over the old one's degradation state
    (a wedged zombie thread keeps a dead reference instead)."""
    if isinstance(old, DevicePolicy):
        p = DevicePolicy(
            old.device_fn, old.host_fn,
            index=old.index,
            trip_after=old.trip_after,
            backoff_base_s=old.backoff_base_s,
            backoff_max_s=old.backoff_max_s,
            stall_patience_s=old.stall_patience_s,
            fault_hook=old.fault_hook,
        )
        for attr in ("backoff_s", "quarantined_until", "device_stalls"):
            setattr(p, attr, getattr(old, attr))
        # NOT `stalled`: only the wedged call's return clears that flag,
        # and the zombie holds the OLD object — a copied flag would
        # quarantine the clone forever
    else:
        p = FallbackPolicy(
            old.device_fn, old.host_fn,
            trip_after=trip_after,
            reprobe_every=reprobe_every,
            fault_hook=old.fault_hook,
        )
    for attr in (
        "consec_failures", "tripped", "fallback_batches",
        "device_errors", "device_trips", "host_reprobes",
    ):
        setattr(p, attr, getattr(old, attr))
    return p


def _split_chunk(chunk: dict, k_txns: int, k_lanes: int) -> tuple[dict, dict]:
    """Split a staged chunk after k_txns txns / k_lanes lanes."""
    head, tail = {}, {}
    for key in ("rows", "szs", "tsorigs", "sig_cnt", "tags", "seqs"):
        head[key], tail[key] = chunk[key][:k_txns], chunk[key][k_txns:]
    for key in ("digests", "sigs", "pubs"):
        head[key], tail[key] = chunk[key][:k_lanes], chunk[key][k_lanes:]
    return head, tail


def _pad2(a: np.ndarray, n: int) -> np.ndarray:
    if len(a) == n:
        return a
    out = np.zeros((n,) + a.shape[1:], dtype=a.dtype)
    out[: len(a)] = a
    return out
