"""The verify tile's device pool: per-device fault domains, one worker
thread per device, and in-order landing.

The counterpart of firedancer_tpu/tiles/verify.py:171-700 (`DevicePolicy`,
`_DeviceWorker`, `_DevicePool`), with the same names, counters and
semantics; `VerifyTile` and its single-device `FallbackPolicy` wait for the
port of the tile runtime, where they get a caller.  How the JAX pool maps
onto PyTorch:

  * dispatch: a domain's device function is
    ops/ed25519/verify.verify_batch_digest_on(i), one per CUDA ordinal.  It
    launches asynchronously and returns the (B,) bool tensor on card i.
  * land: the one sync is the tensor's host copy (`.cpu()`), where a CUDA
    fault of the batch surfaces, as JAX's np.asarray does.
  * threads: each worker thread enters torch.cuda.device(i) itself,
    because the current device is per thread.  Two domains on one card
    share its default stream and run one after the other.
  * host strict path: ops/ed25519/hostpath.verify_batch_digest_host is the
    last resort of host domains only.  Where JAX lands a batch on the host
    when every device is out, a pool of CUDA domains raises DomainsOut:
    work for the card never moves to the CPU because a kernel failed.

A sticky CUDA error poisons the context of its card, so a domain
quarantined for one stays quarantined across its backoff re-probes: the
JAX semantics, not a fault of the port.  Host-to-device copies from
pageable numpy inputs are synchronous (pinned staging is later work).
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time

import numpy as np
import torch

from ..disco.mux import now_ts

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
