"""The port's verify device pool (firedancer_tpu_torch/tiles/verify.py) on N
CPU callables: the `_DevicePool` and `_DeviceWorker` cases of
tests/test_multichip.py that need no tile, with each domain's "card" the
JAX package's strict host verifier (bit-identical to the device kernel's
accept set), so every verdict is held against the JAX package on the same
seeded inputs; then parallel/dryrun.py's run_verify_pool over CPU domains of
the port's verify_batch_digest_on("cpu").
"""

import hashlib
import threading
import time

import numpy as np
import pytest
import torch

from firedancer_tpu.ops.ed25519 import hostpath as HJ
from firedancer_tpu_torch.ops.ed25519 import hostpath
from firedancer_tpu_torch.ops.ed25519 import verify as V
from firedancer_tpu_torch.parallel import dryrun
from firedancer_tpu_torch.tiles.verify import (
    DevicePolicy,
    DomainsOut,
    _DevicePool,
    _DeviceWorker,
)

N_DEV = 8
LANES = 8


def _real_dev(digests, sigs, pubs):
    """Stub card: the JAX package's strict host verifier."""
    return HJ.verify_batch_digest_host(digests, sigs, pubs)


def _wait(cond, deadline_s: float, fail=lambda: None, poll_s: float = 0.02):
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        if cond():
            return
        fail()
        time.sleep(poll_s)
    raise TimeoutError("condition not reached")


def _batches(n_batches, seed, corrupt_frac=0.25):
    """Batches of LANES signed digests, a share of them corrupted; -> the
    batches and the golden-signed ground truth per batch."""
    rng = np.random.default_rng(seed)
    sks = [rng.bytes(32) for _ in range(4)]
    out, good = [], []
    for _ in range(n_batches):
        dg = np.zeros((LANES, 64), np.uint8)
        sg = np.zeros((LANES, 64), np.uint8)
        pb = np.zeros((LANES, 32), np.uint8)
        ok = rng.random(LANES) >= corrupt_frac
        for i in range(LANES):
            sk = sks[i % len(sks)]
            pk = hostpath.public_from_secret(sk)
            msg = rng.bytes(48)
            sig = bytearray(hostpath.sign(sk, msg))
            if not ok[i]:
                sig[5] ^= 0x40  # bad R
            sg[i] = np.frombuffer(bytes(sig), np.uint8)
            pb[i] = np.frombuffer(pk, np.uint8)
            dg[i] = np.frombuffer(
                hashlib.sha512(bytes(sig[:32]) + pk + msg).digest(), np.uint8)
        out.append((dg, sg, pb))
        good.append(ok)
    return out, good


def _pool(fault_hook=None, n=N_DEV, host=hostpath.verify_batch_digest_host, **kw):
    policies = [
        DevicePolicy(_real_dev, host, index=i, fault_hook=fault_hook, **kw)
        for i in range(n)
    ]
    return policies, _DevicePool(policies, depth=2, name="t")


def _run(batches, fault_hook=None, **kw):
    policies, pool = _pool(fault_hook, **kw)
    try:
        verdicts = dryrun.drive_pool(pool, batches, timeout_s=120.0)
    finally:
        pool.stop(timeout_s=10.0)
    return verdicts, policies, pool


def _counter(policies, name):
    return sum(getattr(p, name) for p in policies)


def test_verify_pool_8dev_correctness_order_spread():
    """Agree with the golden-signed ground truth and the JAX host verifier,
    land strictly in submission order, and spread over the domains."""
    batches, good = _batches(12, seed=43)
    verdicts, policies, pool = _run(batches)
    for (dg, sg, pb), ok, want in zip(batches, verdicts, good):
        np.testing.assert_array_equal(ok, want)
        np.testing.assert_array_equal(ok, HJ.verify_batch_digest_host(dg, sg, pb))
    assert _counter(policies, "fallback_batches") == 0
    assert _counter(policies, "device_errors") == 0
    landed = [w.landed_n for w in pool.workers]
    assert sum(landed) == len(batches)
    assert sum(1 for n in landed if n > 0) >= 2, landed


def test_verify_pool_device_kill_chaos():
    """A device that fails every batch is quarantined and its batches are
    resubmitted to healthy domains: nothing lost or duplicated, in order."""
    dead = 3
    hits = []

    def hook(index):
        if index == dead:
            hits.append(index)
            raise RuntimeError("injected device error")

    batches, good = _batches(12, seed=47)
    verdicts, policies, pool = _run(
        batches, hook, trip_after=2, backoff_base_s=300.0, backoff_max_s=300.0)
    for ok, want in zip(verdicts, good):
        np.testing.assert_array_equal(ok, want)
    assert len(hits) >= 1
    assert policies[dead].device_errors >= 1
    assert pool.resubmits >= 1
    assert pool.workers[dead].landed_n == 0
    landed = [w.landed_n for i, w in enumerate(pool.workers) if i != dead]
    assert sum(landed) == len(batches)
    assert sum(1 for n in landed if n > 0) >= 2, landed
    assert _counter(policies, "fallback_batches") == 0


def test_verify_pool_all_devices_dead_falls_to_host():
    """Every domain erroring: the strict host path is the last resort, and
    the batches it served count as fallback degradation."""
    def hook(index):
        raise RuntimeError("injected device error")

    batches, good = _batches(6, seed=53)
    verdicts, policies, pool = _run(
        batches, hook, n=4, trip_after=1, backoff_base_s=300.0,
        backoff_max_s=300.0)
    for ok, want in zip(verdicts, good):
        np.testing.assert_array_equal(ok, want)
    assert _counter(policies, "fallback_batches") >= 1
    assert _counter(policies, "device_trips") >= 1


def test_verify_pool_all_devices_dead_without_host_path_raises():
    """Every domain erroring and none with a host path (as CUDA domains
    have none): poll raises DomainsOut, with the counters, and no batch
    lands."""
    def hook(index):
        raise RuntimeError("injected device error")

    batches, _ = _batches(3, seed=59)
    with pytest.raises(DomainsOut) as e:
        _run(batches, hook, n=2, host=None, trip_after=1,
             backoff_base_s=300.0, backoff_max_s=300.0)
    c = e.value.counters
    assert c["device_trips"] == 2 and c["fallback_batches"] == 0
    assert sum(c["landed"]) == 0


def test_card_domain_refuses_a_host_path():
    """A device function pinned to a CUDA card cannot be given the host
    path: its batches land on the card or the pool raises."""
    def card_fn(d, s, p):  # never called
        raise AssertionError

    card_fn.device = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="no host path"):
        DevicePolicy(card_fn, hostpath.verify_batch_digest_host)
    assert DevicePolicy(card_fn).host_fn is None


def test_pool_stall_patience_quarantines_only_stalled_device():
    """A wedged device call degrades only its domain: in-flight batches move
    to healthy domains, landing stays in order, and the late result from the
    recovered domain is dropped."""
    release = threading.Event()
    hit = threading.Event()

    def wedge_fn(d, s, p):
        hit.set()
        assert release.wait(30.0)
        return np.ones(len(d), bool)

    def fast_fn(d, s, p):
        return np.ones(len(d), bool)

    mk = lambda fn, i: DevicePolicy(  # noqa: E731
        fn, hostpath.verify_batch_digest_host, index=i,
        stall_patience_s=0.1, backoff_base_s=300.0, backoff_max_s=300.0,
    )
    policies = [mk(wedge_fn, 0), mk(fast_fn, 1), mk(fast_fn, 2)]
    pool = _DevicePool(policies, depth=2, name="t")
    try:
        args = (np.zeros((4, 64), np.uint8),) * 2 + (np.zeros((4, 32), np.uint8),)
        n = 8
        metas = [dict(lanes=4, i=i) for i in range(n)]
        submitted = 0
        landed = []
        deadline = time.monotonic() + 30.0
        while len(landed) < n and time.monotonic() < deadline:
            while submitted < n and pool.submit(metas[submitted], args):
                submitted += 1
            pool.poll()
            while pool.ready:
                landed.append(pool.ready.popleft()[0])
            time.sleep(0.005)
        assert [m["pool_seq"] for m in landed] == list(range(n))
        assert [m["i"] for m in landed] == list(range(n))
        assert hit.is_set()
        assert policies[0].stalled and policies[0].device_stalls == 1
        assert not policies[1].stalled and not policies[2].stalled
        assert pool.resubmits >= 1
        release.set()
        _wait(lambda: pool.late_results >= 1, 10.0, pool.poll)
        assert not pool.ready  # no duplicate publish
        assert not policies[0].stalled  # the returned call clears it
    finally:
        release.set()
        pool.stop(timeout_s=5.0)


def test_device_worker_abort_drains_wedged_queue():
    """abort() on a worker wedged inside a device call hands back every
    batch it never landed: the queued ones and the one in flight."""
    release = threading.Event()
    entered = threading.Event()

    def wedge_fn(x):
        entered.set()
        assert release.wait(30.0)
        return np.ones(1, bool)

    p = DevicePolicy(wedge_fn, hostpath.verify_batch_digest_host)
    w = _DeviceWorker(p, depth=3, name="t-wedge")
    try:
        for i in range(3):
            w.submit({"lanes": 1, "i": i}, ("x",))
        assert entered.wait(10.0)
        drained = w.abort(timeout_s=0.3)
        assert sorted(m["i"] for m, _, _ in drained) == [0, 1, 2]
        assert w.submitted_n == 3 and w.completed_n == 0
        assert w.thread.is_alive()  # the zombie is reported, not joined
    finally:
        release.set()


def test_device_worker_stop_timeout_bounded_when_wedged():
    """stop(timeout_s) on a worker wedged with a full queue returns within
    its bound."""
    release = threading.Event()
    entered = threading.Event()

    def wedge_fn(x):
        entered.set()
        assert release.wait(30.0)
        return np.ones(1, bool)

    p = DevicePolicy(wedge_fn, hostpath.verify_batch_digest_host)
    w = _DeviceWorker(p, depth=2, name="t-stopwedge")
    try:
        for i in range(3):  # 1 wedged in flight + 2 filling the queue
            while w.reqq.full():
                time.sleep(0.001)
            w.submit({"lanes": 1, "i": i}, ("x",))
        assert entered.wait(10.0)
        _wait(lambda: w.reqq.full(), 10.0)
        t0 = time.monotonic()
        w.stop(timeout_s=0.5)
        assert time.monotonic() - t0 < 5.0
        assert w.thread.is_alive()  # abandoned daemon, not joined
    finally:
        release.set()


def test_pool_stalled_flag_cleared_when_watchdog_races_return():
    """A mark_stalled() after the wedged call already returned must not
    quarantine the idle domain forever."""
    p = DevicePolicy(
        lambda *a: np.ones(4, bool), hostpath.verify_batch_digest_host,
        index=0, stall_patience_s=60.0,
    )
    pool = _DevicePool([p], depth=2, name="t-race")
    try:
        p.mark_stalled()
        assert p.stalled
        pool.poll()
        assert not p.stalled
        assert p.tripped and p.backoff_s > 0
    finally:
        pool.stop(timeout_s=5.0)


def test_device_worker_abort_clean_exit_asserts_conservation():
    """submitted == landed + drained on a cleanly exited worker."""
    p = DevicePolicy(lambda x: np.ones(1, bool), hostpath.verify_batch_digest_host)
    w = _DeviceWorker(p, depth=2, name="t-clean")
    for i in range(4):
        while w.reqq.full():
            time.sleep(0.001)
        w.submit({"lanes": 1, "i": i}, ("x",))
    _wait(lambda: w.completed_n == 4, 10.0)
    drained = w.abort(timeout_s=5.0)
    assert drained == [] and not w.thread.is_alive()
    assert len(w.results) == 4


def test_run_verify_pool_cpu_domains():
    """run_verify_pool over two CPU domains of verify_batch_digest_on: the
    default batches (valid signatures) land in order and spread."""
    rep = dryrun.run_verify_pool(2, lanes=4, device="cpu")
    assert len(rep["verdicts"]) == 4 and all(v.all() for v in rep["verdicts"])
    assert rep["fallback_batches"] == 0 and rep["device_errors"] == 0
    assert sum(rep["landed"]) == 4 and min(rep["landed"]) >= 1


def test_run_verify_pool_fault_injected_domain_lands_on_host():
    """A CPU domain whose first dispatch raises is quarantined, and the
    batch lands through the strict host path with the same verdicts as the
    domain's function and the JAX host verifier."""
    batches, good = _batches(2, seed=61)
    calls = []

    def first_dispatch_fails(index):
        calls.append(index)
        if len(calls) == 1:
            raise RuntimeError("injected device error")

    rep = dryrun.run_verify_pool(1, device="cpu", batches=batches,
                                 fault_hook=first_dispatch_fails, trip_after=1,
                                 backoff_base_s=300.0, backoff_max_s=300.0)
    for (dg, sg, pb), ok, want in zip(batches, rep["verdicts"], good):
        np.testing.assert_array_equal(ok, want)
        np.testing.assert_array_equal(
            ok, V.verify_batch_digest(dg, sg, pb, device="cpu").numpy())
    assert rep["device_errors"] == 1 and rep["device_trips"] == 1
    assert rep["fallback_batches"] == 2  # quarantined: both went to the host


def test_land_syncs_on_the_tensor_host_copy():
    """A domain returning a tensor lands as numpy (the .cpu() copy)."""
    batches, good = _batches(1, seed=67)
    fn = V.verify_batch_digest_on("cpu")
    policies = [DevicePolicy(fn, hostpath.verify_batch_digest_host, index=0)]
    pool = _DevicePool(policies, depth=2, name="t-tensor")
    try:
        (ok,) = dryrun.drive_pool(pool, batches, timeout_s=120.0)
    finally:
        pool.stop(timeout_s=10.0)
    assert isinstance(ok, np.ndarray) and ok.dtype == bool
    np.testing.assert_array_equal(ok, good[0])
