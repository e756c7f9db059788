"""The port's tile runtime and verify tile (firedancer_tpu_torch/disco/,
tiles/) against the JAX package's: FallbackPolicy batch by batch on a
scripted failing CPU device function, and the ingress topology synth ->
verify -> dedup -> sink at a small size (tests/test_pipeline.py's), the port
with device="cpu" (the plain versions) and with device="off" (the strict
host path), each against the JAX topology with device="off" (which needs no
JAX compile).  Everything compared is bytes, bools or counts: exact.

The run loops sleep 5 ms when idle (idle_sleep_s): at the default 50 µs the
idle tile threads starve the worker thread that launches the plain-torch
verify's small ops of the GIL (PERF.md)."""

import time

import numpy as np
import pytest
import torch

from firedancer_tpu.disco import Topology as TopologyJ
from firedancer_tpu.tiles import verify as VJ
from firedancer_tpu.tiles import wire as WJ
from firedancer_tpu.tiles.dedup import DedupTile as DedupJ
from firedancer_tpu.tiles.sink import SinkTile as SinkJ
from firedancer_tpu.tiles.synth import SynthTile as SynthJ
from firedancer_tpu.tiles.synth import make_txn_pool as make_pool_j
from firedancer_tpu_torch import entry
from firedancer_tpu_torch.disco import mux
from firedancer_tpu_torch.disco.topo import Topology, device_assignments
from firedancer_tpu_torch.tiles import verify as V
from firedancer_tpu_torch.tiles import wire as W
from firedancer_tpu_torch.tiles.dedup import DedupTile
from firedancer_tpu_torch.tiles.sink import SinkTile
from firedancer_tpu_torch.tiles.synth import SynthTile, make_txn_pool

IDLE_S = 5e-3

#: counters that do not depend on thread timing (loop iterations, batch
#: boundaries and device rows do)
EXACT = {
    "synth": ("out_frags", "out_bytes", "published_txns"),
    "verify": ("in_frags", "in_bytes", "out_frags", "out_bytes",
               "overrun_frags", "py_frags", "verify_fail_txns",
               "dedup_drop_txns", "verified_sigs", "fallback_batches",
               "device_errors", "device_trips", "host_reprobes",
               "pool_resubmits", "pool_late_results"),
    "dedup": ("in_frags", "in_bytes", "out_frags", "out_bytes",
              "overrun_frags", "dup_txns", "replay_amnesty", "amnesty_dropped"),
    "sink": ("in_frags", "in_bytes", "overrun_frags", "sunk_frags"),
}


def test_txn_pool_matches_jax():
    """The port's make_txn_pool (signed by its hostpath) gives the JAX
    package's pool byte for byte."""
    for a, b in zip(make_txn_pool(8, corrupt_frac=0.3, seed=17),
                    make_pool_j(8, corrupt_frac=0.3, seed=17)):
        np.testing.assert_array_equal(a, b)


# ---- FallbackPolicy ---------------------------------------------------------

def _policy_run(mod, script):
    """Drive a policy batch by batch: script[i] True = the device fails batch
    i (at dispatch for even i, at land for odd i); -> the counters after each
    batch and every verdict."""
    args = (np.zeros((2, 64), np.uint8),) * 2 + (np.zeros((2, 32), np.uint8),)
    i_box = [0]

    class LandFault:
        def __array__(self, *a, **k):
            raise RuntimeError("injected land fault")

    def device_fn(d, s, p):
        i = i_box[0]
        if script[i] and i % 2 == 0:
            raise RuntimeError("injected dispatch fault")
        return LandFault() if script[i] else np.ones(len(d), bool)

    def host_fn(d, s, p, lanes=None):
        return np.zeros(len(d), bool)

    pol = mod.FallbackPolicy(device_fn, host_fn, trip_after=3, reprobe_every=64)
    trace = []
    for i in range(len(script)):
        i_box[0] = i
        out = pol.land(pol.dispatch(args), args, lanes=2)
        trace.append((bool(out[0]), pol.tripped, pol.consec_failures,
                      pol.fallback_batches, pol.device_errors, pol.device_trips,
                      pol.host_reprobes))
    return trace


def test_fallback_policy_matches_jax_batch_by_batch():
    """Trip after 3 consecutive failures, host path while tripped, a
    re-probe every 64 batches that fails once and then recovers; the same
    counters as the JAX policy after every batch."""
    script = [False] * 3 + [True] * 5 + [False] * 60 + [True] * 70 + [False] * 80
    tp = _policy_run(V, script)
    tj = _policy_run(VJ, script)
    assert tp == tj
    last = tp[-1]
    assert last[5] == 1 and last[6] >= 2 and not last[1]  # tripped once, recovered
    assert any(t[1] for t in tp)


@pytest.fixture
def no_cuda_context(monkeypatch):
    """The worker thread enters torch.cuda.device for a card domain; this
    host's torch has no CUDA, so the context is a no-op here."""
    import contextlib

    monkeypatch.setattr(V, "_domain_device", lambda policy: contextlib.nullcontext())


def test_single_card_domain_raises_domains_out(no_cuda_context):
    """A single CUDA-marked FallbackPolicy domain that fails trips and the
    pool raises DomainsOut: no batch lands, none on the host."""
    calls = []

    def card_fn(d, s, p):
        calls.append(1)
        raise RuntimeError("injected device error")

    card_fn.device = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="no host path"):
        V.FallbackPolicy(card_fn, V.hostpath.verify_batch_digest_host)
    pol = V.FallbackPolicy(card_fn, trip_after=3)
    pool = V._DevicePool([pol], depth=2, name="t")
    args = (np.zeros((4, 64), np.uint8),) * 2 + (np.zeros((4, 32), np.uint8),)
    try:
        with pytest.raises(V.DomainsOut) as e:
            assert pool.submit(dict(lanes=4), args)
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                pool.poll()
                assert not pool.ready
                time.sleep(0.005)
        c = e.value.counters
        assert (c["device_errors"], c["device_trips"]) == (3, 1)
        assert c["fallback_batches"] == 0 and sum(c["landed"]) == 0
        assert len(calls) == 3 and pol.tripped and not pol.healthy()
    finally:
        pool.abort(timeout_s=5.0)


def test_clone_policy_carries_degradation_state():
    pol = V.FallbackPolicy(lambda *a: None, V.hostpath.verify_batch_digest_host)
    pol.tripped, pol.device_errors, pol.fallback_batches = True, 4, 2
    c = V._clone_policy(pol, trip_after=5, reprobe_every=9)
    assert (c.tripped, c.device_errors, c.fallback_batches, c.trip_after,
            c.reprobe_every) == (True, 4, 2, 5, 9)
    dp = V.DevicePolicy(lambda *a: None, index=3, stall_patience_s=7.0)
    dp.stalled, dp.device_stalls, dp.backoff_s = True, 2, 1.5
    c = V._clone_policy(dp, trip_after=1, reprobe_every=1)
    assert isinstance(c, V.DevicePolicy) and c.index == 3
    assert (c.stalled, c.device_stalls, c.backoff_s) == (False, 2, 1.5)


def test_on_crash_drops_in_flight_state():
    """The restart hook aborts the pool and clears staged and queued work;
    the policies survive."""
    tile = V.VerifyTile(max_lanes=32, device="off")
    ctx = mux.MuxCtx("verify", None, [], [], None)
    tile.on_boot(ctx)
    pols = tile._policies
    tile._staged.append({"seqs": np.zeros(1)})
    tile._staged_lanes = 1
    tile.on_crash(ctx)
    assert tile._pool is None and not tile._staged and tile._staged_lanes == 0
    assert tile._policies is pols


def test_unported_options_raise():
    """The process runtime and the profiler are ported and taken; the
    flight recorder, elastic shards and device universes still raise."""
    with pytest.raises(NotImplementedError):
        V.VerifyTile(device="off", device_universe=[0, 1])
    assert Topology(runtime="process").runtime == "process"
    with pytest.raises(ValueError, match="tile runtime"):
        Topology(runtime="bogus")
    with pytest.raises(ValueError, match="stem mode"):
        Topology(stem="bogus")
    topo = Topology()
    topo.enable_profile()
    assert topo.profile is True
    with pytest.raises(NotImplementedError):
        Topology().enable_flight()
    with pytest.raises(NotImplementedError):
        Topology().declare_shards("verify", ["verify"])
    with pytest.raises(ValueError, match="stem mode"):
        mux.run_loop(mux.Tile(), None, stem="bogus")


def test_verify_tile_device_resolution():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        V.VerifyTile()
    assert V.VerifyTile(device="cpu", devices="auto").device_indices == [0]
    assert V.VerifyTile(device="off", devices=3).device_indices == [0, 1, 2]
    assert device_assignments("auto", 2) == [[0], [0]]
    assert device_assignments(4, 2) == [[0, 2], [1, 3]]


# ---- the ingress topology -----------------------------------------------------

POOL_N, REPEAT = 24, 2


def _run_jax(rows, szs, good, *, pre_dedup=False, repeat=REPEAT, batch_max=32):
    """tests/test_pipeline.py's topology on the JAX package, device="off"."""
    total = len(rows) * repeat
    synth = SynthJ(rows, szs, total=total, repeat=repeat)
    verify = VJ.VerifyTile(msg_width=256, max_lanes=32, pad_full=True,
                           pre_dedup=pre_dedup, device="off")
    sink = SinkJ(record=True)
    topo = TopologyJ()
    names = ["synth", "verify", "sink"] if pre_dedup else ["synth", "verify", "dedup", "sink"]
    links = [f"{a}_{b}" for a, b in zip(names, names[1:])]
    for ln in links:
        topo.link(ln, depth=256, mtu=WJ.LINK_MTU)
    topo.tile(synth, outs=[links[0]])
    topo.tile(verify, ins=[(links[0], True)], outs=[links[1]])
    if not pre_dedup:
        topo.tile(DedupJ(depth=1 << 12), ins=[(links[1], True)], outs=[links[2]])
    topo.tile(sink, ins=[(links[-1], True)])
    topo.build()
    topo.start(batch_max=batch_max, idle_sleep_s=IDLE_S)
    try:
        deadline = time.monotonic() + 120.0
        mv, ms = topo.metrics("verify"), topo.metrics("sink")
        md = None if pre_dedup else topo.metrics("dedup")
        while time.monotonic() < deadline:
            topo.poll_failure()
            out = mv.counter("out_frags")
            if (out + mv.counter("verify_fail_txns")
                    + mv.counter("dedup_drop_txns") >= total
                    and (md is None or md.counter("in_frags") >= out)
                    and ms.counter("in_frags")
                    >= (out if md is None else md.counter("out_frags"))):
                break
            time.sleep(0.01)
        topo.halt()
        counters = {n: topo.metrics(n).read() for n in names}
    finally:
        topo.close()
    return counters, sink.all_sigs(), np.concatenate(sink.payloads)


@pytest.fixture(scope="module")
def pool():
    rows, szs, good = make_txn_pool(POOL_N, corrupt_frac=0.3, seed=17)
    assert 0 < good.sum() < POOL_N  # a mix of valid and corrupted
    return rows, szs, good


@pytest.fixture(scope="module")
def jax_run(pool):
    return _run_jax(*pool)


@pytest.mark.parametrize("device", ["cpu", "off"])
def test_ingress_topology_matches_jax(pool, jax_run, device):
    rows, szs, good = pool
    n_good = int(good.sum())
    r = entry.ingress(pool, total=POOL_N * REPEAT, repeat=REPEAT, max_lanes=32,
                      idle_sleep_s=IDLE_S, device=device)
    cj, sigs_j, payloads_j = jax_run
    c = r["counters"]
    for tile, names in EXACT.items():
        for name in names:
            assert c[tile][name] == cj[tile][name], (tile, name)
    # the verdicts follow the pool's good mask; dedup drops exactly repeats
    assert c["verify"]["in_frags"] == POOL_N * REPEAT
    assert c["verify"]["verify_fail_txns"] == (POOL_N - n_good) * REPEAT
    assert c["verify"]["out_frags"] == n_good * REPEAT
    assert c["dedup"]["dup_txns"] == n_good * (REPEAT - 1)
    assert c["sink"]["sunk_frags"] == n_good
    assert c["verify"]["device_batches"] >= 2
    # survivors: the good tags in stream order, payloads byte for byte
    np.testing.assert_array_equal(r["survivors"], sigs_j)
    np.testing.assert_array_equal(r["survivors"], r["pool"]["tags"][good])
    np.testing.assert_array_equal(r["payloads"], payloads_j)
    for t, row, sz in zip(r["survivors"], r["payloads"], r["sizes"]):
        i = int(np.flatnonzero(r["pool"]["tags"] == t)[0])
        assert sz == szs[i] and (row[:sz] == rows[i, :sz]).all()
    assert len(r["landed_stamps"]) == c["verify"]["device_batches"]
    assert r["txns_per_s"] > 0 and r["e2e_p99_us"] >= r["e2e_p50_us"] > 0


@pytest.mark.parametrize("device", ["cpu", "off"])
def test_verify_pre_dedup_with_duplicates_matches_jax(device):
    """tests/test_pipeline.py's pre_dedup case: back-to-back duplicate sigs
    dropped by the verify tile's 16-deep tag cache, the same counters as the
    JAX tile's."""
    pool_n, repeat = 6, 2
    rows, szs, good = make_txn_pool(pool_n, seed=37)
    cj, sigs_j, _ = _run_jax(rows, szs, good, pre_dedup=True, repeat=repeat,
                             batch_max=pool_n * repeat)
    synth = SynthTile(rows, szs, total=pool_n * repeat, repeat=repeat)
    verify = V.VerifyTile(msg_width=256, max_lanes=32, pad_full=True,
                          pre_dedup=True, device=device)
    sink = SinkTile(record=True)
    topo = Topology()
    topo.link("synth_verify", depth=64, mtu=W.LINK_MTU)
    topo.link("verify_sink", depth=64, mtu=W.LINK_MTU)
    topo.tile(synth, outs=["synth_verify"])
    topo.tile(verify, ins=[("synth_verify", True)], outs=["verify_sink"])
    topo.tile(sink, ins=[("verify_sink", True)])
    topo.start(batch_max=pool_n * repeat, idle_sleep_s=IDLE_S)
    try:
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            topo.poll_failure()
            if topo.metrics("sink").counter("sunk_frags") >= pool_n:
                break
            time.sleep(0.01)
        topo.halt()
        mv = topo.metrics("verify")
        assert mv.counter("dedup_drop_txns") == pool_n * (repeat - 1)
        assert topo.metrics("sink").counter("sunk_frags") == pool_n
        for name in ("in_frags", "dedup_drop_txns", "verified_sigs", "out_frags"):
            assert mv.counter(name) == cj["verify"][name], name
        np.testing.assert_array_equal(sink.all_sigs(), sigs_j)
    finally:
        topo.close()


def test_verify_tile_failure_reaches_poll_failure(no_cuda_context):
    """A card domain whose device function fails: the verify tile's pool
    raises DomainsOut and the topology fails visibly through poll_failure
    (nothing lands on the host)."""
    def card_fn(d, s, p):
        raise RuntimeError("injected device error")

    card_fn.device = torch.device("cuda", 0)
    rows, szs, _ = make_txn_pool(4, seed=2)
    synth = SynthTile(rows, szs, total=4)
    verify = V.VerifyTile(max_lanes=4, device="off", device_fn=card_fn)
    topo = Topology()
    topo.link("synth_verify", depth=64, mtu=W.LINK_MTU)
    topo.link("verify_sink", depth=64, mtu=W.LINK_MTU)
    topo.tile(synth, outs=["synth_verify"])
    topo.tile(verify, ins=[("synth_verify", True)], outs=["verify_sink"])
    topo.tile(SinkTile(), ins=[("verify_sink", True)])
    topo.start(batch_max=4, idle_sleep_s=1e-3)
    try:
        deadline = time.monotonic() + 30.0
        with pytest.raises(RuntimeError, match="verify") as e:
            while time.monotonic() < deadline:
                topo.poll_failure()
                time.sleep(0.01)
        assert isinstance(e.value.__cause__, V.DomainsOut)
        assert topo.metrics("verify").counter("out_frags") == 0
        assert verify._policy.fallback_batches == 0
    finally:
        topo.close()


def test_verify_tile_forms_full_batches():
    """With a ring that holds the run, every device batch is full: a
    partial batch goes out only after a drain comes back empty, so a drain
    that catches the synth mid-publish does not split a batch (where the
    JAX tile would submit the part at once)."""
    pool = make_txn_pool(8, seed=23)
    r = entry.ingress(pool, total=128, max_lanes=32, idle_sleep_s=1e-3,
                      device="off")
    v = r["counters"]["verify"]
    assert v["device_batches"] == 4 and v["verified_sigs"] == 128
    assert [lanes for _seq, _dev, lanes, _d, _l in r["landed_stamps"]] == [32] * 4
    assert r["counters"]["sink"]["sunk_frags"] == 8
