"""The port's run-loop profiler (firedancer_tpu_torch/disco/profile.py)
against the JAX package's: the same seeded call sequence through both
TileProfilers gives word-identical regions and equal profile_row,
aggregate and render_rows; a profiled thread run loop samples its
iterations; with the profiler off no region is allocated; and the
monitor's profile sub-row renders as JAX's over the same snapshot."""

import numpy as np
import pytest

from firedancer_tpu.app import monitor as MONJ
from firedancer_tpu.disco import metrics as MJ
from firedancer_tpu.disco import profile as PJ
from firedancer_tpu_torch.app import monitor as MONT
from firedancer_tpu_torch.disco import metrics as MT
from firedancer_tpu_torch.disco import profile as PT
from firedancer_tpu_torch.disco.topo import Topology
from firedancer_tpu_torch.tiles import wire
from firedancer_tpu_torch.tiles.dedup import DedupTile
from firedancer_tpu_torch.tiles.sink import SinkTile
from firedancer_tpu_torch.tiles.synth import SynthTile, make_txn_pool


def _region(P, M):
    return M.Metrics(np.zeros(M.Metrics.footprint(P.PROFILE_SCHEMA), np.uint8),
                     P.PROFILE_SCHEMA)


def _feed(prof, seed: int, n: int = 200) -> None:
    """A seeded call sequence over every writer method, with the negative
    and zero values the writers clamp."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        op = int(rng.integers(0, 5))
        a, b = (int(x) for x in rng.integers(-10**4, 10**8, 2))
        if op == 0:
            prof.add_iter(a, b, int(rng.integers(0, 3)) * int(rng.integers(0, 10**6)))
        elif op == 1:
            prof.add_phase(PT.PHASES[int(rng.integers(0, len(PT.PHASES)))], a, b)
        elif op == 2:
            prof.add_bp(a)
        elif op == 3:
            prof.add_sleep(a, b)
        else:
            prof.sched_lag(int(rng.integers(-10**3, 10**10)))


def test_schema_and_phases_match_jax():
    assert PT.PHASES == PJ.PHASES
    for k in ("counters", "hists", "wide_hists"):
        assert getattr(PT.PROFILE_SCHEMA, k) == getattr(PJ.PROFILE_SCHEMA, k)
    assert (MT.Metrics.footprint(PT.PROFILE_SCHEMA)
            == MJ.Metrics.footprint(PJ.PROFILE_SCHEMA))


@pytest.mark.parametrize("seeds", [(1,), (2, 3, 4)])
def test_profiler_readers_match_jax(seeds):
    port, jax = {}, {}
    for i, seed in enumerate(seeds):
        pm, jm = _region(PT, MT), _region(PJ, MJ)
        _feed(PT.TileProfiler(pm), seed)
        _feed(PJ.TileProfiler(jm), seed)
        assert pm.words.tobytes() == jm.words.tobytes()
        assert PT.profile_row(pm) == PJ.profile_row(jm)
        port[f"tile{i}"], jax[f"tile{i}"] = pm, jm
    assert PT.aggregate(port) == PJ.aggregate(jax)
    assert PT.render_rows(port) == PJ.render_rows(jax)
    assert MT.merge_hists([m.hist("sched_lag_us") for m in port.values()]) == \
        MJ.merge_hists([m.hist("sched_lag_us") for m in jax.values()])


def _relay(profile: bool):
    rows, szs, _ = make_txn_pool(8, seed=5)
    topo = Topology()
    topo.link("a", 64, wire.LINK_MTU)
    topo.link("b", 64, wire.LINK_MTU)
    topo.tile(SynthTile(rows, szs, total=32, repeat=2), outs=["a"])
    topo.tile(DedupTile(depth=1 << 10), ins=[("a", True)], outs=["b"])
    topo.tile(SinkTile(), ins=[("b", True)])
    if profile:
        topo.enable_profile()
    topo.build()
    return topo


def _run(topo) -> None:
    import time

    topo.start(idle_sleep_s=1e-3)
    try:
        deadline = time.monotonic() + 30
        while topo.metrics("sink").counter("in_frags") < 8:
            topo.poll_failure()
            assert time.monotonic() < deadline
            time.sleep(0.01)
        time.sleep(0.1)  # idle iterations: sleeps and housekeeping lag
    finally:
        topo.halt()


def test_profiled_thread_run_loop_samples():
    topo = _relay(profile=True)
    try:
        _run(topo)
        pm = topo.profile_metrics()
        assert sorted(pm) == ["dedup", "sink", "synth"]
        for name, m in pm.items():
            assert m.counter("iter_samples") > 0, name
            assert m.counter("sleeps") > 0 and m.hist("sched_lag_us")["count"] > 0
            assert topo.tiles[name].ctx.profiler.m is m
        agg = PT.aggregate(pm)
        assert 0.0 <= agg["gil_wait_frac"] <= 1.0 and agg["sched_lag_n"] > 0
        assert sorted(agg["tiles"]) == sorted(pm)
        assert PT.render_rows(pm).splitlines()[1].split()[0] == "dedup"
    finally:
        topo.close()


def test_profiler_off_allocates_nothing():
    topo = _relay(profile=False)
    try:
        _run(topo)
        assert topo.profile is None and topo.profile_metrics() == {}
        assert not any(k.startswith("profile_") for k in topo.wksp._allocs)
        assert all(ts.ctx.profiler is None for ts in topo.tiles.values())
        off = topo._footprint()
    finally:
        topo.close()
    on = _relay(profile=True)
    try:
        assert sorted(k for k in on.wksp._allocs if k.startswith("profile_")) == [
            "profile_dedup", "profile_sink", "profile_synth"]
        assert on._footprint() - off == 3 * (MT.Metrics.footprint(PT.PROFILE_SCHEMA) + 256)
    finally:
        on.close()


def test_monitor_profile_row_matches_jax():
    snap = {"verify": {"signal": "RUN", "heartbeat": 1, "stale": False,
                       "counters": {"in_frags": 5, "out_frags": 4, "loop_iters": 10,
                                    "backpressure_iters": 1},
                       "lat_hists": {}},
            "sink": {"signal": "RUN", "heartbeat": 1, "stale": False,
                     "counters": {"in_frags": 4, "out_frags": 0, "loop_iters": 9},
                     "lat_hists": {}}}
    out = {}
    for MON, P, M in ((MONT, PT, MT), (MONJ, PJ, MJ)):
        s = {k: dict(v) for k, v in snap.items()}
        m = _region(P, M)
        _feed(P.TileProfiler(m), 9)
        s["verify"]["profile"] = P.profile_row(m)
        s["sink"]["profile"] = P.profile_row(_region(P, M))  # no samples: no row
        out[MON] = MON.Monitor.render(object.__new__(MON.Monitor), None, s, 1.0)
    assert out[MONT] == out[MONJ]
    assert out[MONT].count("prof: gil_wait") == 1
