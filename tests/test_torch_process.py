"""The port's process runtime (Topology(runtime="process"): one spawned OS
process per tile), the counterparts of tests/test_topo_process.py without
its supervisor tests: golden parity of a synth -> dedup -> sink relay
against the thread runtime and the JAX package; a monitor attached from a
third process, profile rows included; a boot failure raised with the tile's
name and traceback, leaving no file; quic -> verify -> dedup -> pack as
children; a handshake mismatch refused before any ring is bound (and
admitted once approved); the refusals of what waits for unported modules
(restarts, fault injection, hot upgrade); entry.ingress(runtime="process",
device="cpu") held to chip_smoke.check_tiles; and every tile of the
validator topology pickling, as a spawn needs.

Every topology here is named after this process's pid (an anonymous
process topology is auto-named so too), and the no_shm_leak fixture checks
both packages' /dev/shm prefixes for those names, so other test workers'
workspaces never trip it."""

from __future__ import annotations

import glob
import json
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

import chip_smoke as CS
from firedancer_tpu.disco import Topology as TopologyJ
from firedancer_tpu.tiles.dedup import DedupTile as DedupJ
from firedancer_tpu.tiles.sink import SinkTile as SinkJ
from firedancer_tpu.tiles.sink import read_siglog as read_siglog_j
from firedancer_tpu.tiles.synth import SynthTile as SynthJ
from firedancer_tpu_torch import entry
from firedancer_tpu_torch.app import config as C
from firedancer_tpu_torch.disco import handshake as HS
from firedancer_tpu_torch.disco.metrics import MetricsSchema
from firedancer_tpu_torch.disco.mux import MuxCtx, Tile
from firedancer_tpu_torch.disco.topo import PSTAT_BOOTED, Topology
from firedancer_tpu_torch.flamenco.accounts import Account, AccountMgr
from firedancer_tpu_torch.funk import Funk
from firedancer_tpu_torch.tango import rings as R
from firedancer_tpu_torch.tiles import wire
from firedancer_tpu_torch.tiles.dedup import DedupTile
from firedancer_tpu_torch.tiles.sink import SIGLOG_ALLOC, SinkTile, read_siglog
from firedancer_tpu_torch.tiles.synth import SynthTile, make_txn_pool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PID = os.getpid()


@pytest.fixture(autouse=True)
def no_shm_leak():
    """No process run leaves a workspace, directory or err sidecar under
    either package's prefix (close() reaps and unlinks, also after a
    child died mid-boot)."""
    pats = (f"/dev/shm/fdt_wksp_*{PID}*", f"{R.SHM_PREFIX}*{PID}*")
    before = {p for pat in pats for p in glob.glob(pat)}
    yield
    leaked = {p for pat in pats for p in glob.glob(pat)} - before
    assert not leaked, f"leaked shm files: {sorted(leaked)}"


def _wait(cond, what: str, topo=None, deadline_s: float = 120.0) -> None:
    deadline = time.monotonic() + deadline_s
    while not cond():
        if topo is not None:
            topo.poll_failure()
        if time.monotonic() > deadline:
            raise TimeoutError(what)
        time.sleep(0.02)


POOL_N, REPEAT = 48, 3


def _relay(T, Synth, Dedup, Sink, name, runtime=None):
    rows, szs, _ = make_txn_pool(POOL_N, seed=7)
    topo = T(name=name, runtime=runtime) if runtime else T(name=name)
    topo.link("synth_dedup", depth=256, mtu=wire.LINK_MTU)
    topo.link("dedup_sink", depth=256, mtu=wire.LINK_MTU)
    topo.tile(Synth(rows, szs, total=POOL_N * REPEAT, repeat=REPEAT), outs=["synth_dedup"])
    topo.tile(Dedup(depth=1 << 14), ins=[("synth_dedup", True)], outs=["dedup_sink"])
    topo.tile(Sink(shm_log=1 << 12), ins=[("dedup_sink", True)])
    return topo


def _run_relay(T, Synth, Dedup, Sink, read, runtime=None, profile=False):
    topo = _relay(T, Synth, Dedup, Sink, f"tp{PID}_{runtime or 'jax'}", runtime)
    if profile:
        topo.enable_profile()
    topo.build()
    topo.start(batch_max=64, boot_timeout_s=300.0)
    try:
        md, ms = topo.metrics("dedup"), topo.metrics("sink")
        _wait(lambda: md.counter("in_frags") >= POOL_N * REPEAT
              and ms.counter("in_frags") >= POOL_N, "relay", topo)
        topo.halt()
        sigs = read(topo.tile_alloc_view("sink", "siglog"))
        counters = {"dedup_in": md.counter("in_frags"), "dups": md.counter("dup_txns"),
                    "sunk": ms.counter("in_frags"),
                    "overruns": sum(topo.metrics(n).counter("overrun_frags")
                                    for n in topo.tiles)}
        prof = topo.profile_metrics() if profile else None
        rows = {n: m.counter("iter_samples") for n, m in (prof or {}).items()}
        return sigs.tolist(), counters, rows
    finally:
        topo.close()


def test_process_golden_parity_with_threaded_and_jax():
    """Same pool: the thread runtime, the process runtime and the JAX
    package's thread runtime keep the same survivors in the same order,
    with the same accounting; the profiled children sampled their loops."""
    t = _run_relay(Topology, SynthTile, DedupTile, SinkTile, read_siglog, "thread")
    p = _run_relay(Topology, SynthTile, DedupTile, SinkTile, read_siglog, "process",
                   profile=True)
    j = _run_relay(TopologyJ, SynthJ, DedupJ, SinkJ, read_siglog_j)
    assert p[0] == t[0] == j[0] and len(set(p[0])) == len(p[0]) == POOL_N
    assert p[1] == t[1] == j[1] and p[1]["overruns"] == 0
    assert sorted(p[2]) == ["dedup", "sink", "synth"] and all(v > 0 for v in p[2].values())


def test_process_monitor_attaches_from_third_process():
    """app/monitor.py attaches read-only from a genuinely separate process
    while the children run, and shows live counters, signals and every
    tile's profile row."""
    topo = _relay(Topology, SynthTile, DedupTile, SinkTile, f"tm{PID}", "process")
    topo.enable_profile()
    topo.build()
    topo.start(batch_max=64, boot_timeout_s=300.0)
    try:
        md = topo.metrics("dedup")
        _wait(lambda: md.counter("in_frags") >= POOL_N * REPEAT, "relay", topo)
        pids = {n: topo.tile_pid(n) for n in topo.tiles}
        assert len(set(pids.values())) == 3 and PID not in pids.values()
        r = subprocess.run(
            [sys.executable, "-m", "firedancer_tpu_torch.app.monitor", topo.name,
             "--once", "--json"],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        doc = json.loads(r.stdout)
        assert set(doc["tiles"]) == {"synth", "dedup", "sink"}
        assert doc["tiles"]["dedup"]["counters"]["in_frags"] >= POOL_N * REPEAT
        assert doc["tiles"]["dedup"]["signal"] == "RUN"
        assert all(t["profile"]["samples"] > 0 for t in doc["tiles"].values())
        r = subprocess.run(
            [sys.executable, "-m", "firedancer_tpu_torch.app.monitor", topo.name,
             "--once"], cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert r.returncode == 0 and r.stdout.count("prof: gil_wait") == 3, r.stdout
        topo.halt()
    finally:
        topo.close()


class _BoomBootTile(Tile):
    name = "boomboot"
    schema = MetricsSchema()

    def on_boot(self, ctx: MuxCtx) -> None:
        raise RuntimeError("scripted boot failure")


def test_process_boot_failure_raises_and_cleans():
    """A child that dies in on_boot is a construction error (the pstat
    booted word): start() raises naming the tile, with the child's
    traceback from its err sidecar, and close() leaves no file and no
    child."""
    rows, szs, _ = make_txn_pool(4, seed=13)
    topo = Topology(name=f"tb{PID}", runtime="process")
    topo.link("s", depth=64, mtu=wire.LINK_MTU)
    topo.tile(SynthTile(rows, szs, total=8), outs=["s"])
    topo.tile(_BoomBootTile(), ins=[("s", True)])
    topo.build()
    try:
        with pytest.raises(RuntimeError, match="boomboot") as ei:
            topo.start(batch_max=16, boot_timeout_s=300.0)
        msg = str(ei.value)
        assert "during boot" in msg and "scripted boot failure" in msg
        assert int(topo._pstat("boomboot")[PSTAT_BOOTED]) == 0
        assert all(ts.proc is None for ts in topo.tiles.values())
        assert glob.glob(f"{R.SHM_PREFIX}tb{PID}.err_boomboot")
    finally:
        topo.close()
    assert not glob.glob(f"{R.SHM_PREFIX}tb{PID}*")


class _LaunchCountTile(Tile):
    """Bumps two kernel wrappers' launch counters in its own process, as
    a launch on the card would."""

    name = "launcher"
    schema = MetricsSchema()

    def on_boot(self, ctx: MuxCtx) -> None:
        from firedancer_tpu_torch.ops.ed25519 import msm, verify_core

        verify_core.LAUNCHES += 3
        msm.LAUNCHES["msm_buckets"] += 2


def test_process_child_publishes_its_launches():
    """A child's kernel launches count in its own interpreter: it
    publishes them, and whether it made a CUDA context, in its pstat
    words as it exits (Topology.tile_device); a thread tile has none."""
    rows, szs, _ = make_txn_pool(4, seed=13)
    topo = Topology(name=f"tl{PID}", runtime="process")
    topo.link("s", depth=64, mtu=wire.LINK_MTU)
    topo.tile(SynthTile(rows, szs, total=8), outs=["s"])
    topo.tile(_LaunchCountTile(), ins=[("s", True)])
    topo.build()
    try:
        topo.start(batch_max=16, boot_timeout_s=300.0)
        topo.halt()
        got = topo.tile_device("launcher")
        assert got["cuda"] is False
        assert got["launches"] == {"verify_core": 3, "decompress_niels": 0,
                                   "msm_buckets": 2, "pack_select": 0,
                                   "sha256_blocks": 0, "poh_chain": 0}
        assert topo.tile_device("synth") == {"cuda": False, "launches": dict.fromkeys(
            got["launches"], 0)}
    finally:
        topo.close()
    th = Topology(runtime="thread")
    th.link("s", depth=64, mtu=wire.LINK_MTU)
    th.tile(SynthTile(rows, szs, total=8), outs=["s"])
    th.tile(SinkTile(), ins=[("s", True)])
    th.build()
    try:
        th.start(batch_max=16)
        th.halt()
        assert th.tile_device("synth") is None
    finally:
        th.close()


class _EchoBankTile(Tile):
    """Bank stand-in: completes each microblock at pack with its (bank <<
    32 | handle) tag, as tiles/bank.py does, without executing."""

    name = "bank0"
    schema = MetricsSchema(counters=("echoed_mbs",))

    def on_frags(self, ctx: MuxCtx, in_idx: int, frags: np.ndarray) -> None:
        rows = ctx.ins[in_idx].gather(frags)
        tags = [(int(r[4:6].view("<u2")[0]) << 32) | int(r[0:4].view("<u4")[0])
                for r in rows]
        ctx.publish(np.array(tags, dtype=np.uint64))
        ctx.metrics.inc("echoed_mbs", len(tags))


def test_process_quic_verify_dedup_pack():
    """quic (real UDP ingress on a fixed port: the child binds it) ->
    verify (host path) -> dedup -> pack, with a bank echo, every tile a
    child: each unique txn is inserted into pack once and scheduled."""
    from firedancer_tpu_torch.tiles.pack import PackTile
    from firedancer_tpu_torch.tiles.quic import QuicIngressTile
    from firedancer_tpu_torch.tiles.verify import VerifyTile

    identity = np.random.default_rng(31).integers(0, 256, 32, np.uint8).tobytes()
    udp_port = CS.free_port()
    n_txns = 32
    rows, szs, _ = make_txn_pool(n_txns, seed=11)
    tr = wire.parse_trailers(rows, szs.astype(np.int64))
    topo = Topology(name=f"tq{PID}", runtime="process")
    topo.link("quic_verify", depth=256, mtu=wire.LINK_MTU)
    topo.link("verify_dedup", depth=256, mtu=wire.LINK_MTU)
    topo.link("dedup_pack", depth=256, mtu=wire.LINK_MTU)
    topo.link("pack_bank0", depth=256, mtu=65_535)
    topo.link("bank0_pack", depth=256)
    topo.tile(QuicIngressTile(identity, udp_addr=("127.0.0.1", udp_port)),
              outs=["quic_verify"])
    topo.tile(VerifyTile(msg_width=256, max_lanes=64, pad_full=True, pre_dedup=False,
                         device="off"),
              ins=[("quic_verify", True)], outs=["verify_dedup"])
    topo.tile(DedupTile(depth=1 << 10), ins=[("verify_dedup", True)], outs=["dedup_pack"])
    topo.tile(PackTile(1, mb_inflight=4, microblock_ns=1_000_000, txn_limit=8),
              ins=[("dedup_pack", True), ("bank0_pack", True)], outs=["pack_bank0"])
    topo.tile(_EchoBankTile(), ins=[("pack_bank0", True)], outs=["bank0_pack"])
    topo.build()
    topo.start(batch_max=64, boot_timeout_s=300.0)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        mp = topo.metrics("pack")
        deadline = time.monotonic() + 90.0
        while time.monotonic() < deadline:
            topo.poll_failure()
            # resend until through (UDP may drop; dedup collapses repeats)
            for i in range(n_txns):
                tx.sendto(rows[i, : tr["txn_sz"][i]].tobytes(), ("127.0.0.1", udp_port))
            if mp.counter("inserted_txns") >= n_txns and mp.counter("microblocks") >= 1:
                break
            time.sleep(0.2)
        assert mp.counter("inserted_txns") == n_txns
        assert mp.counter("microblocks") >= 1
        assert topo.metrics("verify").counter("verify_fail_txns") == 0
        assert topo.metrics("bank0").counter("echoed_mbs") >= 1
        topo.halt()
    finally:
        tx.close()
        topo.close()


def _handshake_topo(name: str):
    rows, szs, _ = make_txn_pool(4, seed=3)
    topo = Topology(name=name, runtime="process")
    topo.link("s", depth=64, mtu=wire.LINK_MTU)
    topo.tile(SynthTile(rows, szs, total=4), outs=["s"])
    topo.tile(SinkTile(shm_log=16), ins=[("s", True)])
    topo.build()
    return topo


def test_process_handshake_mismatch_refused_before_any_ring():
    """A workspace whose handshake word is another tree's digest refuses
    every child right after attach: start() raises with both digests, no
    child reached RUN, published a frag or moved an fseq; once the
    child's digest is approved into the compat table, the same shape
    boots and relays."""
    mine = R.abi_digest()
    foreign = mine ^ 0xF0F0
    topo = _handshake_topo(f"th{PID}")
    try:
        topo.handshake().words[1] = np.uint64(foreign)
        with pytest.raises(RuntimeError, match="version handshake refused") as ei:
            topo.start(batch_max=16, boot_timeout_s=300.0)
        assert f"{foreign:#018x}" in str(ei.value) and f"{mine:#018x}" in str(ei.value)
        assert topo._mcaches["s"].seq_query() == 0
        assert topo._fseqs[("s", "sink")].query() == 0
        assert topo.metrics("synth").counter("loop_iters") == 0
        assert topo.metrics("sink").counter("loop_iters") == 0
    finally:
        topo.close()
    topo = _handshake_topo(f"ta{PID}")
    try:
        hs = topo.handshake()
        hs.words[1] = np.uint64(foreign)
        topo.approve_version(mine)
        assert hs.compatible(mine) and not HS.Handshake(hs.words.view(np.uint8)).compatible(1)
        topo.start(batch_max=16, boot_timeout_s=300.0)
        _wait(lambda: topo.metrics("sink").counter("in_frags") >= 4, "relay", topo)
        topo.halt()
        assert len(read_siglog(topo.tile_alloc_view("sink", SIGLOG_ALLOC))) == 4
    finally:
        topo.close()


def test_process_refusals_name_their_module():
    """Restarts (disco/supervisor.py), fault injection (disco/faultinj.py)
    and hot upgrade (disco/elastic.py) are not ported: each raises
    NotImplementedError naming the module it waits for."""
    topo = _handshake_topo(f"tr{PID}")
    try:
        topo.faults_spec = (0, [])
        with pytest.raises(NotImplementedError, match="faultinj"):
            topo.start(batch_max=16)
        topo.faults_spec = None
        with pytest.raises(NotImplementedError, match="elastic"):
            topo.hot_upgrade("sink", version_root=ROOT)
        for kw in ({"rejoin": True}, {"replay": 4}):
            with pytest.raises(NotImplementedError, match="supervisor"):
                topo._spawn_tile("sink", **kw)
        topo.tiles["sink"].ctx.incarnation = 1
        with pytest.raises(NotImplementedError, match="supervisor"):
            topo._spawn_tile("sink")
        assert all(ts.proc is None and ts.thread is None for ts in topo.tiles.values())
    finally:
        topo.close()
    with pytest.raises(RuntimeError, match="built for runtime 'process'"):
        t = _handshake_topo(f"tx{PID}")
        try:
            t.start(mode="thread")
        finally:
            t.close()


def test_ingress_process_runtime_held_to_check_tiles(monkeypatch):
    """entry.ingress(runtime="process", device="cpu"): the verify child
    runs the plain versions; held to chip_smoke.check_tiles (its batch
    size set to the run's 32 lanes) through the sink's shm log, with the
    thread run's survivors, and every tile profiled.  The verify tile's
    verify_core calls and landed stamps stay in its child."""
    from firedancer_tpu_torch.ops.ed25519 import verify as V

    monkeypatch.setattr(CS, "B", 32)
    calls = [0]
    core = V.verify_core

    def counting(*a, **kw):
        calls[0] += 1
        return core(*a, **kw)

    monkeypatch.setattr(V, "verify_core", counting)
    pool = make_txn_pool(16, corrupt_frac=0.25, seed=5)
    kw = dict(total=64, max_lanes=32, idle_sleep_s=5e-3, device="cpu", profile=True)
    rp = entry.ingress(pool, runtime="process", **kw)
    assert calls[0] == 0
    CS.check_tiles(rp, None, 64)
    rt = entry.ingress(pool, **kw)
    CS.check_tiles(rt, calls[0], 64)
    assert rp["runtime"] == "process" and rt["runtime"] == "thread"
    assert rp["survivors"].tolist() == rt["survivors"].tolist()
    assert rp["payloads"] is None and rp["landed_stamps"] is None
    assert "child" in rp["landed_stamps_note"] and rt["landed_stamps"]
    assert rp["counters"]["verify"]["device_batches"] >= 1
    # the plain versions in every child: no CUDA context, no launch
    assert sorted(rp["children"]) == ["dedup", "sink", "synth", "verify"]
    assert not any(d["cuda"] or any(d["launches"].values())
                   for d in rp["children"].values())
    for r in (rp, rt):
        prof = r["profile"]
        assert sorted(prof["tiles"]) == ["dedup", "sink", "synth", "verify"]
        assert all(row["samples"] > 0 for row in prof["tiles"].values())
        assert prof["cores"] == len(os.sched_getaffinity(0)) and "gil_wait" in prof["rows"]
        assert r["boot_seconds"] > 0
    with pytest.raises(ValueError, match="synth front"):
        entry.ingress(pool, runtime="process", front="wire", device="cpu")


def test_validator_tiles_pickle():
    """A spawn pickles each child's tile: every proc_safe tile of the
    validator topology round-trips, and the observers (metric, rpc),
    which close over the parent's topology, stay parent threads."""
    cfg = C.parse(f'name = "tk{PID}"\n[topo]\nruntime = "process"\n')
    funk = Funk()
    AccountMgr(funk).store(bytes(32), Account(5))
    with tempfile.TemporaryDirectory() as d:
        topo, _h = C.build_validator_topology(cfg, bytes(range(32)), d, funk=funk,
                                              device="cpu")
        assert topo.runtime == "process"
        threads = sorted(n for n, ts in topo.tiles.items() if not ts.tile.proc_safe)
        assert threads == ["metric", "rpc"]
        for n, ts in topo.tiles.items():
            if ts.tile.proc_safe:
                back = pickle.loads(pickle.dumps(ts.tile))
                assert type(back) is type(ts.tile) and back.name == n
