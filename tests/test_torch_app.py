"""The port's operator layer (firedancer_tpu_torch/app/config.py, fdtctl.py,
monitor.py, ballet/http.py, tiles/metric.py, tiles/rpc.py) against the JAX
package's, exactly: `parse` on TOML texts that set every key, and its
refusals; both topology builders' tiles, links, depths, MTUs and
consumers; the HTTP codec; render_prometheus byte for byte; RPC dispatch;
Monitor.render and alarms over bare snapshots; fdtctl's argparse; and a
named topology that a Monitor and the metric tile attach to by name."""

import dataclasses
import glob
import json

import numpy as np
import pytest

from firedancer_tpu.app import config as CJ
from firedancer_tpu.app import fdtctl as FDJ
from firedancer_tpu.app import monitor as MONJ
from firedancer_tpu.ballet import http as HJ
from firedancer_tpu.disco import metrics as METJ
from firedancer_tpu.flamenco import accounts as AJ
from firedancer_tpu.funk import funk as FJ
from firedancer_tpu.tiles import metric as MTJ
from firedancer_tpu.tiles import rpc as RPJ
from firedancer_tpu_torch.app import config as CT
from firedancer_tpu_torch.app import fdtctl as FDT
from firedancer_tpu_torch.app import monitor as MONT
from firedancer_tpu_torch.ballet import http as HT
from firedancer_tpu_torch.disco import metrics as METT
from firedancer_tpu_torch.flamenco import accounts as AT
from firedancer_tpu_torch.funk import funk as FT
from firedancer_tpu_torch.tango import rings as RT
from firedancer_tpu_torch.tiles import metric as MTT
from firedancer_tpu_torch.tiles import rpc as RPT

EVERY_KEY = """
name = "every"
[topo]
runtime = "thread"
stem = "native"
[tiles.quic]
quic_port = 9007
udp_port = 9008
max_conns = 100
max_conns_per_source = 3
handshake_rate = 50
handshake_burst = 8
txn_rate = 1000
txn_burst = 32
idle_timeout_s = 2.5
handshake_timeout_s = 1.5
backlog_cap = 512
shed_hi = 0.8
shed_lo = 0.2
shed_cooldown_s = 0.5
shed_dwell_s = 0.05
low_stake = 77
[stakes]
"0xdeadbeef00000000000000000000000000000000000000000000000000000000" = 500000
"127.0.0.1:9000" = 1000000
[tiles.verify]
count = 2
max_lanes = 256
msg_width = 512
devices = [0, 1]
stall_patience_s = 30.0
[tiles.dedup]
signature_cache_size = 1000
[tiles.bank]
count = 3
native = false
table_slots = 4096
[tiles.pack]
depth = 2048
mb_inflight = 2
microblock_ns = 1000000
txn_limit = 16
slot_ns = 200000000
device_select = true
[tiles.poh]
ticks_per_slot = 32
[tiles.shred]
version = 9
[tiles.metric]
port = 9101
[tiles.rpc]
port = 9102
[links]
depth = 512
"""

TEXTS = {
    "empty": "",
    "defaults_named": 'name = "fdt_x"\n',
    "every_key": EVERY_KEY,
    "admission_one_key": "[tiles.quic]\ntxn_rate = 5\n",
    "auto_devices": '[tiles.verify]\ndevices = "auto"\ncount = 3\n',
}


def _config_fields(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(CT.Config):
        v = getattr(cfg, f.name)
        if f.name == "quic_admission" and v is not None:
            v = dataclasses.asdict(v)
        out[f.name] = v
    return out


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_parse_matches_jax(name):
    pc, jc = CT.parse(TEXTS[name]), CJ.parse(TEXTS[name])
    assert _config_fields(pc) == _config_fields(jc)
    assert jc.slo is None and jc.elastic is None
    pa, ps = CT._quic_policy(pc)
    ja, js = CJ._quic_policy(jc)
    assert dataclasses.asdict(pa) == dataclasses.asdict(ja)
    assert vars(ps) == vars(js)
    if pc.verify_devices == "auto":
        return  # "auto" counts each package's own devices (CUDA cards, JAX's)
    for n in (1, 2, 3):
        assert CT._verify_device_split(pc, n, n) == CJ._verify_device_split(jc, n, n)


@pytest.mark.parametrize("text,what", [
    ("[slo]\ne2e_p99_us = 50000\n", r"\[slo\]"),
    ("[elastic]\ndwell_s = 2.0\n[elastic.verify]\nmax_shards = 4\n", r"\[elastic\]"),
    ('[topo]\nruntime = "process"\n', None),
])
def test_parse_refuses_what_is_not_ported(text, what):
    """[slo] and [elastic] are refused; [topo] runtime = "process" is
    ported and parses as JAX's does."""
    jc = CJ.parse(text)  # the JAX package takes it
    if what is None:
        pc = CT.parse(text)
        assert pc.runtime == jc.runtime == "process"
        assert _config_fields(pc) == _config_fields(jc)
        return
    with pytest.raises(NotImplementedError, match=what):
        CT.parse(text)


def _shape(topo) -> dict:
    return {
        "links": {n: (ls.depth, ls.mtu, ls.producer, list(ls.consumers))
                  for n, ls in topo.links.items()},
        "tiles": {n: (type(ts.tile).__name__, list(ts.ins), list(ts.outs))
                  for n, ts in topo.tiles.items()},
        "name": topo.name,
    }


@pytest.mark.parametrize("name", ["defaults_named", "every_key"])
def test_builders_match_jax(name, tmp_path):
    text = TEXTS[name].replace('stem = "native"', 'stem = "python"')
    secret = bytes(range(32))
    pc, jc = CT.parse(text), CJ.parse(text)
    pt, ph = CT.build_validator_topology(pc, secret, str(tmp_path / "p"), device="cpu")
    jt, jh = CJ.build_validator_topology(jc, secret, str(tmp_path / "j"))
    assert _shape(pt) == _shape(jt)
    assert sorted(ph) == sorted(jh)
    for n, ts in pt.tiles.items():
        jtile = jt.tiles[n].tile
        if n.startswith("verify"):
            for a in ("msg_width", "max_lanes", "shard", "pad_full", "pre_dedup",
                      "stall_patience_s"):
                assert getattr(ts.tile, a) == getattr(jtile, a), (n, a)
        if n.startswith("bank"):
            for a in ("bank_id", "native", "table_slots", "commit_every"):
                assert getattr(ts.tile, a) == getattr(jtile, a), (n, a)
    pi, _ = CT.build_ingress_topology(pc, secret, device="cpu")
    ji, _ = CJ.build_ingress_topology(jc, secret)
    assert _shape(pi) == _shape(ji)


@pytest.mark.parametrize("build", ["validator", "ingress"])
def test_builders_without_device_raise_without_cuda(build, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default is valid here")
    cfg = CT.parse('name = "fdt_nocard"\n')
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if build == "validator":
            CT.build_validator_topology(cfg, bytes(32), str(tmp_path / "bs"))
        else:
            CT.build_ingress_topology(cfg, bytes(32))
    assert not glob.glob(f"{RT.SHM_PREFIX}fdt_nocard*")


# ---------------------------------------------------------------------------
# HTTP, Prometheus, RPC


def _req_fields(r):
    return None if r is None else dataclasses.asdict(r)


def test_http_codec_matches_jax():
    rng = np.random.default_rng(21)
    cases = [
        b"POST /x HTTP/1.1\r\nHost: a\r\nContent-Length: 4\r\n\r\nbodyextra",
        b"GET /metrics HTTP/1.1\r\nHost: h\r\n\r\n",
        b"GET / HTTP/1.1\r\nContent-Length: 9\r\n\r\nshort",
        b"garbage no request line\r\n\r\n",
        b"GET / HTTP/1.1\r\nbadheader\r\n\r\n",
        b"GET / HTTP/1.1\r\nContent-Length: -1\r\n\r\n",
        b"GET / HTTP/1.1\r\n",
    ]
    for _ in range(32):
        body = rng.integers(0, 256, int(rng.integers(0, 64)), np.uint8).tobytes()
        cases.append(b"POST /r HTTP/1.1\r\nX-A: " + str(rng.integers(0, 9)).encode()
                     + b"\r\nContent-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body)
    for raw in cases:
        for cut in (len(raw), len(raw) // 2):
            want = _outcome(HJ.parse_request, raw[:cut])
            got = _outcome(HT.parse_request, raw[:cut])
            if want[0] == "ok":
                assert got[0] == "ok" and (_req_fields(got[1][0]), got[1][1]) == (
                    _req_fields(want[1][0]), want[1][1])
            else:
                assert got == want
    for status, body, ctype in ((200, b"hi", "text/plain"), (404, b"", "x/y"),
                                (500, bytes(range(256)), "application/json")):
        resp = HT.build_response(status, body, ctype)
        assert resp == HJ.build_response(status, body, ctype)
        assert HT.parse_response(resp) == HJ.parse_response(resp)


def _outcome(fn, *a):
    try:
        return ("ok", fn(*a))
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return (type(e).__name__, str(e))


def _metrics_pair(schema_kw, seed):
    """The same counters and hist samples in a JAX and a port region."""
    rng = np.random.default_rng(seed)
    out = []
    for MET in (METJ, METT):
        schema = MET.MetricsSchema(**schema_kw).with_base()
        out.append(MET.Metrics(np.zeros(MET.Metrics.footprint(schema), np.uint8), schema))
    for c in out[0].schema.counters:
        v = int(rng.integers(0, 10**9))
        for m in out:
            m.inc(c, v)
    for h in out[0].schema.hists:
        for v in rng.integers(0, 1 << 20, 40):
            for m in out:
                m.hist_sample(h, int(v))
    return out


def test_render_prometheus_matches_jax():
    jt, pt = {}, {}
    for i, (name, kw) in enumerate([
        ("bank0", {"counters": ("executed_txns", "fees_lamports")}),
        ("verify0", {"counters": ("device_batches",), "hists": ("lane_batch", "e2e_us_x"),
                     "wide_hists": ("e2e_us_x",)}),
        ("poh", {"counters": ("slots", "mixins")}),
    ]):
        jt[name], pt[name] = _metrics_pair(kw, i)
    assert MTT.render_prometheus(pt) == MTJ.render_prometheus(jt)


def test_rpc_dispatch_matches_jax():
    rng = np.random.default_rng(5)
    keys = [rng.integers(0, 256, 32, np.uint8).tobytes() for _ in range(6)]
    jf, pf = FJ.Funk(), FT.Funk()
    for k, lam in zip(keys[:4], (1, 5000, 10**12, 0)):
        AJ.AccountMgr(jf).store(k, AJ.Account(lam))
        AT.AccountMgr(pf).store(k, AT.Account(lam))
    ident = bytes(range(32))
    tiles = []
    for R, funk in ((RPJ, jf), (RPT, pf)):
        t = R.RpcTile(txn_count=lambda: 8192, slot=lambda: 7, funk=funk, identity=ident)
        t._ctx = type("C", (), {"metrics": type("M", (), {"inc": lambda *a: None})()})()
        tiles.append(t)
    from firedancer_tpu.ballet import base58 as B58J

    bodies = [json.dumps({"jsonrpc": "2.0", "id": i, "method": m, "params": p}).encode()
              for i, (m, p) in enumerate([
                  ("getTransactionCount", []), ("getSlot", []), ("getHealth", []),
                  ("getVersion", []), ("getIdentity", []), ("nope", []),
                  *[("getBalance", [B58J.encode_32(k)]) for k in keys],
                  ("getBalance", ["0OIl"]), ("getBalance", [])])]
    bodies += [b"{not json", b"[]", json.dumps({"id": 3}).encode()]
    for body in bodies:
        jr = tiles[0]._handle(HJ.Request("POST", "/", "HTTP/1.1", {}, body))
        pr = tiles[1]._handle(HT.Request("POST", "/", "HTTP/1.1", {}, body))
        assert pr == jr, body
    assert tiles[1]._handle(HT.Request("GET", "/", "HTTP/1.1")) == tiles[0]._handle(
        HJ.Request("GET", "/", "HTTP/1.1"))


# ---------------------------------------------------------------------------
# the monitor over bare snapshots


def _hist(rng):
    b = [int(x) for x in rng.integers(0, 50, 24)]
    return {"count": sum(b), "sum": int(rng.integers(0, 10**6)), "buckets": b}


def _snapshots(seed):
    rng = np.random.default_rng(seed)
    snaps = []
    base = {
        "verify0": {"in_frags": 10, "out_frags": 9, "backpressure_iters": 1, "loop_iters": 50,
                    "fallback_batches": 2, "dev0_landed": 3, "dev0_degraded": 1,
                    "dev1_landed": 4},
        "dedup": {"in_frags": 9, "out_frags": 8, "stem_engaged": 1, "stem_frags": 0,
                  "py_frags": 100},
        "quic": {"in_frags": 0, "out_frags": 10, "shed_level": 3, "shed_transitions": 4,
                 "gate_txns": 10, "admit_staked": 5, "tx_eagain_drops": 2},
        "bank0": {"in_frags": 4, "out_frags": 8, "degraded": 1, "restarts": 3},
        "bank1": {"in_frags": 4, "out_frags": 8, "restarts": 1, "stem_engaged": 1,
                  "stem_frags": 7, "py_frags": 3},
    }
    for step in range(4):
        snap = {}
        for name, c in base.items():
            cc = {k: v + step * int(rng.integers(0, 40)) for k, v in c.items()}
            if name == "dedup":
                cc["stem_frags"] = 0
            snap[name] = {
                "signal": ["RUN", "RUN", "FAIL", "HALT"][(step + len(name)) % 4],
                "heartbeat": 1, "stale": bool((step + len(name)) % 3 == 0),
                "counters": cc,
                "lat_hists": {f"qwait_us_{name}_in": _hist(rng), f"e2e_us_{name}_in": _hist(rng),
                              f"svc_us_{name}_in": _hist(rng)},
            }
        snap["_links"] = {"a_b": {"produced": 100, "consumers": {
            "b": {"seq": 90 - step, "lag": 10 + step}, "c": {"seq": 100, "lag": 0}}}}
        snaps.append(snap)
    return snaps


@pytest.mark.parametrize("seed", [1, 2])
def test_monitor_render_and_alarms_match_jax(seed):
    mj, mp = object.__new__(MONJ.Monitor), object.__new__(MONT.Monitor)
    prev = None
    for snap in _snapshots(seed):
        assert mp.alarms(snap) == mj.alarms(snap)
        assert mp.render(prev, snap, 0.5) == mj.render(prev, snap, 0.5)
        assert MONT.Monitor.stem_row(snap["dedup"]["counters"]) == MONJ.Monitor.stem_row(
            snap["dedup"]["counters"])
        prev = snap
    assert any("pinned" in a for a in mp.alarms(snap))


# ---------------------------------------------------------------------------
# fdtctl


ARGVS = [
    ["run"], ["run", "--full", "--config", "c.toml", "--keyfile", "k", "--iterations", "5"],
    ["run", "--blockstore", "/x", "--log-path", "l"], ["monitor"],
    ["monitor", "--name", "n", "--interval", "0.5", "--iterations", "1"],
    ["configure"], ["configure", "init", "--stages", "device", "--keyfile", "k"],
]


def _parsed(mod, argv, monkeypatch):
    got = {}
    for cmd in ("cmd_run", "cmd_monitor", "cmd_configure"):
        monkeypatch.setattr(mod, cmd, lambda a, _c=cmd: got.update(vars(a), fn=_c) or 0)
    return mod.main(argv), got


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) for a in ARGVS])
def test_fdtctl_argparse_matches_jax(argv, monkeypatch):
    assert _parsed(FDT, argv, monkeypatch) == _parsed(FDJ, argv, monkeypatch)


@pytest.mark.parametrize("argv", [[], ["fly"], ["run", "--bogus"], ["configure", "wipe"]])
def test_fdtctl_refuses_what_jax_refuses(argv):
    for mod in (FDT, FDJ):
        with pytest.raises(SystemExit) as e:
            mod.main(argv)
        assert e.value.code == 2


def test_fdtctl_configure_runs_the_device_stage(capsys):
    import torch

    rc = FDT.main(["configure"])
    out = capsys.readouterr().out
    assert "device" in out and rc == (0 if torch.cuda.is_available() else 1)
    assert FDT.main(["configure", "--stages", "shm"]) == 2


# ---------------------------------------------------------------------------
# attach by name


def test_monitor_and_metric_tile_attach_by_name():
    """A named topology publishes its manifest once every tile is in RUN:
    a Monitor attached by name reads the tiles' own counters, the metric
    tile serves /metrics over the registry and over the manifest, and
    closing the topology removes the workspace and its directory.  A
    manifest with a layer the port has not ported is refused."""
    from firedancer_tpu_torch.disco.topo import Topology
    from firedancer_tpu_torch.tiles.rpc import RpcTile

    name = "fdt_attach_test"
    topo = Topology(name=name)
    metric = MTT.MetricTile(registry=topo.metrics_registry)
    topo.tile(metric)
    topo.tile(RpcTile(txn_count=lambda: 3))
    topo.build()
    try:
        topo.start(idle_sleep_s=5e-3)
        mon = MONT.Monitor(name)
        snap = mon.snapshot()
        assert set(snap) == {"metric", "rpc"}
        assert snap["rpc"]["signal"] == "RUN"
        status, body = HT.get(("127.0.0.1", metric.addr[1]), "/metrics")
        assert status == 200 and b"fdt_rpc_requests 0" in body
        assert MONT.Monitor(name).snapshot()["metric"]["counters"]["scrapes"] == 1
        by_name = MTT.MetricTile(wksp_name=name)
        assert b"fdt_metric_scrapes 1" in MTT.render_prometheus(by_name._tiles())
        by_name.on_halt(None)
        mon.wksp.close()
    finally:
        topo.halt()
        topo.close()
    assert not glob.glob(f"{RT.SHM_PREFIX}{name}*")
    ws = RT.Workspace(4096, name=name)
    try:
        ws.publish_directory({"tiles": {}, "links": {}, "slo": {"config": {}}})
        with pytest.raises(NotImplementedError, match="slo"):
            MONT.Monitor(name)
    finally:
        ws.unlink()
    assert not glob.glob(f"{RT.SHM_PREFIX}{name}*")


def test_metric_tile_by_name_attaches_once(monkeypatch):
    """ROADMAP C-6: JAX's MetricTile(wksp_name=) attaches the workspace
    again at every scrape (a Monitor: an os.open and an mmap) and never
    closes it; the port's attaches once, renders the same bytes at every
    scrape, and closes at halt (its open descriptors back where they
    were).  JAX's attaches are counted through a stand-in Monitor, so no
    JAX workspace file is made."""
    import os

    attaches = []

    class CountingMonitor:
        def __init__(self, name):
            attaches.append(name)
            self.tiles = {}

    monkeypatch.setattr(MONJ, "Monitor", CountingMonitor)
    jt = MTJ.MetricTile(wksp_name="any")
    for _ in range(10):
        jt._tiles()
    assert len(attaches) == 10

    name = "fdt_leak_torch"
    ws = RT.Workspace(1 << 16, name=name)
    try:
        schema = METT.MetricsSchema(counters=("c",)).with_base()
        m = METT.Metrics(ws.alloc("metrics_t", METT.Metrics.footprint(schema)), schema)
        m.inc("c", 7)
        ws.publish_directory({"tiles": {"t": {
            "metrics": "metrics_t", "cnc": "metrics_t", "counters": list(schema.counters),
            "hists": list(schema.hists), "wide_hists": list(schema.wide_hists)}},
            "links": {}})
        tile = MTT.MetricTile(wksp_name=name)
        n0 = len(os.listdir("/proc/self/fd"))
        bodies = {MTT.render_prometheus(tile._tiles())}
        n1 = len(os.listdir("/proc/self/fd"))
        bodies |= {MTT.render_prometheus(tile._tiles()) for _ in range(9)}
        assert len(os.listdir("/proc/self/fd")) == n1
        assert bodies == {MTT.render_prometheus({"t": m})}
        tile.on_halt(None)
        assert len(os.listdir("/proc/self/fd")) == n0
    finally:
        ws.unlink()
