"""The port's wire ingress front: tiles/net.py, tiles/quic.py, the stem's net
handler (fdt_net.c), UdpBlaster and entry's front="wire", against the JAX
package and chip_smoke.py's exact checks.

  * NetTile over real loopback sockets, three ways: the JAX tile on JAX's
    rings, the port's tile on its Python loop, and on the port's native
    stem; identical rx payload streams (the address prefix excluded: each
    run has its own peer port), identical tx deliveries and identical
    counters, with an oversize drop and a route-miss handback included.
  * QuicIngressTile(via_net=True) callback by callback against its JAX twin:
    the same datagram frags in (legacy txns, garbage, a QUIC client's
    handshake and txns), every published frag and every counter equal after
    each callback (both servers draw from one seeded stream: the JAX side
    through os.urandom, the port's through `rand`; both QUIC modules read a
    frozen monotonic clock).
  * net -> quic -> sink (tests/test_net_tile.py's topology) in both packages
    with a real QUIC client.
  * entry.ingress(front="wire") on the CPU, held to chip_smoke.check_wire
    with chip_smoke.B at 32 and the verify tile's verify_core calls counted
    (entry.leader(front="wire"): tests/test_torch_wire_leader.py).
  * UdpBlaster feeding the net tile within its window, landed fed from
    net's rx_dgrams.
Exact throughout.  Ports are ephemeral on 127.0.0.1; the run loops sleep
5 ms when idle (see tests/test_torch_tiles.py)."""

import os
import socket
import time
import types
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke as CS
from firedancer_tpu.disco import metrics as METJ
from firedancer_tpu.disco import mux as MJ
from firedancer_tpu.disco import topo as TOPOJ
from firedancer_tpu.tango import rings as RJ
from firedancer_tpu.tiles import net as NETJ
from firedancer_tpu.tiles import quic as QTILEJ
from firedancer_tpu.tiles import sink as SINKJ
from firedancer_tpu.waltz import quic as QJ
from firedancer_tpu.waltz import x509 as XJ
from firedancer_tpu_torch import entry
from firedancer_tpu_torch.disco import metrics as METT
from firedancer_tpu_torch.disco import mux as MT
from firedancer_tpu_torch.disco import topo as TOPOT
from firedancer_tpu_torch.ops.ed25519 import hostpath
from firedancer_tpu_torch.ops.ed25519 import verify as V
from firedancer_tpu_torch.tango import rings as RT
from firedancer_tpu_torch.tiles import bench as TB
from firedancer_tpu_torch.tiles import net as NETT
from firedancer_tpu_torch.tiles import quic as QTILET
from firedancer_tpu_torch.tiles import sink as SINKT
from firedancer_tpu_torch.tiles import wire
from firedancer_tpu_torch.tiles.synth import make_txn_pool
from firedancer_tpu_torch.waltz import quic as QT
from firedancer_tpu_torch.waltz import x509 as XT

from torch_stem_rig import Rig

SIDES = {
    "jax": SimpleNamespace(R=RJ, M=MJ, MET=METJ, net=NETJ, quic=QTILEJ, Q=QJ,
                           topo=TOPOJ, sink=SINKJ),
    "torch": SimpleNamespace(R=RT, M=MT, MET=METT, net=NETT, quic=QTILET, Q=QT,
                             topo=TOPOT, sink=SINKT),
}
LANES, IDLE_S, SLOT_MS = 32, 5e-3, 2000
IDENTITY = bytes(range(40, 72))
NET_MTU = NETT.NET_MTU


def test_net_constants_match_jax():
    for name in ("ADDR_SZ", "CTL_QUIC", "CTL_LEGACY", "NET_MTU", "_RC_CAP"):
        assert getattr(NETT, name) == getattr(NETJ, name), name
    assert NETT.NetTile.schema.counters == NETJ.NetTile.schema.counters
    assert QTILET.QuicIngressTile.schema.counters == QTILEJ.QuicIngressTile.schema.counters
    for addr in (("127.0.0.1", 9000), ("10.1.2.3", 65535), ("0.0.0.0", 0)):
        packed = NETT.addr_pack(addr)
        assert packed == NETJ.addr_pack(addr)
        assert NETT.addr_unpack(np.frombuffer(packed, np.uint8)) == addr


# ---------------------------------------------------------------------------
# the net tile over real sockets: JAX, port Python loop, port native stem


def _net_run(side, loop):
    S = SIDES[side]
    net = S.net.NetTile(burst=64)
    rig = Rig(S, loop, net, ins=[(1024, NET_MTU)], outs=[(1024, NET_MTU)], cap=128)
    peer = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    peer.bind(("127.0.0.1", 0))
    peer.settimeout(2)

    def steps(n):
        for _ in range(n):
            rig.ctx.credits = 128
            rig.step(128)

    try:
        # rx: both ports, an oversize datagram in the middle of the QUIC
        # burst (the native path reclaims its reserved row)
        for i in range(10):
            peer.sendto(bytes([i]) * (30 + i), net.quic_addr)
        peer.sendto(b"z" * (NET_MTU - NETT.ADDR_SZ + 1), net.quic_addr)
        for i in range(10, 20):
            peer.sendto(bytes([i]) * (30 + i), net.quic_addr)
        for i in range(5):
            peer.sendto(bytes([0x40 + i]) * 25, net.udp_addr)
        time.sleep(0.1)
        steps(6)
        rx = sorted((sz, ctl & 0x18, pl[NETT.ADDR_SZ:]) for _s, sz, ctl, pl in rig.drain(0))
        # tx: addr-prefixed datagrams through the tx ring, to one new
        # destination (a route-cache miss on the stem)
        rows = np.zeros((12, NET_MTU), np.uint8)
        szs = np.zeros(12, np.uint16)
        for i in range(12):
            pl = NETT.addr_pack(peer.getsockname()) + bytes([0x80 + i]) * 40
            rows[i, : len(pl)] = np.frombuffer(pl, np.uint8)
            szs[i] = len(pl)
        rig.feed(0, np.arange(12), rows, szs)
        steps(4)
        tx = []
        try:
            for _ in range(12):
                tx.append(peer.recvfrom(4096)[0])
        except socket.timeout:
            pass
        m = {k: rig.counter(k) for k in S.net.NetTile.schema.counters}
        return rx, tx, m, rig
    finally:
        net.on_halt(rig.ctx)
        peer.close()


def test_net_tile_loops_match_jax_over_real_sockets():
    runs = {key: _net_run(*key) for key in
            (("jax", "python"), ("torch", "python"), ("torch", "stem"))}
    rx, tx, m, _ = runs[("jax", "python")]
    assert m["oversize_drops"] == 1 and m["rx_dgrams"] == 25 and m["tx_dgrams"] == 12
    assert m["tx_routed"] + m["tx_unrouted"] == m["tx_dgrams"]
    assert len(rx) == 25 and len(tx) == 12
    for key, (rx2, tx2, m2, _rig) in runs.items():
        assert (rx2, tx2, m2) == (rx, tx, m), key
    stem_rig = runs[("torch", "stem")][3]
    # the route miss handed the tx frags back once; the rx ran in the hook
    assert stem_rig.handbacks >= 1 and stem_rig.ctrs["rx_dgrams"] == 25


# ---------------------------------------------------------------------------
# the QUIC tile callback by callback


def _frozen_clock(monkeypatch):
    clock = types.SimpleNamespace(monotonic=lambda: 1000.0)
    for Q in (QJ, QT):
        monkeypatch.setattr(Q, "_time", clock)


def _urandom_refused(n):
    raise AssertionError("the port drew from os.urandom instead of its rand")


def test_quic_tile_callbacks_match_jax(monkeypatch):
    _frozen_clock(monkeypatch)
    monkeypatch.setattr(XJ, "_CERT_CACHE", {})
    monkeypatch.setattr(XT, "_CERT_CACHE", {})
    # the JAX tile's os.urandom while it runs; the port's draws must all go
    # through its rand
    urandom = {"jax": np.random.default_rng(31).bytes, "torch": _urandom_refused}
    monkeypatch.setattr(os, "urandom", urandom["jax"])
    rigs = {}
    outs = [(1024, wire.LINK_MTU), (1024, NET_MTU)]
    rigs["jax"] = Rig(SIDES["jax"], "python",
                      QTILEJ.QuicIngressTile(IDENTITY, via_net=True),
                      ins=[(4096, NET_MTU)], outs=outs)
    monkeypatch.setattr(os, "urandom", _urandom_refused)
    rigs["torch"] = Rig(SIDES["torch"], "python",
                        QTILET.QuicIngressTile(IDENTITY, via_net=True,
                                               rand=np.random.default_rng(31).bytes),
                        ins=[(4096, NET_MTU)], outs=outs)
    pool = make_txn_pool(8, corrupt_frac=0.25, seed=9)
    raws = entry.raw_txns(pool)
    client = QT.QuicClient(rand=np.random.default_rng(32).bytes)
    caddr, laddr = ("10.0.0.7", 4433), ("10.0.0.8", 5000)
    seq = [0]

    def feed(dgrams):
        """(payload, addr, ctl) datagrams into both tiles' rx ring."""
        if not dgrams:
            return
        rows = np.zeros((len(dgrams), NET_MTU), np.uint8)
        szs = np.zeros(len(dgrams), np.uint16)
        ctls = np.zeros(len(dgrams), np.uint16)
        for i, (d, addr, ctl) in enumerate(dgrams):
            pl = NETT.addr_pack(addr) + d
            rows[i, : len(pl)] = np.frombuffer(pl, np.uint8)
            szs[i], ctls[i] = len(pl), ctl | 3
        for rig in rigs.values():
            il = rig.ins[0]
            chunks = il.dcache.write_batch(rows, szs)
            rig.in_seq[0] = il.mcache.publish_batch(
                seq[0], np.arange(len(dgrams), dtype=np.uint64), chunks, szs, ctls, 3, None)
        seq[0] += len(dgrams)

    def step():
        """One loop iteration on both tiles: every output and counter equal;
        -> the port tile's tx datagrams to the client."""
        got = {}
        for side, rig in rigs.items():
            monkeypatch.setattr(os, "urandom", urandom[side])
            rig.ctx.credits = 256
            rig.step(256)
            rig.tile.during_housekeeping(rig.ctx)
            got[side] = ([rig.drain(0), rig.drain(1)],
                         {k: rig.counter(k) for k in rig.tile.schema.with_base().counters
                          if k not in ("housekeep_iters", "loop_iters")})
        assert got["torch"] == got["jax"]
        return [pl[NETT.ADDR_SZ:] for _s, _sz, _c, pl in got["torch"][0][1]]

    # legacy txns from two sources, one garbage datagram among them
    feed([(r, laddr, NETT.CTL_LEGACY) for r in raws[:5]]
         + [(b"\x01garbage", laddr, NETT.CTL_LEGACY)]
         + [(r, ("10.0.0.9", 5001), NETT.CTL_LEGACY) for r in raws[5:]])
    step()
    # the QUIC handshake, then txns on streams
    for _ in range(12):
        feed([(d, caddr, NETT.CTL_QUIC) for d in client.conn.datagrams_out()])
        for d in step():
            client.conn.on_datagram(d)
        if client.conn.established and not client.conn.datagrams_out():
            break
    assert client.conn.established
    assert client.conn.tls.peer_identity == hostpath.public_from_secret(IDENTITY)
    for r in raws:
        client.conn.send_txn(r)
    for _ in range(6):
        feed([(d, caddr, NETT.CTL_QUIC) for d in client.conn.datagrams_out()])
        for d in step():
            client.conn.on_datagram(d)
    c = rigs["torch"]
    assert c.counter("rx_txns_udp") == len(raws) and c.counter("parse_fail_txns") == 1
    assert c.counter("rx_txns_quic") == len(raws)


def test_quic_tile_unported_options_raise(monkeypatch):
    """The JAX tile's fault-injection pump and elastic autosizing are
    refused, not skipped; so are an unknown front and a paced wire run,
    and the wire front's default device on a host without a card."""
    import torch

    tile = QTILET.QuicIngressTile(IDENTITY, via_net=True)
    with pytest.raises(NotImplementedError, match="elastic"):
        tile.on_epoch(None)
    rig = Rig(SIDES["torch"], "python", tile, ins=[(64, NET_MTU)],
              outs=[(64, wire.LINK_MTU), (64, NET_MTU)])
    rig.ctx.faults = object()
    with pytest.raises(NotImplementedError, match="fault-injection"):
        tile.after_credit(rig.ctx)
    with pytest.raises(NotImplementedError, match="fault-injection"):
        QTILET.QuicIngressTile(IDENTITY, via_net=True).on_boot(rig.ctx)
    with pytest.raises(ValueError, match="front"):
        entry.ingress(front="bogus", device="off")
    with pytest.raises(ValueError, match="paced"):
        entry.leader(front="wire", paced=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.ingress(front="wire")


# ---------------------------------------------------------------------------
# net -> quic -> sink in both packages


def _net_quic_sink(side, txns):
    S = SIDES[side]
    net = S.net.NetTile()
    quic = S.quic.QuicIngressTile(IDENTITY, via_net=True)
    sink = S.sink.SinkTile(record=True)
    topo = S.topo.Topology()
    topo.link("net_quic", depth=1024, mtu=NET_MTU)
    topo.link("quic_net", depth=1024, mtu=NET_MTU)
    topo.link("quic_sink", depth=1024, mtu=wire.LINK_MTU)
    topo.tile(net, ins=[("quic_net", True)], outs=["net_quic"])
    topo.tile(quic, ins=[("net_quic", True)], outs=["quic_sink", "quic_net"])
    topo.tile(sink, ins=[("quic_sink", True)])
    topo.build()
    topo.start(batch_max=256, idle_sleep_s=IDLE_S)
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.settimeout(0.05)
    try:
        client = S.Q.QuicClient()

        def pump(want, deadline_s=60.0):
            deadline = time.monotonic() + deadline_s
            while time.monotonic() < deadline:
                topo.poll_failure()
                for d in client.conn.datagrams_out():
                    sock.sendto(d, net.quic_addr)
                try:
                    client.conn.on_datagram(sock.recvfrom(65536)[0])
                except socket.timeout:
                    client.conn.on_timer()
                if want():
                    return True
            return False

        assert pump(lambda: client.conn.established)
        for t in txns:
            client.conn.send_txn(t)
        assert pump(lambda: topo.metrics("sink").counter("in_frags") >= len(txns))
        topo.halt()
        got = sorted(r[:sz].tobytes() for rows, szs in zip(sink.payloads, sink.sizes)
                     for r, sz in zip(rows, szs))
        mn, mq = topo.metrics("net"), topo.metrics("quic")
        return got, mn, mq, client
    finally:
        sock.close()
        topo.close()


def test_net_quic_sink_topology_matches_jax():
    pool = make_txn_pool(4, seed=3)
    raws = entry.raw_txns(pool)
    want = sorted(pool[0][i, : pool[1][i]].tobytes() for i in range(4))
    for side in ("jax", "torch"):
        got, mn, mq, client = _net_quic_sink(side, raws)
        assert got == want, side
        assert client.conn.tls.peer_identity == hostpath.public_from_secret(IDENTITY)
        assert mq.counter("rx_txns_quic") == 4 and mq.counter("conns_opened") == 3
        assert mn.counter("rx_dgrams") > 0 and mn.counter("tx_dgrams") > 0
        assert mn.counter("tx_routed") + mn.counter("tx_unrouted") == mn.counter("tx_dgrams")


# ---------------------------------------------------------------------------
# the wire front through entry, held to chip_smoke's checks


@pytest.fixture
def counted(monkeypatch):
    """chip_smoke's batch size at the test's lanes, and a count of the
    verify tile's verify_core calls (the plain version counts no launch)."""
    monkeypatch.setattr(CS, "B", LANES)
    calls = [0]
    core = V.verify_core

    def counting(*a, **kw):
        calls[0] += 1
        return core(*a, **kw)

    monkeypatch.setattr(V, "verify_core", counting)
    return calls


@pytest.mark.parametrize("stem", ["python", "native"])
def test_entry_ingress_wire_on_cpu(counted, stem):
    pool = make_txn_pool(16, corrupt_frac=0.25, seed=5)
    raws = entry.raw_txns(pool)
    traffic = TB.WireTraffic(raws * 4, raws, n_clients=2, seed=5)
    r = entry.ingress(pool, max_lanes=LANES, idle_sleep_s=IDLE_S, device="cpu",
                      stem=stem, front="wire", traffic=traffic,
                      identity_secret=IDENTITY)
    CS.check_wire(r, counted[0], len(raws) * 4, hostpath.public_from_secret(IDENTITY))
    if stem == "native":
        CS.check_stem(r, CS.STEM_TILES["wire"])
    w = r["wire"]
    assert w["dgrams_sent"]["legacy"] == 64 and w["window"] >= 1
    assert len(w["handshake_ms"]) == 2 and w["quic_txns_per_s"] > 0
    assert r["pool"]["tags"].shape == (16,)


def test_entry_ingress_wire_quic_part_on_cpu(counted, monkeypatch):
    """chip_smoke.wire_traffic's QUIC part (the pool's first WIRE_QUIC_TXNS
    rows) behind whole legacy passes: check_wire counts the part's
    corrupt and good rows once more."""
    monkeypatch.setattr(CS, "WIRE_QUIC_TXNS", 5)
    monkeypatch.setattr(CS, "WIRE_CLIENTS", 2)
    pool = make_txn_pool(16, corrupt_frac=0.25, seed=5)
    assert not pool[2][:5].all() and pool[2][:5].any()
    traffic, frags = CS.wire_traffic(pool, 2)
    assert frags == 16 * 2 + 5
    r = entry.ingress(pool, max_lanes=LANES, idle_sleep_s=IDLE_S, device="cpu",
                      front="wire", traffic=traffic, identity_secret=IDENTITY)
    CS.check_wire(r, counted[0], 16 * 2, hostpath.public_from_secret(IDENTITY))
    assert r["wire"]["rx_txns_quic"] == 5


# ---------------------------------------------------------------------------
# UdpBlaster into the net tile


def test_udp_blaster_feeds_net_within_window():
    pool = make_txn_pool(16, seed=11)
    raws = entry.raw_txns(pool) * 8
    net = NETT.NetTile(burst=16)
    rig = Rig(SIDES["torch"], "stem", net, ins=[(64, NET_MTU)],
              outs=[(1024, NET_MTU)], cap=64)
    window, burst = 24, 8
    b = TB.UdpBlaster(raws, net.udp_addr, burst=burst, window=window).start()
    got, peak = [], 0
    try:
        deadline = time.monotonic() + 30.0
        while len(got) < len(raws) and time.monotonic() < deadline:
            rig.ctx.credits = 64
            rig.step(64)
            got += [pl[NETT.ADDR_SZ:] for _s, _sz, _c, pl in rig.drain(0)]
            b.landed = rig.counter("rx_dgrams")
            peak = max(peak, b.sent - b.landed)
            time.sleep(1e-3)
    finally:
        b.stop()
        net.on_halt(rig.ctx)
    assert got == raws
    assert rig.counter("rx_dgrams") == len(raws) and rig.counter("oversize_drops") == 0
    assert peak <= window + burst
