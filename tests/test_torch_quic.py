"""The port's waltz/quic.py and tango/lru.py against the JAX package's.

Exact throughout: the varints and RFC 9001 Appendix A's initial keys; Lru
op by op; a handshake and txns across the two packages in both directions;
and seeded byte parity of every datagram of scripted exchanges (after
tests/test_quic.py and tests/test_quic_loss.py: handshake and txns, a txn
across datagrams, key update, version negotiation, Retry, migration, and a
lossy link with on_timer(now=...)).  For parity the JAX side draws its
random bytes from os.urandom set to a seeded stream, the port side from
the same stream passed as `rand` (os.urandom then raises, so a draw that
skips `rand` fails the test), and both modules' clocks read one fake
monotonic clock."""

import os
import types

import numpy as np
import pytest

from firedancer_tpu.ops.ed25519 import golden as GJ
from firedancer_tpu.tango import lru as LJ
from firedancer_tpu.waltz import quic as QJ
from firedancer_tpu.waltz import x509 as XJ
from firedancer_tpu_torch.tango import lru as LT
from firedancer_tpu_torch.waltz import quic as QT
from firedancer_tpu_torch.waltz import x509 as XT

IDENTITY = bytes(range(7, 39))


def test_varints_match_jax():
    for v in (0, 1, 63, 64, 16383, 16384, 2**29, 2**30, 2**61 - 1):
        enc = QT.vi_enc(v)
        assert enc == QJ.vi_enc(v)
        assert QT.vi_dec(enc, 0) == (v, len(enc)) == QJ.vi_dec(enc, 0)
        assert QT.vi_dec(b"\x00" + enc, 1) == (v, len(enc) + 1)


def test_rfc9001_initial_keys():
    """RFC 9001 Appendix A.1: the Initial secrets, keys, IVs and header
    protection keys for the client's dcid 0x8394c8f03e515708."""
    dcid = bytes.fromhex("8394c8f03e515708")
    c, s = QT.initial_secrets(dcid)
    assert (c, s) == QJ.initial_secrets(dcid)
    assert c.hex() == "c00cf151ca5be075ed0ebfb5c80323c42d6b7db67881289af4008f1f6c357aea"
    assert s.hex() == "3c199828fd139efd216c155ad844cc81fb82fa8d7446fa7d78be803acdda951b"
    kc, ks = QT.Keys(c), QT.Keys(s)
    assert kc.iv.hex() == "fa044b2f42a3fd3b46fb255c"
    assert ks.iv.hex() == "0ac1493ca1905853b0bba03e"
    label = QT.tls.hkdf_expand_label
    assert label(c, "quic key", b"", 16).hex() == "1f369613dd76d5467730efcbe3b1a22d"
    assert label(c, "quic hp", b"", 16).hex() == "9f50449e04a0e810283a1e9933adedd2"
    assert label(s, "quic key", b"", 16).hex() == "cf3a5331653c364c88f0f379b6067e37"
    assert label(s, "quic hp", b"", 16).hex() == "c206b8d9b9f0f37644430b490eeaa314"
    for k, kj in ((kc, QJ.Keys(c)), (ks, QJ.Keys(s))):
        assert np.array_equal(k.hp, kj.hp)
        sample = bytes(range(16))
        assert k.hp_mask(sample) == kj.hp_mask(sample)
        assert k.nonce(12345) == kj.nonce(12345)


def test_lru_op_by_op():
    rng = np.random.default_rng(3)
    a, b = LT.Lru(8), LJ.Lru(8)
    for _ in range(2000):
        op = int(rng.integers(0, 4))
        key = int(rng.integers(0, 20))
        if op == 0:
            assert a.acquire(key) == b.acquire(key)
        elif op == 1:
            assert a.touch(key) == b.touch(key)
        elif op == 2:
            assert a.remove(key) == b.remove(key)
        else:
            assert (key in a) == (key in b)
        assert len(a) == len(b) and a.lru_key() == b.lru_key()
        assert list(a.iter_lru()) == list(b.iter_lru())


# ---------------------------------------------------------------------------
# interop


def _pump(client_conn, server, addr=("127.0.0.1", 9000), rec=None, rounds=16):
    """Shuttle datagrams both ways until quiescent; `rec` records every
    datagram in order."""
    sconn = None
    for _ in range(rounds):
        moved = False
        for d in client_conn.datagrams_out():
            if rec is not None:
                rec.append(("c2s", d))
            sconn = server.on_datagram(d, addr) or sconn
            moved = True
        for pkt, a in server.stateless_out:
            if rec is not None:
                rec.append(("stateless", pkt, a))
            if a == addr:
                client_conn.on_datagram(pkt)
                moved = True
        server.stateless_out.clear()
        if sconn:
            for d in sconn.datagrams_out():
                if rec is not None:
                    rec.append(("s2c", d))
                client_conn.on_datagram(d)
                moved = True
        if not moved:
            break
    return sconn


@pytest.mark.parametrize("server_mod,client_mod", [(QJ, QT), (QT, QJ)],
                         ids=["port_client_jax_server", "jax_client_port_server"])
def test_cross_interop(server_mod, client_mod):
    rng = np.random.default_rng(21)
    server = server_mod.QuicServer(IDENTITY)
    client = client_mod.QuicClient()
    sconn = _pump(client.conn, server)
    assert sconn is not None and sconn.tls.handshake_complete
    assert client.conn.established
    assert client.conn.tls.peer_identity == GJ.public_from_secret(IDENTITY)
    txns = [rng.integers(0, 256, n, np.uint8).tobytes() for n in (1, 193, 1232)]
    for t in txns:
        client.conn.send_txn(t)
    _pump(client.conn, server)
    assert sconn.txns == txns


# ---------------------------------------------------------------------------
# seeded byte parity


class _Clock:
    """A monotonic clock that moves 1 ms a read."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 1e-3
        return self.t


class _LossyLink:
    """tests/test_quic_loss.py's link: seeded drop, reorder, duplicate."""

    def __init__(self, seed, drop=0.1, reorder=0.1, dup=0.05):
        self.rng = np.random.default_rng(seed)
        self.drop, self.reorder, self.dup = drop, reorder, dup
        self.q = {"c2s": [], "s2c": []}

    def send(self, way, dgrams):
        for d in dgrams:
            r = self.rng.random()
            if r < self.drop:
                continue
            if r < self.drop + self.dup:
                self.q[way].append(d)
            self.q[way].append(d)
        if self.rng.random() < self.reorder and len(self.q[way]) > 1:
            i = int(self.rng.integers(0, len(self.q[way]) - 1))
            self.q[way][i], self.q[way][i + 1] = self.q[way][i + 1], self.q[way][i]

    def deliver(self, way):
        out, self.q[way] = self.q[way], []
        return out


def _script_handshake_txns(Q, mk, rec, rng, clock):
    server, client = mk(Q.QuicServer, IDENTITY), mk(Q.QuicClient)
    sconn = _pump(client.conn, server, rec=rec)
    for n in (1, 193, 1232):
        client.conn.send_txn(rng.integers(0, 256, n, np.uint8).tobytes())
    _pump(client.conn, server, rec=rec)
    rec.append(("txns", tuple(sconn.txns)))


def _script_across_datagrams(Q, mk, rec, rng, clock):
    server, client = mk(Q.QuicServer, IDENTITY), mk(Q.QuicClient)
    sconn = _pump(client.conn, server, rec=rec)
    big = rng.integers(0, 256, 1232, np.uint8).tobytes()
    sid = client.conn._next_uni_stream
    client.conn._next_uni_stream += 4
    for off, chunk, fin in ((0, big[:700], False), (700, big[700:], True)):
        f = (bytes([0x08 | 0x04 | 0x02 | (0x01 if fin else 0)]) + Q.vi_enc(sid)
             + Q.vi_enc(off) + Q.vi_enc(len(chunk)) + chunk)
        client.conn._pending_frames[Q.APPLICATION].append(f)
        client.conn._flush()
    _pump(client.conn, server, rec=rec)
    rec.append(("txns", tuple(sconn.txns)))


def _script_key_update(Q, mk, rec, rng, clock):
    server, client = mk(Q.QuicServer, IDENTITY), mk(Q.QuicClient)
    sconn = _pump(client.conn, server, rec=rec)
    for _ in range(2):
        client.conn.send_txn(rng.integers(0, 256, 100, np.uint8).tobytes())
        _pump(client.conn, server, rec=rec)
        client.conn.initiate_key_update()
    client.conn.send_txn(rng.integers(0, 256, 64, np.uint8).tobytes())
    _pump(client.conn, server, rec=rec)
    rec.append(("state", tuple(sconn.txns), sconn.key_updates, sconn.key_phase))


def _script_version_negotiation(Q, mk, rec, rng, clock):
    server = mk(Q.QuicServer, IDENTITY)
    scid, dcid = b"AABBCCDD", b"11223344"
    probe = bytes([0xC0]) + (2).to_bytes(4, "big") + bytes([8]) + dcid + bytes([8]) + scid
    probe += bytes(1200 - len(probe))
    assert server.on_datagram(probe, ("1.2.3.4", 5)) is None
    vn, _a = server.stateless_out[0]
    rec.append(("vn", vn))
    client = mk(Q.QuicClient)
    rec.extend(("c2s", d) for d in client.conn.datagrams_out())
    client.conn.on_datagram(vn[:-4] + (7).to_bytes(4, "big"))
    rec.append(("closed", client.conn.closed))


def _script_retry(Q, mk, rec, rng, clock):
    server, client = mk(Q.QuicServer, IDENTITY, retry=True), mk(Q.QuicClient)
    sconn = _pump(client.conn, server, rec=rec, rounds=32)
    client.conn.send_txn(b"hello-retry")
    _pump(client.conn, server, rec=rec)
    rec.append(("state", client.conn.token, sconn.validated, tuple(sconn.txns)))


def _script_migration(Q, mk, rec, rng, clock):
    server, client = mk(Q.QuicServer, IDENTITY), mk(Q.QuicClient)
    a1, a2 = ("10.0.0.1", 1111), ("10.9.9.9", 2222)
    sconn = _pump(client.conn, server, addr=a1, rec=rec)
    _pump(client.conn, server, addr=a1, rec=rec)
    client.conn.send_txn(rng.integers(0, 256, 300, np.uint8).tobytes())
    _pump(client.conn, server, addr=a1, rec=rec)
    assert client.conn.migrate_dcid()
    client.conn.send_txn(rng.integers(0, 256, 400, np.uint8).tobytes())
    _pump(client.conn, server, addr=a2, rec=rec)
    rec.append(("state", tuple(sconn.txns), server.migrations, server.paths_validated))


def _script_lossy(Q, mk, rec, rng, clock):
    server, client = mk(Q.QuicServer, IDENTITY), mk(Q.QuicClient)
    link = _LossyLink(seed=7, drop=0.10, reorder=0.15, dup=0.05)
    sconn = None
    txns = [rng.integers(0, 256, int(rng.integers(64, 900)), np.uint8).tobytes()
            for _ in range(60)]
    sent = 0
    for _ in range(400):
        if client.conn.established and sent < len(txns):
            for t in txns[sent:sent + 10]:
                client.conn.send_txn(t)
            sent = min(sent + 10, len(txns))
        out = client.conn.datagrams_out()
        rec.extend(("c2s", d) for d in out)
        link.send("c2s", out)
        for d in link.deliver("c2s"):
            sconn = server.on_datagram(d, ("10.0.0.1", 9000)) or sconn
        if sconn is not None:
            out = sconn.datagrams_out()
            rec.extend(("s2c", d) for d in out)
            link.send("s2c", out)
        for d in link.deliver("s2c"):
            client.conn.on_datagram(d)
        if sent == len(txns) and sconn is not None and len(sconn.txns) == len(txns):
            break
        if not link.q["c2s"] and not link.q["s2c"]:
            now = clock.t + 1.0
            client.conn.on_timer(now=now)
            if sconn is not None:
                sconn.on_timer(now=now)
    assert sorted(sconn.txns) == sorted(txns)
    assert client.conn.lost_packets + client.conn.retx_frames > 0
    rec.append(("state", tuple(sconn.txns), client.conn.lost_packets,
                client.conn.retx_frames, client.conn.pto_count))


SCRIPTS = {
    "handshake_txns": _script_handshake_txns,
    "txn_across_datagrams": _script_across_datagrams,
    "key_update": _script_key_update,
    "version_negotiation": _script_version_negotiation,
    "retry": _script_retry,
    "migration": _script_migration,
    "lossy": _script_lossy,
}


def _urandom_refused(n):
    raise AssertionError("the port drew from os.urandom instead of its rand")


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_seeded_datagram_parity(monkeypatch, name):
    recs = []
    for Q, X in ((QJ, XJ), (QT, XT)):
        stream = np.random.default_rng(99).bytes
        clock = _Clock()
        monkeypatch.setattr(Q, "_time", types.SimpleNamespace(monotonic=clock))
        monkeypatch.setattr(X, "_CERT_CACHE", {})
        if Q is QJ:
            monkeypatch.setattr(os, "urandom", stream)

            def mk(cls, *a, **kw):
                return cls(*a, **kw)
        else:
            monkeypatch.setattr(os, "urandom", _urandom_refused)

            def mk(cls, *a, **kw):
                return cls(*a, rand=stream, **kw)
        rec = []
        SCRIPTS[name](Q, mk, rec, np.random.default_rng(5), clock)
        recs.append(rec)
    jax_rec, port_rec = recs
    assert len(port_rec) == len(jax_rec) and len(port_rec) > 1
    for i, (a, b) in enumerate(zip(port_rec, jax_rec)):
        assert a == b, (name, i, a[0])
