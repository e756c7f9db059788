"""The port's waltz/tls.py and waltz/x509.py against the JAX package's.

Exact throughout: x509 generate (with the same serial bytes), parse and
verify_self_signed byte for byte; HKDF (RFC 5869 test case 1) and the TLS
1.3 labels; a handshake between the two packages in both directions; and
byte-identical handshake messages and secrets under one seeded random
stream (the JAX side draws from os.urandom set to it, the port side from
`rand`; os.urandom raises while the port runs)."""

import hashlib
import os

import numpy as np
import pytest

from firedancer_tpu.ops.ed25519 import golden as GJ
from firedancer_tpu.waltz import tls as TJ
from firedancer_tpu.waltz import x509 as XJ
from firedancer_tpu_torch.waltz import tls as TT
from firedancer_tpu_torch.waltz import x509 as XT

IDENTITY = bytes(range(3, 35))
TP = b"\x0f\x08" + bytes(8)


def _urandom_refused(n):
    raise AssertionError("the port drew from os.urandom instead of its rand")


@pytest.fixture
def fresh_certs(monkeypatch):
    monkeypatch.setattr(XJ, "_CERT_CACHE", {})
    monkeypatch.setattr(XT, "_CERT_CACHE", {})


def test_x509_generate_parse_verify_match_jax(monkeypatch, fresh_certs):
    monkeypatch.setattr(os, "urandom", np.random.default_rng(4).bytes)
    der_j = XJ.generate(IDENTITY)
    monkeypatch.setattr(os, "urandom", _urandom_refused)
    der = XT.generate(IDENTITY, rand=np.random.default_rng(4).bytes)
    assert der == der_j
    # cached per (identity, cn): no second draw, the same bytes
    assert XT.generate(IDENTITY, rand=_urandom_refused) is der
    info, info_j = XT.parse(der), XJ.parse(der)
    assert info == info_j
    assert info["pubkey"] == GJ.public_from_secret(IDENTITY)
    assert XT.verify_self_signed(der) == XJ.verify_self_signed(der) == info["pubkey"]
    # a flipped signature byte fails both; a truncated DER parses in neither
    bad = bytearray(der)
    bad[-5] ^= 1
    assert XT.verify_self_signed(bytes(bad)) is None is XJ.verify_self_signed(bytes(bad))
    for mod in (XT, XJ):
        with pytest.raises(ValueError):
            mod.parse(der[:40])


def test_hkdf_and_labels():
    ikm, salt = b"\x0b" * 22, bytes(range(13))
    info = bytes(range(0xF0, 0xFA))
    prk = TT.hkdf_extract(salt, ikm)
    assert prk.hex() == "077709362c2e32df0ddc3f0dc47bba6390b6c73bb50f9c3122ec844ad7c2b3e5"
    okm = TT.hkdf_expand(prk, info, 42)
    assert okm.hex() == ("3cb25f25faacd57a90434f64d0362f2a2d2d0a90cf1a5a4c5db02d56ecc4c5bf"
                         "34007208d5b887185865")
    assert TJ.hkdf_extract(salt, ikm) == prk and TJ.hkdf_expand(prk, info, 42) == okm
    rng = np.random.default_rng(8)
    for label in ("derived", "c hs traffic", "s ap traffic", "finished", "quic ku"):
        secret = rng.integers(0, 256, 32, np.uint8).tobytes()
        ctx = hashlib.sha256(secret).digest()
        for n in (12, 16, 32):
            assert (TT.hkdf_expand_label(secret, label, ctx, n)
                    == TJ.hkdf_expand_label(secret, label, ctx, n))
        assert TT.derive_secret(secret, label, b"t") == TJ.derive_secret(secret, label, b"t")


def _handshake(client, server, rec=None):
    """Shuttle handshake messages between two engines until both are done."""
    for _ in range(8):
        moved = False
        for src, dst in ((client, server), (server, client)):
            while src.out_queue:
                level, msg = src.out_queue.pop(0)
                if rec is not None:
                    rec.append((level, msg))
                dst.feed(level, msg)
                moved = True
        if not moved:
            break
    assert client.handshake_complete and server.handshake_complete
    assert client.secrets == server.secrets
    assert client.peer_identity == GJ.public_from_secret(IDENTITY)


@pytest.mark.parametrize("server_mod,client_mod", [(TJ, TT), (TT, TJ)],
                         ids=["port_client_jax_server", "jax_client_port_server"])
def test_cross_handshake(server_mod, client_mod):
    server = server_mod.TlsServer(IDENTITY, transport_params=TP)
    client = client_mod.TlsClient(transport_params=TP)
    _handshake(client, server)
    assert server.peer_transport_params == client.peer_transport_params == TP


def test_seeded_handshake_messages_match_jax(monkeypatch, fresh_certs):
    recs, secrets = [], []
    for mod in (TJ, TT):
        stream = np.random.default_rng(12).bytes
        if mod is TJ:
            monkeypatch.setattr(os, "urandom", stream)
            client = mod.TlsClient(transport_params=TP)
            server = mod.TlsServer(IDENTITY, transport_params=TP)
        else:
            monkeypatch.setattr(os, "urandom", _urandom_refused)
            client = mod.TlsClient(transport_params=TP, rand=stream)
            server = mod.TlsServer(IDENTITY, transport_params=TP, rand=stream)
        rec = []
        _handshake(client, server, rec)
        recs.append(rec)
        secrets.append((client.secrets, server.transcript, server.cert_der))
    assert len(recs[0]) >= 5
    assert recs[1] == recs[0]
    assert secrets[1] == secrets[0]


def test_engines_refuse_bad_peers():
    """A low-order key share (all-zero X25519 output) and a tampered
    certificate fail the handshake in both packages alike."""
    for mod in (TT, TJ):
        client = mod.TlsClient(transport_params=TP)
        level, ch = client.out_queue.pop(0)
        ks_at = ch.index(bytes.fromhex("001d0020")) + 4
        low = ch[:ks_at] + bytes(32) + ch[ks_at + 32:]
        server = mod.TlsServer(IDENTITY, transport_params=TP)
        with pytest.raises(mod.TlsError, match="bad key share"):
            server.feed(level, low)
        server = mod.TlsServer(IDENTITY, transport_params=TP)
        server.feed(level, ch)
        msgs = server.out_queue
        cert_i = next(i for i, (_l, m) in enumerate(msgs) if m[0] == mod.CERTIFICATE)
        lv, m = msgs[cert_i]
        bad = bytearray(m)
        bad[-10] ^= 1
        msgs[cert_i] = (lv, bytes(bad))
        with pytest.raises(mod.TlsError):
            for lv, m in msgs:
                client.feed(lv, m)
