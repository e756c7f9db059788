"""Minimal X.509v3 for QUIC-TLS: self-signed Ed25519 cert generate + parse.

A copy of firedancer_tpu/waltz/x509.py.  `generate` takes the source of
the serial's random bytes (`rand(n) -> bytes`, default os.urandom), signs
through the port's ops/ed25519/hostpath.py and `verify_self_signed` checks
through the port's golden.

Reference: src/ballet/x509/ (mock CA generation for QUIC
tests + parser).  Behavior contract only — this is a from-scratch tiny DER
codec covering exactly the certificate shape QUIC needs: an Ed25519
self-signed cert whose SubjectPublicKeyInfo carries the validator identity
key.  The parser extracts that key (and verifies the self-signature at a
higher layer); it is NOT a general-purpose X.509 validator.
"""

from __future__ import annotations

import os

# DER tag bytes
_SEQ = 0x30
_SET = 0x31
_INT = 0x02
_BITSTR = 0x03
_OID = 0x06
_UTF8 = 0x0C
_UTCTIME = 0x17
_CTX0 = 0xA0
_CTX3 = 0xA3

OID_ED25519 = bytes([0x2B, 0x65, 0x70])  # 1.3.101.112
OID_CN = bytes([0x55, 0x04, 0x03])  # 2.5.4.3


def _len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(body)]) + body


def _tlv(tag: int, body: bytes) -> bytes:
    return bytes([tag]) + _len(len(body)) + body


def _uint(n: int) -> bytes:
    body = n.to_bytes(max(1, (n.bit_length() + 7) // 8), "big")
    if body[0] & 0x80:
        body = b"\0" + body
    return _tlv(_INT, body)


def _name(cn: str) -> bytes:
    rdn = _tlv(
        _SET,
        _tlv(_SEQ, _tlv(_OID, OID_CN) + _tlv(_UTF8, cn.encode())),
    )
    return _tlv(_SEQ, rdn)


_ALG_ED25519 = _tlv(_SEQ, _tlv(_OID, OID_ED25519))


#: one cert per identity: a server presents the SAME certificate on
#: every connection, so signing a fresh one per TlsServer (≈280 ms of
#: pure-python ed25519) was a self-inflicted handshake-flood DoS — an
#: attacker's bare Initial cost US a signature.  Keyed by (secret, cn).
_CERT_CACHE: dict[tuple[bytes, str], bytes] = {}


def generate(identity_secret: bytes, cn: str = "fdt", rand=os.urandom) -> bytes:
    """Self-signed Ed25519 certificate DER for the identity key.
    Cached per identity, and signed via the fast host path
    (ops/ed25519/hostpath.py — bit-identical to golden by parity test,
    ~50x faster), so connection setup never re-signs.  The serial is
    rand(8), drawn only when the certificate is not cached."""
    cached = _CERT_CACHE.get((identity_secret, cn))
    if cached is not None:
        return cached
    from ..ops.ed25519 import hostpath as golden

    pub = golden.public_from_secret(identity_secret)
    validity = _tlv(_SEQ, _tlv(_UTCTIME, b"200101000000Z") * 2)
    spki = _tlv(_SEQ, _ALG_ED25519 + _tlv(_BITSTR, b"\0" + pub))
    tbs = _tlv(
        _SEQ,
        _tlv(_CTX0, _uint(2))  # version v3
        + _uint(int.from_bytes(rand(8), "big") >> 1)  # serial
        + _ALG_ED25519
        + _name(cn)
        + validity
        + _name(cn)
        + spki,
    )
    sig = golden.sign(identity_secret, tbs)
    der = _tlv(_SEQ, tbs + _ALG_ED25519 + _tlv(_BITSTR, b"\0" + sig))
    _CERT_CACHE[(identity_secret, cn)] = der
    return der


class _Reader:
    def __init__(self, buf: bytes, off: int = 0):
        self.buf = buf
        self.off = off

    def tlv(self) -> tuple[int, bytes]:
        tag = self.buf[self.off]
        i = self.off + 1
        l0 = self.buf[i]
        i += 1
        if l0 & 0x80:
            nb = l0 & 0x7F
            length = int.from_bytes(self.buf[i : i + nb], "big")
            i += nb
        else:
            length = l0
        body = self.buf[i : i + length]
        if len(body) != length:
            raise ValueError("truncated DER")
        self.off = i + length
        return tag, body


def parse(der: bytes) -> dict:
    """Extract {pubkey, tbs, sig} from an Ed25519 certificate.

    Raises ValueError on malformed input or non-Ed25519 algorithms."""
    tag, cert = _Reader(der).tlv()
    if tag != _SEQ:
        raise ValueError("not a certificate sequence")
    r = _Reader(cert)
    tbs_tag, tbs_body = r.tlv()
    # reconstruct the exact signed bytes (header + body)
    tbs_raw = _tlv(tbs_tag, tbs_body)
    alg_tag, alg_body = r.tlv()
    if _tlv(alg_tag, alg_body) != _ALG_ED25519:
        raise ValueError("unsupported signature algorithm")
    sig_tag, sig_body = r.tlv()
    if sig_tag != _BITSTR or len(sig_body) != 65 or sig_body[0] != 0:
        raise ValueError("bad signature bitstring")

    # walk the TBS for the SPKI (version?, serial, alg, issuer, validity,
    # subject, spki)
    t = _Reader(tbs_body)
    tag0, body0 = t.tlv()
    if tag0 == _CTX0:  # explicit version present
        tag0, body0 = t.tlv()  # serial
    for _ in range(4):  # alg, issuer, validity, subject
        t.tlv()
    spki_tag, spki_body = t.tlv()
    if spki_tag != _SEQ:
        raise ValueError("bad SPKI")
    s = _Reader(spki_body)
    a_tag, a_body = s.tlv()
    if _tlv(a_tag, a_body) != _ALG_ED25519:
        raise ValueError("not an Ed25519 key")
    k_tag, k_body = s.tlv()
    if k_tag != _BITSTR or len(k_body) != 33 or k_body[0] != 0:
        raise ValueError("bad key bitstring")
    return {"pubkey": k_body[1:], "tbs": tbs_raw, "sig": sig_body[1:]}


def verify_self_signed(der: bytes) -> bytes | None:
    """Parse + check the self-signature; returns the pubkey or None."""
    from ..ops.ed25519 import golden

    try:
        info = parse(der)
    except ValueError:
        return None
    ok = golden.verify(info["tbs"], info["sig"], info["pubkey"]) == 0
    return info["pubkey"] if ok else None
