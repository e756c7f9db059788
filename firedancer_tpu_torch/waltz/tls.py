"""Minimal TLS 1.3 handshake engine for QUIC (sans-IO).

A copy of firedancer_tpu/waltz/tls.py.  TlsServer and TlsClient take the
source of their random bytes, `rand(n) -> bytes` (default os.urandom), and
draw from it in the JAX package's order: the server the certificate's
serial (x509.generate, when not cached) at construction, then its X25519
ephemeral key and then its ServerHello random; the client its ephemeral key
and then its ClientHello random, at construction.  Signatures go through the
port's ops/ed25519/hostpath.py and golden.

Reference: src/waltz/tls/fd_tls.c — a purpose-built TLS 1.3
implementation supporting exactly what QUIC needs: TLS_AES_128_GCM_SHA256,
X25519 key exchange, Ed25519 certificates.  This is an independent
re-implementation of that scope from RFC 8446 + RFC 9001: handshake
messages ride QUIC CRYPTO frames (no TLS record layer), and each side
exports per-level traffic secrets (initial handled by QUIC itself).

Sans-IO: callers feed received CRYPTO-stream bytes via `feed(level, data)`
and drain `(level, bytes)` outputs from `out_queue`; `secrets[level]` fills
in as the handshake advances.  Control-plane code — python ints + hashlib
(the host "libc" here), not the batch TPU kernels.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import os

from ..ballet import x25519 as X
from . import x509

# handshake message types
CLIENT_HELLO = 1
SERVER_HELLO = 2
ENCRYPTED_EXTENSIONS = 8
CERTIFICATE = 11
CERTIFICATE_VERIFY = 15
FINISHED = 20

# encryption levels (QUIC)
INITIAL, HANDSHAKE, APPLICATION = 0, 1, 2

CIPHER_AES128_GCM_SHA256 = 0x1301
GROUP_X25519 = 0x001D
SIG_ED25519 = 0x0807

EXT_SNI = 0x0000
EXT_SUPPORTED_GROUPS = 0x000A
EXT_SIG_ALGS = 0x000D
EXT_ALPN = 0x0010
EXT_SUPPORTED_VERSIONS = 0x002B
EXT_KEY_SHARE = 0x0033
EXT_QUIC_TRANSPORT_PARAMS = 0x0039

_HASH_LEN = 32


def hkdf_extract(salt: bytes, ikm: bytes) -> bytes:
    return _hmac.new(salt or b"\0" * _HASH_LEN, ikm, hashlib.sha256).digest()


def hkdf_expand(prk: bytes, info: bytes, length: int) -> bytes:
    out = b""
    t = b""
    i = 1
    while len(out) < length:
        t = _hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        out += t
        i += 1
    return out[:length]


def hkdf_expand_label(
    secret: bytes, label: str, context: bytes, length: int
) -> bytes:
    full = b"tls13 " + label.encode()
    info = (
        length.to_bytes(2, "big")
        + bytes([len(full)])
        + full
        + bytes([len(context)])
        + context
    )
    return hkdf_expand(secret, info, length)


def derive_secret(secret: bytes, label: str, transcript: bytes) -> bytes:
    return hkdf_expand_label(
        secret, label, hashlib.sha256(transcript).digest(), _HASH_LEN
    )


def _u8v(b: bytes) -> bytes:
    return bytes([len(b)]) + b


def _u16v(b: bytes) -> bytes:
    return len(b).to_bytes(2, "big") + b


def _ext(etype: int, body: bytes) -> bytes:
    return etype.to_bytes(2, "big") + _u16v(body)


def _msg(mtype: int, body: bytes) -> bytes:
    return bytes([mtype]) + len(body).to_bytes(3, "big") + body


def _parse_exts(b: bytes) -> dict[int, bytes]:
    out = {}
    off = 0
    while off + 4 <= len(b):
        et = int.from_bytes(b[off : off + 2], "big")
        ln = int.from_bytes(b[off + 2 : off + 4], "big")
        out[et] = b[off + 4 : off + 4 + ln]
        off += 4 + ln
    return out


_CV_SERVER_CTX = b" " * 64 + b"TLS 1.3, server CertificateVerify" + b"\0"


class TlsError(Exception):
    pass


class _Engine:
    """Shared handshake-stream plumbing for client/server."""

    def __init__(self):
        self.bufs = {INITIAL: b"", HANDSHAKE: b"", APPLICATION: b""}
        self.out_queue: list[tuple[int, bytes]] = []
        self.secrets: dict[int, tuple[bytes, bytes]] = {}  # level->(client, server)
        self.transcript = b""
        self.handshake_complete = False
        self.alert: str | None = None
        self.peer_transport_params: bytes | None = None
        self.peer_identity: bytes | None = None  # Ed25519 pubkey from cert

    def feed(self, level: int, data: bytes) -> None:
        """Append received CRYPTO bytes at an encryption level and process
        any complete handshake messages."""
        self.bufs[level] += data
        while True:
            buf = self.bufs[level]
            if len(buf) < 4:
                return
            mlen = int.from_bytes(buf[1:4], "big")
            if len(buf) < 4 + mlen:
                return
            msg, self.bufs[level] = buf[: 4 + mlen], buf[4 + mlen :]
            self._on_message(level, msg[0], msg[4:], msg)

    def _send(self, level: int, msg: bytes) -> None:
        self.out_queue.append((level, msg))
        self.transcript += msg

    def _fail(self, why: str):
        self.alert = why
        raise TlsError(why)


class TlsServer(_Engine):
    """TLS 1.3 server for QUIC: one handshake per instance."""

    def __init__(self, identity_secret: bytes, transport_params: bytes,
                 alpn: bytes = b"solana-tpu", rand=os.urandom):
        super().__init__()
        self.rand = rand
        self.identity_secret = identity_secret
        self.cert_der = x509.generate(identity_secret, rand=rand)
        self.transport_params = transport_params
        self.alpn = alpn
        self._master = None
        self._client_hs_traffic = None

    def _on_message(self, level, mtype, body, raw):
        if mtype == CLIENT_HELLO and level == INITIAL:
            self.transcript += raw
            self._on_client_hello(body)
        elif mtype == FINISHED and level == HANDSHAKE:
            fin_key = hkdf_expand_label(
                self._client_hs_traffic, "finished", b"", _HASH_LEN
            )
            want = _hmac.new(
                fin_key, hashlib.sha256(self.transcript).digest(), hashlib.sha256
            ).digest()
            if not _hmac.compare_digest(want, body):
                self._fail("bad client Finished")
            self.transcript += raw
            self.handshake_complete = True
        else:
            self._fail(f"unexpected message type {mtype} at level {level}")

    def _on_client_hello(self, body: bytes) -> None:
        off = 2 + 32  # legacy_version + random
        sid_len = body[off]
        off += 1 + sid_len
        cs_len = int.from_bytes(body[off : off + 2], "big")
        suites = body[off + 2 : off + 2 + cs_len]
        off += 2 + cs_len
        off += 1 + body[off]  # compression
        ext_len = int.from_bytes(body[off : off + 2], "big")
        exts = _parse_exts(body[off + 2 : off + 2 + ext_len])

        if CIPHER_AES128_GCM_SHA256.to_bytes(2, "big") not in [
            suites[i : i + 2] for i in range(0, len(suites), 2)
        ]:
            self._fail("no common cipher suite")
        ks = exts.get(EXT_KEY_SHARE)
        peer_pub = None
        if ks:
            kslen = int.from_bytes(ks[:2], "big")
            o = 2
            while o < 2 + kslen:
                grp = int.from_bytes(ks[o : o + 2], "big")
                klen = int.from_bytes(ks[o + 2 : o + 4], "big")
                if grp == GROUP_X25519:
                    peer_pub = ks[o + 4 : o + 4 + klen]
                o += 4 + klen
        if peer_pub is None or len(peer_pub) != 32:
            self._fail("no x25519 key share")
        self.peer_transport_params = exts.get(EXT_QUIC_TRANSPORT_PARAMS)

        eph = self.rand(32)
        my_pub = X.public_key(eph)
        shared = X.x25519(eph, peer_pub)
        if shared == b"\x00" * 32:
            # RFC 8446 7.4.2: abort on all-zero X25519 output (low-order
            # peer share would force a predictable handshake key)
            self._fail("bad key share")

        sh_exts = _ext(EXT_SUPPORTED_VERSIONS, (0x0304).to_bytes(2, "big"))
        sh_exts += _ext(
            EXT_KEY_SHARE,
            GROUP_X25519.to_bytes(2, "big") + _u16v(my_pub),
        )
        sh = (
            (0x0303).to_bytes(2, "big")
            + self.rand(32)
            + _u8v(b"")
            + CIPHER_AES128_GCM_SHA256.to_bytes(2, "big")
            + b"\0"
            + _u16v(sh_exts)
        )
        self._send(INITIAL, _msg(SERVER_HELLO, sh))

        # key schedule to handshake secrets
        early = hkdf_extract(b"", b"\0" * _HASH_LEN)
        derived = derive_secret(early, "derived", b"")
        hs = hkdf_extract(derived, shared)
        c_hs = derive_secret(hs, "c hs traffic", self.transcript)
        s_hs = derive_secret(hs, "s hs traffic", self.transcript)
        self._client_hs_traffic = c_hs
        self.secrets[HANDSHAKE] = (c_hs, s_hs)
        self._master = hkdf_extract(
            derive_secret(hs, "derived", b""), b"\0" * _HASH_LEN
        )

        ee = _u16v(_ext(EXT_QUIC_TRANSPORT_PARAMS, self.transport_params)
                   + _ext(EXT_ALPN, _u16v(_u8v(self.alpn))))
        self._send(HANDSHAKE, _msg(ENCRYPTED_EXTENSIONS, ee))
        cert = b"\0" + (
            len(self.cert_der) + 5
        ).to_bytes(3, "big") + (
            len(self.cert_der).to_bytes(3, "big") + self.cert_der + b"\0\0"
        )
        self._send(HANDSHAKE, _msg(CERTIFICATE, cert))

        # hostpath.sign is bit-identical to golden (parity-tested) and
        # ~50x faster — the per-handshake CertificateVerify must not
        # cost a pure-python signature under a handshake storm
        from ..ops.ed25519 import hostpath

        to_sign = _CV_SERVER_CTX + hashlib.sha256(self.transcript).digest()
        sig = hostpath.sign(self.identity_secret, to_sign)
        cv = SIG_ED25519.to_bytes(2, "big") + _u16v(sig)
        self._send(HANDSHAKE, _msg(CERTIFICATE_VERIFY, cv))

        fin_key = hkdf_expand_label(s_hs, "finished", b"", _HASH_LEN)
        verify = _hmac.new(
            fin_key, hashlib.sha256(self.transcript).digest(), hashlib.sha256
        ).digest()
        self._send(HANDSHAKE, _msg(FINISHED, verify))

        c_ap = derive_secret(self._master, "c ap traffic", self.transcript)
        s_ap = derive_secret(self._master, "s ap traffic", self.transcript)
        self.secrets[APPLICATION] = (c_ap, s_ap)


class TlsClient(_Engine):
    """TLS 1.3 client for QUIC (tests + the bench txn sender)."""

    def __init__(self, transport_params: bytes, alpn: bytes = b"solana-tpu",
                 server_name: str = "fdt", rand=os.urandom):
        super().__init__()
        self.rand = rand
        self.transport_params = transport_params
        self.alpn = alpn
        self.server_name = server_name
        self._eph = self.rand(32)
        self._hs_secret = None
        self._s_hs_traffic = None
        self._c_hs_traffic = None
        self._master = None
        self._cv_ok = False
        ch = self._client_hello()
        self._send(INITIAL, ch)

    def _client_hello(self) -> bytes:
        sni = _u16v(b"\0" + _u16v(self.server_name.encode()))
        exts = (
            _ext(EXT_SNI, sni)
            + _ext(EXT_SUPPORTED_VERSIONS, b"\x02" + (0x0304).to_bytes(2, "big"))
            + _ext(EXT_SUPPORTED_GROUPS, _u16v(GROUP_X25519.to_bytes(2, "big")))
            + _ext(EXT_SIG_ALGS, _u16v(SIG_ED25519.to_bytes(2, "big")))
            + _ext(
                EXT_KEY_SHARE,
                _u16v(
                    GROUP_X25519.to_bytes(2, "big")
                    + _u16v(X.public_key(self._eph))
                ),
            )
            + _ext(EXT_ALPN, _u16v(_u8v(self.alpn)))
            + _ext(EXT_QUIC_TRANSPORT_PARAMS, self.transport_params)
        )
        body = (
            (0x0303).to_bytes(2, "big")
            + self.rand(32)
            + _u8v(b"")
            + _u16v(CIPHER_AES128_GCM_SHA256.to_bytes(2, "big"))
            + _u8v(b"\0")
            + _u16v(exts)
        )
        return _msg(CLIENT_HELLO, body)

    def _on_message(self, level, mtype, body, raw):
        if mtype == SERVER_HELLO and level == INITIAL:
            self._on_server_hello(body, raw)
        elif mtype == ENCRYPTED_EXTENSIONS and level == HANDSHAKE:
            exts = _parse_exts(body[2:])
            self.peer_transport_params = exts.get(EXT_QUIC_TRANSPORT_PARAMS)
            self.transcript += raw
        elif mtype == CERTIFICATE and level == HANDSHAKE:
            # cert_request_context u8 + u24 list [u24 cert + u16 exts]
            clen = int.from_bytes(body[1 + body[0] + 0 : 4 + body[0]], "big")
            off = 4 + body[0]
            first_len = int.from_bytes(body[off : off + 3], "big")
            der = body[off + 3 : off + 3 + first_len]
            del clen
            pub = x509.verify_self_signed(der)
            if pub is None:
                self._fail("bad certificate")
            self.peer_identity = pub
            self.transcript += raw
        elif mtype == CERTIFICATE_VERIFY and level == HANDSHAKE:
            from ..ops.ed25519 import golden

            sig_alg = int.from_bytes(body[:2], "big")
            slen = int.from_bytes(body[2:4], "big")
            sig = body[4 : 4 + slen]
            signed = _CV_SERVER_CTX + hashlib.sha256(self.transcript).digest()
            if sig_alg != SIG_ED25519 or golden.verify(
                signed, sig, self.peer_identity
            ) != 0:
                self._fail("bad CertificateVerify")
            self._cv_ok = True
            self.transcript += raw
        elif mtype == FINISHED and level == HANDSHAKE:
            if not self._cv_ok:
                self._fail("Finished before CertificateVerify")
            fin_key = hkdf_expand_label(
                self._s_hs_traffic, "finished", b"", _HASH_LEN
            )
            want = _hmac.new(
                fin_key, hashlib.sha256(self.transcript).digest(), hashlib.sha256
            ).digest()
            if not _hmac.compare_digest(want, body):
                self._fail("bad server Finished")
            self.transcript += raw
            # client app secrets + client Finished
            c_ap = derive_secret(self._master, "c ap traffic", self.transcript)
            s_ap = derive_secret(self._master, "s ap traffic", self.transcript)
            my_fin_key = hkdf_expand_label(
                self._c_hs_traffic, "finished", b"", _HASH_LEN
            )
            verify = _hmac.new(
                my_fin_key,
                hashlib.sha256(self.transcript).digest(),
                hashlib.sha256,
            ).digest()
            self._send(HANDSHAKE, _msg(FINISHED, verify))
            self.secrets[APPLICATION] = (c_ap, s_ap)
            self.handshake_complete = True
        else:
            self._fail(f"unexpected message type {mtype} at level {level}")

    def _on_server_hello(self, body: bytes, raw: bytes) -> None:
        off = 2 + 32
        off += 1 + body[off]  # session id echo
        cipher = int.from_bytes(body[off : off + 2], "big")
        off += 3  # cipher + compression
        exts = _parse_exts(body[off + 2 :])
        if cipher != CIPHER_AES128_GCM_SHA256:
            self._fail("bad cipher")
        ks = exts.get(EXT_KEY_SHARE)
        if not ks or int.from_bytes(ks[:2], "big") != GROUP_X25519:
            self._fail("bad key share")
        klen = int.from_bytes(ks[2:4], "big")
        server_pub = ks[4 : 4 + klen]
        shared = X.x25519(self._eph, server_pub)
        if shared == b"\x00" * 32:
            # RFC 8446 7.4.2 contributory-behavior check (see server side)
            self._fail("bad key share")
        self.transcript += raw

        early = hkdf_extract(b"", b"\0" * _HASH_LEN)
        derived = derive_secret(early, "derived", b"")
        hs = hkdf_extract(derived, shared)
        self._c_hs_traffic = derive_secret(hs, "c hs traffic", self.transcript)
        self._s_hs_traffic = derive_secret(hs, "s hs traffic", self.transcript)
        self.secrets[HANDSHAKE] = (self._c_hs_traffic, self._s_hs_traffic)
        self._master = hkdf_extract(
            derive_secret(hs, "derived", b""), b"\0" * _HASH_LEN
        )
