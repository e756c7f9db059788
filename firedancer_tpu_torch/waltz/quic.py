"""Minimal QUIC v1 (RFC 9000/9001/9002) for the Solana TPU ingress path.

A copy of firedancer_tpu/waltz/quic.py.  QuicServer, QuicClient and
Connection take the source of their random bytes, `rand(n) -> bytes`
(default os.urandom), hand it on to the TLS engines they make, and draw
from it in the JAX package's order (the server's token secret at
construction; a new connection's scid, then its TLS engine's draws; Retry
and Version Negotiation packets; NEW_CONNECTION_ID and PATH_CHALLENGE
data; the client's scid, its initial dcid, then its TLS engine's draws), so
a seeded `rand` and the same seeded os.urandom give both packages the same
bytes.

Reference: src/waltz/quic/fd_quic.c — connection lifecycle,
Initial/Handshake/1-RTT packet protection, CRYPTO-stream handshake via the
TLS engine, and client-initiated unidirectional streams each carrying one
transaction (FIN marks the end), which is exactly how the Solana TPU
protocol uses QUIC.  Independent re-implementation of that scope from the
RFCs; packet protection uses ballet.aes, the handshake uses waltz.tls.

Loss recovery (reference analog: fd_quic_pkt_meta.c ack tracking + loss
detection): every ack-eliciting packet's retransmittable frames are kept
in a per-level sent map; ACK frames are parsed into ranges, newly-acked
packets feed the RFC 9002 smoothed-RTT estimator, and packets are declared
lost by packet threshold (3) or time threshold (9/8 RTT), their frames
re-queued for a fresh packet number.  A PTO timer (`on_timer`, sans-IO:
the owner polls it) probes with exponential backoff when acks stop.
Receivers track true ACK ranges so reordered/lossy arrival is acked
faithfully.  Server-side Retry + token validation and pre-validation
anti-amplification (3x) implement RFC 9000 section 8.

It carries RFC 9000 section 6 version negotiation (stateless VN
packets from the server, client abort on incompatible VN) and RFC 9001
section 6 key update (phase bit, per-generation secrets via "quic ku",
constant header-protection keys, previous-generation receive window).

It also carries RFC 9000 section 9 connection migration: the server
routes short-header packets from unknown addresses by DCID, adopts the
new path, probes it with PATH_CHALLENGE/PATH_RESPONSE, and offers spare
CIDs via NEW_CONNECTION_ID after the handshake so a migrating client
rotates its destination CID (9.5).

Sans-IO: Connection.datagrams_out() drains UDP payloads to send; feed
received payloads via Connection.on_datagram(); call on_timer(now)
periodically (or at next_timeout()).
"""

from __future__ import annotations

import hmac as _hmac
import os
import time as _time

from ..ballet import aes as A
from . import tls

INITIAL_SALT_V1 = bytes.fromhex("38762cf7f55934b34d179ae6a4c80cadccbb7f0a")
VERSION = 1

INITIAL, HANDSHAKE, APPLICATION = tls.INITIAL, tls.HANDSHAKE, tls.APPLICATION

# long-header packet types (bits 4-5 of the first byte)
_PT_INITIAL, _PT_0RTT, _PT_HANDSHAKE, _PT_RETRY = 0, 1, 2, 3
_LEVEL_BY_PT = {_PT_INITIAL: INITIAL, _PT_HANDSHAKE: HANDSHAKE}
_PT_BY_LEVEL = {INITIAL: _PT_INITIAL, HANDSHAKE: _PT_HANDSHAKE}

MAX_DATAGRAM = 1200

#: RFC 9002 constants
K_PACKET_THRESHOLD = 3
K_TIME_THRESHOLD = 9 / 8
K_GRANULARITY = 1e-3
INITIAL_RTT = 0.1  # conservative for LAN/tests; RFC suggests 0.333

#: RFC 9001 section 5.8 Retry integrity key/nonce for QUIC v1
_RETRY_KEY = bytes.fromhex("be0c690b9f66575a1d766b54e368c84e")
_RETRY_NONCE = bytes.fromhex("461599d35d632bf2239825bb")

#: the Retry integrity key is a spec CONSTANT, so its AEAD (key
#: schedule + GHASH table) is built once — a Retry is the cheap backoff
#: signal the handshake-rate limiter answers floods with, and
#: rebuilding the key schedule per Retry made the defense cost more
#: than the attack
_retry_aead_cache: list = []


def _retry_aead() -> "A.AesGcm":
    if not _retry_aead_cache:
        _retry_aead_cache.append(A.AesGcm(_RETRY_KEY))
    return _retry_aead_cache[0]


# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------


def vi_enc(n: int) -> bytes:
    if n < 1 << 6:
        return bytes([n])
    if n < 1 << 14:
        return (n | 0x4000).to_bytes(2, "big")
    if n < 1 << 30:
        return (n | 0x80000000).to_bytes(4, "big")
    return (n | 0xC000000000000000).to_bytes(8, "big")


def vi_dec(buf: bytes, off: int) -> tuple[int, int]:
    first = buf[off]
    ln = 1 << (first >> 6)
    val = int.from_bytes(buf[off : off + ln], "big") & ((1 << (8 * ln - 2)) - 1)
    return val, off + ln


# ---------------------------------------------------------------------------
# packet protection
# ---------------------------------------------------------------------------


def ku_secret(secret: bytes) -> bytes:
    """Next-generation traffic secret (RFC 9001 section 6 key update)."""
    return tls.hkdf_expand_label(secret, "quic ku", b"", 32)


class Keys:
    """AEAD + header-protection keys for one direction at one level.

    Key update note: the header-protection key is NOT updated across key
    phases (RFC 9001 6.1) — updated generations reuse the old hp."""

    def __init__(self, secret: bytes, hp=None):
        self.secret = secret
        self.aead = A.AesGcm(
            tls.hkdf_expand_label(secret, "quic key", b"", 16)
        )
        self.iv = tls.hkdf_expand_label(secret, "quic iv", b"", 12)
        # key update passes the previous generation's hp (never updated)
        self.hp = hp if hp is not None else A.key_expand(
            tls.hkdf_expand_label(secret, "quic hp", b"", 16)
        )

    def nonce(self, pn: int) -> bytes:
        n = int.from_bytes(self.iv, "big") ^ pn
        return n.to_bytes(12, "big")

    def hp_mask(self, sample: bytes) -> bytes:
        return A.encrypt_block(self.hp, sample)[:5]


def initial_secrets(dcid: bytes) -> tuple[bytes, bytes]:
    """(client secret, server secret) for the Initial level."""
    initial = tls.hkdf_extract(INITIAL_SALT_V1, dcid)
    c = tls.hkdf_expand_label(initial, "client in", b"", 32)
    s = tls.hkdf_expand_label(initial, "server in", b"", 32)
    return c, s


def _pn_decode(truncated: int, pn_len: int, largest: int) -> int:
    """RFC 9000 appendix A packet-number recovery."""
    expected = largest + 1
    win = 1 << (8 * pn_len)
    hwin = win // 2
    cand = (expected & ~(win - 1)) | truncated
    if cand <= expected - hwin and cand < (1 << 62) - win:
        return cand + win
    if cand > expected + hwin and cand >= win:
        return cand - win
    return cand


# ---------------------------------------------------------------------------
# frame-level helpers
# ---------------------------------------------------------------------------


class CryptoStream:
    """In-order reassembly of one CRYPTO stream (per level)."""

    def __init__(self):
        self.delivered = 0
        self.pending: dict[int, bytes] = {}

    def insert(self, off: int, data: bytes) -> bytes:
        self.pending[off] = max(
            self.pending.get(off, b""), data, key=len
        )
        out = b""
        while True:
            # find a chunk covering `delivered`
            hit = None
            for o, d in self.pending.items():
                if o <= self.delivered < o + len(d):
                    hit = (o, d)
                    break
                if o == self.delivered and not d:
                    hit = (o, d)
                    break
            if hit is None:
                return out
            o, d = hit
            del self.pending[o]
            take = d[self.delivered - o :]
            out += take
            self.delivered += len(take)


class StreamBuf:
    """Reassembly of one client->server unidirectional stream."""

    __slots__ = ("chunks", "fin_size", "size")

    def __init__(self):
        self.chunks: dict[int, bytes] = {}
        self.fin_size = -1
        self.size = 0

    def insert(self, off: int, data: bytes, fin: bool) -> bytes | None:
        """Returns the complete payload once FIN and all bytes are in."""
        if data:
            self.chunks[off] = max(self.chunks.get(off, b""), data, key=len)
        if fin:
            self.fin_size = off + len(data)
        if self.fin_size < 0:
            return None
        # contiguity check
        have = 0
        while True:
            nxt = None
            for o, d in self.chunks.items():
                if o <= have < o + len(d):
                    nxt = o + len(d)
                    break
            if nxt is None:
                break
            have = max(have, nxt)
        if have < self.fin_size:
            return None
        out = bytearray(self.fin_size)
        for o, d in self.chunks.items():
            out[o : o + len(d)] = d[: max(0, self.fin_size - o)]
        return bytes(out)


# ---------------------------------------------------------------------------
# connection
# ---------------------------------------------------------------------------


class Connection:
    """One QUIC connection endpoint (sans-IO)."""

    def __init__(self, is_server: bool, engine, scid: bytes, dcid: bytes,
                 rand=os.urandom):
        self.rand = rand
        self.is_server = is_server
        self.tls = engine
        self.scid = scid
        self.dcid = dcid
        self.keys_rx: dict[int, Keys] = {}
        self.keys_tx: dict[int, Keys] = {}
        self.pn_tx = {INITIAL: 0, HANDSHAKE: 0, APPLICATION: 0}
        self.largest_rx = {INITIAL: -1, HANDSHAKE: -1, APPLICATION: -1}
        #: received pn ranges per level: sorted merged [lo, hi] pairs —
        #: the truth the ACK frames we send are generated from
        self.rx_ranges: dict[int, list[list[int]]] = {
            INITIAL: [], HANDSHAKE: [], APPLICATION: [],
        }
        self.ack_pending = {INITIAL: False, HANDSHAKE: False, APPLICATION: False}
        self.crypto_rx = {INITIAL: CryptoStream(), HANDSHAKE: CryptoStream(), APPLICATION: CryptoStream()}
        self.crypto_tx_off = {INITIAL: 0, HANDSHAKE: 0, APPLICATION: 0}
        self.streams: dict[int, StreamBuf] = {}
        #: completed stream ids (bounded): a retransmitted copy of an
        #: already-delivered stream must not re-deliver its txn
        import collections as _c

        self._done_streams: set[int] = set()
        self._done_order: _c.deque = _c.deque()
        self.txns: list[bytes] = []  # completed stream payloads (server)
        self.established = False
        self.closed = False
        self._out: list[bytes] = []
        self._pending_frames: dict[int, list[bytes]] = {INITIAL: [], HANDSHAKE: [], APPLICATION: []}
        self._next_uni_stream = 2  # client: uni stream ids 2, 6, 10, ...
        self.peer_identity = None
        # ---- loss recovery state (fd_quic_pkt_meta analog) ----
        #: per level: pn -> (time_sent, retransmittable frame tuple)
        self.sent: dict[int, dict[int, tuple[float, tuple[bytes, ...]]]] = {
            INITIAL: {}, HANDSHAKE: {}, APPLICATION: {},
        }
        self.largest_acked = {INITIAL: -1, HANDSHAKE: -1, APPLICATION: -1}
        self.srtt: float | None = None
        self.rttvar: float | None = None
        self.pto_count = 0
        self.lost_packets = 0
        self.retx_frames = 0
        #: client: retry token to carry in Initial packets
        self.token = b""
        #: server address validation (RFC 9000 section 8): until the peer
        #: proves address ownership, send at most 3x bytes received
        self.validated = not is_server
        self.bytes_rx = 0
        self.bytes_tx = 0
        self._amp_blocked: list[bytes] = []
        # ---- key update state (RFC 9001 section 6) ----
        #: current key phase bit for 1-RTT packets (both directions flip
        #: together)
        self.key_phase = 0
        self.key_updates = 0
        self._app_rx_secret: bytes | None = None
        self._app_tx_secret: bytes | None = None
        #: previous-generation rx keys (reordered pre-update packets)
        self._rx_prev: Keys | None = None
        #: cached next-generation rx trial keys (one derivation per
        #: generation, not per phase-mismatched packet)
        self._rx_next: Keys | None = None
        # ---- connection migration state (RFC 9000 section 9) ----
        #: CIDs we issued via NEW_CONNECTION_ID (all route to us)
        self.scids: set[bytes] = {scid}
        self._cid_seq = 0
        self._cids_issued = False
        #: CIDs the peer issued to us: list of (seq, cid)
        self.peer_cids: list[tuple[int, bytes]] = []
        #: outstanding PATH_CHALLENGE data (one at a time)
        self._path_challenge_sent: bytes | None = None
        #: set when a matching PATH_RESPONSE arrives (owner consumes)
        self.path_response: bytes | None = None
        #: NON-PROBING application packets that authenticated with a
        #: not-previously-received pn strictly above largest_rx — the
        #: only packets that may trigger a server-side path migration
        #: (RFC 9000 9.2/9.3)
        self.migrate_auth_cnt = 0
        self._rx_non_probing = False
        #: when set (by the server, around an off-path datagram), any
        #: PATH_RESPONSE generated while processing is diverted to
        #: _path_response_out instead of the active tx path, so ONLY the
        #: response — not coalesced acks/data — leaves on the
        #: unvalidated arriving path
        self._divert_path_response = False
        self._path_response_out: list[bytes] = []
        #: last datagram arrival in the owner's tickcount domain, stamped
        #: by QuicServer.on_datagram from its now_tick — the idle-churn
        #: eviction input (waltz/admission.py ConnAdmission.sweep)
        self.last_rx_tick = 0

    # -- key install ---------------------------------------------------------

    def _install_initial(self, dcid: bytes) -> None:
        c, s = initial_secrets(dcid)
        if self.is_server:
            self.keys_rx[INITIAL] = Keys(c)
            self.keys_tx[INITIAL] = Keys(s)
        else:
            self.keys_rx[INITIAL] = Keys(s)
            self.keys_tx[INITIAL] = Keys(c)

    def _install_from_tls(self) -> None:
        for level in (HANDSHAKE, APPLICATION):
            if level in self.tls.secrets and level not in self.keys_tx:
                c, s = self.tls.secrets[level]
                if self.is_server:
                    self.keys_rx[level] = Keys(c)
                    self.keys_tx[level] = Keys(s)
                else:
                    self.keys_rx[level] = Keys(s)
                    self.keys_tx[level] = Keys(c)
                if level == APPLICATION:
                    self._app_rx_secret = self.keys_rx[level].secret
                    self._app_tx_secret = self.keys_tx[level].secret
                if level == HANDSHAKE and not self.is_server:
                    # client discards the Initial space when it first
                    # sends at the handshake level (RFC 9002 6.4); the
                    # server keeps it until a Handshake packet ARRIVES
                    # (a lost ServerHello must stay retransmittable)
                    self.sent[INITIAL].clear()

    # -- receive path --------------------------------------------------------

    def on_datagram(self, data: bytes) -> None:
        self.bytes_rx += len(data)
        self._release_amp_blocked()
        off = 0
        while off < len(data) and not self.closed:
            first = data[off]
            if first == 0:  # padding between coalesced packets
                off += 1
                continue
            try:
                if first & 0x80:
                    consumed = self._rx_long(data, off)
                else:
                    consumed = self._rx_short(data, off)
            except (IndexError, ValueError):
                return  # malformed packet: drop the rest of the datagram
            if consumed <= 0:
                return
            off += consumed
            # keys derived from a packet earlier in this datagram must be
            # live before the next coalesced packet (Initial(SH) and the
            # Handshake flight typically share one datagram)
            self._install_from_tls()
        self._drive()
        # a packet in this datagram may have validated the path (token or
        # handshake receipt): release anything the 3x budget was holding
        self._release_amp_blocked()

    def _amp_ok(self, extra: int) -> bool:
        return self.validated or self.bytes_tx + extra <= 3 * self.bytes_rx

    def _release_amp_blocked(self) -> None:
        while self._amp_blocked and self._amp_ok(len(self._amp_blocked[0])):
            d = self._amp_blocked.pop(0)
            self.bytes_tx += len(d)
            self._out.append(d)

    def _rx_long(self, data: bytes, off: int) -> int:
        version = int.from_bytes(data[off + 1 : off + 5], "big")
        if version == 0:
            # Version Negotiation (RFC 9000 section 6): only meaningful
            # to a client that has not yet processed any server packet
            if self.is_server or any(
                v >= 0 for v in self.largest_rx.values()
            ):
                return len(data) - off
            o = off + 5
            o += 1 + data[o]            # dcid
            o += 1 + data[o]            # scid
            offered = {
                int.from_bytes(data[i : i + 4], "big")
                for i in range(o, len(data) - 3, 4)
            }
            if VERSION not in offered:
                self.closed = True      # no compatible version
            return len(data) - off
        if version != VERSION:
            return -1                   # unknown version: drop
        pt = (data[off] >> 4) & 3
        o = off + 5
        dcil = data[o]
        dcid = data[o + 1 : o + 1 + dcil]
        o += 1 + dcil
        scil = data[o]
        scid = data[o + 1 : o + 1 + scil]
        o += 1 + scil
        if pt == _PT_RETRY:
            if not self.is_server:
                self._on_retry(data[off:], scid)
            return len(data) - off  # retry consumes the datagram
        if pt == _PT_INITIAL:
            tok_len, o = vi_dec(data, o)
            o += tok_len
        elif pt not in _LEVEL_BY_PT:
            return -1  # 0-rtt unsupported
        length, o = vi_dec(data, o)
        level = _LEVEL_BY_PT[pt]
        if level == INITIAL and INITIAL not in self.keys_rx:
            self._install_initial(dcid)
        if not self.is_server and level == INITIAL and scid:
            self.dcid = scid  # adopt server-chosen CID
        pkt_end = o + length
        self._decrypt_and_process(data[off:pkt_end], o - off, level)
        return pkt_end - off

    def _rx_short(self, data: bytes, off: int) -> int:
        # short header: flags + dcid (our scid length) + pn; runs to dgram end
        pn_off = off + 1 + len(self.scid)
        self._decrypt_and_process(data[off:], pn_off - off, APPLICATION)
        return len(data) - off

    def _decrypt_and_process(self, pkt: bytes, pn_off: int, level: int) -> None:
        keys = self.keys_rx.get(level)
        if keys is None:
            return  # keys not yet available; drop (lossless-link assumption)
        buf = bytearray(pkt)
        sample = bytes(buf[pn_off + 4 : pn_off + 20])
        if len(sample) < 16:
            return
        mask = keys.hp_mask(sample)
        if buf[0] & 0x80:
            buf[0] ^= mask[0] & 0x0F
        else:
            buf[0] ^= mask[0] & 0x1F
        pn_len = (buf[0] & 0x03) + 1
        for i in range(pn_len):
            buf[pn_off + i] ^= mask[1 + i]
        truncated = int.from_bytes(buf[pn_off : pn_off + pn_len], "big")
        pn = _pn_decode(truncated, pn_len, self.largest_rx[level])
        header = bytes(buf[: pn_off + pn_len])
        body = bytes(buf[pn_off + pn_len :])
        if level == APPLICATION and self._app_rx_secret is not None:
            phase = (buf[0] >> 2) & 1
            if phase != self.key_phase:
                # peer-initiated key update (try next generation), or a
                # reordered packet from before OUR update (previous keys)
                if self._rx_next is None:
                    self._rx_next = Keys(
                        ku_secret(self._app_rx_secret), hp=keys.hp
                    )
                trial = self._rx_next
                payload = trial.aead.decrypt(trial.nonce(pn), body, header)
                if payload is not None:
                    self._advance_generation(rx_keys=trial)
                elif self._rx_prev is not None:
                    payload = self._rx_prev.aead.decrypt(
                        self._rx_prev.nonce(pn), body, header
                    )
            else:
                payload = keys.aead.decrypt(keys.nonce(pn), body, header)
        else:
            payload = keys.aead.decrypt(keys.nonce(pn), body, header)
        if payload is None:
            return
        if level == HANDSHAKE and self.is_server:
            # a decryptable Handshake packet proves the peer owns the
            # address (RFC 9000 8.1) and closes the Initial space (9002 6.4)
            self.validated = True
            self.sent[INITIAL].clear()
        if level == APPLICATION:
            self.sent[HANDSHAKE].clear()
        fresh = pn > self.largest_rx[level]
        self.largest_rx[level] = max(self.largest_rx[level], pn)
        self._range_add(level, pn)
        self._rx_non_probing = False
        if self._on_frames(level, payload):
            # only ack-eliciting packets trigger sending an ACK
            # (acking pure-ACK packets would ping-pong forever)
            self.ack_pending[level] = True
        if level == APPLICATION and fresh and self._rx_non_probing:
            # migration gate (RFC 9000 sections 9.2/9.3): only a
            # NON-PROBING packet with a not-previously-received packet
            # number strictly above everything seen in the application
            # space may move the path.  A replayed datagram still
            # AUTHENTICATES (AEAD keys don't change) but its pn is <=
            # largest_rx, and a path-validation probe (PATH_CHALLENGE /
            # PATH_RESPONSE / NEW_CONNECTION_ID / PADDING only) must not
            # rebind the return path before the peer commits to it.
            self.migrate_auth_cnt += 1

    def _advance_generation(self, rx_keys: "Keys | None" = None) -> None:
        """Step both directions to the next key generation and flip the
        phase bit (used by initiate_key_update and on peer-initiated
        updates)."""
        self._rx_prev = self.keys_rx[APPLICATION]
        self._app_rx_secret = ku_secret(self._app_rx_secret)
        self._app_tx_secret = ku_secret(self._app_tx_secret)
        self.keys_rx[APPLICATION] = rx_keys or Keys(
            self._app_rx_secret, hp=self._rx_prev.hp
        )
        self.keys_tx[APPLICATION] = Keys(
            self._app_tx_secret, hp=self.keys_tx[APPLICATION].hp
        )
        self._rx_next = None
        self.key_phase ^= 1
        self.key_updates += 1

    # -- connection migration (RFC 9000 section 9) ---------------------------

    def issue_new_cids(self, n: int = 2) -> list[bytes]:
        """Queue NEW_CONNECTION_ID frames offering n fresh CIDs; returns
        them so the owner can route future short-header packets
        addressed to any of them (fd_quic keeps a CID map per conn)."""
        out = []
        for _ in range(n):
            cid = self.rand(8)
            self._cid_seq += 1
            frame = (
                b"\x18"
                + vi_enc(self._cid_seq)
                + vi_enc(0)
                + bytes([len(cid)])
                + cid
                + bytes(16)  # stateless reset token (unused)
            )
            self._pending_frames[APPLICATION].append(frame)
            self.scids.add(cid)
            out.append(cid)
        self._drive()
        return out

    def take_path_response_datagram(self) -> bytes | None:
        """Probing-only datagram carrying diverted PATH_RESPONSE frames
        (see _divert_path_response).  The caller sends it out the path
        the challenge ARRIVED on (RFC 9000 8.2.2); the packet is not
        registered for retransmission (a lost response is answered by
        the peer re-challenging, and it must not migrate paths)."""
        frames, self._path_response_out = self._path_response_out, []
        if not frames or APPLICATION not in self.keys_tx:
            return None
        pkt, _pn = self._build_packet(APPLICATION, b"".join(frames))
        return pkt

    def send_path_challenge(self) -> bytes:
        """Probe the current peer path: queue PATH_CHALLENGE with fresh
        random data (RFC 9000 8.2.1); a matching PATH_RESPONSE sets
        self.path_response."""
        data = self.rand(8)
        self._path_challenge_sent = data
        self._pending_frames[APPLICATION].append(b"\x1a" + data)
        self._drive()
        return data

    def migrate_dcid(self) -> bool:
        """Switch to the next CID the peer issued (a migrating endpoint
        SHOULD rotate its destination CID, RFC 9000 9.5).  Returns False
        when the peer never offered spare CIDs."""
        if not self.peer_cids:
            return False
        _, cid = self.peer_cids.pop(0)
        self.dcid = cid
        return True

    def initiate_key_update(self) -> None:
        """Start sending 1-RTT packets under the next key generation
        (RFC 9001 6.1); the peer follows when it sees the flipped phase
        bit."""
        assert self.established and self._app_tx_secret is not None
        self._advance_generation()

    def _range_add(self, level: int, pn: int) -> None:
        """Insert pn into the level's merged [lo, hi] range list."""
        rs = self.rx_ranges[level]
        for r in rs:
            if r[0] - 1 <= pn <= r[1] + 1:
                r[0] = min(r[0], pn)
                r[1] = max(r[1], pn)
                break
        else:
            rs.append([pn, pn])
        rs.sort()
        # merge neighbors and cap the list (oldest ranges drop first)
        merged = [rs[0]]
        for r in rs[1:]:
            if r[0] <= merged[-1][1] + 1:
                merged[-1][1] = max(merged[-1][1], r[1])
            else:
                merged.append(r)
        self.rx_ranges[level] = merged[-32:]

    def _on_frames(self, level: int, payload: bytes) -> bool:
        """Process frames; returns True if any frame was ack-eliciting."""
        eliciting = False
        off = 0
        n = len(payload)
        while off < n:
            ft = payload[off]
            if ft not in (0x00, 0x02, 0x03):
                eliciting = True
            if ft not in (0x00, 0x18, 0x1A, 0x1B):
                # anything beyond PADDING / NEW_CONNECTION_ID /
                # PATH_CHALLENGE / PATH_RESPONSE makes the packet
                # non-probing (RFC 9000 9.2 — the migration gate)
                self._rx_non_probing = True
            if ft == 0x00:  # PADDING
                off += 1
            elif ft == 0x01:  # PING
                off += 1
            elif ft in (0x02, 0x03):  # ACK
                off += 1
                largest, off = vi_dec(payload, off)
                _, off = vi_dec(payload, off)  # delay
                cnt, off = vi_dec(payload, off)
                first, off = vi_dec(payload, off)
                hi = largest
                ranges = [(hi - first, hi)]
                lo = hi - first
                for _ in range(cnt):
                    gap, off = vi_dec(payload, off)
                    rlen, off = vi_dec(payload, off)
                    hi = lo - gap - 2
                    lo = hi - rlen
                    ranges.append((lo, hi))
                if ft == 0x03:
                    for _ in range(3):
                        _, off = vi_dec(payload, off)
                self._on_ack(level, ranges)
            elif ft == 0x06:  # CRYPTO
                off += 1
                coff, off = vi_dec(payload, off)
                clen, off = vi_dec(payload, off)
                data = payload[off : off + clen]
                off += clen
                try:
                    self.tls.feed(level, self.crypto_rx[level].insert(coff, data))
                except tls.TlsError:
                    self.closed = True
                    return eliciting
            elif 0x08 <= ft <= 0x0F:  # STREAM
                has_off = bool(ft & 0x04)
                has_len = bool(ft & 0x02)
                fin = bool(ft & 0x01)
                off += 1
                sid, off = vi_dec(payload, off)
                soff = 0
                if has_off:
                    soff, off = vi_dec(payload, off)
                if has_len:
                    slen, off = vi_dec(payload, off)
                else:
                    slen = n - off
                data = payload[off : off + slen]
                off += slen
                if sid in self._done_streams:
                    continue  # duplicate of a delivered stream
                buf = self.streams.setdefault(sid, StreamBuf())
                done = buf.insert(soff, data, fin)
                if done is not None:
                    self.txns.append(done)
                    del self.streams[sid]
                    self._done_streams.add(sid)
                    self._done_order.append(sid)
                    if len(self._done_order) > 4096:
                        self._done_streams.discard(self._done_order.popleft())
            elif ft in (0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17):
                off += 1  # flow-control / blocked frames: type + varints
                nargs = {0x11: 2, 0x15: 2}.get(ft, 1)
                for _ in range(nargs):
                    _, off = vi_dec(payload, off)
            elif ft == 0x18:  # NEW_CONNECTION_ID
                off += 1
                seq, off = vi_dec(payload, off)
                _, off = vi_dec(payload, off)  # retire_prior_to
                cl = payload[off]
                cid = payload[off + 1 : off + 1 + cl]
                off += 1 + cl + 16  # + stateless reset token
                if not any(s == seq for s, _ in self.peer_cids):
                    self.peer_cids.append((seq, bytes(cid)))
            elif ft == 0x19:  # RETIRE_CONNECTION_ID
                off += 1
                _, off = vi_dec(payload, off)
            elif ft == 0x1A:  # PATH_CHALLENGE
                off += 1
                data = bytes(payload[off : off + 8])
                off += 8
                # echo on PATH_RESPONSE (RFC 9000 8.2.2).  Normally the
                # response rides the tx path (the owner points it at the
                # probed address during migration); for an off-path
                # probe the server diverts it so it leaves on the
                # ARRIVING path without dragging acks/data along
                if self._divert_path_response:
                    self._path_response_out.append(b"\x1b" + data)
                else:
                    self._pending_frames[APPLICATION].append(b"\x1b" + data)
            elif ft == 0x1B:  # PATH_RESPONSE
                off += 1
                data = bytes(payload[off : off + 8])
                off += 8
                if data == self._path_challenge_sent:
                    self.path_response = data
                    self._path_challenge_sent = None
            elif ft in (0x1C, 0x1D):  # CONNECTION_CLOSE
                self.closed = True
                return eliciting
            elif ft == 0x1E:  # HANDSHAKE_DONE
                off += 1
                self.established = True
            else:
                self.closed = True  # unknown frame: fatal per RFC
                return eliciting
        return eliciting

    # -- loss recovery (RFC 9002; reference: fd_quic_pkt_meta.c) -------------

    def _on_ack(self, level: int, ranges: list[tuple[int, int]]) -> None:
        now = _time.monotonic()
        if ranges[0][1] >= self.pn_tx[level]:
            # ack for a packet number never sent: a bogus largest would
            # poison largest_acked and storm-retransmit (RFC 9002 rule)
            self.closed = True
            return
        sent = self.sent[level]
        newly = []
        for lo, hi in ranges:
            for pn in list(sent):
                if lo <= pn <= hi:
                    newly.append(pn)
        if not newly:
            # still update largest_acked for loss threshold purposes
            self.largest_acked[level] = max(
                self.largest_acked[level], ranges[0][1]
            )
            self._detect_losses(level, now)
            return
        largest_newly = max(newly)
        if largest_newly == ranges[0][1]:
            # RTT sample from the largest acked when it is newly acked
            sample = max(now - sent[largest_newly][0], K_GRANULARITY)
            if self.srtt is None:
                self.srtt = sample
                self.rttvar = sample / 2
            else:
                self.rttvar = 0.75 * self.rttvar + 0.25 * abs(
                    self.srtt - sample
                )
                self.srtt = 0.875 * self.srtt + 0.125 * sample
        for pn in newly:
            del sent[pn]
        self.largest_acked[level] = max(self.largest_acked[level], ranges[0][1])
        self.pto_count = 0
        self._detect_losses(level, now)

    def _detect_losses(self, level: int, now: float) -> None:
        """Packet-threshold + time-threshold loss declaration; lost
        packets' frames re-enter the pending queue for a new packet."""
        sent = self.sent[level]
        la = self.largest_acked[level]
        if la < 0:
            return
        loss_delay = K_TIME_THRESHOLD * (self.srtt or INITIAL_RTT)
        lost = [
            pn
            for pn, (t, _f) in sent.items()
            if pn < la
            and (la - pn >= K_PACKET_THRESHOLD or t <= now - loss_delay)
        ]
        for pn in lost:
            _t, frames = sent.pop(pn)
            self.lost_packets += 1
            self.retx_frames += len(frames)
            self._pending_frames[level].extend(frames)
        if lost:
            self._flush()

    def _pto_interval(self) -> float:
        base = (self.srtt or INITIAL_RTT) + max(
            4 * (self.rttvar or INITIAL_RTT / 2), K_GRANULARITY
        )
        return base * (1 << min(self.pto_count, 6))

    def on_timer(self, now: float | None = None) -> None:
        """Probe-timeout check: when the oldest unacked packet has waited
        a full PTO, its frames are retransmitted with exponential backoff.
        Owners call this periodically (sans-IO)."""
        if self.closed:
            return
        if self._amp_blocked:
            # packets held by the 3x pre-validation budget were never on
            # the wire; "retransmitting" them would only duplicate state
            return
        now = _time.monotonic() if now is None else now
        pto = self._pto_interval()
        fired = False
        for level in (INITIAL, HANDSHAKE, APPLICATION):
            sent = self.sent[level]
            if not sent:
                continue
            oldest = min(sent, key=lambda p: sent[p][0])
            t, frames = sent[oldest]
            if now - t >= pto:
                del sent[oldest]
                self.retx_frames += len(frames)
                self._pending_frames[level].extend(
                    frames if frames else [b"\x01"]  # bare probe: PING
                )
                fired = True
        if fired:
            self.pto_count += 1
            self._flush()

    def next_timeout(self, now: float | None = None) -> float | None:
        """Seconds until the earliest PTO expiry, or None when idle."""
        now = _time.monotonic() if now is None else now
        pto = self._pto_interval()
        nxt = None
        for level in (INITIAL, HANDSHAKE, APPLICATION):
            for t, _f in self.sent[level].values():
                d = t + pto - now
                nxt = d if nxt is None else min(nxt, d)
        return nxt

    def _on_retry(self, pkt: bytes, retry_scid: bytes) -> None:
        """Client side of Retry: verify the integrity tag, adopt the
        server's new CID, stash the token, and replay the Initial flight
        under re-derived keys (RFC 9001 section 5.8 / RFC 9000 17.2.5)."""
        if self.token or HANDSHAKE in self.keys_rx:
            return  # at most one retry, and only before the handshake
        if len(pkt) < 16:
            return
        tag = pkt[-16:]
        token = pkt[:-16][5 + 1 + len(self.scid) + 1 + len(retry_scid) :]
        # integrity check: AEAD over pseudo-packet (odcid prefixed)
        pseudo = bytes([len(self.dcid)]) + self.dcid + pkt[:-16]
        want = _retry_aead().encrypt(_RETRY_NONCE, b"", pseudo)
        if not _hmac.compare_digest(want[-16:], tag):
            return
        self.token = token
        # replay the Initial flight: unacked frames go back to pending
        frames = []
        for pn in sorted(self.sent[INITIAL]):
            frames.extend(self.sent[INITIAL][pn][1])
        self.sent[INITIAL].clear()
        self.dcid = retry_scid
        self._install_initial(retry_scid)
        self._pending_frames[INITIAL] = frames + self._pending_frames[INITIAL]
        self._flush()

    # -- send path -----------------------------------------------------------

    def _drive(self) -> None:
        """Flush TLS output + ACKs into packets."""
        self._install_from_tls()
        while self.tls.out_queue:
            level, msg = self.tls.out_queue.pop(0)
            frame = (
                b"\x06"
                + vi_enc(self.crypto_tx_off[level])
                + vi_enc(len(msg))
                + msg
            )
            self.crypto_tx_off[level] += len(msg)
            self._pending_frames[level].append(frame)
        self._install_from_tls()
        if (
            self.is_server
            and self.tls.handshake_complete
            and not self.established
            and APPLICATION in self.keys_tx
        ):
            self.peer_identity = self.tls.peer_identity
            self._pending_frames[APPLICATION].append(b"\x1e")  # HANDSHAKE_DONE
            self.established = True
        # ACK every level with new ack-eliciting packets, with true ranges
        for level in (INITIAL, HANDSHAKE, APPLICATION):
            if self.ack_pending[level] and level in self.keys_tx:
                ack = self._ack_frame(level)
                if ack:
                    self._pending_frames[level].append(ack)
                self.ack_pending[level] = False
        self._flush()

    def _ack_frame(self, level: int) -> bytes:
        """Encode the level's received ranges as one ACK frame."""
        rs = self.rx_ranges[level]
        if not rs:
            return b""
        rs = rs[::-1]  # largest first
        lo, hi = rs[0]
        out = b"\x02" + vi_enc(hi) + vi_enc(0) + vi_enc(len(rs) - 1)
        out += vi_enc(hi - lo)
        prev_lo = lo
        for nlo, nhi in rs[1:]:
            out += vi_enc(prev_lo - nhi - 2) + vi_enc(nhi - nlo)
            prev_lo = nlo
        return out

    def _flush(self) -> None:
        """Coalesce pending frames into protected packets/datagrams.

        Each ack-eliciting packet's retransmittable frames are recorded in
        the sent map for loss recovery (pkt_meta registration)."""
        now = _time.monotonic()
        datagram = b""
        for level in (INITIAL, HANDSHAKE, APPLICATION):
            frames = self._pending_frames[level]
            if not frames or level not in self.keys_tx:
                continue
            self._pending_frames[level] = []
            # split oversized frame runs across packets
            while frames:
                take, sz = [], 0
                while frames and sz + len(frames[0]) <= MAX_DATAGRAM - 64:
                    take.append(frames.pop(0))
                    sz += len(take[-1])
                if not take:  # single oversized frame: send alone
                    take.append(frames.pop(0))
                payload = b"".join(take)
                retrans = tuple(
                    f for f in take if f[0] not in (0x00, 0x02, 0x03)
                )
                pkt, pn = self._build_packet(level, payload)
                if retrans:
                    self.sent[level][pn] = (now, retrans)
                if len(datagram) + len(pkt) > MAX_DATAGRAM:
                    if datagram:
                        self._emit_datagram(datagram)
                    datagram = b""
                datagram += pkt
        if datagram:
            self._emit_datagram(datagram)

    def _emit_datagram(self, dgram: bytes) -> None:
        dgram = self._pad_if_initial(dgram)
        if not self._amp_ok(len(dgram)):
            # pre-validation 3x budget exhausted: hold until more bytes
            # arrive from the (unvalidated) peer
            self._amp_blocked.append(dgram)
            return
        self.bytes_tx += len(dgram)
        self._out.append(dgram)

    def _pad_if_initial(self, dgram: bytes) -> bytes:
        # datagrams containing Initial packets must be >= 1200 bytes
        if dgram and (dgram[0] & 0xF0) == 0xC0 and len(dgram) < MAX_DATAGRAM:
            return dgram + b"\0" * (MAX_DATAGRAM - len(dgram))
        return dgram

    def _build_packet(self, level: int, payload: bytes) -> tuple[bytes, int]:
        keys = self.keys_tx[level]
        pn = self.pn_tx[level]
        self.pn_tx[level] += 1
        pn_len = 2
        pn_bytes = (pn & 0xFFFF).to_bytes(2, "big")
        # AEAD adds 16; ensure sample coverage for header protection
        if len(payload) + 16 < 20 - pn_len:
            payload = payload + b"\0" * (20 - pn_len - 16 - len(payload))
        if level == APPLICATION:
            first = 0x40 | (self.key_phase << 2) | (pn_len - 1)
            header = bytes([first]) + self.dcid + pn_bytes
        else:
            first = 0xC0 | (_PT_BY_LEVEL[level] << 4) | (pn_len - 1)
            length = len(payload) + 16 + pn_len
            token = self.token if not self.is_server else b""
            header = (
                bytes([first])
                + VERSION.to_bytes(4, "big")
                + bytes([len(self.dcid)])
                + self.dcid
                + bytes([len(self.scid)])
                + self.scid
                + (vi_enc(len(token)) + token if level == INITIAL else b"")
                + vi_enc(length)
                + pn_bytes
            )
        sealed = keys.aead.encrypt(keys.nonce(pn), payload, header)
        pkt = bytearray(header + sealed)
        pn_off = len(header) - pn_len
        mask = keys.hp_mask(bytes(pkt[pn_off + 4 : pn_off + 20]))
        if pkt[0] & 0x80:
            pkt[0] ^= mask[0] & 0x0F
        else:
            pkt[0] ^= mask[0] & 0x1F
        for i in range(pn_len):
            pkt[pn_off + i] ^= mask[1 + i]
        return bytes(pkt), pn

    def datagrams_out(self) -> list[bytes]:
        out, self._out = self._out, []
        return out

    # -- client API ----------------------------------------------------------

    def send_txn(self, txn: bytes) -> None:
        """Open the next unidirectional stream carrying one txn (client)."""
        assert not self.is_server
        sid = self._next_uni_stream
        self._next_uni_stream += 4
        frame = (
            bytes([0x08 | 0x04 | 0x02 | 0x01])  # STREAM with OFF/LEN/FIN
            + vi_enc(sid)
            + vi_enc(0)
            + vi_enc(len(txn))
            + txn
        )
        self._pending_frames[APPLICATION].append(frame)
        self._flush()


# ---------------------------------------------------------------------------
# endpoints
# ---------------------------------------------------------------------------

_TP_DEFAULT = (
    vi_enc(0x04) + vi_enc(4) + (1 << 24).to_bytes(4, "big")  # initial_max_data
    + vi_enc(0x07) + vi_enc(4) + (1 << 20).to_bytes(4, "big")  # max_stream_data_uni
    + vi_enc(0x09) + vi_enc(4) + (1 << 16).to_bytes(4, "big")  # max_streams_uni
    + vi_enc(0x03) + vi_enc(2) + (1452 | 0x4000).to_bytes(2, "big")  # max_udp
)


class QuicServer:
    """Multi-connection QUIC server endpoint (sans-IO; sockets live in the
    net tile)."""

    #: cap on live connections — a new-source flood beyond this is refused
    #: rather than allocating a TlsServer + x509 cert per datagram
    MAX_CONNS = 4096

    def __init__(
        self,
        identity_secret: bytes,
        max_conns: int = MAX_CONNS,
        retry: bool = False,
        admission=None,
        rand=os.urandom,
    ):
        """retry=True: stateless Retry with address-validating tokens —
        no connection state (TLS engine, certs) is allocated until the
        client echoes a valid token (RFC 9000 section 8.1.2).

        admission: a waltz.admission.ConnAdmission policy consulted on
        every connection-opening Initial (handshake-rate + global /
        per-source caps).  The owner sets `now_tick` (tickcount domain)
        before each datagram burst; refusals are tallied by reason in
        `admit_drops` for the owning tile to meter — a refused datagram
        never raises, and a rate-limited handshake draws a stateless
        Retry so a legitimate client backs off and revalidates."""
        from ..tango.lru import Lru

        self.rand = rand
        self.identity_secret = identity_secret
        self.max_conns = max_conns
        self.retry = retry
        self.admission = admission
        #: owner-stamped tickcount for admission decisions + idle stamps
        self.now_tick = 0
        #: refusal tally by REASONS code, drained into tile metrics
        self.admit_drops: dict[str, int] = {}
        self.token_secret = rand(32)
        self.conns: dict[bytes, Connection] = {}  # by our scid
        self.by_addr: dict = {}
        #: recency over addrs: at capacity the least-recently-active
        #: connection is evicted (reference: tango/lru under fd_quic)
        self.lru = Lru(max_conns)
        #: stateless packets to send: (datagram, addr) — Retry responses
        self.stateless_out: list[tuple[bytes, object]] = []
        #: address migrations adopted (path challenges sent)
        self.migrations = 0
        #: migrations whose PATH_RESPONSE validated the new path
        self.paths_validated = 0

    def _evict_at_cap(self) -> bool:
        """Make room at the table cap: sweep closed conns, else evict
        the least-recently-active conn, preferring one that never
        finished its handshake (a handshake flood must not push out
        established peers).  Returns True when a slot is free."""
        for a, c in list(self.by_addr.items()):
            if c.closed:
                self._reap(a, c)
        if len(self.conns) < self.max_conns:
            return True
        victim = None
        for a in self.lru.iter_lru():
            c = self.by_addr.get(a)
            if c is not None and not c.established:
                victim = a
                break
        victim = victim if victim is not None else self.lru.lru_key()
        if victim is None:
            return False
        self._reap(victim, self.by_addr[victim])
        return True

    def _reap(self, addr, conn) -> None:
        for cid in conn.scids:
            self.conns.pop(cid, None)
        self.by_addr.pop(addr, None)
        self.lru.remove(addr)
        if self.admission is not None:
            self.admission.conn_released(conn.scid)

    def evict(self, addr) -> bool:
        """Administrative eviction (idle-churn / slow-loris sweep from
        the owning tile's housekeeping).  Returns True when a live
        connection was reaped."""
        conn = self.by_addr.get(addr)
        if conn is None:
            return False
        self._reap(addr, conn)
        return True

    @staticmethod
    def _addr_bytes(addr) -> bytes:
        return repr(addr).encode()

    def _vn_packet(self, data: bytes) -> bytes:
        """Stateless Version Negotiation: echo the client's CIDs swapped,
        version field 0, then our supported version list."""
        dcil = data[5]
        dcid = data[6 : 6 + dcil]
        o = 6 + dcil
        scil = data[o]
        scid = data[o + 1 : o + 1 + scil]
        return (
            bytes([0x80 | (self.rand(1)[0] & 0x7F)])
            + (0).to_bytes(4, "big")
            + bytes([len(scid)]) + scid
            + bytes([len(dcid)]) + dcid
            + VERSION.to_bytes(4, "big")
        )

    def _retry_packet(self, client_scid: bytes, odcid: bytes, addr) -> bytes:
        retry_scid = self.rand(8)
        mac = _hmac.new(
            self.token_secret,
            self._addr_bytes(addr) + odcid + retry_scid,
            "sha256",
        ).digest()[:16]
        token = bytes([len(odcid)]) + odcid + retry_scid + mac
        hdr = (
            bytes([0xF0])
            + VERSION.to_bytes(4, "big")
            + bytes([len(client_scid)])
            + client_scid
            + bytes([len(retry_scid)])
            + retry_scid
            + token
        )
        pseudo = bytes([len(odcid)]) + odcid + hdr
        tag = _retry_aead().encrypt(_RETRY_NONCE, b"", pseudo)[-16:]
        return hdr + tag

    def _check_token(self, token: bytes, addr) -> tuple[bytes, bytes] | None:
        """Valid token -> (odcid, retry_scid); else None."""
        if len(token) < 1 + 8 + 16:
            return None
        ol = token[0]
        if len(token) != 1 + ol + 8 + 16:
            return None
        odcid = token[1 : 1 + ol]
        retry_scid = token[1 + ol : 1 + ol + 8]
        mac = token[1 + ol + 8 :]
        want = _hmac.new(
            self.token_secret,
            self._addr_bytes(addr) + odcid + retry_scid,
            "sha256",
        ).digest()[:16]
        return (odcid, retry_scid) if _hmac.compare_digest(mac, want) else None

    def on_datagram(self, data: bytes, addr) -> Connection | None:
        conn = self.by_addr.get(addr)
        if conn is not None and conn.closed:
            self._reap(addr, conn)
            conn = None
        if conn is None and len(data) >= 9 and not (data[0] & 0x80):
            # short header from an UNKNOWN address: route by DCID — an
            # established peer migrating (NAT rebind, multihome).  RFC
            # 9000 section 9: the address change is honored ONLY if the
            # packet AUTHENTICATES (DCIDs are plaintext — an off-path
            # attacker echoing an observed CID from its own address must
            # not be able to steal the path), then the new path is
            # validated with PATH_CHALLENGE.  fd_quic routes through its
            # CID map the same way.
            cand = self.conns.get(bytes(data[1:9]))
            if cand is not None and cand.established and not cand.closed:
                auth0 = cand.migrate_auth_cnt
                cand._divert_path_response = True
                try:
                    cand.on_datagram(data)
                finally:
                    cand._divert_path_response = False
                # any PATH_RESPONSE this datagram provoked goes out the
                # ARRIVING path (RFC 9000 8.2.2) — and ONLY the
                # response: acks/data stay queued for the active path
                resp = cand.take_path_response_datagram()
                if resp is not None:
                    self.stateless_out.append((resp, addr))
                if cand.migrate_auth_cnt == auth0:
                    # did not decrypt, a replay (pn not above
                    # largest_rx), or a probing-only packet: keep the
                    # old path — RFC 9000 9.3 honors an address change
                    # only for the highest-numbered non-probing packet
                    return None
                old = getattr(cand, "_addr", None)
                if old is not None and old != addr:
                    self.by_addr.pop(old, None)
                    self.lru.remove(old)
                self.by_addr[addr] = cand
                cand._addr = addr
                cand.last_rx_tick = self.now_tick
                self.lru.acquire(addr)
                self.migrations += 1
                cand.send_path_challenge()
                if cand.path_response is not None:
                    self.paths_validated += 1
                    cand.path_response = None
                if cand.closed:
                    self._reap(addr, cand)
                return cand
        if conn is None:
            if len(data) < 7 or not (data[0] & 0x80):
                return None  # short header / runt for unknown conn
            version = int.from_bytes(data[1:5], "big")
            if version != VERSION:
                # RFC 9000 section 6: answer an unknown version with a
                # stateless Version Negotiation packet (and never VN a VN)
                if version != 0 and len(data) >= 1200:
                    self.stateless_out.append(
                        (self._vn_packet(data), addr)
                    )
                return None
            if ((data[0] >> 4) & 3) != _PT_INITIAL:
                return None  # only an Initial may open a connection
            if 6 + data[5] + 1 > len(data):
                return None  # malformed CID lengths
            # cheap header parse (CIDs + token) shared by the admission
            # gate and the retry path below
            try:
                dcil = data[5]
                pre_dcid = data[6 : 6 + dcil]
                po = 6 + dcil
                pre_scid = data[po + 1 : po + 1 + data[po]]
                po += 1 + data[po]
                tok_len, to = vi_dec(data, po)
                pre_token = data[to : to + tok_len]
            except (IndexError, ValueError):
                return None  # malformed Initial header: drop
            # a token echoed from OUR Retry (MAC over addr + odcid +
            # retry-scid, and the client must address us by the retry
            # scid) proves address ownership: the Retry round-trip WAS
            # this source's rate toll, so the echo bypasses the
            # handshake bucket — the backoff signal guarantees a
            # legitimate client progress under exactly the flood that
            # empties the bucket, while a flood's forged tokens fail
            # the MAC and stay rate-limited
            tok_hit = (
                self._check_token(pre_token, addr) if pre_token else None
            )
            token_valid = tok_hit is not None and tok_hit[1] == pre_dcid
            if self.admission is not None:
                # pre-allocation gate: handshake-rate + emergency-level
                # refusal BEFORE any TLS/cert state exists.  A
                # rate-limited source gets a stateless Retry — the RFC
                # 9000 section 8 backoff signal — and revalidates by
                # echoing the token (the bypass above)
                reason = self.admission.admit_handshake(
                    addr, self.now_tick, validated=token_valid
                )
                if reason is not None:
                    self.admit_drops[reason] = (
                        self.admit_drops.get(reason, 0) + 1
                    )
                    if reason == "drop_handshake_rate":
                        self.stateless_out.append(
                            (
                                self._retry_packet(
                                    pre_scid, pre_dcid, addr
                                ),
                                addr,
                            )
                        )
                        self.admit_drops["retry_sent"] = (
                            self.admit_drops.get("retry_sent", 0) + 1
                        )
                    return None
            dcid, client_scid = pre_dcid, pre_scid
            validated = False
            odcid = dcid
            if self.retry:
                if not pre_token:
                    self.stateless_out.append(
                        (self._retry_packet(client_scid, dcid, addr), addr)
                    )
                    return None
                if not token_valid:
                    return None  # forged/stale token: drop silently
            if token_valid:
                # either retry mode's mandatory round-trip, or the echo
                # of a rate-limit Retry: the original DCID rides the
                # token, and the path counts as validated (RFC 9000
                # 8.1 — lifts the 3x anti-amplification budget)
                odcid, validated = tok_hit[0], True
            if self.admission is not None:
                # cap gate at the exact allocation point (after token
                # validation, so a Retry round-trip is never counted as
                # a connection): global cap, then per-source-IP cap
                reason = self.admission.admit_conn(addr, self.now_tick)
                if reason == "drop_conn_cap" and self._evict_at_cap():
                    # table-cap refusal is the one retryable reason:
                    # evicting per the churn policy freed a registry
                    # slot too (_reap -> conn_released), so re-gate
                    reason = self.admission.admit_conn(
                        addr, self.now_tick
                    )
                if reason is not None:
                    self.admit_drops[reason] = (
                        self.admit_drops.get(reason, 0) + 1
                    )
                    return None
            if len(self.conns) >= self.max_conns:
                # at-cap eviction runs only once every refusal gate has
                # passed — an Initial that is about to be refused must
                # never cost an existing peer its slot
                if not self._evict_at_cap():
                    return None
                if len(self.conns) >= self.max_conns:
                    return None
            # a validated (token-echoing) client already addresses us
            # by the Retry-chosen CID: keep it as our scid so its dcid
            # stays stable across the handshake
            scid = dcid if validated else self.rand(8)
            tp = (
                vi_enc(0x00) + vi_enc(len(odcid)) + odcid
                + vi_enc(0x0F) + vi_enc(len(scid)) + scid
                + (
                    vi_enc(0x10) + vi_enc(len(scid)) + scid
                    if validated
                    else b""
                )  # retry_source_connection_id
                + _TP_DEFAULT
            )
            engine = tls.TlsServer(self.identity_secret, transport_params=tp,
                                   rand=self.rand)
            conn = Connection(True, engine, scid, client_scid, rand=self.rand)
            conn.validated = conn.validated or validated
            self.conns[scid] = conn
            self.by_addr[addr] = conn
            if self.admission is not None:
                self.admission.conn_opened(scid, addr, self.now_tick)
        conn._addr = addr
        conn.last_rx_tick = self.now_tick
        self.lru.acquire(addr)
        conn.on_datagram(data)
        if conn.path_response is not None:
            self.paths_validated += 1
            conn.path_response = None
        if conn.established and not conn._cids_issued:
            # offer spare CIDs so a migrating client can rotate its
            # destination CID (RFC 9000 9.5); register them for routing
            conn._cids_issued = True
            for cid in conn.issue_new_cids():
                self.conns[cid] = conn
        if conn.closed:
            self._reap(addr, conn)
        return conn


class QuicClient:
    """Single-connection QUIC client (tests + bench txn sender)."""

    def __init__(self, rand=os.urandom):
        self.scid = rand(8)
        initial_dcid = rand(8)
        tp = (
            vi_enc(0x0F) + vi_enc(len(self.scid)) + self.scid + _TP_DEFAULT
        )
        engine = tls.TlsClient(transport_params=tp, rand=rand)
        self.conn = Connection(False, engine, self.scid, initial_dcid,
                               rand=rand)
        self.conn._install_initial(initial_dcid)
        self.conn._drive()  # emits the Initial(ClientHello)
