"""Load generation for the leader pipeline: the many-payer transfer corpus.

A copy of firedancer_tpu/tiles/bench.py's `make_transfer_pool`, signed by
the port's ops/ed25519/sign.py in one `public_keys` batch and one
`sign_many` batch on `device` (None: the CUDA card), and `wire_pool`, which
turns its rows into the (rows, szs, good) pool that tiles/synth.SynthTile
and entry.leader take; and the wire front's senders: `UdpBlaster`, the
paced UDP sender that feeds the net tile, `quic_send`, which drives QUIC
clients, and `WireTraffic`, both together behind entry's front="wire".
SYSTEM_PROGRAM_ID is a copy of firedancer_tpu/flamenco/accounts.py's.

Reference model: src/app/fddev/bench.c:62-90 — benchg tiles sign a stream
of distinct transfer transactions.  Distinctness matters: every txn has a
unique (dest, amount) so dedup cannot collapse the load and every landed
count is a real execution.
"""

from __future__ import annotations

import socket
import threading
import time

import numpy as np

from ..ballet import txn as T
from ..ops.ed25519 import sign as dsign
from ..utils import devices
from . import wire

#: the system program's address (firedancer_tpu/flamenco/accounts.py)
SYSTEM_PROGRAM_ID = bytes(32)


def make_transfer_pool(
    n_txns: int,
    *,
    n_signers: int = 1024,
    seed: int = 0,
    amount_base: int = 1,
    device=None,
) -> tuple[np.ndarray, list[bytes]]:
    """n distinct signed system transfers -> ((n, sz) u8 payload rows,
    payer pubkeys to pre-fund).

    One template txn is built/parsed once; per-txn dest+amount are
    patched into the template body and the signatures come from the
    batch signer in ONE run across all keys.

    n_signers matters: pack's conflict-aware scheduler serializes txns
    sharing a writable payer account, so payer diversity IS the
    schedulable parallelism (the reference's benchg funds a whole
    account set for the same reason)."""
    dev = devices.resolve(device)
    rng = np.random.default_rng(seed)
    secrets = [
        rng.integers(0, 256, 32, np.uint8).tobytes() for _ in range(n_signers)
    ]
    # one device batch instead of n_signers host scalar muls
    pubs = dsign.public_keys(secrets, device=dev)
    blockhash = rng.integers(0, 256, 32, np.uint8).tobytes()

    # template: transfer(payer -> dest, amount); offsets recovered once
    dest0 = bytes(range(32))
    data0 = (2).to_bytes(4, "little") + (0).to_bytes(8, "little")
    body0 = T.build(
        [bytes(64)], [pubs[0], dest0, SYSTEM_PROGRAM_ID], blockhash,
        [(2, [0, 1], data0)], readonly_unsigned_cnt=1,
    )
    desc0 = T.parse(body0)
    assert desc0 is not None
    payer_off = desc0.acct_addr_off
    dest_off = payer_off + 32
    amt_off = desc0.instr[0].data_off + 4
    sz = len(body0)

    rows = np.zeros((n_txns, sz), np.uint8)
    rows[:] = np.frombuffer(body0, np.uint8)
    # unique dest per txn; amount = index (both inside the signed message)
    dests = rng.integers(0, 256, (n_txns, 32), np.uint8)
    rows[:, dest_off:dest_off + 32] = dests
    amts = (np.arange(n_txns, dtype=np.uint64) + amount_base)
    rows[:, amt_off:amt_off + 8] = (
        amts[:, None] >> (8 * np.arange(8, dtype=np.uint64))
    ).astype(np.uint8)

    msg_off = 1 + 64 * desc0.signature_cnt
    pub_rows = np.stack([np.frombuffer(p, np.uint8) for p in pubs])
    rows[:, payer_off:payer_off + 32] = pub_rows[
        np.arange(n_txns) % n_signers
    ]
    pairs = [
        (secrets[i % n_signers], rows[i, msg_off:].tobytes())
        for i in range(n_txns)
    ]
    sigs = dsign.sign_many(pairs, pubs=dict(zip(secrets, pubs)), device=dev)
    for i, sig in enumerate(sigs):
        rows[i, 1:65] = np.frombuffer(sig, np.uint8)
    return rows, pubs


def wire_pool(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """make_transfer_pool's rows -> (rows (n, LINK_MTU) u8 with each txn's
    trailer, szs (n,) u16, good (n,) bool all True): the pool layout of
    tiles/synth.make_txn_pool."""
    n, sz = rows.shape
    out = np.zeros((n, wire.LINK_MTU), np.uint8)
    szs = np.zeros(n, np.uint16)
    for i in range(n):
        payload = rows[i].tobytes()
        desc = T.parse(payload)
        assert desc is not None
        full = wire.append_trailer(payload, desc)
        out[i, : len(full)] = np.frombuffer(full, np.uint8)
        szs[i] = len(full)
    return out, szs, np.ones(n, bool)


class UdpBlaster:
    """benchs analog: a sender thread blasting pool rows at a UDP addr (a
    copy of firedancer_tpu/tiles/bench.py's; `rows` may also be a sequence
    of bytes, for transactions of different sizes).

    UDP severs the ring-credit backpressure the reference's benchs
    tiles inherit, and pack DROPS inserts when its buffer is full — an
    unpaced blast of a finite pool burns most of it as rejects within
    seconds.  Feedback pacing restores the backpressure: the owner
    updates `landed` (an observed count) and the sender keeps
    sent - landed <= window.

    Each burst goes out in one sendmmsg (fdt_udp_send_burst, GIL released)
    where the JAX sender makes one Python sendto a datagram: in a process
    that also runs the tiles, every sendto gives the GIL up and waits to
    take it back, and the sender's rate becomes the GIL's.  A burst's tail
    that the socket refuses (EAGAIN) is sent again, never counted as sent:
    `sent` is what left."""

    def __init__(self, rows, addr: tuple[str, int],
                 burst: int = 64, pace_s: float = 0.0,
                 window: int | None = None):
        self.rows = rows
        self.addr = addr
        self.burst = burst
        self.pace_s = pace_s
        self.window = window
        self.sent = 0
        #: observed landed count, updated by the measuring loop
        self.landed = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _send(self, fd: int, lo: int, hi: int, buf, szs, addrs) -> int:
        """Rows lo..hi out in one sendmmsg; -> datagrams sent."""
        from ..tango import rings as R

        if isinstance(self.rows, np.ndarray):
            view = np.ascontiguousarray(self.rows[lo:hi])
            szs[: hi - lo] = view.shape[1]
        else:
            view = buf
            for k in range(hi - lo):
                row = self.rows[lo + k]
                buf[k, : len(row)] = np.frombuffer(row, np.uint8)
                szs[k] = len(row)
        return int(R._lib.fdt_udp_send_burst(
            fd, view.ctypes.data, view.shape[1], szs.ctypes.data, hi - lo,
            addrs.ctypes.data))

    def _run(self):
        import struct

        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            n = len(self.rows)
            width = (self.rows.shape[1] if isinstance(self.rows, np.ndarray)
                     else max((len(r) for r in self.rows), default=1))
            buf = np.zeros((self.burst, width), np.uint8)
            szs = np.zeros(self.burst, np.uint32)
            prefix = socket.inet_aton(self.addr[0]) + struct.pack("<H", self.addr[1])
            addrs = np.tile(np.frombuffer(prefix, np.uint8), (self.burst, 1))
            last_landed, last_progress = -1, time.monotonic()
            while not self._stop.is_set() and self.sent < n:
                if (
                    self.window is not None
                    and self.sent - self.landed > self.window
                ):
                    # permanently lost txns (UDP drops, rejects) never
                    # leave the window; a long landing stall (a tile
                    # blocked on its device for seconds) must NOT
                    # trigger unpaced sending — that burns the finite
                    # pool as full-buffer rejects in seconds.  Hold
                    # position unless the stall outlives 120 s.
                    now = time.monotonic()
                    if self.landed != last_landed:
                        last_landed, last_progress = self.landed, now
                    if now - last_progress < 120.0:
                        time.sleep(0.005)
                        continue
                end = min(self.sent + self.burst, n)
                got = self._send(sock.fileno(), self.sent, end, buf, szs, addrs)
                short = got < end - self.sent
                self.sent += max(got, 0)
                if short:
                    time.sleep(1e-4)  # the send buffer is full: let it drain
                elif self.pace_s:
                    time.sleep(self.pace_s)
        finally:
            sock.close()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)

    @property
    def done(self) -> bool:
        return self.sent >= len(self.rows)


#: the kernel's receive-buffer charge for one loopback datagram of up to
#: 1,232 payload bytes (a 2 KiB data buffer plus its sk_buff: SO_RCVBUF /
#: the datagrams a full buffer held, on Linux 6.x loopback); the legacy
#: blaster's window is the net tile's granted SO_RCVBUF over this
TRUESIZE = 2304

#: the wire front's legacy sender: datagrams a burst (one sendmmsg)
BLAST_BURST = 64
#: unacked 1-RTT packets a QUIC client keeps in flight (quic_send)
QUIC_WINDOW = 16
#: quic_send ends this long after the last datagram it received, and
#: raises when not done this long after it began
QUIC_QUIET_S, QUIC_TIMEOUT_S = 0.1, 300.0


def quic_send(server_addr, txns_per_client, *, seed: int = 0) -> list[dict]:
    """Drive one waltz.quic.QuicClient per entry of `txns_per_client`, each
    on its own loopback socket, in one loop: the handshake, then the
    client's txns, one stream each, with at most QUIC_WINDOW unacked 1-RTT
    packets in flight, until every client's ack-eliciting packets are
    acked and no datagram has arrived for QUIC_QUIET_S.  The clients draw their
    random bytes from np.random.default_rng(seed).  -> per client:
    established, peer_identity,
    handshake_ms, dgrams_sent, txns, send_s (first txn sent to the last
    packet acked)."""
    import selectors

    from ..waltz import quic as Q

    rand = np.random.default_rng(seed).bytes
    sel = selectors.DefaultSelector()
    clients = []
    try:
        for txns in txns_per_client:
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            sock.bind(("127.0.0.1", 0))
            sock.setblocking(False)
            st = {"sock": sock, "todo": list(txns), "n": len(txns),
                  "t0": time.monotonic(), "client": Q.QuicClient(rand=rand),
                  "hs_ms": None, "sent": 0, "t_send0": None, "t_done": None}
            sel.register(sock, selectors.EVENT_READ, st)
            clients.append(st)
        deadline = time.monotonic() + QUIC_TIMEOUT_S
        last_rx = time.monotonic()

        def send_out(st):
            for d in st["client"].conn.datagrams_out():
                st["sock"].sendto(d, server_addr)
                st["sent"] += 1

        while True:
            now = time.monotonic()
            for st in clients:
                conn = st["client"].conn
                if conn.established and st["hs_ms"] is None:
                    st["hs_ms"] = (now - st["t0"]) * 1e3
                    st["t_send0"] = now
                while (st["hs_ms"] is not None and st["todo"]
                       and len(conn.sent[Q.APPLICATION]) < QUIC_WINDOW):
                    conn.send_txn(st["todo"].pop(0))
                send_out(st)
            for key, _ev in sel.select(timeout=0.002):
                st = key.data
                while True:
                    try:
                        data, _ = st["sock"].recvfrom(65536)
                    except BlockingIOError:
                        break
                    st["client"].conn.on_datagram(data)
                    last_rx = time.monotonic()
            now = time.monotonic()
            for st in clients:
                conn = st["client"].conn
                conn.on_timer()
                send_out(st)
                if (st["t_done"] is None and st["hs_ms"] is not None
                        and not st["todo"] and not any(conn.sent.values())):
                    st["t_done"] = now
            if (all(st["t_done"] is not None for st in clients)
                    and now - last_rx >= QUIC_QUIET_S):
                break
            if now > deadline:
                raise TimeoutError(
                    f"quic_send: not done after {QUIC_TIMEOUT_S} s: "
                    f"{[(st['hs_ms'], len(st['todo'])) for st in clients]}")
    finally:
        sel.close()
        for st in clients:
            st["sock"].close()
    out = []
    for st in clients:
        conn = st["client"].conn
        out.append({
            "established": bool(conn.established),
            "peer_identity": bytes(conn.tls.peer_identity or b""),
            "handshake_ms": st["hs_ms"], "dgrams_sent": st["sent"],
            "txns": st["n"], "send_s": st["t_done"] - st["t_send0"],
        })
    return out


def _quic_child(server_addr, txns_per_client, seed, q):
    """quic_send in a spawned child; its report (or its error) on `q`."""
    try:
        q.put(("ok", quic_send(server_addr, txns_per_client, seed=seed)))
    except BaseException as e:  # noqa: BLE001 — handed to the parent
        q.put(("error", repr(e)))


class WireTraffic:
    """The wire front's senders: the legacy transactions (one datagram each,
    in order) through a UdpBlaster at the net tile's legacy port, and the
    QUIC transactions split over n_clients QUIC connections (quic_send) in
    a spawned child, where their numpy AES-GCM and handshakes take no GIL
    from the tiles of this process.

    start(addrs, rcvbuf) begins sending: the blaster's window is rcvbuf
    (the net tile's granted SO_RCVBUF) // TRUESIZE less one burst of
    BLAST_BURST, so the
    datagrams in flight never outgrow the socket's buffer; poll(landed)
    feeds the blaster the legacy txns the QUIC tile has taken in (its
    rx_txns_udp), which also bounds the net -> quic ring: the QUIC tile
    publishes only on loop iterations that leave it credits, which a full
    drain of its input does not.  finished() is True once every legacy
    datagram is sent and the QUIC clients reported; it raises what failed
    the clients.  close() stops both."""

    def __init__(self, legacy: list, quic: list, *, n_clients: int = 4, seed: int = 0):
        self.legacy, self.seed = list(legacy), seed
        self.per_client = ([list(quic[i::n_clients]) for i in range(n_clients)]
                           if quic else [])
        self.txns = len(self.legacy) + len(quic)
        self.window = self.rcvbuf = None
        self.blaster = self._child = self._q = None
        self.clients: list[dict] = []

    def start(self, addrs: dict, rcvbuf: int) -> None:
        import multiprocessing as mp

        self.rcvbuf = rcvbuf
        self.window = max(rcvbuf // TRUESIZE - BLAST_BURST, 1)
        if self.per_client:
            ctx = mp.get_context("spawn")
            self._q = ctx.Queue()
            self._child = ctx.Process(
                target=_quic_child, daemon=True,
                args=(addrs["quic"], self.per_client, self.seed, self._q))
            self._child.start()
        self.blaster = UdpBlaster(self.legacy, addrs["udp"], burst=BLAST_BURST,
                                  window=self.window).start()

    def poll(self, landed: int) -> None:
        if self.blaster is not None:
            self.blaster.landed = landed

    def finished(self) -> bool:
        if self._child is not None and not self.clients:
            if self._q.empty():
                if self._child.exitcode is not None:
                    raise RuntimeError(f"QUIC client process exited "
                                       f"{self._child.exitcode} without a report")
                return False
            status, out = self._q.get()
            if status != "ok":
                raise RuntimeError(f"QUIC clients failed: {out}")
            self.clients = out
        return self.blaster is not None and self.blaster.done

    @property
    def dgrams_sent(self) -> dict:
        """Datagrams sent so far: legacy (live), QUIC (once reported)."""
        return {"legacy": self.blaster.sent if self.blaster else 0,
                "quic": sum(c["dgrams_sent"] for c in self.clients)}

    def report(self) -> dict:
        cl = self.clients
        send_s = max((c["send_s"] for c in cl), default=0.0)
        return {
            "dgrams_sent": self.dgrams_sent,
            "window": self.window, "rcvbuf": self.rcvbuf, "truesize": TRUESIZE,
            "quic_clients": cl,
            "handshake_ms": [c["handshake_ms"] for c in cl],
            "quic_txns_per_s": sum(c["txns"] for c in cl) / send_s if send_s else None,
        }

    def close(self) -> None:
        if self.blaster is not None:
            self.blaster.stop()
        if self._child is not None:
            # drain the queue before the join: a child whose report is still
            # in the pipe cannot exit
            while not self._q.empty():
                self._q.get()
            self._child.join(timeout=10.0)
            if self._child.is_alive():
                self._child.terminate()
                self._child.join(timeout=10.0)
