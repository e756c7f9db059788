"""Net tile: the socket edge, decoupled from protocol tiles.

A copy of firedancer_tpu/tiles/net.py: the Python loop (on_frags for the
tx ring, after_credit for rx) and the native handler (fdt_net.c on the
port's stem: the tx body and the rx after-credit hook).

Reference model: src/app/fdctl/run/tiles/fd_net.c — the only tile
touching the NIC (AF_XDP there, UDP sockets here): rx datagrams route by
destination port onto per-protocol rings, and protocol tiles send by
publishing to the net tile's tx ring.  Datagram frags carry the peer
address as a 6-byte prefix (ip4 + port), so protocol tiles stay sans-IO.

Ring layout: outs[0] = rx ring (to the quic tile, QUIC port + legacy
port datagrams alike; the ctl field distinguishes: CTL_QUIC/CTL_LEGACY);
ins[0] = tx ring (addr-prefixed datagrams to put on the wire).

Native stem: both directions run as native stem
bodies (tango/native/fdt_net.c) — tx drains the ring with sendmmsg
iovecs pointing straight into the in dcache, rx recvmmsg-writes
addr-prefixed rows DIRECTLY into the out dcache as the after-credit
hook — one syscall per burst, zero Python per datagram at steady
state.  The egress route-classification metrics (the fd_ip mirror) ride
a native route cache: a destination not yet classified hands the frag
back to this file's Python loop, which does the IpStack lookup and
seeds the native cache (the bank-tile MISS -> resolve -> retry
pattern)."""

from __future__ import annotations

import socket
import struct

import numpy as np

from ..disco.metrics import MetricsSchema
from ..disco.mux import MuxCtx, Tile
from ..tango import rings as R
from ..waltz.udpsock import UdpSock

ADDR_SZ = 6
#: ctl tags for rx frags (which port the datagram arrived on)
CTL_QUIC = 8
CTL_LEGACY = 16

#: dcache MTU for net rings: addr prefix + a full UDP payload
NET_MTU = ADDR_SZ + 1500

#: native route-cache geometry: twice the Python dict's 4096-entry
#: bound so open addressing stays sparse
_RC_CAP = 8192


def addr_pack(addr: tuple[str, int]) -> bytes:
    return socket.inet_aton(addr[0]) + struct.pack("<H", addr[1])


def addr_unpack(b: bytes) -> tuple[str, int]:
    return socket.inet_ntoa(bytes(b[:4])), struct.unpack("<H", bytes(b[4:6]))[0]


class NetTile(Tile):
    """Owns the sockets; routes rx by port, drains the tx ring."""

    name = "net"
    schema = MetricsSchema(
        counters=("rx_dgrams", "tx_dgrams", "rx_bytes", "tx_bytes",
                  "oversize_drops", "tx_routed", "tx_unrouted"),
    )

    def __init__(
        self,
        *,
        quic_addr=("127.0.0.1", 0),
        udp_addr=("127.0.0.1", 0),
        burst: int = 256,
    ):
        self._quic_addr_req = quic_addr
        self._udp_addr_req = udp_addr
        self.burst = burst
        self.quic_sock: UdpSock | None = None
        self.udp_sock: UdpSock | None = None

    @property
    def quic_addr(self):
        return self.quic_sock.addr

    @property
    def udp_addr(self):
        return self.udp_sock.addr

    def on_boot(self, ctx: MuxCtx) -> None:
        self.quic_sock = UdpSock(self._quic_addr_req)
        self.udp_sock = UdpSock(self._udp_addr_req)
        # egress routing observability: mirror the host tables (the
        # reference's net tile consults fd_ip to pick the egress
        # interface/next hop for every tx, src/waltz/ip/fd_ip.c; with
        # kernel UDP sockets the kernel routes for real, so the mirror's
        # job is surfacing that decision in metrics)
        from ..waltz.ip import IpStack

        try:
            self._ip = IpStack.from_proc()
        except OSError:
            self._ip = IpStack()
        self._route_cache: dict[str, bool] = {}
        # native route cache + args block (host memory; the cache is a
        # metrics mirror, rebuilt from scratch on restart)
        self._nwords = np.zeros(8, np.int64)
        self._rc_keys = np.zeros(_RC_CAP, np.uint32)
        self._rc_vals = np.zeros(_RC_CAP, np.uint8)
        self._rx_szs = np.zeros(max(self.burst, 16), np.uint32)
        self._nargs = np.zeros(4, np.uint64)
        self._nargs[0] = self._nwords.ctypes.data
        self._nargs[1] = self._rc_keys.ctypes.data
        self._nargs[2] = self._rc_vals.ctypes.data
        self._nargs[3] = self._rx_szs.ctypes.data
        self._nwords[0] = self.quic_sock.sock.fileno()  # tx rides quic
        self._nwords[1] = self.quic_sock.sock.fileno()
        self._nwords[2] = self.udp_sock.sock.fileno()
        self._nwords[3] = self.burst
        self._nwords[4] = NET_MTU
        self._nwords[5] = _RC_CAP - 1

    def _route_classify(self, ip_str: str) -> bool:
        """IpStack lookup with the Python-side cache; seeds the native
        cache so the stem's next burst stays native (MISS -> resolve ->
        retry)."""
        hit = self._route_cache.get(ip_str)
        if hit is None:
            hit = self._ip.lookup_route(ip_str) is not None
            if len(self._route_cache) < 4096:
                self._route_cache[ip_str] = hit
                ip_u32 = struct.unpack(
                    "<I", socket.inet_aton(ip_str)
                )[0]
                R._lib.fdt_net_route_put(
                    self._nargs.ctypes.data, ip_u32, int(hit)
                )
        return hit

    def native_handler(self, ctx: MuxCtx):
        """Native fast path: fdt_net_tx (sendmmsg straight from the in
        dcache, route metrics off the native cache) plus fdt_net_rx as
        the after-credit hook (recvmmsg straight into the out dcache,
        credit-gated)."""
        if (
            len(ctx.outs) != 1
            or ctx.outs[0].dcache is None
            or any(il.dcache is None for il in ctx.ins)
        ):
            return None
        return R.StemSpec(
            R.STEM_H_NET, self._nargs,
            counters=("rx_dgrams", "tx_dgrams", "rx_bytes", "tx_bytes",
                      "oversize_drops", "tx_routed", "tx_unrouted"),
            keepalive=(self._nargs, self._nwords, self._rc_keys,
                       self._rc_vals, self._rx_szs),
            ac_handler=R.STEM_AC_NET,
            ac_args=self._nargs,
        )

    def on_halt(self, ctx: MuxCtx) -> None:
        for s in (self.quic_sock, self.udp_sock):
            if s is not None:
                s.close()

    def on_frags(self, ctx: MuxCtx, in_idx: int, frags: np.ndarray) -> None:
        """tx ring: addr-prefixed datagrams out the QUIC socket."""
        il = ctx.ins[in_idx]
        rows = il.gather(frags)
        pkts = []
        for i in range(len(rows)):
            row = rows[i, : frags["sz"][i]]
            pkts.append((row[ADDR_SZ:].tobytes(), addr_unpack(row[:ADDR_SZ])))
        n = self.quic_sock.send_burst(pkts)
        # route classification covers only packets actually SENT, so
        # tx_routed + tx_unrouted == tx_dgrams holds across partial
        # bursts (EAGAIN drops)
        routed = unrouted = 0
        for _, addr in pkts[:n]:
            hit = self._route_classify(addr[0])
            routed += hit
            unrouted += not hit
        if routed:
            ctx.metrics.inc("tx_routed", routed)
        if unrouted:
            ctx.metrics.inc("tx_unrouted", unrouted)
        ctx.metrics.inc("tx_dgrams", n)
        ctx.metrics.inc("tx_bytes", int(frags["sz"].sum()) - ADDR_SZ * len(rows))

    def after_credit(self, ctx: MuxCtx) -> None:
        budget = ctx.credits
        if budget <= 0:
            return
        rows_l, szs_l, ctls_l = [], [], []
        for sock, ctl in ((self.quic_sock, CTL_QUIC), (self.udp_sock, CTL_LEGACY)):
            # the budget is shared across both sockets: the combined
            # publish must stay within the iteration's credits
            take = min(self.burst, budget - len(rows_l))
            if take <= 0:
                break
            for data, addr in sock.recv_burst(take):
                if len(data) > NET_MTU - ADDR_SZ:
                    ctx.metrics.inc("oversize_drops")
                    continue
                payload = addr_pack(addr) + data
                row = np.zeros(NET_MTU, np.uint8)
                row[: len(payload)] = np.frombuffer(payload, np.uint8)
                rows_l.append(row)
                szs_l.append(len(payload))
                ctls_l.append(ctl | 3)  # SOM|EOM
        if not rows_l:
            return
        n = len(rows_l)
        ctx.metrics.inc("rx_dgrams", n)
        ctx.metrics.inc("rx_bytes", int(sum(szs_l)) - ADDR_SZ * n)
        ctx.publish(
            np.arange(n, dtype=np.uint64),
            np.stack(rows_l),
            np.asarray(szs_l, np.uint16),
            ctls=np.asarray(ctls_l, np.uint16),
        )
        ctx.credits -= n
