"""IP routing + ARP resolution for the network edge.

A copy of firedancer_tpu/waltz/ip.py.

Reference model: src/waltz/ip/fd_ip.c + fd_netlink.c — because the
reference's XDP path bypasses the kernel's egress stack, it must pick
the next hop itself: it mirrors the kernel routing table and ARP cache
(via netlink), does longest-prefix-match per destination, and probes
unresolved neighbors.

This build's ingress rides UDP sockets (the kernel routes egress), so
the module's role is the DECISION logic + observability the reference
exposes: a routing table with longest-prefix match, an ARP/neighbor
cache with entry states, and a `route()` query that returns (interface,
next hop, source hint).  Tables load from the same ground truth the
kernel holds — /proc/net/route and /proc/net/arp (no netlink socket
needed for read-only mirrors) — or from explicit entries in tests.
"""

from __future__ import annotations

import socket
import struct
from dataclasses import dataclass, field

#: neighbor entry states (reference fd_ip_enum.h semantics)
ARP_INCOMPLETE = 0
ARP_REACHABLE = 1
ARP_STALE = 2


def ip_to_int(s: str) -> int:
    return struct.unpack(">I", socket.inet_aton(s))[0]


def int_to_ip(v: int) -> str:
    return socket.inet_ntoa(struct.pack(">I", v))


@dataclass(frozen=True)
class RouteEntry:
    dst: int          # network byte-order value as host int
    mask: int
    gateway: int      # 0 = directly connected
    ifname: str
    metric: int = 0

    @property
    def prefix_len(self) -> int:
        return bin(self.mask).count("1")


@dataclass
class ArpEntry:
    ip: int
    mac: bytes
    ifname: str
    state: int = ARP_REACHABLE


@dataclass
class IpStack:
    """Mirrored routing + neighbor tables with the reference's query
    surface (fd_ip_route_ip_addr / fd_ip_arp_query behavior)."""

    routes: list[RouteEntry] = field(default_factory=list)
    arp: dict[int, ArpEntry] = field(default_factory=dict)
    #: IPs a caller asked for that had no neighbor entry — the reference
    #: sends an ARP probe; socket substrates let the kernel do it, but
    #: the pending set is surfaced for observability/tests
    probes_pending: set = field(default_factory=set)

    # ---- table loading ---------------------------------------------------

    @classmethod
    def from_proc(cls, route_path: str = "/proc/net/route",
                  arp_path: str = "/proc/net/arp") -> "IpStack":
        st = cls()
        try:
            with open(route_path) as f:
                lines = f.read().splitlines()[1:]
        except OSError:
            lines = []
        for ln in lines:
            parts = ln.split()
            if len(parts) < 8:
                continue
            # /proc/net/route stores little-endian hex of the BE value
            dst = socket.ntohl(int(parts[1], 16))
            gw = socket.ntohl(int(parts[2], 16))
            mask = socket.ntohl(int(parts[7], 16))
            metric = int(parts[6]) if parts[6].isdigit() else 0
            st.routes.append(RouteEntry(dst, mask, gw, parts[0], metric))
        try:
            with open(arp_path) as f:
                lines = f.read().splitlines()[1:]
        except OSError:
            lines = []
        for ln in lines:
            parts = ln.split()
            if len(parts) < 6:
                continue
            ip = ip_to_int(parts[0])
            flags = int(parts[2], 16)
            mac = bytes(int(x, 16) for x in parts[3].split(":"))
            state = ARP_REACHABLE if flags & 0x2 else ARP_INCOMPLETE
            st.arp[ip] = ArpEntry(ip, mac, parts[5], state)
        st.routes.sort(key=lambda r: (-r.prefix_len, r.metric))
        return st

    def add_route(self, cidr: str, gateway: str | None, ifname: str,
                  metric: int = 0) -> None:
        net, _, plen = cidr.partition("/")
        plen = int(plen or 32)
        mask = (0xFFFFFFFF << (32 - plen)) & 0xFFFFFFFF if plen else 0
        self.routes.append(RouteEntry(
            ip_to_int(net) & mask, mask,
            ip_to_int(gateway) if gateway else 0, ifname, metric,
        ))
        self.routes.sort(key=lambda r: (-r.prefix_len, r.metric))

    def add_neighbor(self, ip: str, mac: bytes, ifname: str,
                     state: int = ARP_REACHABLE) -> None:
        v = ip_to_int(ip)
        self.arp[v] = ArpEntry(v, mac, ifname, state)

    # ---- queries ---------------------------------------------------------

    def lookup_route(self, dst: str) -> RouteEntry | None:
        """Longest-prefix match, lowest metric first (routes are kept
        sorted that way)."""
        v = ip_to_int(dst)
        for r in self.routes:
            if (v & r.mask) == r.dst:
                return r
        return None

    def next_hop(self, dst: str) -> tuple[str, str] | None:
        """-> (ifname, next-hop ip): the gateway for off-link routes,
        the destination itself when directly connected."""
        r = self.lookup_route(dst)
        if r is None:
            return None
        hop = int_to_ip(r.gateway) if r.gateway else dst
        return r.ifname, hop

    def route(self, dst: str):
        """Full egress decision (fd_ip_route_ip_addr shape):
        -> (ifname, next_hop_ip, mac | None).  A missing neighbor entry
        (or a stale one) records a pending probe and returns mac None —
        the caller falls back to kernel sockets (this substrate) or
        probes (the reference's XDP path)."""
        hit = self.next_hop(dst)
        if hit is None:
            return None
        ifname, hop = hit
        e = self.arp.get(ip_to_int(hop))
        if e is None or e.state != ARP_REACHABLE:
            self.probes_pending.add(ip_to_int(hop))
            return ifname, hop, None
        return ifname, hop, e.mac
