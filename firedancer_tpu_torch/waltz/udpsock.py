"""Batch UDP socket I/O — the aio backend of this build.

A copy of firedancer_tpu/waltz/udpsock.py.

Reference: src/waltz/udpsock/ (plain-socket aio fallback to
AF_XDP) and src/waltz/aio/fd_aio.h (the abstract packet-burst interface).
AF_XDP kernel bypass is not available in this environment, so the batch
recv/send loop over a nonblocking socket IS the aio layer; the tile API
mirrors the burst shape (list in, list out) so an XDP backend could slot
in behind the same calls.
"""

from __future__ import annotations

import socket


class UdpSock:
    """Nonblocking UDP socket with burst recv/send."""

    def __init__(self, bind_addr: tuple[str, int] | None = None):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setblocking(False)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 21)
        if bind_addr is not None:
            self.sock.bind(bind_addr)

    @property
    def addr(self) -> tuple[str, int]:
        return self.sock.getsockname()

    def recv_burst(self, max_pkts: int = 256, mtu: int = 2048):
        """Drain up to max_pkts datagrams; returns [(bytes, addr)]."""
        out = []
        for _ in range(max_pkts):
            try:
                data, addr = self.sock.recvfrom(mtu)
            except BlockingIOError:
                break
            out.append((data, addr))
        return out

    def send_burst(self, pkts) -> int:
        """Send [(bytes, addr)]; returns count sent (EAGAIN drops tail)."""
        n = 0
        for data, addr in pkts:
            try:
                self.sock.sendto(data, addr)
                n += 1
            except BlockingIOError:
                break
        return n

    def close(self) -> None:
        self.sock.close()
