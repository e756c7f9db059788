"""pcap capture files: writer + reader for UDP packet corpora.

A copy of firedancer_tpu/waltz/pcap.py.

Reference: src/util/net/fd_pcap.c (+ fd_eth/ip4/udp header
structs) — deterministic replay of captured ingress is the reference's
reproducibility mechanism (src/disco/replay/fd_replay_tile.c).  Classic
libpcap format (magic 0xa1b2c3d4, LINKTYPE_ETHERNET), with synthesized
Ethernet/IPv4/UDP headers on write so corpora open in standard tools.
"""

from __future__ import annotations

import struct

MAGIC = 0xA1B2C3D4
LINKTYPE_ETHERNET = 1

_GHDR = struct.Struct("<IHHiIII")
_PHDR = struct.Struct("<IIII")
_ETH_IP_UDP = 14 + 20 + 8


def _udp_frame(payload: bytes, src_port: int, dst_port: int) -> bytes:
    eth = bytes(6) + bytes(6) + (0x0800).to_bytes(2, "big")
    total = 20 + 8 + len(payload)
    ip = struct.pack(
        ">BBHHHBBH4s4s",
        0x45, 0, total, 0, 0, 64, 17, 0,
        bytes([127, 0, 0, 1]), bytes([127, 0, 0, 1]),
    )
    udp = struct.pack(">HHHH", src_port, dst_port, 8 + len(payload), 0)
    return eth + ip + udp + payload


class PcapWriter:
    def __init__(self, path: str):
        self.f = open(path, "wb")
        self.f.write(
            _GHDR.pack(MAGIC, 2, 4, 0, 0, 65535, LINKTYPE_ETHERNET)
        )
        self._n = 0

    def write(self, payload: bytes, *, ts_us: int = 0,
              src_port: int = 9000, dst_port: int = 8001) -> None:
        frame = _udp_frame(payload, src_port, dst_port)
        self.f.write(
            _PHDR.pack(ts_us // 1_000_000, ts_us % 1_000_000,
                       len(frame), len(frame))
        )
        self.f.write(frame)
        self._n += 1

    def close(self) -> None:
        self.f.close()


def read_udp_payloads(path: str) -> list[tuple[int, bytes]]:
    """Parse a pcap; returns [(ts_us, udp_payload)] for every UDP/IPv4
    packet (non-UDP frames are skipped)."""
    out = []
    with open(path, "rb") as f:
        g = f.read(_GHDR.size)
        magic = struct.unpack_from("<I", g)[0]
        if magic != MAGIC:
            raise ValueError("not a (little-endian classic) pcap")
        while True:
            ph = f.read(_PHDR.size)
            if len(ph) < _PHDR.size:
                break
            sec, usec, incl, _orig = _PHDR.unpack(ph)
            frame = f.read(incl)
            if len(frame) < incl:
                raise ValueError("truncated pcap")
            if len(frame) < _ETH_IP_UDP:
                continue
            if frame[12:14] != b"\x08\x00":  # not IPv4
                continue
            ihl = (frame[14] & 0xF) * 4
            if frame[14 + 9] != 17:  # not UDP
                continue
            off = 14 + ihl + 8
            udp_len = int.from_bytes(
                frame[14 + ihl + 4 : 14 + ihl + 6], "big"
            )
            out.append((sec * 1_000_000 + usec, frame[off : 14 + ihl + udp_len]))
    return out
