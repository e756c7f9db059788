"""Minimal HTTP/1.1: sans-IO request/response codec + a tiny threaded
server and client.

A copy of firedancer_tpu/ballet/http.py.

Reference model: src/ballet/http/ (vendored picohttpparser serving the
metrics endpoint and downloading snapshots).  This build needs the same
two uses — the Prometheus metric tile (tiles/metric.py) and snapshot
transfer (flamenco/snapshot.py) — so the codec is written fresh and kept
deliberately small: request line + headers + content-length bodies, no
chunked encoding, no keep-alive pipelining beyond sequential reuse.
"""

from __future__ import annotations

import socket
import threading
from dataclasses import dataclass, field


@dataclass
class Request:
    method: str
    path: str
    version: str
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""


def parse_request(data: bytes) -> tuple[Request | None, int]:
    """(request, bytes consumed); (None, 0) if incomplete; raises
    ValueError on malformed input."""
    end = data.find(b"\r\n\r\n")
    if end < 0:
        if len(data) > 65536:
            raise ValueError("header block too large")
        return None, 0
    head = data[:end].decode("latin1")
    lines = head.split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/"):
        raise ValueError("bad request line")
    req = Request(parts[0], parts[1], parts[2])
    for ln in lines[1:]:
        if ":" not in ln:
            raise ValueError("bad header")
        k, v = ln.split(":", 1)
        req.headers[k.strip().lower()] = v.strip()
    n = int(req.headers.get("content-length", "0"))
    if n < 0 or n > 1 << 30:
        raise ValueError("bad content-length")
    total = end + 4 + n
    if len(data) < total:
        return None, 0
    req.body = data[end + 4 : total]
    return req, total


def build_response(
    status: int = 200,
    body: bytes = b"",
    content_type: str = "text/plain; charset=utf-8",
    headers: dict[str, str] | None = None,
) -> bytes:
    reason = {200: "OK", 404: "Not Found", 400: "Bad Request",
              500: "Internal Server Error"}.get(status, "OK")
    h = {
        "Content-Type": content_type,
        "Content-Length": str(len(body)),
        "Connection": "close",
    }
    h.update(headers or {})
    head = f"HTTP/1.1 {status} {reason}\r\n" + "".join(
        f"{k}: {v}\r\n" for k, v in h.items()
    )
    return head.encode("latin1") + b"\r\n" + body


def parse_response(data: bytes) -> tuple[int, dict[str, str], bytes]:
    """Full response bytes -> (status, headers, body)."""
    end = data.find(b"\r\n\r\n")
    if end < 0:
        raise ValueError("incomplete response")
    lines = data[:end].decode("latin1").split("\r\n")
    status = int(lines[0].split(" ")[1])
    headers = {}
    for ln in lines[1:]:
        k, v = ln.split(":", 1)
        headers[k.strip().lower()] = v.strip()
    return status, headers, data[end + 4 :]


class HttpServer:
    """Threaded one-request-per-connection server (the metric tile's
    scrape endpoint; scrape cadence makes keep-alive irrelevant)."""

    def __init__(self, handler, addr=("127.0.0.1", 0)):
        """handler(Request) -> (status, body, content_type)"""
        self.handler = handler
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(addr)
        self.sock.listen(16)
        self.addr = self.sock.getsockname()
        self._stop = False
        self.thread = threading.Thread(
            target=self._serve, name="http", daemon=True
        )
        self.thread.start()

    def _serve(self) -> None:
        while not self._stop:
            try:
                conn, _peer = self.sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._one, args=(conn,), daemon=True
            ).start()

    def _one(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(5.0)
            buf = b""
            while True:
                try:
                    req, consumed = parse_request(buf)
                except ValueError:
                    conn.sendall(build_response(400, b"bad request\n"))
                    return
                if req is not None:
                    break
                chunk = conn.recv(65536)
                if not chunk:
                    return
                buf += chunk
            try:
                status, body, ctype = self.handler(req)
            except Exception:
                status, body, ctype = 500, b"internal error\n", "text/plain"
            if isinstance(body, (bytes, bytearray)):
                conn.sendall(build_response(status, bytes(body), ctype))
            else:
                # streamed body (iterator of byte chunks): CHUNKED
                # framing, O(chunk) memory on both ends.  Close-framing
                # would make a mid-stream server failure look like a
                # clean EOF to the client; the terminal 0-chunk is what
                # lets get_stream distinguish truncation from success.
                reason = {200: "OK"}.get(status, "OK")
                conn.sendall(
                    (
                        f"HTTP/1.1 {status} {reason}\r\n"
                        f"Content-Type: {ctype}\r\n"
                        f"Transfer-Encoding: chunked\r\n"
                        f"Connection: close\r\n\r\n"
                    ).encode("latin1")
                )
                for chunk in body:
                    if chunk:
                        conn.sendall(
                            f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n"
                        )
                conn.sendall(b"0\r\n\r\n")
        except OSError:
            pass
        finally:
            conn.close()

    def close(self) -> None:
        self._stop = True
        try:
            self.sock.close()
        except OSError:
            pass


def get(addr: tuple[str, int], path: str, timeout: float = 5.0) -> tuple[int, bytes]:
    """Tiny client: GET path -> (status, body)."""
    with socket.create_connection(addr, timeout=timeout) as s:
        s.sendall(
            f"GET {path} HTTP/1.1\r\nHost: {addr[0]}\r\n"
            f"Connection: close\r\n\r\n".encode()
        )
        data = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
    status, _h, body = parse_response(data)
    return status, body


def get_stream(addr: tuple[str, int], path: str, sink,
               timeout: float = 30.0) -> tuple[int, int]:
    """Streaming GET: body chunks go to sink(bytes) as they arrive —
    O(chunk) client memory (the snapshot download path; reference:
    fd_snapshot_http.c's incremental read state machine).  Returns
    (status, body_bytes)."""
    with socket.create_connection(addr, timeout=timeout) as s:
        s.sendall(
            f"GET {path} HTTP/1.1\r\nHost: {addr[0]}\r\n"
            f"Connection: close\r\n\r\n".encode()
        )
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = s.recv(65536)
            if not chunk:
                raise ValueError("connection closed before headers")
            buf += chunk
        head, rest = buf.split(b"\r\n\r\n", 1)
        lines = head.decode("latin1").split("\r\n")
        status = int(lines[0].split(" ")[1])
        headers = {}
        for ln in lines[1:]:
            k, v = ln.split(":", 1)
            headers[k.strip().lower()] = v.strip()
        if headers.get("transfer-encoding", "").lower() == "chunked":
            return status, _read_chunked(s, rest, sink)
        want = int(headers["content-length"]) if "content-length" in headers else None
        n = 0
        if rest:
            sink(rest)
            n += len(rest)
        while want is None or n < want:
            chunk = s.recv(262144)
            if not chunk:
                break
            sink(chunk)
            n += len(chunk)
        if want is not None and n != want:
            raise ValueError("short body")
        # want is None: close-framed legacy body — length UNVERIFIED
        # (our own streamed responses are chunked; only foreign servers
        # reach this path)
        return status, n


def _read_chunked(s, buf: bytes, sink) -> int:
    """Decode a chunked body; raises on truncation (the framing is what
    makes a mid-stream peer death detectable — the terminal 0-chunk
    never arrives)."""
    buf = bytearray(buf)
    n = 0

    def fill() -> None:
        blk = s.recv(262144)
        if not blk:
            raise ValueError("connection closed mid-chunk")
        buf.extend(blk)

    while True:
        while b"\r\n" not in buf:
            fill()
        line, _, rest = bytes(buf).partition(b"\r\n")
        buf = bytearray(rest)
        size = int(line.split(b";")[0], 16)
        while len(buf) < size + 2:
            fill()
        if size == 0:
            return n
        sink(bytes(buf[:size]))
        n += size
        if buf[size : size + 2] != b"\r\n":
            raise ValueError("bad chunk terminator")
        del buf[: size + 2]
