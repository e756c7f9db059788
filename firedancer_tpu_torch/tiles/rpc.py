"""RPC tile: JSON-RPC 2.0 over HTTP for observers and tooling.

A copy of firedancer_tpu/tiles/rpc.py.

Reference model: the fddev `bencho` tile observes landed TPS through the
validator's JSON-RPC endpoint, and src/ballet/json vendors a parser for
that client path.  This build serves the observer surface natively:
getTransactionCount / getSlot / getHealth / getVersion / getBalance /
getIdentity over ballet.http (the JSON codec is the host stdlib — the
analog of the reference vendoring a C parser).

Data sources are callables so the tile composes with any topology:
txn_count (e.g. a bank tile's executed_txns counter via the metrics
registry), slot (the poh tile), and an optional funk for balances.
"""

from __future__ import annotations

import json

from ..ballet import base58
from ..ballet.http import HttpServer
from ..disco.metrics import MetricsSchema
from ..disco.mux import MuxCtx, Tile

VERSION = "firedancer-tpu/0.3"


class RpcTile(Tile):
    name = "rpc"
    schema = MetricsSchema(counters=("requests", "bad_requests"))
    #: observer tile: its counter/slot callables close over parent-side
    #: topology state — stays a parent THREAD under the process runtime
    proc_safe = False

    def __init__(
        self,
        *,
        txn_count=None,
        slot=None,
        funk=None,
        identity: bytes | None = None,
        addr=("127.0.0.1", 0),
    ):
        self._txn_count = txn_count or (lambda: 0)
        self._slot = slot or (lambda: 0)
        self._funk = funk
        self._identity = identity
        self._addr_req = addr
        self.server: HttpServer | None = None
        self._ctx: MuxCtx | None = None

    @property
    def addr(self):
        return self.server.addr

    def _dispatch(self, method: str, params: list):
        if method == "getTransactionCount":
            return int(self._txn_count())
        if method == "getSlot":
            return int(self._slot())
        if method == "getHealth":
            return "ok"
        if method == "getVersion":
            return {"solana-core": VERSION}
        if method == "getIdentity":
            if self._identity is None:
                raise ValueError("no identity configured")
            return {"identity": base58.encode_32(self._identity)}
        if method == "getBalance":
            if self._funk is None:
                raise ValueError("no account store attached")
            from ..flamenco.accounts import AccountMgr

            key = base58.decode_32(params[0])
            if key is None:
                raise ValueError("bad pubkey")
            return {
                "context": {"slot": int(self._slot())},
                "value": AccountMgr(self._funk).lamports(key),
            }
        raise LookupError(method)

    def _handle(self, req):
        if req.method != "POST":
            return 404, b"POST json-rpc only\n", "text/plain"
        self._ctx.metrics.inc("requests")
        try:
            body = json.loads(req.body)
            method = body["method"]
            params = body.get("params", [])
            rid = body.get("id")
        except (ValueError, KeyError, TypeError):
            self._ctx.metrics.inc("bad_requests")
            return 200, json.dumps(
                {"jsonrpc": "2.0", "id": None,
                 "error": {"code": -32700, "message": "parse error"}}
            ).encode(), "application/json"
        try:
            result = self._dispatch(method, params)
            resp = {"jsonrpc": "2.0", "id": rid, "result": result}
        except LookupError:
            resp = {"jsonrpc": "2.0", "id": rid,
                    "error": {"code": -32601, "message": "method not found"}}
        except Exception as e:  # noqa: BLE001 — rpc boundary
            resp = {"jsonrpc": "2.0", "id": rid,
                    "error": {"code": -32602, "message": str(e)}}
        return 200, json.dumps(resp).encode(), "application/json"

    def on_boot(self, ctx: MuxCtx) -> None:
        self._ctx = ctx
        self.server = HttpServer(self._handle, self._addr_req)

    def on_halt(self, ctx: MuxCtx) -> None:
        if self.server is not None:
            self.server.close()


def rpc_call(addr: tuple[str, int], method: str, params=None, rid=1):
    """Tiny JSON-RPC client (the bencho observer's request shape)."""
    import socket

    from ..ballet.http import build_response  # noqa: F401
    from ..ballet.http import parse_response

    body = json.dumps(
        {"jsonrpc": "2.0", "id": rid, "method": method,
         "params": params or []}
    ).encode()
    req = (
        f"POST / HTTP/1.1\r\nHost: {addr[0]}\r\n"
        f"Content-Type: application/json\r\n"
        f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
    ).encode() + body
    with socket.create_connection(addr, timeout=5.0) as s:
        s.sendall(req)
        data = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
    _status, _h, resp = parse_response(data)
    return json.loads(resp)
