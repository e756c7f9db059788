"""Metric tile: Prometheus scrape endpoint over every tile's metrics.

A copy of firedancer_tpu/tiles/metric.py.

Reference model: src/app/fdctl/run/tiles/fd_metric.c — an HTTP server
reading all tiles' metrics shared memory and rendering the Prometheus
text exposition format.  This build reads the SAME schema the monitor
consumes (the topology's published manifest / in-process registry) and
serves it via ballet.http.

Naming: fdt_<tile>_<metric>[_total] for counters;
fdt_<tile>_<metric>_bucket{le="2^k"} / _sum / _count for the 16-bucket
power-of-two histograms (disco/metrics.py layout).
"""

from __future__ import annotations

from ..ballet.http import HttpServer
from ..disco.metrics import Metrics, MetricsSchema
from ..disco.mux import MuxCtx, Tile


def render_prometheus(tiles: dict[str, Metrics]) -> bytes:
    """Prometheus text format over {tile name: Metrics}."""
    out = []
    for tile, m in sorted(tiles.items()):
        for c in m.schema.counters:
            out.append(f"# TYPE fdt_{tile}_{c} counter")
            out.append(f"fdt_{tile}_{c} {m.counter(c)}")
        for hname in m.schema.hists:
            h = m.hist(hname)
            out.append(f"# TYPE fdt_{tile}_{hname} histogram")
            cum = 0
            # width-agnostic: wide hists (sched_lag_us-class) carry
            # more than HIST_BUCKETS buckets
            for b in range(len(h["buckets"])):
                cum += h["buckets"][b]
                le = (1 << (b + 1)) - 1
                out.append(
                    f'fdt_{tile}_{hname}_bucket{{le="{le}"}} {cum}'
                )
            out.append(
                f'fdt_{tile}_{hname}_bucket{{le="+Inf"}} {h["count"]}'
            )
            out.append(f"fdt_{tile}_{hname}_sum {h['sum']}")
            out.append(f"fdt_{tile}_{hname}_count {h['count']}")
    return ("\n".join(out) + "\n").encode()


class MetricTile(Tile):
    """Serves /metrics over HTTP.  Reads either the in-process topology
    registry (registry=dict of name->Metrics) or a named workspace
    manifest (wksp_name=..., the cross-process monitor path).  The named
    workspace is attached once, at the first scrape, and closed at halt
    (JAX's tile attaches it again at every scrape and never closes it:
    ROADMAP C-6)."""

    name = "metric"
    schema = MetricsSchema(counters=("scrapes", "bad_requests"))
    #: observer tile: closes over the topology's registry callable, so
    #: it stays a parent THREAD under the process runtime (it only
    #: reads shared memory — no isolation is lost)
    proc_safe = False

    def __init__(
        self,
        *,
        registry: dict[str, Metrics] | None = None,
        wksp_name: str | None = None,
        addr=("127.0.0.1", 0),
    ):
        assert (registry is None) != (wksp_name is None), (
            "exactly one of registry / wksp_name"
        )
        self._registry = registry
        self._wksp_name = wksp_name
        self._addr_req = addr
        self.server: HttpServer | None = None
        self._ctx: MuxCtx | None = None
        self._mon = None

    @property
    def addr(self):
        return self.server.addr

    def _tiles(self) -> dict[str, Metrics]:
        if self._registry is not None:
            # in-process: a dict or a callable returning one (a Topology
            # binds its registry only after build(), so tiles constructed
            # earlier pass `topo.metrics_registry`)
            r = self._registry
            return r() if callable(r) else r
        if self._mon is None:
            from ..app.monitor import Monitor

            self._mon = Monitor(self._wksp_name)
        return {name: tv.metrics for name, tv in self._mon.tiles.items()}

    def _handle(self, req):
        if req.path not in ("/metrics", "/"):
            return 404, b"not found\n", "text/plain"
        self._ctx.metrics.inc("scrapes")
        body = render_prometheus(self._tiles())
        return 200, body, "text/plain; version=0.0.4; charset=utf-8"

    def on_boot(self, ctx: MuxCtx) -> None:
        self._ctx = ctx
        self.server = HttpServer(self._handle, self._addr_req)

    def on_halt(self, ctx: MuxCtx) -> None:
        if self.server is not None:
            self.server.close()
        if self._mon is not None:
            self._mon.wksp.close()
            self._mon = None
