"""Declarative topology: links + tiles + workspace layout + a thread runner.

The thread runtime of firedancer_tpu/disco/topo.py (`Topology`,
`device_assignments`): one thread per tile in one interpreter, the shape
the reference's own tests use (src/disco/dedup/test_dedup.c:654-660),
with either data-plane inner loop (`stem="python"`, the default, or
`"native"`: the tiles that register a native handler run the GIL-released
fdt_stem burst loop).  The mode is an explicit argument only: the JAX
package's FDT_STEM environment switch is not carried.  A named topology
publishes its workspace directory and a monitor manifest once every tile
is in RUN (`export_manifest`), so app/monitor.py and the metric tile can
attach to it by name.
Not ported yet, and refused rather than ignored: the process runtime
(`runtime="process"`), the supervisor, elastic shards,
the version handshake and hot upgrade, the flight recorder, the run-loop
profiler and asserted SLOs.

Reference model: src/disco/topo/fd_topo.h:28-230 (fd_topo_t = wksps,
links, tiles, objs; built by fd_topob_*) and fd_topo_run.c (join
workspaces → init → run loop).  Fail-stop supervision mirrors
run/run.c:264-270: any tile failure halts the whole topology.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field

from ..tango import rings as R
from .metrics import Metrics, MetricsSchema
from .mux import InLink, MuxCtx, OutLink, Tile, link_hist_names, run_loop
from .trace import SpanRing, TraceConfig, Tracer

_LOG = logging.getLogger(__name__)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: the port's topology is the thread "
        f"runtime"
    )


def device_assignments(spec, n_tiles: int) -> list[list[int]]:
    """Partition a `verify_devices` spec (auto | N | [ordinals]) across
    n_tiles seq-sharded verify replicas.

    Each replica gets a DISJOINT device-ordinal list so two workers
    never contend for one card (the reference pins each wiredancer lane
    to one FPGA slot for the same reason).  With fewer devices than
    replicas the devices are shared round-robin — valid, just contended.
    "auto" counts the local CUDA cards (utils/devices.local_device_count,
    1 on a host without one)."""
    assert n_tiles >= 1
    if spec in (None, 1, "off"):
        return [[0] for _ in range(n_tiles)]
    if spec == "auto":
        from ..utils.devices import local_device_count

        indices = list(range(local_device_count()))
    elif isinstance(spec, int):
        indices = list(range(max(spec, 1)))
    else:
        indices = [int(d) for d in spec] or [0]
    if len(indices) < n_tiles:
        return [[indices[i % len(indices)]] for i in range(n_tiles)]
    return [indices[i::n_tiles] for i in range(n_tiles)]


@dataclass
class LinkSpec:
    name: str
    depth: int
    mtu: int = 0  # 0 = metadata-only link (no dcache)
    producer: str | None = None
    consumers: list[tuple[str, bool]] = field(default_factory=list)


@dataclass
class TileSpec:
    tile: Tile
    ins: list[tuple[str, bool]]  # (link name, reliable)
    outs: list[str]
    ctx: MuxCtx | None = None
    thread: threading.Thread | None = None
    error: BaseException | None = None


class Topology:
    """Build links and tiles, then run them on threads.

    Usage:
        topo = Topology()
        topo.link("synth_verify", depth=1024, mtu=1280)
        topo.tile(SynthTile(...), outs=["synth_verify"])
        topo.tile(VerifyTile(...), ins=[("synth_verify", True)], outs=[...])
        topo.start(); ...; topo.halt(); topo.close()
    """

    def __init__(
        self,
        name: str | None = None,
        trace: TraceConfig | None = None,
        runtime: str | None = None,
        stem: str | None = None,
    ):
        if runtime not in (None, "thread"):
            raise _not_ported(f"runtime={runtime!r}")
        #: data-plane inner loop: "python" | "native" | None (= "python").
        #: "native" lets tiles with a registered native handler
        #: (Tile.native_handler) run their drain→handle→publish cycle in
        #: one GIL-released fdt_stem call per burst; tiles without one
        #: keep the Python loop either way.
        self.stem = stem
        self._resolve_stem()
        #: None: an anonymous (numpy) workspace; a name: a /dev/shm file
        #: under the port's own prefix (tango.rings.SHM_PREFIX)
        self.name = name
        self.links: dict[str, LinkSpec] = {}
        self.tiles: dict[str, TileSpec] = {}
        self.wksp: R.Workspace | None = None
        # sample <= 0 means OFF (TraceConfig contract)
        self.trace = trace if trace is not None and trace.sample > 0 else None
        self._loop_kw: dict = {}
        self._mcaches: dict[str, R.MCache] = {}
        self._dcaches: dict[str, R.DCache] = {}
        self._fseqs: dict[tuple[str, str], R.FSeq] = {}
        self._cncs: dict[str, R.CNC] = {}
        self._metrics: dict[str, Metrics] = {}
        self._tracers: dict[str, Tracer] = {}

    def enable_trace(self, sample: int = 64, depth: int = 1 << 14) -> None:
        """Turn on span rings for every tile (must run before build()).
        sample <= 0 disables — no tracer is installed and the hot path
        pays only the per-phase None checks."""
        assert self.wksp is None, "enable_trace before build()"
        self.trace = (
            TraceConfig(sample=sample, depth=depth) if sample > 0 else None
        )

    def enable_profile(self, on: bool = True) -> None:
        raise _not_ported("the run-loop profiler")

    def enable_flight(self, depth: int = 64, timeline_n: int = 256) -> None:
        raise _not_ported("the flight recorder")

    def declare_shards(self, kind: str, members: list[str], **kw) -> None:
        raise _not_ported("elastic shard groups")

    # ---- declaration ----------------------------------------------------

    def link(self, name: str, depth: int, mtu: int = 0) -> None:
        assert name not in self.links, f"duplicate link {name!r}"
        self.links[name] = LinkSpec(name, depth, mtu)

    def tile(
        self,
        tile: Tile,
        ins: list[tuple[str, bool]] | None = None,
        outs: list[str] | None = None,
    ) -> None:
        name = tile.name
        assert name not in self.tiles, f"duplicate tile {name!r}"
        ins = list(ins or [])
        outs = list(outs or [])
        for ln, reliable in ins:
            self.links[ln].consumers.append((name, reliable))
        for ln in outs:
            spec = self.links[ln]
            assert spec.producer is None, f"link {ln!r} has two producers"
            spec.producer = name
        self.tiles[name] = TileSpec(tile, ins, outs)

    # ---- build ----------------------------------------------------------

    def _resolve_stem(self, mode: str | None = None) -> str:
        sm = mode or self.stem or "python"
        if sm not in ("python", "native"):
            raise ValueError(
                f"unknown stem mode {sm!r} (python|native; from "
                f"start(stem=) or Topology(stem=))"
            )
        return sm

    def _tile_schema(self, ts: TileSpec) -> MetricsSchema:
        """The tile's own schema + base + the per-in-link latency
        attribution hists (qwait/svc/e2e per consumed link) the run loop
        records.  The link hists are wide (metrics.WIDE_HIST_BUCKETS), so
        a latency past 2^16 µs stays representable."""
        base = ts.tile.schema.with_base()
        link_hists = tuple(
            h for ln, _rel in ts.ins for h in link_hist_names(ln)
        )
        return MetricsSchema(
            base.counters, base.hists + link_hists,
            wide_hists=base.wide_hists + link_hists,
        )

    def _shared_regions(self) -> dict[str, int]:
        """Topology-wide shared regions declared by tiles
        (Tile.shared_wksp_footprints): {name: footprint}.  Tiles naming
        the same region must agree on its size."""
        shared: dict[str, int] = {}
        for name, ts in self.tiles.items():
            for nm, fp in ts.tile.shared_wksp_footprints().items():
                if nm in shared and shared[nm] != fp:
                    raise ValueError(
                        f"shared region {nm!r}: tile {name!r} declares "
                        f"footprint {fp} but another tile declared "
                        f"{shared[nm]}"
                    )
                shared[nm] = fp
        return shared

    def _footprint(self) -> int:
        total = 4096
        for fp in self._shared_regions().values():
            total += fp + 256
        for ls in self.links.values():
            total += R.MCache.footprint(ls.depth) + 256
            if ls.mtu:
                total += R.DCache.footprint(ls.mtu, ls.depth) + 256
            total += (R.FSeq.footprint() + 128) * max(len(ls.consumers), 1)
        for ts in self.tiles.values():
            total += R.CNC.footprint() + 128
            total += Metrics.footprint(self._tile_schema(ts)) + 256
            total += ts.tile.wksp_footprint() + 256
            if self.trace is not None:
                total += SpanRing.footprint(self.trace.depth) + 256
        return total

    def build(self, runtime: str | None = None) -> None:
        assert self.wksp is None, "already built"
        if runtime not in (None, "thread"):
            raise _not_ported(f"runtime={runtime!r}")
        self.wksp = R.Workspace(self._footprint(), name=self.name)
        # topology-wide shared regions, once each (MuxCtx.shared resolves
        # them by name)
        for nm, fp in sorted(self._shared_regions().items()):
            self.wksp.alloc(f"shared_{nm}", fp)
        for ls in self.links.values():
            self._mcaches[ls.name] = R.MCache.create(
                self.wksp, f"mc_{ls.name}", ls.depth
            )
            if ls.mtu:
                self._dcaches[ls.name] = R.DCache.create(
                    self.wksp, f"dc_{ls.name}", ls.mtu, ls.depth
                )
            for cons, _rel in ls.consumers:
                self._fseqs[(ls.name, cons)] = R.FSeq.create(
                    self.wksp, f"fs_{ls.name}_{cons}"
                )
        # link ids: declaration-order small ints, shared with the span
        # events (u8 field)
        link_ids = {ln: i for i, ln in enumerate(self.links)}
        assert len(link_ids) <= 256, "span events carry a u8 link id"
        for name, ts in self.tiles.items():
            self._cncs[name] = R.CNC.create(self.wksp, f"cnc_{name}")
            schema = self._tile_schema(ts)
            mem = self.wksp.alloc(f"metrics_{name}", Metrics.footprint(schema))
            self._metrics[name] = Metrics(mem, schema)
            if self.trace is not None:
                ring = SpanRing(
                    self.wksp.alloc(
                        f"trace_{name}", SpanRing.footprint(self.trace.depth)
                    ),
                    self.trace.depth,
                    self.trace.sample,
                )
                self._tracers[name] = Tracer(ring, self.trace.sample, name=name)
        for name, ts in self.tiles.items():
            tracer = self._tracers.get(name)
            ins = [
                InLink(
                    ln,
                    self._mcaches[ln],
                    self._dcaches.get(ln),
                    self._fseqs[(ln, name)],
                    reliable,
                    link_id=link_ids[ln],
                    h_qwait=f"qwait_us_{ln}",
                    h_svc=f"svc_us_{ln}",
                    h_e2e=f"e2e_us_{ln}",
                )
                for ln, reliable in ts.ins
            ]
            outs = [
                OutLink(
                    ln,
                    self._mcaches[ln],
                    self._dcaches.get(ln),
                    [
                        self._fseqs[(ln, cons)]
                        for cons, rel in self.links[ln].consumers
                        if rel
                    ],
                    link_id=link_ids[ln],
                    tracer=tracer,
                )
                for ln in ts.outs
            ]
            ts.ctx = MuxCtx(
                name, self._cncs[name], ins, outs, self._metrics[name],
                wksp=self.wksp,
            )
            ts.ctx.tracer = tracer

    # ---- run ------------------------------------------------------------

    def _tile_main(self, ts: TileSpec, loop_kw: dict) -> None:
        try:
            run_loop(ts.tile, ts.ctx, **loop_kw)
        except BaseException as e:  # noqa: BLE001 — fail-stop supervision
            _LOG.error("tile %s failed: %r", ts.ctx.name, e, exc_info=True)
            ts.error = e

    def start(
        self,
        boot_timeout_s: float = 600.0,
        mode: str | None = None,
        **loop_kw,
    ) -> None:
        """Spawn one thread per tile and wait for every tile to reach RUN.
        A tile that fails during on_boot (bad config, no card) halts the
        topology and its error is raised here.  loop_kw goes to run_loop
        (batch_max, lazy_ns, ...); its `stem` (python|native) overrides
        Topology(stem=)."""
        if mode not in (None, "thread"):
            raise _not_ported(f"mode={mode!r}")
        if self.wksp is None:
            self.build()
        self._loop_kw = dict(loop_kw)
        # the stem mode rides the loop kwargs, so every tile runs the
        # same inner loop
        self._loop_kw["stem"] = self._resolve_stem(loop_kw.get("stem"))
        for ts in self.tiles.values():
            t = threading.Thread(
                target=self._tile_main,
                args=(ts, self._loop_kw),
                name=f"tile:{ts.tile.name}",
                daemon=True,
            )
            ts.thread = t
            t.start()
        # wait for every tile to reach RUN (or fail during boot)
        deadline = time.monotonic() + boot_timeout_s
        for name, ts in self.tiles.items():
            while self._cncs[name].signal_query() == R.CNC_BOOT:
                if ts.error is not None:
                    self.halt()
                    raise ts.error
                if time.monotonic() > deadline:
                    self.halt()
                    raise TimeoutError(f"tile {name!r} stuck in BOOT")
                time.sleep(1e-3)
            if self._cncs[name].signal_query() == R.CNC_FAIL:
                # run_loop signals FAIL before the exception reaches
                # _tile_main, so give the error a moment to land
                ts.thread.join(timeout=10.0)
                if not ts.ctx.booted:
                    # died DURING on_boot: a construction error, raised now.
                    # A tile that reached RUN and then crashed stays
                    # fail-stop via poll_failure.
                    self.halt()
                    if ts.error is not None:
                        raise ts.error
                    raise RuntimeError(f"tile {name!r} failed during boot")
        self.export_manifest()

    def poll_failure(self) -> None:
        """Fail-stop check: if any tile died, halt everything and re-raise."""
        for name, ts in self.tiles.items():
            if ts.error is not None:
                self.halt()
                raise RuntimeError(f"tile {name!r} failed") from ts.error

    def halt(self, timeout_s: float = 30.0) -> None:
        """Halt upstream-first so in-flight frags drain before consumers
        stop."""
        for name in self._topo_order():
            cnc = self._cncs.get(name)
            if cnc is None:
                continue
            cnc.signal(R.CNC_HALT)
            ts = self.tiles[name]
            if ts.thread is not None:
                ts.thread.join(timeout=timeout_s)

    def _topo_order(self) -> list[str]:
        """Tiles ordered producers-before-consumers (cycles broken by
        declaration order)."""
        order: list[str] = []
        seen: set[str] = set()

        def visit(name: str) -> None:
            if name in seen:
                return
            seen.add(name)
            for ln in self.tiles[name].ins:
                prod = self.links[ln[0]].producer
                if prod is not None and prod not in seen:
                    visit(prod)
            order.append(name)

        for name in self.tiles:
            visit(name)
        return order

    def metrics(self, tile_name: str) -> Metrics:
        return self._metrics[tile_name]

    def metrics_registry(self) -> dict[str, Metrics]:
        """Snapshot of every tile's Metrics (the metric tile's source)."""
        return dict(self._metrics)

    def export_manifest(self) -> None:
        """Publish the workspace directory + a monitor manifest (tile
        schemas, metrics/cnc alloc names, link fseq names, the resolved
        stem mode) so a separate process can attach and observe
        (app/monitor.py).  No-op for anonymous (in-process) workspaces.
        The port has no profile, flight, SLO or elastic regions and no
        trace reader, so the manifest carries none of those keys."""
        if self.wksp is None or self.wksp.name is None:
            return
        tiles = {}
        for name, ts in self.tiles.items():
            schema = self._metrics[name].schema
            tiles[name] = {
                "metrics": f"metrics_{name}",
                "cnc": f"cnc_{name}",
                "counters": list(schema.counters),
                "hists": list(schema.hists),
                # layout-affecting (wide hists store more buckets):
                # attached readers must reconstruct the same schema
                "wide_hists": list(schema.wide_hists),
                "ins": [ln for ln, _rel in ts.ins],
                "outs": list(ts.outs),
            }
        links = {
            ls.name: {
                "depth": ls.depth,
                "mcache": f"mc_{ls.name}",
                "consumers": [
                    {"tile": cons, "fseq": f"fs_{ls.name}_{cons}"}
                    for cons, _rel in ls.consumers
                ],
            }
            for ls in self.links.values()
        }
        self.wksp.publish_directory({
            "tiles": tiles, "links": links,
            "stem": self._loop_kw.get("stem") or self._resolve_stem(),
        })

    def close(self) -> None:
        if self.wksp is not None:
            self.wksp.unlink()
            self.wksp = None
