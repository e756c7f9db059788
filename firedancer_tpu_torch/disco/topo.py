"""Declarative topology: links + tiles + workspace layout + a runner.

The thread and process runtimes of firedancer_tpu/disco/topo.py
(`Topology`, `device_assignments`), over the same /dev/shm-backed objects:

  * runtime="thread" (the default): one thread per tile in one
    interpreter — the shape the reference's own tests use
    (src/disco/dedup/test_dedup.c:654-660).
  * runtime="process": one OS process per tile.  The parent builds the
    named workspace (an anonymous topology gets a name) and publishes a
    boot manifest; each child is SPAWNED (never forked: the parent may
    hold a CUDA context), re-attaches the workspace, proves its ring-ABI
    digest against the `shared_handshake` word (disco/handshake.py)
    before it binds any ring, rebinds its mcache/dcache/fseq/cnc views
    and metrics/trace/profile regions by manifest name, allocates its
    state from its own shm arena (tango.rings.WkspArena) and enters the
    same disco/mux.py run loop.  The control plane (boot acks and the
    booted/pid words of a per-tile `pstat` region) lives in shared
    memory; a child that crashes writes its traceback to an err sidecar
    beside the workspace, which close() removes.  Observer tiles that
    close over parent state (metric, rpc) declare proc_safe=False and
    stay threads in the parent.  Each child makes its own device state
    (a verify child its own CUDA context) in on_boot.

Either runtime runs either data-plane inner loop (`stem="python"`, the
default, or `"native"`: the tiles that register a native handler run the
GIL-released fdt_stem burst loop).  The runtime and the stem mode are
explicit arguments only: the JAX package's FDT_RUNTIME, FDT_STEM and
FDT_SPAWN environment switches are not carried.  A named topology
publishes its workspace directory and a monitor manifest
(`export_manifest`), so app/monitor.py and the metric tile can attach to
it by name; with `enable_profile()` every tile gets a run-loop profiler
region (disco/profile.py), read through `profile_metrics()` and the
manifest's `profile` key.
Not ported yet, and refused rather than ignored: restarts (an
incarnation past the first, a ring rejoin: disco/supervisor.py), fault
injection (disco/faultinj.py), hot upgrade (disco/elastic.py), elastic
shards, the flight recorder and asserted SLOs.  The shm dcache cursor
word, which only a restarted producer child needs, comes with the
supervisor.

Reference model: src/disco/topo/fd_topo.h:28-230 (fd_topo_t = wksps,
links, tiles, objs; built by fd_topob_*) and fd_topo_run.c (join
workspaces → init → run loop).  Fail-stop supervision mirrors
run/run.c:264-270: any tile failure halts the whole topology.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from ..tango import rings as R
from .metrics import Metrics, MetricsSchema
from .mux import InLink, MuxCtx, OutLink, Tile, link_hist_names, run_loop
from .trace import SpanRing, TraceConfig, Tracer

_LOG = logging.getLogger(__name__)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet")


#: per-tile process-control shm words ("pstat" region): the control plane
#: a child and its parent share beyond the cnc.  Single writer per word:
#: the parent owns INCARNATION (set before each spawn), the child owns PID
#: and BOOTED (its crash handler records whether on_boot had completed, so
#: the parent tells a construction error from a post-RUN crash without
#: any Python-object channel).  Word 3 (the JAX package's elastic drained
#: epoch) stays unused until elastic shards are ported.
PSTAT_INCARNATION, PSTAT_PID, PSTAT_BOOTED = 0, 1, 2
#: port-only child-owned words, written as the child exits (a kernel
#: wrapper's launch counter is per process, so a parent cannot read a
#: child's): CUDA = whether the child made a CUDA context, then one word
#: a kernel of DEVICE_KERNELS, its launches in the child
PSTAT_CUDA, PSTAT_LAUNCHES = 4, 5
#: the port's kernel wrappers' launch counters: (kernel, module under
#: the package, LAUNCHES key or None for a plain int)
DEVICE_KERNELS = (
    ("verify_core", "ops.ed25519.verify_core", None),
    ("decompress_niels", "ops.ed25519.msm", "decompress_niels"),
    ("msm_buckets", "ops.ed25519.msm", "msm_buckets"),
    ("pack_select", "ops.pack_select", None),
    ("sha256_blocks", "ops.sha256", "sha256_blocks"),
    ("poh_chain", "ops.sha256", "poh_chain"),
)
_PSTAT_WORDS = PSTAT_LAUNCHES + len(DEVICE_KERNELS)
_PSTAT_BYTES = 128
assert 8 * _PSTAT_WORDS <= _PSTAT_BYTES


def _publish_device(pstat: np.ndarray) -> None:
    """A child's exit: its CUDA context and its kernels' launches into
    its pstat words.  Reads only modules the child imported."""
    import sys

    root = __name__.split(".")[0]
    torch = sys.modules.get("torch")
    pstat[PSTAT_CUDA] = int(torch is not None and torch.cuda.is_initialized())
    for i, (_kernel, mod, key) in enumerate(DEVICE_KERNELS):
        m = sys.modules.get(f"{root}.{mod}")
        n = 0 if m is None else (m.LAUNCHES if key is None else m.LAUNCHES[key])
        pstat[PSTAT_LAUNCHES + i] = n


def _err_path(wksp_name: str, tile: str) -> str:
    """Child-crash report sidecar: the process analog of TileSpec.error
    (a traceback cannot cross the process boundary as an object).  Under
    the port's own /dev/shm prefix (tango.rings.SHM_PREFIX), so the JAX
    package's workspaces and leak checks never meet it."""
    return f"{R.SHM_PREFIX}{wksp_name}.err_{tile}"


def _read_err(wksp_name: str | None, tile: str) -> str:
    if wksp_name is None:
        return ""
    try:
        with open(_err_path(wksp_name, tile)) as f:
            return f.read()[-4000:]
    except OSError:
        return ""


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
    #: process runtime: the tile's child process (multiprocessing
    #: handle).  None for thread tiles and proc_safe=False observers.
    proc: object | None = None
    error: BaseException | None = None


class Topology:
    """Build links and tiles, then run them on threads or processes.

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
        #: tile runtime: "thread" | "process" | None (= "thread").  Must be
        #: settled before build(): the process runtime adds workspace
        #: regions (per-tile arenas and pstat words).
        self.runtime = runtime
        self._runtime: str | None = None  # resolved at build()
        self._resolve_runtime()
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
        #: run-loop profiling (disco/profile.py): None = off; set via
        #: enable_profile() before build()
        self.profile = None
        #: a fault-injection schedule for the children (JAX's
        #: Supervisor sets it); start() refuses one until
        #: disco/faultinj.py is ported
        self.faults_spec = None
        self._handshake = None  # handshake.Handshake, bound at build
        self._loop_kw: dict = {}
        self._mcaches: dict[str, R.MCache] = {}
        self._dcaches: dict[str, R.DCache] = {}
        self._fseqs: dict[tuple[str, str], R.FSeq] = {}
        self._cncs: dict[str, R.CNC] = {}
        self._metrics: dict[str, Metrics] = {}
        self._schemas: dict[str, MetricsSchema] = {}
        self._tracers: dict[str, Tracer] = {}
        self._profilers: dict = {}

    def enable_trace(self, sample: int = 64, depth: int = 1 << 14) -> None:
        """Turn on span rings for every tile (must run before build()).
        sample <= 0 disables — no tracer is installed and the hot path
        pays only the per-phase None checks."""
        assert self.wksp is None, "enable_trace before build()"
        self.trace = (
            TraceConfig(sample=sample, depth=depth) if sample > 0 else None
        )

    def enable_profile(self, on: bool = True) -> None:
        """Turn on the per-tile run-loop profiler (disco/profile.py):
        sampled wall/CPU phase attribution, GIL-wait fraction, and the
        scheduler-lag histogram, in per-tile workspace regions.  Must run
        before build(); off = one None check per loop hook and no region
        allocated."""
        assert self.wksp is None, "enable_profile before build()"
        self.profile = True if on else None

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

    def _resolve_runtime(self, mode: str | None = None) -> str:
        rt = mode or self.runtime or "thread"
        if rt not in ("thread", "process"):
            raise ValueError(
                f"unknown tile runtime {rt!r} (thread|process; from "
                f"start(mode=), build(runtime=) or Topology(runtime=))"
            )
        return rt

    def _proc(self, ts: TileSpec) -> bool:
        """Whether the tile runs as a child process (else a thread)."""
        return self._runtime == "process" and ts.tile.proc_safe

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
        from .handshake import HANDSHAKE_FOOTPRINT

        # version-handshake word region (every topology has one)
        total = 4096 + HANDSHAKE_FOOTPRINT + 256
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
            if self._proc(ts):
                # a child allocates its tile state from its arena (and
                # its pstat words), not from the workspace
                total += R.WkspArena.footprint(ts.tile.wksp_footprint()) + 256
                total += _PSTAT_BYTES + 128
            else:
                total += ts.tile.wksp_footprint() + 256
            if self.trace is not None:
                total += SpanRing.footprint(self.trace.depth) + 256
            if self.profile is not None:
                from .profile import PROFILE_SCHEMA

                total += Metrics.footprint(PROFILE_SCHEMA) + 256
        return total

    def build(self, runtime: str | None = None) -> None:
        assert self.wksp is None, "already built"
        self._runtime = self._resolve_runtime(runtime)
        if self._runtime == "process" and self.name is None:
            # children attach by name; auto-name anonymous topologies
            self.name = f"p{os.getpid()}_{os.urandom(3).hex()}"
        self.wksp = R.Workspace(self._footprint(), name=self.name)
        # topology-wide shared regions, once each, before any tile boots
        # (MuxCtx.shared resolves them by name; a process child joins
        # them, an attached workspace never allocates)
        for nm, fp in sorted(self._shared_regions().items()):
            self.wksp.alloc(f"shared_{nm}", fp)
        # version-handshake word (disco/handshake.py): written ONCE by the
        # building tree with its own ring-ABI digest, read by every
        # process child before it binds a ring
        from .handshake import HANDSHAKE_FOOTPRINT, Handshake

        self._handshake = Handshake(
            self.wksp.alloc("shared_handshake", HANDSHAKE_FOOTPRINT),
            join=False,
        )
        self._handshake.init(R.abi_digest())
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
            self._schemas[name] = schema
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
            if self.profile is not None:
                from .profile import PROFILE_SCHEMA, TileProfiler

                pmem = self.wksp.alloc(
                    f"profile_{name}", Metrics.footprint(PROFILE_SCHEMA)
                )
                self._profilers[name] = TileProfiler(
                    Metrics(pmem, PROFILE_SCHEMA)
                )
            if self._proc(ts):
                self.wksp.alloc(f"pstat_{name}", _PSTAT_BYTES, align=64)
                self.wksp.alloc(
                    f"arena_{name}",
                    R.WkspArena.footprint(ts.tile.wksp_footprint()),
                )
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
            ts.ctx.profiler = self._profilers.get(name)

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
        """Start every tile (a thread each, or under the process runtime a
        child process each, proc_safe=False tiles staying threads) and
        wait for every tile to reach RUN.  A tile that fails during
        on_boot (bad config, no card, a refused handshake) halts the
        topology and its error is raised here.  mode: the runtime
        (overrides Topology(runtime=); must match a topology already
        built).  loop_kw goes to run_loop (batch_max, lazy_ns, ...); its
        `stem` (python|native) overrides Topology(stem=)."""
        runtime = self._resolve_runtime(mode)
        if self.wksp is None:
            self.build(runtime=runtime)
        elif runtime != self._runtime:
            raise RuntimeError(
                f"topology built for runtime {self._runtime!r}; cannot "
                f"start as {runtime!r} (the process runtime changes the "
                f"workspace layout — set it before build())"
            )
        if self.faults_spec is not None:
            raise _not_ported("fault injection (disco/faultinj.py)")
        self._loop_kw = dict(loop_kw)
        # the stem mode rides the loop kwargs: the same dict reaches
        # thread tiles and process children (spawn args), so every tile
        # runs the same inner loop
        self._loop_kw["stem"] = self._resolve_stem(loop_kw.get("stem"))
        if runtime == "process":
            # publish BEFORE spawn: children rebuild their endpoints from
            # the directory's boot manifest
            self.export_manifest()
            self._spawn_children()
        else:
            for name in self.tiles:
                self._spawn_tile(name)
        deadline = time.monotonic() + boot_timeout_s
        for name in self.tiles:
            self._wait_boot(name, deadline)
        # publish AFTER boot: on_boot workspace allocations of thread
        # tiles (tcaches etc.) must appear in the directory the monitor
        # attaches to (a child's arena name table is in shm already)
        self.export_manifest()

    def _wait_boot(self, name: str, deadline: float) -> None:
        """Wait for one tile to leave BOOT; a death or failure during boot
        halts the topology and raises, naming the tile (with a child's
        err sidecar), and so does the deadline."""
        ts = self.tiles[name]
        cnc = self._cncs[name]
        while cnc.signal_query() == R.CNC_BOOT:
            if ts.error is not None:
                self.halt()
                raise ts.error
            p = ts.proc
            if p is not None and not p.is_alive():
                # died before reaching RUN or FAIL (a spawn or import
                # crash, a refused handshake): the sidecar carries the
                # traceback
                err = _read_err(self.name, name)
                rc = p.exitcode  # before halt() reaps and closes it
                self.halt()
                raise RuntimeError(
                    f"tile {name!r} process died during boot (exitcode "
                    f"{rc})" + (f":\n{err}" if err else "")
                )
            if time.monotonic() > deadline:
                self.halt()
                raise TimeoutError(f"tile {name!r} stuck in BOOT")
            time.sleep(1e-3)
        if cnc.signal_query() != R.CNC_FAIL:
            return
        # run_loop signals FAIL before the exception reaches the thread's
        # or the child's handler, so give the error a moment to land
        if ts.proc is not None:
            ts.proc.join(timeout=10.0)
            booted = bool(self._pstat(name)[PSTAT_BOOTED])
        else:
            ts.thread.join(timeout=10.0)
            booted = ts.ctx.booted
        if booted:
            # reached RUN and then crashed: fail-stop via poll_failure
            return
        # died DURING on_boot: a construction error, raised now
        err = _read_err(self.name, name)
        self.halt()
        if ts.error is not None:
            raise ts.error
        raise RuntimeError(
            f"tile {name!r} failed during boot" + (f":\n{err}" if err else "")
        )

    # ---- process runtime -------------------------------------------------

    def _pstat(self, name: str) -> np.ndarray:
        return self.wksp.view(f"pstat_{name}")[: 8 * _PSTAT_WORDS].view(np.uint64)

    def tile_pid(self, name: str) -> int | None:
        """The tile's child pid (process runtime; None for threads)."""
        ts = self.tiles[name]
        if ts.proc is None:
            return None
        return int(self._pstat(name)[PSTAT_PID]) or ts.proc.pid

    def tile_device(self, name: str) -> dict | None:
        """A child's device use, published as it exited (read it after
        halt): `cuda`, whether it made a CUDA context, and `launches`,
        each DEVICE_KERNELS kernel's launches in it, its warm-ups
        included.  None for a thread tile, whose launches count in this
        process."""
        if not self._proc(self.tiles[name]):
            return None
        w = self._pstat(name)
        return {"cuda": bool(w[PSTAT_CUDA]),
                "launches": {k: int(w[PSTAT_LAUNCHES + i])
                             for i, (k, _m, _key) in enumerate(DEVICE_KERNELS)}}

    def _spawn_tile(self, name: str, replay: int = 0,
                    rejoin: bool | None = None) -> None:
        """Start one tile in the resolved runtime: a child process, or a
        thread for the thread runtime and proc_safe=False observers.  A
        re-incarnation and a ring rejoin (`replay`, `rejoin`) belong to
        restarts, which are not ported."""
        ts = self.tiles[name]
        if rejoin or replay or ts.ctx.incarnation > 0:
            raise _not_ported("restarting a tile (disco/supervisor.py)")
        ts.error = None
        if not self._proc(ts):
            t = threading.Thread(
                target=self._tile_main,
                args=(ts, self._loop_kw),
                name=f"tile:{name}",
                daemon=True,
            )
            ts.thread = t
            t.start()
            return
        import multiprocessing as mp

        # fresh incarnation contract: the parent owns the incarnation
        # word, the child the pid and booted words — clear the child's
        # words and any stale crash report before it starts
        pstat = self._pstat(name)
        pstat[PSTAT_INCARNATION] = np.uint64(ts.ctx.incarnation)
        pstat[PSTAT_PID] = 0
        pstat[PSTAT_BOOTED] = 0
        pstat[PSTAT_CUDA:] = 0
        try:
            os.unlink(_err_path(self.name, name))
        except FileNotFoundError:
            pass
        # spawn, never fork: a pristine interpreter per tile, with no
        # inherited GIL state, locks or CUDA context; the child rebuilds
        # everything from the manifest and the pickled tile
        p = mp.get_context("spawn").Process(
            target=_tile_process_main,
            args=(self.name, name, ts.tile, self._loop_kw),
            name=f"tile:{name}",
            daemon=True,
        )
        ts.proc = p
        p.start()

    def _spawn_children(self) -> None:
        """Start every tile of a process topology at once, one thread per
        tile: a spawn writes the pickled tile into the child's pipe and
        blocks until the child has read it all, which for a large tile
        (pack's pools) waits out the child's imports; started in turn,
        each such child would hold back every tile after it.  A failed
        start halts what started and raises."""
        errors: list[BaseException] = []

        def spawn(name: str) -> None:
            try:
                self._spawn_tile(name)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        starters = [threading.Thread(target=spawn, args=(n,), name=f"spawn:{n}")
                    for n in self.tiles]
        for t in starters:
            t.start()
        for t in starters:
            t.join()
        if errors:
            self.halt()
            raise errors[0]

    def _reap(self, ts: TileSpec, timeout_s: float) -> None:
        """Join a child with bounded escalation: HALT should have ended
        it; a survivor gets SIGTERM then SIGKILL, and the handle is
        always closed so no zombie outlives the topology (a child that
        died mid-boot is reaped the same way)."""
        p = ts.proc
        if p is None:
            return
        p.join(timeout=timeout_s)
        if p.is_alive():
            p.terminate()
            p.join(timeout=5.0)
        if p.is_alive():
            p.kill()
            p.join(timeout=5.0)
        try:
            p.close()
        except ValueError:
            pass  # still alive after SIGKILL (D-state): leaked
        ts.proc = None

    def poll_failure(self) -> None:
        """Fail-stop check: if any tile died, halt everything and re-raise."""
        for name, ts in self.tiles.items():
            if ts.error is not None:
                self.halt()
                raise RuntimeError(f"tile {name!r} failed") from ts.error
            p = ts.proc
            if p is None:
                continue
            sig = self._cncs[name].signal_query()
            if sig == R.CNC_FAIL or (sig == R.CNC_RUN and not p.is_alive()):
                err = _read_err(self.name, name)
                self.halt()
                raise RuntimeError(
                    f"tile {name!r} process failed"
                    + (f":\n{err}" if err else "")
                )

    def handshake(self):
        """The workspace's version-handshake view (disco/handshake.py),
        bound at build()."""
        assert self._handshake is not None, "build() first"
        return self._handshake

    def approve_version(self, digest: int) -> None:
        """Admit a foreign ABI digest into the workspace compat table —
        the operator's out-of-band ring-compatibility proof.  Children
        carrying it pass the handshake thereafter."""
        self.handshake().approve(digest)

    def hot_upgrade(self, name: str, **kw) -> None:
        raise _not_ported("hot upgrade (disco/elastic.py)")

    def halt(self, timeout_s: float = 30.0) -> None:
        """Halt upstream-first so in-flight frags drain before consumers
        stop.  Children are reaped with bounded SIGTERM→SIGKILL
        escalation (a child that died mid-boot is reaped the same way)."""
        for name in self._topo_order():
            cnc = self._cncs.get(name)
            if cnc is None:
                continue
            cnc.signal(R.CNC_HALT)
            ts = self.tiles[name]
            if ts.proc is not None:
                self._reap(ts, timeout_s)
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

    def profile_metrics(self) -> dict[str, Metrics]:
        """Per-tile profiler regions (disco/profile.py readers), empty
        when profiling is off."""
        return {name: p.m for name, p in self._profilers.items()}

    def tile_alloc_view(self, tile: str, name: str) -> np.ndarray:
        """Resolve a tile's ctx.alloc region by name from the PARENT: the
        tile's shm arena under the process runtime, the workspace alloc
        table under the thread runtime, the ctx-local buffer of an
        anonymous thread topology."""
        key = f"{tile}_{name}"
        if self._proc(self.tiles[tile]):
            # join=True: a read-only attach never initializes the header
            # (the owning child's job; racing it would corrupt the table)
            return R.WkspArena(
                self.wksp.view(f"arena_{tile}"), join=True
            ).view(key)
        if self.wksp is not None and key in self.wksp._allocs:
            return self.wksp.view(key)
        return self.tiles[tile].ctx._local_allocs[key]

    def export_manifest(self) -> None:
        """Publish the workspace directory + a monitor manifest (tile
        schemas, metrics/cnc alloc names, link fseq names, the resolved
        stem mode, the profile regions when profiling is on, and under
        the process runtime the children's boot manifest) so a separate
        process can attach (app/monitor.py, a tile child).  No-op for
        anonymous (in-process) workspaces.  The port has no flight, SLO
        or elastic regions and no trace reader, so the manifest carries
        none of those keys."""
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
        extra = {
            "tiles": tiles, "links": links,
            "stem": self._loop_kw.get("stem") or self._resolve_stem(),
        }
        if self.profile is not None:
            extra["profile"] = {
                "tiles": {name: f"profile_{name}" for name in self.tiles},
            }
        if self._runtime == "process":
            extra["boot"] = self._boot_manifest()
        self.wksp.publish_directory(extra)

    def _boot_manifest(self) -> dict:
        """The child-side reconstruction contract: everything a spawned
        tile process needs to rebind its endpoints by name — link
        geometry (depth/mtu/ids, mcache/dcache/fseq alloc names),
        per-tile cnc/metrics/arena/pstat names, the flattened metrics
        schemas (including wide-hist widths — layout-affecting), the
        trace and profile regions and the handshake word."""
        link_ids = {ln: i for i, ln in enumerate(self.links)}
        links = {}
        for ls in self.links.values():
            links[ls.name] = {
                "id": link_ids[ls.name],
                "depth": ls.depth,
                "mtu": ls.mtu,
                "producer": ls.producer,
                "mcache": f"mc_{ls.name}",
                "dcache": f"dc_{ls.name}" if ls.mtu else None,
                "consumers": [
                    [cons, rel, f"fs_{ls.name}_{cons}"]
                    for cons, rel in ls.consumers
                ],
            }
        tiles = {}
        for name, ts in self.tiles.items():
            schema = self._schemas[name]
            proc = ts.tile.proc_safe  # observers have no child regions
            tiles[name] = {
                "ins": [[ln, rel] for ln, rel in ts.ins],
                "outs": list(ts.outs),
                "cnc": f"cnc_{name}",
                "metrics": f"metrics_{name}",
                "schema": {
                    "counters": list(schema.counters),
                    "hists": list(schema.hists),
                    "wide_hists": list(schema.wide_hists),
                },
                "arena": f"arena_{name}" if proc else None,
                "pstat": f"pstat_{name}" if proc else None,
                "trace": f"trace_{name}" if self.trace is not None else None,
                "profile": (
                    f"profile_{name}" if self.profile is not None else None
                ),
            }
        return {
            "runtime": "process",
            "spawn": "spawn",
            "handshake": "shared_handshake",
            "links": links,
            "tiles": tiles,
            "trace": (
                {"sample": self.trace.sample, "depth": self.trace.depth}
                if self.trace is not None
                else None
            ),
        }

    def close(self) -> None:
        """Halt whatever still runs (the tiles of a run that raised before
        its halt: a daemon thread would spin on, a child be left to the
        SIGTERM below), reap every child still there (a failed start, a
        child dead mid-boot), then remove the workspace file, its
        directory and every err sidecar."""
        if any(ts.proc is not None or (ts.thread is not None and ts.thread.is_alive())
               for ts in self.tiles.values()):
            self.halt(timeout_s=5.0)
        for ts in self.tiles.values():
            if ts.proc is not None:
                self._reap(ts, timeout_s=1.0)
        if self.wksp is not None:
            self.wksp.unlink()
            self.wksp = None


# ---------------------------------------------------------------------------
# process-runtime child entrypoint
#
# Runs in a FRESH interpreter (spawn): re-attach the named workspace, prove
# the ring-ABI digest, rebind every endpoint by boot-manifest name, rebuild
# the MuxCtx with the tile's shm arena and profiler, and enter the SAME run
# loop the thread runtime uses — the ring protocol itself is process-safe.


def _tile_process_main(
    wksp_name: str,
    tile_name: str,
    tile: Tile,
    loop_kw: dict,
) -> None:
    import sys
    import traceback

    err_path = _err_path(wksp_name, tile_name)
    ctx = None
    cnc = None
    pstat = None
    try:
        ws, extra = R.Workspace.attach(wksp_name)
        boot = extra["boot"]
        links = boot["links"]
        t = boot["tiles"][tile_name]
        pstat = ws.view(t["pstat"])[: 8 * _PSTAT_WORDS].view(np.uint64)
        pstat[PSTAT_PID] = os.getpid()
        # version handshake (disco/handshake.py): prove THIS
        # interpreter's ring-ABI digest against the workspace word BEFORE
        # binding a single ring — a mixed-version join is refused right
        # here (HandshakeRefused lands in the err sidecar with both
        # digests; exit code 2, a construction failure)
        from .handshake import check_join

        check_join(ws.view(boot["handshake"]), R.abi_digest(), tile=tile_name)
        mcaches: dict[str, R.MCache] = {}
        dcaches: dict[str, R.DCache] = {}

        def _mc(ln: str) -> R.MCache:
            if ln not in mcaches:
                mcaches[ln] = R.MCache(
                    ws.view(links[ln]["mcache"]), links[ln]["depth"],
                    join=True,
                )
            return mcaches[ln]

        def _dc(ln: str) -> R.DCache | None:
            spec = links[ln]
            if spec["dcache"] is None:
                return None
            if ln not in dcaches:
                dcaches[ln] = R.DCache(
                    ws.view(spec["dcache"]), spec["mtu"], spec["depth"]
                )
            return dcaches[ln]

        cnc = R.CNC(ws.view(t["cnc"]), join=True)
        sch = t["schema"]
        schema = MetricsSchema(
            counters=tuple(sch["counters"]),
            hists=tuple(sch["hists"]),
            wide_hists=tuple(sch["wide_hists"]),
        )
        metrics = Metrics(ws.view(t["metrics"]), schema)
        tracer = None
        if boot["trace"] is not None and t["trace"] is not None:
            ring = SpanRing(ws.view(t["trace"]), join=True)
            tracer = Tracer(ring, boot["trace"]["sample"], name=tile_name)
        profiler = None
        if t["profile"] is not None:
            from .profile import PROFILE_SCHEMA, TileProfiler

            profiler = TileProfiler(
                Metrics(ws.view(t["profile"]), PROFILE_SCHEMA)
            )
        ins = [
            InLink(
                ln,
                _mc(ln),
                _dc(ln),
                R.FSeq(
                    ws.view(next(
                        c[2] for c in links[ln]["consumers"]
                        if c[0] == tile_name
                    )),
                    join=True,
                ),
                bool(rel),
                link_id=links[ln]["id"],
                h_qwait=f"qwait_us_{ln}",
                h_svc=f"svc_us_{ln}",
                h_e2e=f"e2e_us_{ln}",
            )
            for ln, rel in t["ins"]
        ]
        outs = [
            OutLink(
                ln,
                _mc(ln),
                _dc(ln),
                [
                    R.FSeq(ws.view(c[2]), join=True)
                    for c in links[ln]["consumers"]
                    if c[1]
                ],
                link_id=links[ln]["id"],
                tracer=tracer,
            )
            for ln in t["outs"]
        ]
        ctx = MuxCtx(tile_name, cnc, ins, outs, metrics, wksp=ws)
        ctx.tracer = tracer
        ctx.profiler = profiler
        ctx.arena = R.WkspArena(ws.view(t["arena"]))
        run_loop(tile, ctx, **loop_kw)
    except BaseException:  # noqa: BLE001 — fail-stop, reported via shm
        try:
            with open(err_path, "w") as f:
                f.write(traceback.format_exc())
        except OSError:
            pass
        booted = bool(ctx is not None and ctx.booted)
        if pstat is not None:
            pstat[PSTAT_BOOTED] = 1 if booted else 0
            try:
                _publish_device(pstat)
            except Exception:  # noqa: BLE001 — the crash is reported already
                pass
        # run_loop signals FAIL for its own exceptions; cover crashes
        # before or outside it so the parent's cnc wait always resolves
        if cnc is not None and cnc.signal_query() != R.CNC_FAIL:
            cnc.signal(R.CNC_FAIL)
        _LOG.error("tile %s process failed: see %s", tile_name, err_path)
        # the exit code mirrors the boot/run classification
        sys.exit(2 if not booted else 1)
    else:
        if pstat is not None:
            _publish_device(pstat)
            pstat[PSTAT_BOOTED] = 1
