"""Python bindings for the port's native tango layer (fdt_tango.c).

A copy of firedancer_tpu/tango/rings.py, trimmed to what the thread and
process runtimes need: `Workspace`, `WkspArena` (a tile's named
sub-allocator, with its name table in shared memory, so a process-runtime
child allocates its state and the parent reads it by name), `MCache`,
`DCache`, `FSeq`, `CNC`, `TCache`, `cr_avail`, the wrap-safe `seq_*`
helpers, the rejoin helpers, the native `trace_*` helpers, the native stem
(`StemSpec`, `Stem`, the `STEM_*` ids), the named workspace's attach
surface (`publish_directory`, `attach`) and the version-handshake digest
(`abi_components`, `digest_of`, `abi_digest`).  The library is built
from the port's own copies of fdt_tango.c, fdt_sha512.c, fdt_sha256.c,
fdt_trace.c, fdt_pack.c, fdt_bank.c, fdt_stem.c, fdt_poh.c, fdt_shred.c
and fdt_net.c (tango/native/) by utils/cbuild.py into the git-ignored
_build/, at first use, and loaded with ctypes.CDLL, so every call
releases the GIL; `_load` injects the SHA-512 and SHA-256 tables and the
pack cost model's constants into this library's own statics.  The
shm-backed dcache producer cursor (`DCache.bind_cursor`), which only a
restarted producer child needs, waits for the supervisor.

Objects live in caller-provided buffers: a numpy array for in-process
topologies, or an mmap of a /dev/shm file (`Workspace(name=...)`, under the
port's own prefix fdt_torch_wksp_).  The bindings expose both one-frag
operations (tests, low-rate tiles) and the batch drain/dedup entry points
that feed the device bridge (thousands of frags per native call, one
ctypes crossing).

Reference semantics being mirrored: src/tango/fd_tango_base.h:4-110
(seq/sig/ctl model), src/tango/tcache/fd_tcache.h (dedup cache),
src/tango/fctl/fd_fctl.h (credit flow control).
"""

from __future__ import annotations

import ctypes as ct
import mmap
import os
import threading
from pathlib import Path

import numpy as np

from ..utils import cbuild
from ..utils.shaconst import H32, H64, K32, K64

# ---------------------------------------------------------------------------
# library load

_HERE = Path(__file__).parent

#: sources of the ring library, in link order
_NATIVE_SOURCES = [
    _HERE / "native" / "fdt_tango.c",
    _HERE / "native" / "fdt_sha512.c",
    _HERE / "native" / "fdt_sha256.c",
    _HERE / "native" / "fdt_trace.c",
    _HERE / "native" / "fdt_pack.c",
    _HERE / "native" / "fdt_bank.c",
    _HERE / "native" / "fdt_stem.c",
    _HERE / "native" / "fdt_poh.c",
    _HERE / "native" / "fdt_shred.c",
    _HERE / "native" / "fdt_net.c",
]

#: the prefix of named workspaces' /dev/shm files (firedancer_tpu's use
#: fdt_wksp_; the two never share a file)
SHM_PREFIX = "/dev/shm/fdt_torch_wksp_"


def _bind(lib, sigs: dict) -> None:
    """Apply a {symbol: (restype, argtypes)} table to a loaded library.  A
    symbol missing from the library raises, naming it."""
    for name, (res, args) in sigs.items():
        try:
            fn = getattr(lib, name)
        except AttributeError:
            raise RuntimeError(
                f"native symbol {name!r} is bound in the ctypes table but "
                f"missing from the built library (tango/native/*.c)"
            ) from None
        fn.restype = res
        fn.argtypes = args


#: set by _load(): path of the loaded library and the ctypes sigs table —
#: the Python-side inputs to the version-handshake digest (abi_digest)
_LIB_PATH: str | None = None
_LIB_SIGS: dict | None = None


def _load() -> ct.CDLL:
    global _LIB_PATH, _LIB_SIGS
    so = cbuild.build("fdt_tango", _NATIVE_SOURCES)
    _LIB_PATH = str(so)
    lib = ct.CDLL(_LIB_PATH)
    u64, u32, u16, i32, i64, vp = (
        ct.c_uint64, ct.c_uint32, ct.c_uint16, ct.c_int, ct.c_int64,
        ct.c_void_p,
    )
    sigs = {
        "fdt_mcache_align": (u64, []),
        "fdt_mcache_footprint": (u64, [u64]),
        "fdt_mcache_new": (i32, [vp, u64, u64]),
        "fdt_mcache_depth": (u64, [vp]),
        "fdt_mcache_seq0": (u64, [vp]),
        "fdt_mcache_seq_advance": (None, [vp, u64]),
        "fdt_mcache_seq_query": (u64, [vp]),
        "fdt_mcache_publish": (None, [vp, u64, u64, u32, u16, u16, u32, u32]),
        "fdt_mcache_poll": (i32, [vp, u64, vp, vp]),
        "fdt_mcache_drain": (u64, [vp, vp, u64, vp, vp]),
        "fdt_mcache_publish_batch": (u64, [vp, u64, vp, vp, vp, vp, vp, u32, u64]),
        "fdt_dcache_scatter": (None, [vp, vp, u64, u64, vp, vp, u64, u64, vp]),
        "fdt_dcache_footprint": (u64, [u64, u64]),
        "fdt_dcache_chunk_cnt": (u64, [u64]),
        "fdt_dcache_compact_next": (u64, [u64, u64, u64, u64]),
        "fdt_dcache_gather": (None, [vp, vp, vp, u64, u64, vp]),
        "fdt_fseq_align": (u64, []),
        "fdt_fseq_footprint": (u64, []),
        "fdt_fseq_new": (None, [vp, u64]),
        "fdt_fseq_query": (u64, [vp]),
        "fdt_fseq_update": (None, [vp, u64]),
        "fdt_fseq_diag_query": (u64, [vp, u64]),
        "fdt_fseq_diag_add": (None, [vp, u64, u64]),
        "fdt_fctl_cr_avail": (u64, [u64, u64, u64]),
        "fdt_cnc_align": (u64, []),
        "fdt_cnc_footprint": (u64, []),
        "fdt_cnc_new": (None, [vp]),
        "fdt_cnc_signal_query": (u64, [vp]),
        "fdt_cnc_signal": (None, [vp, u64]),
        "fdt_cnc_heartbeat": (None, [vp, u64]),
        "fdt_cnc_heartbeat_query": (u64, [vp]),
        "fdt_tcache_align": (u64, []),
        "fdt_tcache_footprint": (u64, [u64, u64]),
        "fdt_tcache_new": (i32, [vp, u64, u64]),
        "fdt_tcache_depth": (u64, [vp]),
        "fdt_tcache_dedup": (u64, [vp, vp, u64, vp]),
        "fdt_tcache_dedup_j": (u64, [vp, vp, u64, vp, vp, u64]),
        "fdt_tcache_query": (i32, [vp, u64]),
        "fdt_tcache_reset": (None, [vp]),
        "fdt_verify_expand": (
            u64,
            [vp, vp, vp, u64, u64, vp, u64, vp, vp, vp, vp, vp, vp, vp, vp],
        ),
        "fdt_sha512_init_consts": (None, [vp, vp]),
        "fdt_sha512_rpm": (None, [vp, vp, vp, u64, vp]),
        "fdt_sha512_batch": (None, [vp, vp, u64, u64, vp]),
        "fdt_xxh64": (u64, [vp, u64, u64]),
        "fdt_trace_words": (u64, []),
        "fdt_trace_now": (u32, []),
        "fdt_trace_read_clock": (u32, [vp]),
        "fdt_trace_ts_diff": (i64, [u32, u32]),
        "fdt_trace_hist_sample": (None, [vp, i64, i64]),
        "fdt_trace_span_block": (None, [vp, vp, i64]),
        "fdt_trace_span": (None, [vp, u64, u64, u64, u64, u64, u64, u64]),
        "fdt_pack_init_consts": (None, [vp, vp, vp, vp, i64]),
        "fdt_txn_scan": (
            i64,
            [vp, i64, i64, vp, i64, i64] + [vp] * 12
            + [vp, vp, vp, vp, i64, vp, vp, i64, vp, i64, vp],
        ),
        "fdt_pack_select_x": (
            i64,
            [vp, i64, vp, vp, i64, vp, vp, i64, vp, vp, i64, vp, vp, i64,
             vp, vp, i64, vp, vp, i64, i64, i64, i64, vp, vp],
        ),
        "fdt_pack_release_x": (
            None,
            [vp, i64, vp, vp, i64, vp, vp, i64, vp, vp, i64, vp, vp, i64],
        ),
        "fdt_mb_encode": (i64, [vp, i64, vp, vp, i64, u32, u32, vp, i64]),
        "fdt_mb_decode": (i64, [vp, i64, vp, i64, vp, i64]),
        "fdt_pack_sched": (i64, [vp, vp, i64, i64, i64, u64, vp]),
        # the shared account table and its batch executor (fdt_bank.c),
        # and the stem's fused bank body (fdt_stem.c)
        "fdt_bank_tab_footprint": (u64, [u64]),
        "fdt_bank_tab_new": (i32, [vp, u64]),
        "fdt_bank_tab_slots": (u64, [vp]),
        "fdt_bank_tab_put": (i64, [vp, vp, i64, u64, i64]),
        "fdt_bank_tab_get": (i64, [vp, vp, vp]),
        "fdt_bank_exec": (
            i64, [vp, i64, vp, i64, i64, vp, vp, vp, vp, vp, vp, vp, u64, i64, vp, vp],
        ),
        "fdt_bank_commit": (i64, [vp, vp, vp, vp, vp, vp, i64]),
        "fdt_bank_commit_ack": (None, [vp, vp, vp, i64]),
        "fdt_bank_recover": (i64, [vp, vp, vp]),
        "fdt_bank_pipeline": (i64, [vp, i64, vp, u64, vp]),
        "fdt_stem_cfg_words": (u64, []),
        "fdt_stem_run": (i64, [vp, i64]),
        "fdt_stem_out_cr": (i64, [vp]),
        "fdt_stem_out_emit": (None, [vp, u64, vp, u64, u16, u32, u32, i64]),
        "fdt_stem_out_emit_at": (None, [vp, u64, u32, u64, u16, u32, u32, i64]),
        # the block egress's bodies, dispatched from fdt_stem_run; the
        # direct bindings serve the differential tests
        "fdt_sha256_init_consts": (None, [vp, vp]),
        "fdt_sha256": (None, [vp, u64, vp]),
        "fdt_sha256_mix": (None, [vp, vp, vp]),
        "fdt_sha256_append": (None, [vp, u64]),
        "fdt_poh_mixins": (i64, [vp, vp, i64, u64, vp, vp, vp, i64, i64]),
        "fdt_poh_tick": (i64, [vp, vp, i64, i64, u64, vp]),
        "fdt_shred_entries": (i64, [vp, vp, vp, i64, vp]),
        "fdt_shred_sign": (i64, [vp, vp, vp, i64, vp]),
        "fdt_shred_drain": (i64, [vp, vp, i64, i64, u64, vp]),
        # the net tile's datagram paths (fdt_net.c): the recvmmsg /
        # sendmmsg bursts, the tx body and rx hook fdt_stem_run
        # dispatches, and the route cache's slow-path insert
        "fdt_udp_recv_burst": (i64, [i32, vp, i64, vp, i64, i64]),
        "fdt_udp_send_burst": (i64, [i32, vp, i64, vp, i64, vp]),
        "fdt_net_tx": (i64, [vp, vp, vp, i64, vp]),
        "fdt_net_rx": (i64, [vp, vp, i64, i64, u64, vp]),
        "fdt_net_route_put": (None, [vp, u32, i64]),
    }
    _bind(lib, sigs)
    _LIB_SIGS = sigs
    # the SHA-512 constant tables are globals of THIS library (a second
    # copy of the ring library in the process keeps its own): inject them
    k = np.array(K64, dtype=np.uint64)
    h = np.array(H64, dtype=np.uint64)
    lib.fdt_sha512_init_consts(k.ctypes.data, h.ctypes.data)
    k2 = np.array(K32, dtype=np.uint32)
    h2 = np.array(H32, dtype=np.uint32)
    lib.fdt_sha256_init_consts(k2.ctypes.data, h2.ctypes.data)
    # the pack cost model's consensus constants, from the port's own
    # ballet/compute_budget.py and base58.py (the Python tables stay
    # authoritative; C never duplicates them)
    from ..ballet import compute_budget as CB
    from ..ballet.base58 import decode_32

    pids = np.frombuffer(b"".join(CB.BUILTIN_COSTS), np.uint8).copy()
    costs = np.array(list(CB.BUILTIN_COSTS.values()), np.uint64)
    cb = np.frombuffer(CB.COMPUTE_BUDGET_PROGRAM_ID, np.uint8).copy()
    vote = np.frombuffer(
        decode_32("Vote111111111111111111111111111111111111111"), np.uint8
    ).copy()
    lib.fdt_pack_init_consts(cb.ctypes.data, vote.ctypes.data,
                             pids.ctypes.data, costs.ctypes.data, len(costs))
    return lib


class _Library:
    """The ring library, built and loaded at its first use, not at import
    (the first call may compile it)."""

    _lock = threading.Lock()
    _cdll: ct.CDLL | None = None

    def __getattr__(self, name: str):
        if _Library._cdll is None:
            with _Library._lock:
                if _Library._cdll is None:
                    _Library._cdll = _load()
        return getattr(_Library._cdll, name)


_lib = _Library()

CHUNK_SZ = 64
CTL_SOM, CTL_EOM, CTL_ERR = 1, 2, 4
# ---------------------------------------------------------------------------
# wrap-safe sequence arithmetic
#
# Native seqs are u64 and wrap mod 2^64; Python ints do not.  Every
# comparison/distance on seqs host-side must go through these helpers
# (mirroring the reference's fd_seq_lt/fd_seq_diff, fd_tango_base.h), or
# rejoin/overrun logic silently breaks when a ring crosses 2^64.

_U64_MASK = (1 << 64) - 1


def seq_u64(x: int) -> int:
    """Reduce to the u64 domain (mod 2^64)."""
    return x & _U64_MASK


def seq_diff(a: int, b: int) -> int:
    """Signed distance a - b mod 2^64 (positive: a is after b)."""
    d = (a - b) & _U64_MASK
    return d - (1 << 64) if d >= (1 << 63) else d


def seq_lt(a: int, b: int) -> bool:
    return seq_diff(a, b) < 0


def seq_le(a: int, b: int) -> bool:
    return seq_diff(a, b) <= 0


def seq_min(a: int, b: int) -> int:
    return a if seq_le(a, b) else b


def seq_max(a: int, b: int) -> int:
    return a if seq_le(b, a) else b

FRAG_DTYPE = np.dtype(
    {
        "names": ["seq", "sig", "chunk", "sz", "ctl", "tsorig", "tspub"],
        "formats": ["<u8", "<u8", "<u4", "<u2", "<u2", "<u4", "<u4"],
        "offsets": [0, 8, 16, 20, 22, 24, 28],
        "itemsize": 32,
    }
)


def _ptr(buf: np.ndarray, off: int = 0) -> int:
    assert buf.flags["C_CONTIGUOUS"]
    return buf.ctypes.data + off


# ---------------------------------------------------------------------------
# workspace: a region of tango objects, anonymous or a named /dev/shm file


class Workspace:
    """A contiguous byte region holding tango objects.

    Anonymous (name None): backed by one numpy buffer.  Named: backed by
    the /dev/shm file SHM_PREFIX + name, mmapped (the reference's hugetlbfs
    wksp model, src/util/wksp/fd_wksp.h:7-75, minus NUMA placement).
    Allocation is an aligned bump allocator with a name->offset table kept
    host-side.
    """

    def __init__(self, size: int, name: str | None = None):
        self.size = int(size)
        self.name = name
        self._allocs: dict[str, tuple[int, int]] = {}
        self._off = 64
        if name is None:
            self._mm = None
            self.buf = np.zeros(self.size, dtype=np.uint8)
        else:
            path = f"{SHM_PREFIX}{name}"
            self._fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o600)
            os.ftruncate(self._fd, self.size)
            self._mm = mmap.mmap(self._fd, self.size)
            self.buf = np.frombuffer(self._mm, dtype=np.uint8)
            self._path = path

    def alloc(self, name: str, footprint: int, align: int = 128) -> np.ndarray:
        # idempotent by name: re-allocating an existing name returns the
        # SAME region (a restarted tile re-running on_boot must re-attach
        # its state, not leak a second copy) — with the footprint checked
        # so a size change can never silently hand back a stale region
        if name in self._allocs:
            off, fp = self._allocs[name]
            if fp != footprint:
                raise ValueError(
                    f"realloc of {name!r} with footprint {footprint} != "
                    f"existing {fp}"
                )
            return self.buf[off : off + fp]
        off = (self._off + align - 1) & ~(align - 1)
        if off + footprint > self.size:
            raise MemoryError(f"workspace full allocating {name!r}")
        self._off = off + footprint
        self._allocs[name] = (off, footprint)
        return self.buf[off : off + footprint]

    def view(self, name: str) -> np.ndarray:
        off, fp = self._allocs[name]
        return self.buf[off : off + fp]

    # -- attach from another process (named workspaces) -------------------

    def _dir_path(self) -> str:
        assert self.name is not None, "directory needs a named workspace"
        return f"{SHM_PREFIX}{self.name}.dir"

    def publish_directory(self, extra: dict | None = None) -> None:
        """Persist the alloc table (+ arbitrary JSON metadata) beside the
        workspace file so another process can attach() and find objects by
        name (the reference keeps the directory in the wksp itself,
        src/util/wksp; a JSON sidecar keeps the bump allocator trivial)."""
        import json

        doc = {
            "size": self.size,
            "allocs": {k: list(v) for k, v in self._allocs.items()},
            "extra": extra or {},
        }
        # write-then-rename: a concurrent attach (a monitor) never reads a
        # truncated in-place rewrite
        tmp = self._dir_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self._dir_path())

    @classmethod
    def attach(cls, name: str) -> tuple["Workspace", dict]:
        """Map an existing named workspace read-write and load its
        directory.  -> (workspace, extra metadata).  A workspace that was
        never published raises FileNotFoundError."""
        import json

        with open(f"{SHM_PREFIX}{name}.dir") as f:
            doc = json.load(f)
        ws = cls(doc["size"], name=name)
        ws._allocs = {k: tuple(v) for k, v in doc["allocs"].items()}
        ws._off = ws.size  # attached views must not allocate over live data
        return ws, doc["extra"]

    def close(self) -> None:
        if self._mm is not None:
            self.buf = None
            try:
                self._mm.close()
            except BufferError:
                # numpy views of the mapping are still alive somewhere; the
                # mapping stays valid until they are collected.  Unlinking
                # the backing file below is still safe (POSIX semantics).
                pass
            os.close(self._fd)
            self._mm = None

    def unlink(self) -> None:
        """Close, and remove the workspace file with its directory and its
        tiles' error sidecars."""
        self.close()
        if self.name is not None:
            import glob

            for path in (self._path, self._dir_path(), self._dir_path() + ".tmp"):
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass
            # per-tile sidecars (a process-runtime child's crash report)
            # share the workspace's prefix; a close never leaves them
            for path in glob.glob(f"{SHM_PREFIX}{self.name}.err_*"):
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass


class WkspArena:
    """A tile-private named sub-allocator INSIDE a workspace region,
    with its name table in the shared memory itself.

    The process-per-tile runtime needs tiles to allocate observable
    state (dedup's tcache, sink sig logs) from a CHILD process, but an
    attached Workspace cannot allocate (two children bumping the same
    host-side cursor would hand out overlapping regions).  Each tile
    instead gets one arena region, pre-sized by the topology from
    Tile.wksp_footprint(), and carves it with this allocator.  The
    name -> (offset, footprint) table lives in the region's header —
    single writer (the owning tile), torn-read tolerant — so the
    parent, monitors, and tests can resolve a tile's allocations by
    name without replaying the tile's allocation order.

    Same contracts as Workspace.alloc: idempotent by name with the
    footprint checked, so a restarted incarnation re-running on_boot
    REJOINS its regions (what lets dedup's tag cache survive a child
    kill) instead of leaking copies.
    """

    MAGIC = 0x46445441414E4552  # "FDTAANER"
    NAME_BYTES = 40
    _ENT_WORDS = 7  # 5 name words + off + fp
    _HDR_WORDS = 4  # magic, capacity, count, data_off(words)

    def __init__(
        self, mem_u8: np.ndarray, max_entries: int = 64,
        join: bool = False,
    ):
        """join=False: the OWNING tile — initialize the header if this
        is the region's first use (a restarted owner finds the magic
        and rejoins).  join=True: a READER (parent/monitor) — never
        write the header; raises if the owner has not initialized yet
        (a reader that auto-initialized would race the owner's header
        stores)."""
        self.mem = mem_u8
        self.words = mem_u8[: (len(mem_u8) // 8) * 8].view(np.uint64)
        if int(self.words[0]) == self.MAGIC:
            # live arena (attach, or a restarted owner rejoining)
            self.capacity = int(self.words[1])
        elif join:
            raise RuntimeError(
                "arena not initialized yet (owning tile has not booted)"
            )
        else:
            self.capacity = max_entries
            self.words[1] = max_entries
            self.words[2] = 0
            self.words[3] = self._HDR_WORDS + max_entries * self._ENT_WORDS
            # magic last: an attacher that sees it sees a full header
            self.words[0] = np.uint64(self.MAGIC)
        self._data0 = int(self.words[3]) * 8

    @classmethod
    def footprint(cls, data_bytes: int, max_entries: int = 64) -> int:
        """Region size for `data_bytes` of payload: header + name table
        + payload + per-alloc alignment slack."""
        hdr = (cls._HDR_WORDS + max_entries * cls._ENT_WORDS) * 8
        return hdr + int(data_bytes) + 128 * max_entries

    def _entry(self, i: int) -> tuple[str, int, int]:
        base = self._HDR_WORDS + i * self._ENT_WORDS
        raw = self.words[base : base + 5].tobytes()
        name = raw.rstrip(b"\0").decode("utf-8", "replace")
        return name, int(self.words[base + 5]), int(self.words[base + 6])

    def names(self) -> list[str]:
        return [self._entry(i)[0] for i in range(int(self.words[2]))]

    def alloc(self, name: str, footprint: int, align: int = 128) -> np.ndarray:
        enc = name.encode()
        if len(enc) > self.NAME_BYTES:
            raise ValueError(f"arena alloc name too long: {name!r}")
        n = int(self.words[2])
        off_end = self._data0
        for i in range(n):
            nm, off, fp = self._entry(i)
            if nm == name:
                if fp != footprint:
                    raise ValueError(
                        f"arena realloc of {name!r} with footprint "
                        f"{footprint} != existing {fp}"
                    )
                return self.mem[off : off + fp]
            off_end = max(off_end, off + fp)
        if n >= self.capacity:
            raise MemoryError(f"arena name table full allocating {name!r}")
        off = (off_end + align - 1) & ~(align - 1)
        if off + footprint > len(self.mem):
            raise MemoryError(
                f"arena full allocating {name!r} ({footprint}B; "
                f"did the tile's wksp_footprint() under-report?)"
            )
        base = self._HDR_WORDS + n * self._ENT_WORDS
        self.words[base : base + 5] = np.frombuffer(
            enc.ljust(self.NAME_BYTES, b"\0"), np.uint64
        )
        self.words[base + 5] = off
        self.words[base + 6] = footprint
        # count last (release order): a reader never sees a half-written
        # entry as live
        self.words[2] = np.uint64(n + 1)
        return self.mem[off : off + footprint]

    def view(self, name: str) -> np.ndarray:
        for i in range(int(self.words[2])):
            nm, off, fp = self._entry(i)
            if nm == name:
                return self.mem[off : off + fp]
        raise KeyError(name)


# ---------------------------------------------------------------------------
# mcache


class MCache:
    """Single-producer multi-consumer frag-metadata ring."""

    def __init__(self, mem: np.ndarray, depth: int, seq0: int = 0, join: bool = False):
        self.mem = mem
        self.depth = depth
        if not join:
            if _lib.fdt_mcache_new(_ptr(mem), depth, seq0) != 0:
                raise ValueError(f"bad mcache depth {depth}")

    @staticmethod
    def footprint(depth: int) -> int:
        fp = _lib.fdt_mcache_footprint(depth)
        if fp == 0:
            raise ValueError(f"depth {depth} not a power of 2")
        return fp

    @classmethod
    def create(cls, wksp: Workspace, name: str, depth: int, seq0: int = 0) -> "MCache":
        return cls(wksp.alloc(name, cls.footprint(depth)), depth, seq0)

    def seq0_query(self) -> int:
        return _lib.fdt_mcache_seq0(_ptr(self.mem))

    def seq_query(self) -> int:
        return _lib.fdt_mcache_seq_query(_ptr(self.mem))

    def seq_advance(self, seq: int) -> None:
        """Restart-only cursor repair — see producer_rejoin."""
        _lib.fdt_mcache_seq_advance(_ptr(self.mem), seq)

    def publish(
        self,
        seq: int,
        sig: int,
        chunk: int = 0,
        sz: int = 0,
        ctl: int = CTL_SOM | CTL_EOM,
        tsorig: int = 0,
        tspub: int = 0,
    ) -> None:
        _lib.fdt_mcache_publish(_ptr(self.mem), seq, sig, chunk, sz, ctl, tsorig, tspub)

    def poll(self, seq_expect: int):
        """Returns (rc, frag, seq_now): rc 0=ok, -1=empty, 1=overrun."""
        out = np.zeros(1, dtype=FRAG_DTYPE)
        seq_now = ct.c_uint64(0)
        rc = _lib.fdt_mcache_poll(
            _ptr(self.mem), seq_expect, out.ctypes.data, ct.byref(seq_now)
        )
        return rc, (out[0] if rc == 0 else None), seq_now.value

    def drain(self, seq: int, max_frags: int):
        """Batch-consume. Returns (frags ndarray, new_seq, n_overrun)."""
        out = np.zeros(max_frags, dtype=FRAG_DTYPE)
        seq_io = ct.c_uint64(seq)
        ovr = ct.c_uint64(0)
        n = _lib.fdt_mcache_drain(
            _ptr(self.mem), ct.byref(seq_io), max_frags, out.ctypes.data, ct.byref(ovr)
        )
        return out[:n], seq_io.value, ovr.value

    def publish_batch(
        self,
        seq0: int,
        sigs: np.ndarray,
        chunks: np.ndarray | None = None,
        szs: np.ndarray | None = None,
        ctls: np.ndarray | None = None,
        tspub: int = 0,
        tsorigs: np.ndarray | None = None,
    ) -> int:
        """Publish len(sigs) frags at consecutive seqs; returns the new seq.

        tsorigs carries per-frag origin timestamps end to end (latency
        observability); None stamps tsorig = tspub (this tile is the
        origin)."""
        sigs = np.ascontiguousarray(sigs, dtype=np.uint64)
        # converted copies must stay referenced until the native call returns
        chunks = None if chunks is None else np.ascontiguousarray(chunks, np.uint32)
        szs = None if szs is None else np.ascontiguousarray(szs, np.uint16)
        ctls = None if ctls is None else np.ascontiguousarray(ctls, np.uint16)
        tsorigs = (
            None if tsorigs is None
            else np.ascontiguousarray(tsorigs, np.uint32)
        )
        return _lib.fdt_mcache_publish_batch(
            _ptr(self.mem),
            seq0,
            sigs.ctypes.data,
            None if chunks is None else chunks.ctypes.data,
            None if szs is None else szs.ctypes.data,
            None if ctls is None else ctls.ctypes.data,
            None if tsorigs is None else tsorigs.ctypes.data,
            tspub,
            len(sigs),
        )


# ---------------------------------------------------------------------------
# dcache


class DCache:
    """Chunk-addressed payload region with the compact ring discipline."""

    def __init__(self, mem: np.ndarray, mtu: int, depth: int):
        self.mem = mem
        self.mtu = mtu
        self.depth = depth
        self.wmark_chunks = len(mem) // CHUNK_SZ
        #: producer cursor (chunk index of the next write)
        self.chunk = 0

    @staticmethod
    def footprint(mtu: int, depth: int) -> int:
        return _lib.fdt_dcache_footprint(mtu, depth)

    @classmethod
    def create(cls, wksp: Workspace, name: str, mtu: int, depth: int) -> "DCache":
        return cls(wksp.alloc(name, cls.footprint(mtu, depth), align=CHUNK_SZ), mtu, depth)

    def write(self, payload: np.ndarray) -> int:
        """Producer: copy payload in at the cursor, return its chunk idx."""
        sz = len(payload)
        assert sz <= self.mtu
        off = self.chunk * CHUNK_SZ
        self.mem[off : off + sz] = payload
        chunk = self.chunk
        self.chunk = _lib.fdt_dcache_compact_next(
            self.chunk, sz, self.mtu, self.wmark_chunks
        )
        return chunk

    def read(self, chunk: int, sz: int) -> np.ndarray:
        off = chunk * CHUNK_SZ
        return self.mem[off : off + sz]

    def read_batch(self, chunks: np.ndarray, szs: np.ndarray, width: int) -> np.ndarray:
        """Gather payloads into a dense (n, width) u8 matrix (zero-padded) —
        the shape the verify tile expands into lanes.  One native call."""
        chunks = np.ascontiguousarray(chunks, dtype=np.uint32)
        szs = np.ascontiguousarray(szs, dtype=np.uint16)
        n = len(chunks)
        out = np.empty((n, width), dtype=np.uint8)
        _lib.fdt_dcache_gather(
            _ptr(self.mem),
            chunks.ctypes.data,
            szs.ctypes.data,
            n,
            width,
            out.ctypes.data,
        )
        return out

    def write_batch(self, rows: np.ndarray, szs: np.ndarray) -> np.ndarray:
        """Producer-side dual of read_batch: scatter n payloads (rows of a
        dense (n, width) u8 matrix, row i holding szs[i] live bytes) into
        the dcache at the cursor.  Returns the chunk index of each payload.
        One native call."""
        rows = np.ascontiguousarray(rows, dtype=np.uint8)
        szs = np.ascontiguousarray(szs, dtype=np.uint16)
        n, width = rows.shape
        if len(szs) and int(szs.max()) > min(self.mtu, width):
            # a sz beyond the row width would publish a frag whose tail the
            # consumer reads as stale dcache bytes — reject loudly
            raise ValueError(
                f"payload sz {int(szs.max())} exceeds "
                f"min(dcache mtu {self.mtu}, row width {width})"
            )
        out_chunks = np.empty(n, dtype=np.uint32)
        chunk_io = ct.c_uint64(self.chunk)
        _lib.fdt_dcache_scatter(
            _ptr(self.mem),
            ct.byref(chunk_io),
            self.mtu,
            self.wmark_chunks,
            rows.ctypes.data,
            szs.ctypes.data,
            n,
            width,
            out_chunks.ctypes.data,
        )
        self.chunk = chunk_io.value
        return out_chunks


# ---------------------------------------------------------------------------
# fseq / fctl / cnc


class FSeq:
    def __init__(self, mem: np.ndarray, seq0: int = 0, join: bool = False):
        self.mem = mem
        if not join:
            _lib.fdt_fseq_new(_ptr(mem), seq0)

    @staticmethod
    def footprint() -> int:
        return _lib.fdt_fseq_footprint()

    @classmethod
    def create(cls, wksp: Workspace, name: str, seq0: int = 0) -> "FSeq":
        return cls(wksp.alloc(name, cls.footprint(), align=64), seq0)

    def query(self) -> int:
        return _lib.fdt_fseq_query(_ptr(self.mem))

    def update(self, seq: int) -> None:
        _lib.fdt_fseq_update(_ptr(self.mem), seq)

    def diag(self, idx: int) -> int:
        return _lib.fdt_fseq_diag_query(_ptr(self.mem), idx)

    def diag_add(self, idx: int, delta: int) -> None:
        _lib.fdt_fseq_diag_add(_ptr(self.mem), idx, delta)


def cr_avail(seq_prod: int, seq_cons_min: int, cr_max: int) -> int:
    # pure function of its arguments (no shared-memory access), but routed
    # through the hook so the checker can trace credit decisions and the
    # mutant corpus can fault them (credit-leak)
    return _lib.fdt_fctl_cr_avail(seq_prod, seq_cons_min, cr_max)


def consumer_rejoin(
    mcache: "MCache", fseq: "FSeq", *, reliable: bool = True, replay: int = 0
) -> tuple[int, int]:
    """Resync point for a consumer rejoining a ring after a crash.
    Returns (seq, skipped).

    Reliable links resume at the published fseq — the producer's credit
    gate guarantees everything from there forward is still in the ring —
    optionally REWOUND by up to `replay` frags (clamped to the oldest
    frag the ring still holds).  Replay gives at-least-once delivery
    across a restart: frags the dead incarnation consumed but never
    forwarded are re-seen, and a downstream dedup stage (whose tag cache
    survives restarts, tiles/dedup.py) collapses the re-delivery back to
    exactly-once.

    Unreliable links jump to the producer's head; the gap is returned as
    `skipped` for the caller to account as overrun_frags (the same
    book-keeping an overrun during normal operation gets).

    All arithmetic is wrap-safe mod 2^64 (a model-checker finding): the old
    plain-int min/max resumed a reliable consumer at the producer's
    wrapped-to-tiny head instead of the consumer's own fseq when the ring
    crossed 2^64 (silent frag loss on a reliable link), and the replay
    rewind could land before the ring's seq0 where the init lines'
    "ancient" seq marks alias real seqs and poll would validate garbage."""
    prod = mcache.seq_query()
    last = fseq.query()
    if not reliable:
        return prod, max(seq_diff(prod, last), 0)
    oldest = seq_max(seq_u64(prod - mcache.depth), mcache.seq0_query())
    seq = seq_max(seq_u64(seq_min(last, prod) - max(replay, 0)), oldest)
    return seq, 0


def producer_rejoin(mcache: "MCache") -> int:
    """Resync point for a producer rejoining its ring after a crash: the
    mcache's own published cursor (fdt_mcache_seq_query reads the seq the
    last publish advanced to), so the new incarnation continues the
    sequence instead of overwriting live frags from seq 0.

    A crash can land BETWEEN a publish's line-seq store and its seq_prod
    advance (a model-checker finding: seen as a spurious reliable-consumer
    overrun).  The line for seq_prod then already carries its
    final seq and consumers may have consumed it — re-publishing it would
    invalidate a live line under a concurrent consumer's speculative
    copy.  Recovery completes the interrupted publish instead: advance
    the cursor past every already-published line."""
    seq = mcache.seq_query()
    while True:
        rc, _frag, _now = mcache.poll(seq)
        if rc != 0:
            return seq
        seq = seq_u64(seq + 1)
        mcache.seq_advance(seq)


CNC_BOOT, CNC_RUN, CNC_HALT, CNC_FAIL = 0, 1, 2, 3


class CNC:
    def __init__(self, mem: np.ndarray, join: bool = False):
        self.mem = mem
        if not join:
            _lib.fdt_cnc_new(_ptr(mem))

    @staticmethod
    def footprint() -> int:
        return _lib.fdt_cnc_footprint()

    @classmethod
    def create(cls, wksp: Workspace, name: str) -> "CNC":
        return cls(wksp.alloc(name, cls.footprint(), align=64))

    def signal_query(self) -> int:
        return _lib.fdt_cnc_signal_query(_ptr(self.mem))

    def signal(self, sig: int) -> None:
        _lib.fdt_cnc_signal(_ptr(self.mem), sig)

    def heartbeat(self, now: int) -> None:
        _lib.fdt_cnc_heartbeat(_ptr(self.mem), now)

    def heartbeat_query(self) -> int:
        return _lib.fdt_cnc_heartbeat_query(_ptr(self.mem))


# ---------------------------------------------------------------------------
# tcache


class TCache:
    """Dedup tag cache: remembers the most recent `depth` unique tags."""

    def __init__(self, mem: np.ndarray, depth: int, map_cnt: int, join: bool = False):
        self.mem = mem
        self.depth = depth
        if not join:
            if _lib.fdt_tcache_new(_ptr(mem), depth, map_cnt) != 0:
                raise ValueError(f"bad tcache geometry {depth}/{map_cnt}")

    @staticmethod
    def map_cnt_for(depth: int) -> int:
        m = 1
        while m < 2 * depth + 1:
            m <<= 1
        return m

    @staticmethod
    def footprint(depth: int, map_cnt: int | None = None) -> int:
        map_cnt = map_cnt or TCache.map_cnt_for(depth)
        fp = _lib.fdt_tcache_footprint(depth, map_cnt)
        if fp == 0:
            raise ValueError(f"bad tcache geometry {depth}/{map_cnt}")
        return fp

    @classmethod
    def create(cls, wksp: Workspace, name: str, depth: int) -> "TCache":
        map_cnt = cls.map_cnt_for(depth)
        return cls(wksp.alloc(name, cls.footprint(depth, map_cnt)), depth, map_cnt)

    def dedup(self, tags: np.ndarray) -> np.ndarray:
        """Query+insert a batch; returns bool mask of duplicates."""
        tags = np.ascontiguousarray(tags, dtype=np.uint64)
        is_dup = np.zeros(len(tags), dtype=np.uint8)
        _lib.fdt_tcache_dedup(
            _ptr(self.mem), tags.ctypes.data, len(tags), is_dup.ctypes.data
        )
        return is_dup.astype(bool)

    def dedup_j(self, tags: np.ndarray, jnl: np.ndarray) -> np.ndarray:
        """dedup() with a crash journal: every tag about to be inserted
        is appended to `jnl` (u64 words: [0] phase / [1] seq0 — caller
        owned, [2] count, [3] overflow, tags from [4]) BEFORE the
        insert, so a consumer killed between insert and publish can
        amnesty the replay instead of losing the batch (tiles/dedup.py
        exactly-once discipline)."""
        tags = np.ascontiguousarray(tags, dtype=np.uint64)
        is_dup = np.zeros(len(tags), dtype=np.uint8)
        _lib.fdt_tcache_dedup_j(
            _ptr(self.mem), tags.ctypes.data, len(tags),
            is_dup.ctypes.data, jnl.ctypes.data, len(jnl) - 4,
        )
        return is_dup.astype(bool)

    def query(self, tag: int) -> bool:
        return bool(_lib.fdt_tcache_query(_ptr(self.mem), tag))

    def reset(self) -> None:
        _lib.fdt_tcache_reset(_ptr(self.mem))


def trace_now() -> int:
    """One compressed µs timestamp from the NATIVE clock
    (fdt_trace.c fdt_trace_now) — the same CLOCK_MONOTONIC µs-mod-2^32
    domain as disco.mux.now_ts, so native and Python stamps interleave
    on one clock."""
    return int(_lib.fdt_trace_now())


def trace_ts_diff(a: int, b: int) -> int:
    """The C restatement of disco.mux.ts_diff (wrap-safe signed µs
    distance on the u32 ring) — exported for the differential
    wrap-boundary test."""
    return int(_lib.fdt_trace_ts_diff(a & 0xFFFFFFFF, b & 0xFFFFFFFF))


def trace_hist_sample(hist_addr: int, nb: int, value: int) -> None:
    """One native log2-hist sample with Metrics.hist_sample's exact
    bucketing, written at `hist_addr` (a hist's first bucket word, e.g.
    disco.metrics.Metrics.hist_ref)."""
    _lib.fdt_trace_hist_sample(hist_addr, nb, int(value))


def trace_span(ring_words: np.ndarray, kind: int, link: int = 0,
               aux16: int = 0, ts: int = 0, seq: int = 0, sig: int = 0,
               aux64: int = 0) -> None:
    """One native span event into a SpanRing's u64 words —
    byte-compatible with disco.trace.Tracer.point."""
    _lib.fdt_trace_span(
        _ptr(ring_words), kind, link, aux16, ts & 0xFFFFFFFF,
        seq & (2**64 - 1), sig & (2**64 - 1), aux64 & (2**64 - 1),
    )


def trace_span_block(ring_words: np.ndarray, rows: np.ndarray) -> None:
    """Append a (k, 4) u64 event block natively — SpanRing.write_block's
    reserve→store→commit discipline from C."""
    rows = np.ascontiguousarray(rows, np.uint64)
    _lib.fdt_trace_span_block(_ptr(ring_words), rows.ctypes.data, len(rows))


def trace_read_clock(block: np.ndarray) -> int:
    """Read an armed trace block's clock (injected (value, step) pair
    when configured, the native monotonic clock otherwise)."""
    return int(_lib.fdt_trace_read_clock(_ptr(block)))




# ---------------------------------------------------------------------------
# stem: GIL-released native inner loop for data-plane tiles
#
# One fdt_stem_run call drains a tile's in-mcaches, dispatches the frags
# to a registered native handler (dedup / pack / poh / shred), publishes
# to the out mcaches/dcaches and updates fseqs/credits — Python regains
# control only at the burst boundary (tango/native/fdt_stem.h).  The run
# loop (disco/mux.py) owns when the stem runs; tiles describe their
# handler with a StemSpec (Tile.native_handler).

#: handler ids (fdt_stem.h FDT_STEM_H_*, the JAX package's numbering)
STEM_H_DEDUP, STEM_H_BANK, STEM_H_PACK = 1, 2, 3
STEM_H_POH, STEM_H_SHRED, STEM_H_NET = 4, 5, 6

#: after-credit hook ids (fdt_stem.h FDT_STEM_AC_*): invoked once per
#: fdt_stem_run call at the burst boundary — the native analog of the
#: Python loop's tile.after_credit slot.
STEM_AC_PACK, STEM_AC_POH, STEM_AC_SHRED, STEM_AC_NET = 1, 2, 3, 4

#: the handler and hook ids this build's fdt_stem_run dispatches
STEM_HANDLERS = (STEM_H_DEDUP, STEM_H_BANK, STEM_H_PACK, STEM_H_POH,
                 STEM_H_SHRED, STEM_H_NET)
STEM_HOOKS = (STEM_AC_PACK, STEM_AC_POH, STEM_AC_SHRED, STEM_AC_NET)

#: stem flags (cfg word 13): manual-credit tile — skip the global
#: credit gate; every publish happens in the after-credit hook behind
#: that ring's OWN cr_avail (the Python manual_credits contract)
STEM_F_MANUAL = 1

#: run statuses (fdt_stem.h FDT_STEM_*)
STEM_IDLE, STEM_BUDGET, STEM_PYTHON, STEM_BP = 0, 1, 2, 3

#: status_in sentinel: the PYTHON handback came from the after-credit
#: hook (block-boundary end_block), not a pending frag
STEM_IN_AC = 0xFFFFFFFF

#: fdt_pack_sched args-block word count (fdt_pack.h FDT_PACK_SS_*)
PACK_SCHED_WORDS = 50

_STEM_MAGIC = 0xF17EDA2CE57E0001
_STEM_WORDS = 256
_STEM_MAX_INS, _STEM_MAX_OUTS, _STEM_N_CTRS = 8, 8, 16
# cfg word indices (fdt_stem.c C_* / I_* / O_*); words 14/15 are reserved
_SC_MAGIC, _SC_HANDLER, _SC_NINS, _SC_NOUTS, _SC_CAP = 0, 1, 2, 3, 4
_SC_STATUS, _SC_STATUS_IN, _SC_ARGS, _SC_CTRS, _SC_TSPUB = 5, 6, 7, 8, 9
_SC_AC, _SC_AC_ARGS, _SC_FLAGS = 11, 12, 13
_SI0, _SI_STRIDE = 16, 12
# in-block word 5 is reserved (handlers address payloads by chunk)
(_SI_MCACHE, _SI_DCACHE, _SI_FSEQ, _SI_SEQ, _SI_FLAGS, _SI_RSVD,
 _SI_FRAGS, _SI_CONSUMED, _SI_BYTES, _SI_OVR) = range(10)
_SO0, _SO_STRIDE = 112, 16
(_SO_MCACHE, _SO_DCACHE, _SO_CHUNKP, _SO_MTU, _SO_WMARK, _SO_DEPTH,
 _SO_NFSEQ, _SO_FSEQ0) = range(8)
_SO_SEQ, _SO_PUBLISHED, _SO_BYTES, _SO_SIGS, _SO_TSORIGS = 11, 12, 13, 14, 15
#: in-burst trace block pointer (fdt_stem.h FDT_STEM_C_TRACE)
_SC_TRACE = 240

# in-burst trace block (fdt_trace.h) — word indices mirrored from C
_TR_MAGIC = 0xF17EDA2CE57E0002
_TR_WORDS = 128
(_TR_W_MAGIC, _TR_W_RING, _TR_W_SAMPLE, _TR_W_CLOCK, _TR_W_PUBROWS,
 _TR_W_PUBCAP, _TR_W_PUBCNT, _TR_W_TS, _TR_W_BATCH, _TR_W_BATCH_NB,
 _TR_W_INROWS) = range(11)
_TR_IN0, _TR_IN_STRIDE = 16, 8
(_TR_I_LINK, _TR_I_QWAIT, _TR_I_QWAIT_NB, _TR_I_E2E, _TR_I_E2E_NB,
 _TR_I_SVC, _TR_I_SVC_NB) = range(7)
_TR_OUT0 = 80


class StemSpec:
    """A tile's native-handler descriptor (Tile.native_handler).

    `args` is the handler's u64 argument block (raw pointers into
    scratch/state the tile owns — everything referenced must be kept
    alive via `keepalive`).  `counters` maps the stem's per-burst
    counter-scratch indices to this tile's metric names, applied ONCE
    per burst by the run loop.  `ready` (optional) gates the stem per
    iteration — a tile with host-side state the fast path cannot
    express yet (dedup's pending replay amnesty) returns False to stay
    on the Python loop until it drains.  `after_burst` (optional) runs
    after the deltas are applied (bank's deferred-commit cadence).  An id
    fdt_stem_run does not dispatch raises ValueError."""

    def __init__(self, handler: int, args: np.ndarray,
                 counters: tuple = (), keepalive: tuple = (),
                 native_ins: tuple | None = None,
                 ready=None, after_burst=None, cap: int | None = None,
                 ac_handler: int = 0, ac_args: np.ndarray | None = None,
                 manual: bool = False):
        if handler not in STEM_HANDLERS:
            raise ValueError(
                f"stem handler id {handler}: the port's stem carries "
                f"dedup, bank, pack, poh, shred and net only (ids "
                f"{STEM_HANDLERS})"
            )
        if ac_handler and ac_handler not in STEM_HOOKS:
            raise ValueError(
                f"stem after-credit hook id {ac_handler}: the port's stem "
                f"carries the pack, poh, shred and net hooks only {STEM_HOOKS}"
            )
        self.handler = handler
        self.args = args
        self.counters = counters
        self.keepalive = keepalive
        self.native_ins = native_ins
        self.ready = ready
        self.after_burst = after_burst
        #: max frags per burst the args block's scratch supports; the
        #: Stem clamps its own capacity to it (None = no tile bound)
        self.cap = cap
        #: native after-credit hook (STEM_AC_*, 0 = none): runs once per
        #: burst at its boundary; when set, the run loop SKIPS the
        #: Python after_credit except on PYTHON handbacks
        self.ac_handler = ac_handler
        self.ac_args = ac_args
        #: manual-credit stem (shred <-> keyguard ring cycle): the
        #: tile's handlers never publish from the frag path, so the
        #: stem skips its global credit gate and the after-credit hook
        #: gates each ring on its OWN cr_avail.  Required for the run
        #: loop to engage the stem on a Tile with manual_credits.
        self.manual = manual


class Stem:
    """Host handle on one tile's native stem config block.

    Builds the flat u64 config (fdt_stem.h layout) over the SAME
    mcache/dcache/fseq regions the tile's InLink/OutLink endpoints use,
    so the native and Python loops are interchangeable between bursts.
    Cursor words (in seqs, out seqs, dcache chunk cursors) are synced
    both ways around every run() call: InLink.seq / OutLink.seq are the
    u64 ring seqs and DCache.chunk the producer's next chunk index, which
    is what the cfg block's seq and chunk-cursor words hold."""

    def __init__(self, ins, outs, spec: StemSpec, cap: int = 4096):
        if len(ins) > _STEM_MAX_INS or len(outs) > _STEM_MAX_OUTS:
            raise ValueError(
                f"stem supports <= {_STEM_MAX_INS} ins / "
                f"{_STEM_MAX_OUTS} outs (got {len(ins)}/{len(outs)})"
            )
        for o in outs:
            if len(o.consumer_fseqs) > 4:
                raise ValueError(
                    f"stem out {o.name!r}: > 4 reliable consumers"
                )
        if int(_lib.fdt_stem_cfg_words()) != _STEM_WORDS:
            raise RuntimeError("fdt_stem.h's cfg block size drifted")
        self.ins = list(ins)
        self.outs = list(outs)
        self.spec = spec
        if spec.cap is not None:
            cap = min(int(cap), int(spec.cap))
        self.cap = int(cap)
        w = self._w = np.zeros(_STEM_WORDS, np.uint64)
        self._ctrs = np.zeros(_STEM_N_CTRS, np.uint64)
        self._in_frags = [np.zeros(self.cap, FRAG_DTYPE) for _ in self.ins]
        self._out_sigs = [np.zeros(self.cap, np.uint64) for _ in self.outs]
        self._out_tsorigs = [
            np.zeros(self.cap, np.uint32) for _ in self.outs
        ]
        #: host-side chunk-cursor words of the outs' dcaches, synced with
        #: DCache.chunk around run()
        self._cursors: list[np.ndarray | None] = []
        native = (
            set(range(len(self.ins)))
            if spec.native_ins is None
            else set(spec.native_ins)
        )
        w[_SC_MAGIC] = _STEM_MAGIC
        w[_SC_HANDLER] = spec.handler
        w[_SC_NINS] = len(self.ins)
        w[_SC_NOUTS] = len(self.outs)
        w[_SC_CAP] = self.cap
        w[_SC_ARGS] = _ptr(spec.args)
        w[_SC_CTRS] = _ptr(self._ctrs)
        if spec.ac_handler:
            w[_SC_AC] = spec.ac_handler
            w[_SC_AC_ARGS] = _ptr(spec.ac_args)
        if spec.manual:
            w[_SC_FLAGS] = STEM_F_MANUAL
        for i, il in enumerate(self.ins):
            b = _SI0 + i * _SI_STRIDE
            w[b + _SI_MCACHE] = _ptr(il.mcache.mem)
            w[b + _SI_DCACHE] = (
                _ptr(il.dcache.mem) if il.dcache is not None else 0
            )
            w[b + _SI_FSEQ] = _ptr(il.fseq.mem)
            w[b + _SI_FLAGS] = 1 if i in native else 0
            w[b + _SI_FRAGS] = self._in_frags[i].ctypes.data
        for o, ol in enumerate(self.outs):
            b = _SO0 + o * _SO_STRIDE
            w[b + _SO_MCACHE] = _ptr(ol.mcache.mem)
            dc = ol.dcache
            if dc is not None:
                w[b + _SO_DCACHE] = _ptr(dc.mem)
                w[b + _SO_MTU] = dc.mtu
                w[b + _SO_WMARK] = dc.wmark_chunks
                cur = np.zeros(1, np.uint64)
                w[b + _SO_CHUNKP] = _ptr(cur)
                self._cursors.append(cur)
            else:
                self._cursors.append(None)
            w[b + _SO_DEPTH] = ol.mcache.depth
            w[b + _SO_NFSEQ] = len(ol.consumer_fseqs)
            for j, fs in enumerate(ol.consumer_fseqs[:4]):
                w[b + _SO_FSEQ0 + j] = _ptr(fs.mem)
            w[b + _SO_SIGS] = self._out_sigs[o].ctypes.data
            w[b + _SO_TSORIGS] = self._out_tsorigs[o].ctypes.data

    def arm_trace(
        self,
        *,
        ring_addr: int = 0,
        sample: int = 1,
        in_rows=(),
        out_links=(),
        batch_hist: tuple[int, int] | None = None,
        clock: np.ndarray | None = None,
        keepalive: tuple = (),
    ) -> None:
        """Arm the in-burst trace block (tango/native/fdt_trace.h) on
        this stem: per-frag compressed timestamps at drain and publish
        time, native qwait/svc/e2e (+batch_sz) hist updates straight
        into the tile's metrics words, and native span emission
        byte-compatible with disco/trace.py's SpanRing.

        ring_addr: the SpanRing's u64 words base address (0 = span
        emission off); sample: the tracer's 1-in-N sig sampling.
        in_rows: per in-link (link_id, qwait, e2e, svc) where each hist
        is (first-bucket-word address, bucket count) or None.
        batch_hist: the tile's batch_sz hist ref.  clock: a u64[2]
        (value, step) injected-clock array for a deterministic test —
        None reads CLOCK_MONOTONIC.  Everything addressed must stay
        alive; pass owners via keepalive."""
        if int(_lib.fdt_trace_words()) != _TR_WORDS:
            raise RuntimeError("fdt_trace.h's block size drifted")
        t = self._trace_block = np.zeros(_TR_WORDS, np.uint64)
        # publish spans can exceed one row per consumed frag (PoH emits a
        # tick and slot boundaries per hook firing), so size the buffer
        # at 2x cap; overflow flushes early rather than drops
        self._trace_pub = np.zeros((2 * self.cap + 64, 4), np.uint64)
        self._trace_in_rows = np.zeros((self.cap, 4), np.uint64)
        self._trace_ts = np.zeros(self.cap, np.uint32)
        self._trace_keep = tuple(keepalive)
        t[_TR_W_MAGIC] = _TR_MAGIC
        t[_TR_W_RING] = ring_addr
        t[_TR_W_SAMPLE] = max(int(sample), 1)
        if clock is not None:
            clock = np.ascontiguousarray(clock, np.uint64)
            if len(clock) < 2:
                raise ValueError("an injected clock is (value, step)")
            self._trace_clock = clock
            t[_TR_W_CLOCK] = clock.ctypes.data
        t[_TR_W_PUBROWS] = self._trace_pub.ctypes.data
        t[_TR_W_PUBCAP] = len(self._trace_pub)
        t[_TR_W_TS] = self._trace_ts.ctypes.data
        t[_TR_W_INROWS] = self._trace_in_rows.ctypes.data
        if batch_hist is not None:
            t[_TR_W_BATCH] = batch_hist[0]
            t[_TR_W_BATCH_NB] = batch_hist[1]
        for i, row in enumerate(in_rows[: len(self.ins)]):
            b = _TR_IN0 + i * _TR_IN_STRIDE
            link_id, hq, he, hs = row
            t[b + _TR_I_LINK] = link_id
            if hq is not None:
                t[b + _TR_I_QWAIT], t[b + _TR_I_QWAIT_NB] = hq
            if he is not None:
                t[b + _TR_I_E2E], t[b + _TR_I_E2E_NB] = he
            if hs is not None:
                t[b + _TR_I_SVC], t[b + _TR_I_SVC_NB] = hs
        for o, lid in enumerate(list(out_links)[: len(self.outs)]):
            t[_TR_OUT0 + o] = lid
        self._w[_SC_TRACE] = t.ctypes.data

    def run(self, budget: int, tspub: int) -> tuple[int, int, int]:
        """One GIL-released burst: up to `budget` frags drained,
        handled and published natively.  Returns (consumed, status,
        status_in); raises if fdt_stem_run rejects its config block."""
        w = self._w
        for i, il in enumerate(self.ins):
            w[_SI0 + i * _SI_STRIDE + _SI_SEQ] = seq_u64(il.seq)
        for o, ol in enumerate(self.outs):
            b = _SO0 + o * _SO_STRIDE
            w[b + _SO_SEQ] = seq_u64(ol.seq)
            cur = self._cursors[o]
            if cur is not None:
                cur[0] = ol.dcache.chunk
        w[_SC_TSPUB] = tspub & 0xFFFFFFFF
        n = _lib.fdt_stem_run(_ptr(self._w), budget)
        if n < 0:
            raise RuntimeError("fdt_stem_run rejected its config block")
        for i, il in enumerate(self.ins):
            il.seq = int(w[_SI0 + i * _SI_STRIDE + _SI_SEQ])
        for o, ol in enumerate(self.outs):
            b = _SO0 + o * _SO_STRIDE
            ol.seq = int(w[b + _SO_SEQ])
            cur = self._cursors[o]
            if cur is not None:
                ol.dcache.chunk = int(cur[0])
        return int(n), int(w[_SC_STATUS]), int(w[_SC_STATUS_IN])

    # -- per-burst readbacks (applied once per burst by the run loop) --

    def consumed(self, i: int) -> int:
        return int(self._w[_SI0 + i * _SI_STRIDE + _SI_CONSUMED])

    def in_bytes(self, i: int) -> int:
        return int(self._w[_SI0 + i * _SI_STRIDE + _SI_BYTES])

    def overruns(self, i: int) -> int:
        return int(self._w[_SI0 + i * _SI_STRIDE + _SI_OVR])

    def frags(self, i: int) -> np.ndarray:
        return self._in_frags[i][: self.consumed(i)]

    def published(self, o: int) -> int:
        return int(self._w[_SO0 + o * _SO_STRIDE + _SO_PUBLISHED])

    def out_bytes(self, o: int) -> int:
        return int(self._w[_SO0 + o * _SO_STRIDE + _SO_BYTES])

    def out_sigs(self, o: int) -> np.ndarray:
        return self._out_sigs[o][: self.published(o)]

    def out_tsorigs(self, o: int) -> np.ndarray:
        return self._out_tsorigs[o][: self.published(o)]

    @property
    def counters(self) -> np.ndarray:
        return self._ctrs


# ---------------------------------------------------------------------------
# version-handshake digest
#
# A mixed-version topology is ring-safe iff both incarnations agree on
# every contract the /dev/shm rings encode: the native symbol set (the
# .so's ABI sidecar), the ctypes sigs table, the ring/stem layout
# constants, the stem cfg-word map, and the emit-body signatures.
# abi_digest() folds all of that into one u64 (never 0 — 0 is the
# uninitialized-word sentinel); disco/handshake.py stores it in a
# per-workspace shm word at build() and every joining incarnation
# compares before binding a single ring.  Lazy + cached: the cfg-word
# constants below are module-level and must exist before collection.

_ABI_CACHE: dict | None = None

#: module-global int constants folded into the digest's layout/cfg-word
#: components — any rename, renumber, add, or remove changes the digest
_ABI_CONST_PREFIXES = (
    "CHUNK_SZ", "CTL_", "STEM_", "PACK_SCHED_WORDS",
    "_STEM_", "_SC_", "_SI", "_SO", "_TR_",
)

#: the emit-body surface: the native calls a handler body may make
#: mid-burst (fdt_stem.h) — split out of "sigs" so the component diff
#: in a refusal incident names the half that moved
_ABI_EMIT_SYMBOLS = ("fdt_stem_out_emit", "fdt_stem_out_emit_at",
                     "fdt_stem_out_cr")


def _ct_name(t) -> str:
    return "None" if t is None else getattr(t, "__name__", str(t))


def abi_components() -> dict:
    """The handshake digest's input document, canonical and
    JSON-stable.  Split by component so tests (and refused-join
    incident detail) can name WHICH contract moved."""
    global _ABI_CACHE
    if _ABI_CACHE is not None:
        return _ABI_CACHE
    if _LIB_SIGS is None:
        _lib.fdt_trace_words  # the first use builds and loads the library
    side = cbuild.read_sidecar(Path(_LIB_PATH))
    c_syms = (side or {}).get("symbols")
    if c_syms is None:
        # a library without its sidecar: parse this tree's sources
        c_syms = cbuild.abi_symbols(_NATIVE_SOURCES)
    sigs = {
        name: [_ct_name(res), [_ct_name(a) for a in args]]
        for name, (res, args) in (_LIB_SIGS or {}).items()
    }
    consts = {
        k: v
        for k, v in sorted(globals().items())
        if isinstance(v, int) and k.startswith(_ABI_CONST_PREFIXES)
    }
    _ABI_CACHE = {
        "c": list(c_syms),
        "sigs": sigs,
        "cfg_words": consts,
        "emit": {k: sigs[k] for k in _ABI_EMIT_SYMBOLS if k in sigs},
    }
    return _ABI_CACHE


def digest_of(components: dict) -> int:
    """Fold an abi_components()-shaped document into the nonzero u64
    handshake word value (exposed separately so tests can digest
    mutated documents)."""
    import hashlib
    import json as _json

    blob = _json.dumps(components, sort_keys=True).encode()
    return int.from_bytes(hashlib.sha256(blob).digest()[:8], "big") | 1


def abi_digest() -> int:
    """This incarnation's version-handshake word (see abi_components)."""
    return digest_of(abi_components())
