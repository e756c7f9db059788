"""Python bindings for the port's native tango layer (fdt_tango.c).

A copy of firedancer_tpu/tango/rings.py, trimmed to what the thread
runtime needs: `Workspace`, `MCache`, `DCache`, `FSeq`, `CNC`, `TCache`,
`cr_avail`, the wrap-safe `seq_*` helpers, the rejoin helpers and the
native `trace_*` helpers.  The library is built from the port's own copies
of fdt_tango.c, fdt_sha512.c, fdt_trace.c and fdt_pack.c (tango/native/)
by utils/cbuild.py into the git-ignored _build/, at first use; `_load`
injects the SHA-512 tables and the pack cost model's constants into this
library's own statics.  The native
stem (`Stem`, `StemSpec`), the ABI digest and the process runtime's
workspace attach are not ported yet.

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
from ..utils.shaconst import H64, K64

# ---------------------------------------------------------------------------
# library load

_HERE = Path(__file__).parent

#: sources of the ring library, in link order
_NATIVE_SOURCES = [
    _HERE / "native" / "fdt_tango.c",
    _HERE / "native" / "fdt_sha512.c",
    _HERE / "native" / "fdt_trace.c",
    _HERE / "native" / "fdt_pack.c",
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


def _load() -> ct.CDLL:
    lib = ct.CDLL(str(cbuild.build("fdt_tango", _NATIVE_SOURCES)))
    u64, u32, u16, i32, i64, vp = (
        ct.c_uint64, ct.c_uint32, ct.c_uint16, ct.c_int, ct.c_int64,
        ct.c_void_p,
    )
    _bind(lib, {
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
    })
    # the SHA-512 constant tables are globals of THIS library (a second
    # copy of the ring library in the process keeps its own): inject them
    k = np.array(K64, dtype=np.uint64)
    h = np.array(H64, dtype=np.uint64)
    lib.fdt_sha512_init_consts(k.ctypes.data, h.ctypes.data)
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
        self.close()
        if self.name is not None:
            try:
                os.unlink(self._path)
            except FileNotFoundError:
                pass


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


