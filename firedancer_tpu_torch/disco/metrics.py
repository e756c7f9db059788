"""Shared-memory metrics regions, one per tile.

A copy of firedancer_tpu/disco/metrics.py, without the reader of its
SLO layer (`hist_frac_above`; not ported yet).

Reference model: src/disco/metrics/ — an XML schema compiled to typed
per-tile offset tables, written lock-free by the owning tile via
FD_MCNT_INC / FD_MGAUGE_SET / FD_MHIST_COPY macros and scraped by a
monitor/metric tile reading the same shared memory.

Here the schema is a plain Python object (no codegen step needed — Python
IS the config language), but the storage contract is the same: a flat u64
array in a workspace, single-writer, torn-read-tolerant, readable by any
process mapping the workspace.  Histograms use the reference's shape: 16
power-of-two buckets (src/util/hist/fd_histf.h) plus sum and count words.

NATIVE MIRROR: tango/native/fdt_trace.c's
fdt_trace_hist_sample re-states hist_sample's exact bucketing (bucket
floor(log2(max(v,1))) clamped to nb-1; sum += max(v,0); count += 1) so
the in-burst stem writes qwait/svc/e2e samples into the SAME hist words
this module lays out (see hist_ref) — shared format.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

HIST_BUCKETS = 16
#: wide log2 hists: 24 buckets + the same sum/count tail.  Bucket 23
#: covers [2^23, 2^24) so a µs-domain wide hist represents ~16.8 s
#: before clamping; the TOP bucket is the explicit overflow bucket
#: (values beyond the domain land there and percentiles interpolate
#: inside it with the documented 2x-span bias).  The 16-bucket domain
#: ends at 2^16 µs = 65.5 ms; the topology stores its per-link latency
#: hists wide so a tail past that stays representable.
WIDE_HIST_BUCKETS = 24
_HIST_WORDS = HIST_BUCKETS + 2  # buckets + sum + count

#: the per-device health/throughput row exported by device-pool tiles
#: (tiles/verify.py): queue depth, batches in flight, batches landed,
#: batches failed (errors + stalls), and a 0/1 degraded gauge
#: (quarantined / stalled / dead worker)
DEVICE_METRICS = ("depth", "inflight", "landed", "failed", "degraded")


def device_counters(
    n_devices: int, names: tuple[str, ...] = DEVICE_METRICS
) -> tuple[str, ...]:
    """Schema counters for an n-device pool: dev0_depth, dev0_inflight,
    ... dev{n-1}_degraded.  Kept here (not in the tile) so readers —
    app/monitor.py's health rows, tests — parse the same naming."""
    return tuple(
        f"dev{i}_{m}" for i in range(n_devices) for m in names
    )


def parse_device_counter(name: str) -> tuple[int, str] | None:
    """"dev3_landed" -> (3, "landed"); None for non-device counters."""
    if not name.startswith("dev"):
        return None
    head, _, metric = name.partition("_")
    if not metric or metric not in DEVICE_METRICS:
        return None
    try:
        return int(head[3:]), metric
    except ValueError:
        return None


def device_rows(counters: dict) -> dict[int, dict]:
    """Group a tile's counter snapshot into per-device health rows:
    {dev_idx: {metric: value}} for every dev{i}_* counter present."""
    out: dict[int, dict] = {}
    for name, v in counters.items():
        parsed = parse_device_counter(name)
        if parsed is not None:
            idx, metric = parsed
            out.setdefault(idx, {})[metric] = v
    return out


@dataclass(frozen=True)
class MetricsSchema:
    """Ordered metric names for one tile kind.

    counters: monotone u64 counts (also used for gauges via set()).
    hists: 16-bucket log2 histograms with sum/count.
    wide_hists: names (a subset of hists) stored with WIDE_HIST_BUCKETS
    buckets instead — a wider domain plus an explicit overflow bucket,
    for distributions (scheduler lag) whose tail outruns 2^16.  Layout-
    affecting: every reader of a region must use the SAME schema
    including this field (it rides the topology manifest).
    """

    counters: tuple[str, ...] = ()
    hists: tuple[str, ...] = ()
    wide_hists: tuple[str, ...] = ()

    def hist_buckets(self, name: str) -> int:
        return WIDE_HIST_BUCKETS if name in self.wide_hists else HIST_BUCKETS

    # every tile gets these on top of its own schema
    BASE_COUNTERS = (
        "in_frags",
        "in_bytes",
        "out_frags",
        "out_bytes",
        "overrun_frags",
        "backpressure_iters",
        "housekeep_iters",
        "loop_iters",
        # frags consumed through the native stem's GIL-released burst
        # loop (tango/native/fdt_stem.c) — always a subset of in_frags,
        # so stem_frags/in_frags is the native-coverage ratio a monitor
        # or bench can read straight off the tile
        "stem_frags",
        # 1 when this incarnation's run loop engaged a native stem (the
        # tile registered a handler under stem="native"), written at
        # boot by the tile itself.  Monitors key stem-coverage rows and
        # the pinned-to-Python alarm off it: a stem-CONFIGURED tile
        # whose py_frags advance while stem_frags sit flat has silently
        # lost native coverage (amnesty/fault pins), which was
        # previously invisible from outside.
        "stem_engaged",
        # the Python-side complements (the zero-Python steady-state
        # contract): frags the Python on_frags callback handled, and
        # Python after_credit invocations.  A fully native data-plane
        # tile shows both FLAT across a measured window while
        # stem_frags/microblocks advance.
        "py_frags",
        "py_credit",
        # supervision counters, written by disco/supervisor.py (distinct
        # slots from the tile's own, so the single-writer-per-word
        # discipline holds): crash/stall restarts, heartbeat deadline
        # misses, and the circuit-breaker latch (1 = tile degraded,
        # supervisor gave up restarting)
        "restarts",
        "hb_misses",
        "degraded",
    )
    #: loop phase durations are sampled every 16th iteration (reference:
    #: fd_mux.c histograms every loop phase via tickcount)
    BASE_HISTS = ("batch_sz", "loop_ns", "hk_ns", "frag_ns", "credit_ns")

    def with_base(self) -> "MetricsSchema":
        return MetricsSchema(
            counters=MetricsSchema.BASE_COUNTERS + tuple(self.counters),
            hists=MetricsSchema.BASE_HISTS + tuple(self.hists),
            wide_hists=tuple(self.wide_hists),
        )

    def footprint_words(self) -> int:
        return len(self.counters) + sum(
            self.hist_buckets(h) + 2 for h in self.hists
        )


@dataclass
class _Hist:
    base: int
    nb: int = HIST_BUCKETS


class Metrics:
    """A tile's metrics region: a u64 view into a workspace allocation."""

    def __init__(self, mem_u8: np.ndarray, schema: MetricsSchema):
        self.schema = schema
        n = schema.footprint_words()
        self.words = mem_u8[: n * 8].view(np.uint64)
        self._slot: dict[str, int] = {}
        off = 0
        for c in schema.counters:
            self._slot[c] = off
            off += 1
        self._hist: dict[str, _Hist] = {}
        for h in schema.hists:
            nb = schema.hist_buckets(h)
            self._hist[h] = _Hist(off, nb)
            off += nb + 2

    @staticmethod
    def footprint(schema: MetricsSchema) -> int:
        return schema.footprint_words() * 8

    # -- writer side (owning tile only) ----------------------------------

    def inc(self, name: str, v: int = 1) -> None:
        self.words[self._slot[name]] += np.uint64(v)

    def set(self, name: str, v: int) -> None:
        self.words[self._slot[name]] = np.uint64(v)

    def hist_sample(self, name: str, value: int) -> None:
        h = self._hist[name]
        b = min(max(int(value), 1).bit_length() - 1, h.nb - 1)
        w = self.words
        w[h.base + b] += np.uint64(1)
        w[h.base + h.nb] += np.uint64(max(int(value), 0))
        w[h.base + h.nb + 1] += np.uint64(1)

    def hist_sample_many(self, name: str, values: np.ndarray) -> None:
        h = self._hist[name]
        raw = np.asarray(values, dtype=np.int64)
        # bucketing floors at 1; the sum clamps negatives to 0, matching
        # hist_sample's max(value, 0) — NOT the raw values
        v = np.maximum(raw, 1)
        buckets = np.minimum(
            np.floor(np.log2(v)).astype(np.int64), h.nb - 1
        )
        counts = np.bincount(buckets, minlength=h.nb).astype(np.uint64)
        w = self.words
        w[h.base : h.base + h.nb] += counts
        w[h.base + h.nb] += np.uint64(int(np.maximum(raw, 0).sum()))
        w[h.base + h.nb + 1] += np.uint64(len(raw))

    def hist_ref(self, name: str) -> tuple[int, int]:
        """(address of the hist's first bucket word, bucket count) — the
        native in-burst trace emitter (tango/native/fdt_trace.c) updates
        the hist in place with hist_sample's exact bucketing, so native
        and Python samples land in ONE storage with one estimator."""
        h = self._hist[name]
        return int(self.words.ctypes.data) + h.base * 8, h.nb

    # -- reader side (any process) ---------------------------------------

    def counter(self, name: str) -> int:
        return int(self.words[self._slot[name]])

    def hist(self, name: str) -> dict:
        h = self._hist[name]
        w = self.words
        return {
            "buckets": w[h.base : h.base + h.nb].tolist(),
            "sum": int(w[h.base + h.nb]),
            "count": int(w[h.base + h.nb + 1]),
        }

    def read(self) -> dict:
        out = {c: self.counter(c) for c in self.schema.counters}
        out.update({h: self.hist(h) for h in self.schema.hists})
        return out


# ---------------------------------------------------------------------------
# percentile estimation over the 16-bucket log2 histograms
#
# Bucket b holds samples v with floor(log2(max(v, 1))) == b, i.e. bucket 0
# covers [0, 2) and bucket b covers [2^b, 2^(b+1)), with the top bucket
# clamped open-ended.  A percentile is estimated by walking the cumulative
# counts to the containing bucket and interpolating linearly inside it —
# the error is bounded by the bucket's 2x span, which is the resolution
# the storage format buys (the reference converts the same fd_histf
# buckets to approximate percentiles in fd_top).


def hist_percentile(h: dict, q: float) -> float:
    """Estimate the q-th percentile (q in [0, 100]) of a Metrics.hist()
    snapshot by log-bucket linear interpolation.  0.0 on an empty hist.

    Boundary contract:
      * empty hist / count <= 0 / no occupied bucket -> 0.0;
      * q is clamped into [0, 100]; q=0 returns the lower edge of the
        first occupied bucket (the min estimate), q=100 the upper edge
        of the last occupied one (the max estimate);
      * all mass in the overflow bucket interpolates inside
        [2^(nb-1), 2^nb] for the hist's own bucket count nb (16, or
        WIDE_HIST_BUCKETS for wide hists — the estimator works off
        len(buckets), so both widths share this code) — a finite
        estimate with the documented 2x-span bias for values beyond
        the top bucket;
      * torn snapshots (the regions are read lock-free, and windowed
        deltas of torn reads can even go negative per bucket) never
        push the walk past the occupied mass: negative bucket counts
        are treated as empty and the rank is clamped to the occupied
        total, so the estimate stays inside the last occupied bucket
        instead of jumping to the 2^HIST_BUCKETS sentinel."""
    buckets = h.get("buckets") or []
    count = h.get("count", 0)
    if count <= 0:
        return 0.0
    occupied = [(b, n) for b, n in enumerate(buckets) if n > 0]
    if not occupied:
        # count incremented before its bucket landed (torn read)
        return 0.0
    mass = sum(n for _, n in occupied)
    rank = (min(max(q, 0.0), 100.0) / 100.0) * min(count, mass)
    cum = 0
    for b, n in occupied:
        if cum + n >= rank:
            lo = 0.0 if b == 0 else float(1 << b)
            # the top bucket is open-ended; assume the same 2x
            # geometric span as the others (documented estimator bias
            # for distributions with mass beyond 2^HIST_BUCKETS)
            hi = float(1 << (b + 1))
            return lo + (hi - lo) * (max(rank - cum, 0.0) / n)
        cum += n
    # unreachable while rank <= mass; keep the clamp for safety
    b, n = occupied[-1]
    return float(1 << (b + 1))


def merge_hists(hs: list[dict]) -> dict:
    """Sum Metrics.hist() snapshots bucket-wise (counts, sums, and a
    buckets vector as long as the longest input) — the primitive behind
    profile aggregation (disco/profile.py)."""
    out = {"count": 0, "sum": 0, "buckets": []}
    for h in hs:
        out["count"] += h.get("count", 0)
        out["sum"] += h.get("sum", 0)
        bk = h.get("buckets", [])
        if len(bk) > len(out["buckets"]):
            out["buckets"] += [0] * (len(bk) - len(out["buckets"]))
        for i, n in enumerate(bk):
            out["buckets"][i] += n
    return out


def hist_delta(cur: dict, prev: dict | None) -> dict:
    """Windowed hist: cur - prev per bucket (both cumulative monotone
    snapshots of the same region).  No/empty prev -> cur unchanged
    (cumulative view).  Buckets are padded to the longer vector so a
    schema-extended snapshot diffs cleanly against an older one."""
    if not prev or not prev.get("count"):
        return cur
    cb, pb = cur.get("buckets", []), prev.get("buckets", [])
    n = max(len(cb), len(pb))
    return {
        "count": cur.get("count", 0) - prev.get("count", 0),
        "sum": cur.get("sum", 0) - prev.get("sum", 0),
        "buckets": [
            (cb[i] if i < len(cb) else 0) - (pb[i] if i < len(pb) else 0)
            for i in range(n)
        ],
    }
