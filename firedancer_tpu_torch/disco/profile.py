"""Per-tile run-loop profiler: sampled wall/CPU attribution + GIL-wait.

A copy of firedancer_tpu/disco/profile.py, whole: `PHASES`,
`PROFILE_SCHEMA`, `TileProfiler`, `profile_row`, `aggregate` and
`render_rows`.

The run loop (disco/mux.py) histogram-samples phase WALL durations
1-in-16; this layer adds, on the same sampled iterations, the thread-CPU
clock (time.thread_time_ns) so wall - cpu decomposes into

    gil_wait = wall - cpu - voluntary_sleep

per phase: the time this tile's thread spent runnable but not running —
GIL contention plus OS scheduling (with fewer cores than runnable tile
threads or processes, the run queue's wait too) — which is the quantity
the process-per-tile runtime should drive toward zero.  A scheduler-lag
histogram (actual minus intended housekeeping firing time) captures the
same contention from the other side: how late the loop's time-based
cadence fires under interpreter load.  On the native stem a whole burst
is one GIL-released C call inside the frag phase; its thread CPU counts
as cpu, so the burst itself adds no gil_wait.

Storage: one Metrics region per tile (PROFILE_SCHEMA) in the topology
workspace ("profile_{tile}" alloc) — u64 accumulators + one wide log2
hist, single-writer (the tile's loop thread), torn-read tolerant,
mappable by monitors.  Because the state lives in workspace memory, the
same regions serve the thread and the process runtimes.

Cost when off: ctx.profiler is None and every hook in the loop is one
attribute check.  Cost when on: two thread_time_ns reads + a few u64
adds per SAMPLED iteration (1-in-16) plus two clock reads around idle
sleeps (which are idle by definition).
"""

from __future__ import annotations

from .metrics import Metrics, MetricsSchema, hist_percentile, merge_hists

#: loop phases the profiler attributes (wall + cpu per phase)
PHASES = ("frag", "hk", "credit")

PROFILE_SCHEMA = MetricsSchema(
    counters=(
        # whole sampled iterations
        "iter_wall_ns",
        "iter_cpu_ns",
        "iter_sleep_ns",
        "iter_samples",
        # per-phase attribution (sampled iterations only)
        "frag_wall_ns",
        "frag_cpu_ns",
        "hk_wall_ns",
        "hk_cpu_ns",
        "credit_wall_ns",
        "credit_cpu_ns",
        # backpressured sampled iterations (zero-credit stalls)
        "bp_wall_ns",
        "bp_samples",
        # every voluntary sleep (not just sampled): actual time slept
        "sleep_ns",
        "sleep_req_ns",
        "sleeps",
    ),
    hists=(
        #: actual - intended housekeeping firing time, µs: the loop's
        #: time-based cadence lag under GIL/scheduler contention
        "sched_lag_us",
    ),
    # sched-lag is a WIDE hist (metrics.WIDE_HIST_BUCKETS): the
    # 16-bucket domain ends at 2^16 µs, and the thread-vs-process
    # comparison needs a 100 ms-class lag AND a sub-ms one to be
    # representable in the same storage format, with the top bucket as
    # the explicit overflow bucket.
    wide_hists=("sched_lag_us",),
)


class TileProfiler:
    """Writer facade held on MuxCtx.profiler (tile loop thread only)."""

    __slots__ = ("m",)

    def __init__(self, metrics: Metrics):
        self.m = metrics

    # -- writer side (loop thread) ---------------------------------------

    def add_iter(self, wall_ns: int, cpu_ns: int, sleep_ns: int = 0) -> None:
        m = self.m
        m.inc("iter_wall_ns", max(wall_ns, 0))
        m.inc("iter_cpu_ns", max(cpu_ns, 0))
        if sleep_ns:
            m.inc("iter_sleep_ns", max(sleep_ns, 0))
        m.inc("iter_samples")

    def add_phase(self, phase: str, wall_ns: int, cpu_ns: int) -> None:
        m = self.m
        m.inc(f"{phase}_wall_ns", max(wall_ns, 0))
        m.inc(f"{phase}_cpu_ns", max(cpu_ns, 0))

    def add_bp(self, wall_ns: int) -> None:
        m = self.m
        m.inc("bp_wall_ns", max(wall_ns, 0))
        m.inc("bp_samples")

    def add_sleep(self, actual_ns: int, requested_ns: int) -> None:
        m = self.m
        m.inc("sleep_ns", max(actual_ns, 0))
        m.inc("sleep_req_ns", max(requested_ns, 0))
        m.inc("sleeps")

    def sched_lag(self, lag_ns: int) -> None:
        self.m.hist_sample("sched_lag_us", max(lag_ns, 0) // 1000)


# ---------------------------------------------------------------------------
# readers


def profile_row(m: Metrics) -> dict:
    """One tile's profile summary from its (possibly live) region.

    gil_wait_frac = (wall - cpu - sleep) / (wall - sleep) over the
    sampled iterations: the fraction of the tile's NON-SLEEPING loop
    time spent waiting for the interpreter/core rather than executing.
    Phase fractions are of sampled non-sleep wall time."""
    c = {k: m.counter(k) for k in PROFILE_SCHEMA.counters}
    busy = max(c["iter_wall_ns"] - c["iter_sleep_ns"], 0)
    wait = max(busy - c["iter_cpu_ns"], 0)
    lag = m.hist(
        "sched_lag_us"
    ) if "sched_lag_us" in m.schema.hists else {"count": 0}
    row = {
        "samples": c["iter_samples"],
        "gil_wait_frac": round(wait / busy, 4) if busy else 0.0,
        "busy_wall_ns": busy,
        "cpu_ns": c["iter_cpu_ns"],
        "sleep_ns": c["sleep_ns"],
        #: oversleep: how much longer voluntary sleeps ran than asked —
        #: the scheduler's contribution seen from the sleep side
        "oversleep_ns": max(c["sleep_ns"] - c["sleep_req_ns"], 0),
        "sched_lag_p50_us": round(hist_percentile(lag, 50), 1),
        "sched_lag_p99_us": round(hist_percentile(lag, 99), 1),
        "sched_lag_n": lag.get("count", 0),
        #: share of sampled non-sleep time spent in zero-credit
        #: (backpressured) iterations — stalled behind a slow consumer
        "bp_frac": (
            round(min(c["bp_wall_ns"] / busy, 1.0), 4) if busy else 0.0
        ),
    }
    for ph in PHASES:
        row[f"{ph}_frac"] = (
            round(c[f"{ph}_wall_ns"] / busy, 4) if busy else 0.0
        )
        pw = c[f"{ph}_wall_ns"]
        row[f"{ph}_gil_wait_frac"] = (
            round(max(pw - c[f"{ph}_cpu_ns"], 0) / pw, 4) if pw else 0.0
        )
    return row


def aggregate(profiles: dict[str, Metrics]) -> dict:
    """Topology-level summary for bench JSON: gil_wait_frac weighted by
    each tile's busy wall time, and the merged sched-lag p99."""
    busy_total = 0
    wait_total = 0
    lags = []
    rows = {}
    for name, m in profiles.items():
        row = profile_row(m)
        rows[name] = row
        busy_total += row["busy_wall_ns"]
        wait_total += int(row["gil_wait_frac"] * row["busy_wall_ns"])
        if "sched_lag_us" in m.schema.hists:
            lags.append(m.hist("sched_lag_us"))
    merged = merge_hists(lags)
    return {
        "gil_wait_frac": (
            round(wait_total / busy_total, 4) if busy_total else 0.0
        ),
        "sched_lag_p99_us": round(hist_percentile(merged, 99), 1),
        "sched_lag_n": merged.get("count", 0),
        "tiles": rows,
    }


def render_rows(profiles: dict[str, Metrics]) -> str:
    """Human table (one row per tile)."""
    lines = [
        f"{'tile':>10} {'gil_wait':>9} {'frag':>6} {'hk':>6} "
        f"{'credit':>7} {'bp':>6} {'lag p50/p99 us':>16} {'samples':>8}"
    ]
    for name in sorted(profiles):
        r = profile_row(profiles[name])
        lines.append(
            f"{name:>10} {r['gil_wait_frac'] * 100:8.1f}% "
            f"{r['frag_frac'] * 100:5.1f}% {r['hk_frac'] * 100:5.1f}% "
            f"{r['credit_frac'] * 100:6.1f}% {r['bp_frac'] * 100:5.1f}% "
            f"{r['sched_lag_p50_us']:,.0f}/{r['sched_lag_p99_us']:,.0f}"
            f"{'':>4} {r['samples']:8,}"
        )
    return "\n".join(lines)
