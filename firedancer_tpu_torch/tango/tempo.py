"""Tempo: tick sources, calibration, and housekeeping-interval math.

A copy of firedancer_tpu/tango/tempo.py.

Reference model: src/tango/tempo/ — fd_tempo calibrates the CPU
tickcounter against the wallclock and derives the "lazy" housekeeping
cadence from ring depth: a consumer must refresh its flow-control view
well before a depth's worth of traffic can pass, but spinning the
housekeeping path every iteration wastes the hot loop.  The same math
drives this build's run loop (disco/mux.py): housekeeping fires when
`now >= next`, with `next = now + jitter(lazy)` — the randomized
interval (uniform in [lazy/2, 3*lazy/2]) that decorrelates tiles'
housekeeping so they do not thundering-herd the shared memory.
"""

from __future__ import annotations

import os
import time


def tickcount() -> int:
    """The monotonic tick source (ns resolution on this host)."""
    return time.monotonic_ns()


def tick_per_ns(observe_s: float = 0.005) -> float:
    """Calibrate tickcount ticks per wallclock ns.

    On this substrate the tick source IS the ns clock, so the measured
    ratio is ~1.0 — the calibration exists so tick arithmetic stays
    correct if the source changes (the reference measures rdtsc)."""
    t0w = time.time_ns()
    t0 = tickcount()
    time.sleep(observe_s)
    t1 = tickcount()
    t1w = time.time_ns()
    dw = max(t1w - t0w, 1)
    return (t1 - t0) / dw


def lazy_default(cr_max: int) -> int:
    """Housekeeping interval (ns) for a link of cr_max credits.

    Matches the reference's intent: refresh roughly every cr_max/2
    frags at a presumed ~10 ns/frag floor, clamped to [100us, 100ms] for
    a Python-hosted loop where iterations are microseconds, not ns."""
    ns = (cr_max * 10) // 2
    return min(max(ns, 100_000), 100_000_000)


def async_reload(lazy: int, rng_u32: int | None = None) -> int:
    """Randomized next-interval in [lazy/2, 3*lazy/2] (uniform)."""
    if rng_u32 is None:
        rng_u32 = int.from_bytes(os.urandom(4), "little")
    span = max(lazy, 2)
    return span // 2 + (rng_u32 % span)
