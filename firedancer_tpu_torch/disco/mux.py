"""The one piece of the tile runtime the verify pool needs: `now_ts`.

A copy of firedancer_tpu/disco/mux.py's `now_ts`; the rest of the runtime
(the mux loop, tiles, rings) is not ported yet.
"""

from __future__ import annotations

import time


def now_ts() -> int:
    """Frag timestamp: microseconds, truncated to the meta's u32 field
    (wraps every ~71 min; latency deltas use modular arithmetic like the
    reference's compressed tspub, fd_frag_meta_ts_comp)."""
    return (time.monotonic_ns() // 1000) & 0xFFFFFFFF
