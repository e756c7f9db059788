"""Time the ingress step's dedup half (models/pipeline.py `dedup`, one card,
no mesh) in several checkouts of the repo, in turns within one call.

Each ROOT's firedancer_tpu_torch runs in a subprocess of its own, in the order
given, on the same seeded batch: B = 4096 verified lanes of random tags into
an empty production-size filter pair.  Times are CUDA-event medians of one
dedup call after warm-up calls, as chip_smoke.py's cuda_ms takes them.

    python -m firedancer_tpu_torch.bench_dedup PARENT . . PARENT

prints one JSON line per run, {"root", "ms", "ms_each", "card"}, with the
card's name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

LANES = 4096
REPS = 20

_CHILD = """
import json, statistics, sys
import numpy as np
import torch
from firedancer_tpu_torch.models import pipeline as PL

lanes, reps = int(sys.argv[1]), int(sys.argv[2])
dev = torch.device("cuda")
rng = np.random.default_rng(5)
tags = torch.from_numpy(rng.integers(0, 2**32, (lanes, 2), dtype=np.int64)).to(dev)
ok = torch.ones(lanes, dtype=torch.bool, device=dev)
cur, prev = PL.fresh_bloom(dev), PL.fresh_bloom(dev)
for _ in range(3):
    PL.dedup(ok, tags, cur, prev)
torch.cuda.synchronize()
each = []
for _ in range(reps):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    PL.dedup(ok, tags, cur, prev)
    e1.record()
    torch.cuda.synchronize()
    each.append(e0.elapsed_time(e1))
print(json.dumps({"ms": statistics.median(each), "ms_each": each}))
"""


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def time_root(root: str, lanes: int = LANES, reps: int = REPS) -> dict:
    """One subprocess that imports `root`'s package and times its dedup."""
    root = os.path.abspath(root)
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", _CHILD, str(lanes), str(reps)],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    return {"root": root, **json.loads(res.stdout.strip().splitlines()[-1])}


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    name = card()
    for root in argv:
        print(json.dumps({**time_root(root), "card": name}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
