"""The pack tile's select on the card, one measurement a process: the
pack_select kernel at the deployment shape, or one `leader` run with the
host ms of its select calls.

    python -m firedancer_tpu_torch.bench_select kernel
    python -m firedancer_tpu_torch.bench_select leader [--select off] [--idle-sleep-us 1000]

Run from the root of a checkout: it takes chip_smoke.py's deployment
candidates (K = 1024 rows of 1024 account bits, seed 7) and its leader
pool and sizes.  Prints one JSON line:

  kernel  the kernel's CUDA-event ms around one call (median of 50) and its
          device ms with 20 launches queued behind a spin, so that the
          host's launch overhead is off the clock
  leader  txns/s, the executed count, the select calls and their host ms
          (median, max)

Both forms use only what every tree of the port since the pack hop has
(`select_impl`, `select_noconflict`, `entry.leader`), so an A/B of two
trees runs this file in each, alternately, on one card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch


def cuda_ms_queued(fn, n: int = 20) -> float:
    """Device ms per call of fn() with n calls queued behind a spin on the
    current stream, so that the host's launch overhead is off the clock."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # covers the host's enqueue of the n calls
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def kernel() -> dict:
    import chip_smoke as CS

    from .ops import pack_select as PS

    dev = torch.device("cuda")
    rw, wr, in_rw, in_w, costs = CS.pack_candidates(seed=7)
    args = [torch.from_numpy(PS.split_u32(a)).to(dev) for a in (rw, wr, in_rw, in_w)]
    args.append(torch.from_numpy(costs).to(dev))

    def fn():
        return PS.select_impl(*args, CS.CU_LIMIT, CS.TXN_LIMIT)

    return {"kernel_one_call_ms": CS.cuda_ms(fn, reps=50),
            "kernel_queued_ms": cuda_ms_queued(fn)}


def leader(select: bool, idle_sleep_s: float) -> dict:
    import chip_smoke as CS

    from . import entry
    from .ops import pack_select as PS
    from .tiles.synth import make_txn_pool

    pool = make_txn_pool(CS.TILES_POOL, corrupt_frac=0.1, seed=CS.TILES_SEED)
    orig, ms = PS.select_noconflict, []

    def timed(*a, **kw):
        t = time.perf_counter()
        out = orig(*a, **kw)
        ms.append((time.perf_counter() - t) * 1e3)
        return out

    PS.select_noconflict = timed  # the tile binds it when it is built
    try:
        r = entry.leader(pool, total=CS.TILES_FRAGS, max_lanes=CS.B, n_banks=2,
                         pack_device_select=select, idle_sleep_s=idle_sleep_s)
    finally:
        PS.select_noconflict = orig
    c = r["counters"]
    return {"select": select, "idle_sleep_us": idle_sleep_s * 1e6,
            "txns_per_s": r["txns_per_s"],
            "executed": sum(v["executed_txns"] for k, v in c.items()
                            if k.startswith("bank")),
            "select_calls": len(ms),
            "select_call_ms_median": statistics.median(ms) if ms else None,
            "select_call_ms_max": max(ms, default=None)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("kernel", "leader"))
    ap.add_argument("--select", choices=("on", "off"), default="on")
    ap.add_argument("--idle-sleep-us", type=float, default=1000.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_select: no CUDA device")
    import chip_smoke as CS

    out = (kernel() if args.what == "kernel"
           else leader(args.select == "on", args.idle_sleep_us * 1e-6))
    print(json.dumps({**out, "card": CS.nvidia_smi_line()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
