"""Integration points of the port, the counterparts of __graft_entry__.py:

entry()             -> (fn, example_args): the single-card forward step of
                       the flagship path (Ed25519 batch verify, message form)
                       on the CUDA card (device="cpu": the plain versions).
dryrun_multichip(n) -> the step over a dp x mp mesh of n ranks and the
                       verify pool (parallel/dryrun.py): NCCL ranks on n
                       cards, or with device="cpu" gloo ranks on the CPU.
ingress(...)        -> the ingress tile pipeline over real rings in the
                       thread runtime: synth -> verify (on the card) ->
                       dedup -> sink, run to completion; the tiles'
                       counters, the sink's survivors and the latencies.

    python -c "from firedancer_tpu_torch import entry; entry.dryrun_multichip(8, device='cpu')"
"""

from __future__ import annotations

import numpy as np


def entry(device=None):
    from .ops.ed25519 import verify as fver
    from .utils import devices

    dev = devices.resolve(device)
    batch, msg_len = 128, 64
    rng = np.random.default_rng(0)
    msgs = rng.integers(0, 256, size=(batch, msg_len), dtype=np.uint8)
    lens = np.full((batch,), msg_len, dtype=np.int32)
    sigs = rng.integers(0, 256, size=(batch, 64), dtype=np.uint8)
    pubs = rng.integers(0, 256, size=(batch, 32), dtype=np.uint8)

    def fn(m, l, s, p):
        return fver.verify_batch(m, l, s, p, device=dev)

    return fn, (msgs, lens, sigs, pubs)


def dryrun_multichip(n_devices: int, device=None) -> None:
    from .parallel import dryrun

    dryrun.run(n_devices, device=device)


#: the ingress topology's tiles, producer first
INGRESS_TILES = ("synth", "verify", "dedup", "sink")


def ingress(
    pool=None,
    *,
    total: int | None = None,
    repeat: int = 1,
    max_lanes: int = 4096,
    idle_sleep_s: float = 50e-6,
    device=None,
) -> dict:
    """Build synth -> verify -> dedup -> sink in the thread runtime, stream
    `total` frags (default: two passes over the pool), each pool entry
    `repeat` times back to back, and run until every frag has left the
    pipeline; -> a report (see below).

    pool: (rows, szs, good) from tiles.synth.make_txn_pool, by default
    tests/test_pipeline.py's (24 txns, 30 % corrupted, seed 17).  The
    verify tile is VerifyTile(msg_width=1232, max_lanes, pad_full=True,
    pre_dedup=False) on one domain, the dedup tile DedupTile(depth=2^20).
    Every ring holds the whole run (depth: the smallest power of two >=
    total), so the synth never waits for credits and the verify tile
    forms full batches; batch_max is max_lanes, and idle_sleep_s goes to
    the run loop.  device=None runs verify on the CUDA card and raises "no
    CUDA device" on a host without one; "cpu" runs the plain versions
    (tests); "off" the strict host path.

    The report: `counters` (every tile's counters), `pool` (rows, szs,
    good, tags), the sink's `survivors` (tags) with their `payloads` and
    `sizes`, `seconds` (from every tile in RUN until the last frag left),
    `txns_per_s` (total / seconds), the e2e p50/p99 at the sink and the
    verify hop's p99 (µs, from the run loop's link hists), and the verify
    tile's `landed_stamps` (pool_seq, domain, lanes, dispatch and land
    stamps in µs)."""
    import time

    from .disco import metrics as M
    from .disco.topo import Topology
    from .tiles import wire
    from .tiles.dedup import DedupTile
    from .tiles.sink import SinkTile
    from .tiles.synth import SynthTile, make_txn_pool
    from .tiles.verify import VerifyTile

    # the card first: no pool is signed for a run that cannot start
    verify = VerifyTile(msg_width=1232, max_lanes=max_lanes, pad_full=True,
                        pre_dedup=False, device=device)
    if pool is None:
        pool = make_txn_pool(24, corrupt_frac=0.3, seed=17)
    rows, szs, good = pool
    total = 2 * len(rows) if total is None else total
    depth = 1 << max(total - 1, 1).bit_length()
    # the synth publishes nothing until every tile is in RUN (its total is
    # set below), so the boot (the verify tile's warm-up) is not timed
    synth = SynthTile(rows, szs, total=0, repeat=repeat)
    sink = SinkTile(record=True)
    topo = Topology()
    for ln in ("synth_verify", "verify_dedup", "dedup_sink"):
        topo.link(ln, depth=depth, mtu=wire.LINK_MTU)
    topo.tile(synth, outs=["synth_verify"])
    topo.tile(verify, ins=[("synth_verify", True)], outs=["verify_dedup"])
    topo.tile(DedupTile(depth=1 << 20), ins=[("verify_dedup", True)],
              outs=["dedup_sink"])
    topo.tile(sink, ins=[("dedup_sink", True)])
    try:
        topo.start(batch_max=max_lanes, idle_sleep_s=idle_sleep_s)
        mv, md, ms = (topo.metrics(n) for n in ("verify", "dedup", "sink"))
        t0 = time.perf_counter()
        synth.total = total
        deadline = t0 + 600.0

        def done() -> bool:
            out = mv.counter("out_frags")
            return (
                mv.counter("in_frags") >= total
                and out + mv.counter("verify_fail_txns")
                + mv.counter("dedup_drop_txns") >= total
                and md.counter("in_frags") >= out
                and ms.counter("in_frags") >= md.counter("out_frags")
            )

        while not done():
            topo.poll_failure()
            if time.perf_counter() > deadline:
                raise TimeoutError("ingress: not done after 600 s")
            time.sleep(1e-3)
        dt = time.perf_counter() - t0
        topo.halt()
        topo.poll_failure()
        counters = {
            n: {c: topo.metrics(n).counter(c)
                for c in topo.metrics(n).schema.counters}
            for n in INGRESS_TILES
        }
        lat = {}
        he = ms.hist("e2e_us_dedup_sink")
        if he["count"]:
            lat["e2e_p50_us"] = M.hist_percentile(he, 50)
            lat["e2e_p99_us"] = M.hist_percentile(he, 99)
        hv = mv.hist("svc_us_synth_verify")
        if hv["count"]:
            lat["verify_hop_p99_us"] = M.hist_percentile(hv, 99)
    finally:
        topo.close()
    # the sink has halted: its records are final
    survivors = sink.all_sigs()
    payloads = (np.concatenate(sink.payloads) if sink.payloads
                else np.zeros((0, wire.LINK_MTU), np.uint8))
    sizes = (np.concatenate(sink.sizes) if sink.sizes
             else np.zeros(0, np.uint16))
    return {
        "counters": counters,
        "pool": {"rows": rows, "szs": szs, "good": good, "tags": synth.tags},
        "survivors": survivors, "payloads": payloads, "sizes": sizes,
        "total": total, "seconds": dt, "txns_per_s": total / dt, **lat,
        "landed_stamps": list(verify.landed_stamps),
    }


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", tuple(out.shape), str(out.dtype), out.device)
