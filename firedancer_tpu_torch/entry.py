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
leader(...)         -> the leader pipeline: synth -> verify -> dedup ->
                       pack (its select on the card) -> bank x n -> sink
                       x n, run to completion; the tiles' counters, the
                       microblocks the sinks received, the drained pack
                       engine and the rates.

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


def _front(topo, pool, total, repeat, max_lanes, device, out_link):
    """Declare synth -> verify -> dedup -> `out_link` on `topo` (every ring
    holds the run); -> (synth, verify, pool, total).  The verify tile is
    built first, so no pool is signed for a run that cannot start."""
    from .tiles import wire
    from .tiles.dedup import DedupTile
    from .tiles.synth import SynthTile, make_txn_pool
    from .tiles.verify import VerifyTile

    verify = VerifyTile(msg_width=1232, max_lanes=max_lanes, pad_full=True,
                        pre_dedup=False, device=device)
    if pool is None:
        pool = make_txn_pool(24, corrupt_frac=0.3, seed=17)
    rows, szs, _good = pool
    total = 2 * len(rows) if total is None else total
    depth = 1 << max(total - 1, 1).bit_length()
    # the synth publishes nothing until every tile is in RUN (its total is
    # set by _run), so the boot (the verify tile's warm-up) is not timed
    synth = SynthTile(rows, szs, total=0, repeat=repeat)
    for ln in ("synth_verify", "verify_dedup", out_link):
        topo.link(ln, depth=depth, mtu=wire.LINK_MTU)
    topo.tile(synth, outs=["synth_verify"])
    topo.tile(verify, ins=[("synth_verify", True)], outs=["verify_dedup"])
    topo.tile(DedupTile(depth=1 << 20), ins=[("verify_dedup", True)],
              outs=[out_link])
    return synth, verify, pool, total


def _front_done(topo, total) -> bool:
    """Every frag has left verify, and dedup has published or dropped all
    of verify's output (a tile counts in_frags before its callback and
    out_frags after its publish)."""
    mv, md = topo.metrics("verify"), topo.metrics("dedup")
    out = mv.counter("out_frags")
    return (
        mv.counter("in_frags") >= total
        and out + mv.counter("verify_fail_txns")
        + mv.counter("dedup_drop_txns") >= total
        and md.counter("out_frags") + md.counter("dup_txns") >= out
    )


def _run(topo, synth, total, idle_sleep_s, max_lanes, done, tiles, what):
    """Start `topo`, release the synth once every tile is in RUN, wait for
    done(), halt; -> (the release's perf_counter, seconds from the release
    to done, every tile's counters)."""
    import time

    topo.start(batch_max=max_lanes, idle_sleep_s=idle_sleep_s)
    t0 = time.perf_counter()
    synth.total = total
    deadline = t0 + 600.0
    while not done():
        topo.poll_failure()
        if time.perf_counter() > deadline:
            raise TimeoutError(f"{what}: not done after 600 s")
        time.sleep(1e-3)
    dt = time.perf_counter() - t0
    topo.halt()
    topo.poll_failure()
    counters = {
        n: {c: topo.metrics(n).counter(c)
            for c in topo.metrics(n).schema.counters}
        for n in tiles
    }
    return t0, dt, counters


def _percentiles(m, hist: str, key: str) -> dict:
    """{key_p50_us, key_p99_us} from one of a tile's link hists (empty
    when it has no samples)."""
    from .disco import metrics as M

    h = m.hist(hist)
    if not h["count"]:
        return {}
    return {f"{key}_p50_us": M.hist_percentile(h, 50),
            f"{key}_p99_us": M.hist_percentile(h, 99)}


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
    from .disco.topo import Topology
    from .tiles import wire
    from .tiles.sink import SinkTile

    topo = Topology()
    synth, verify, pool, total = _front(topo, pool, total, repeat, max_lanes,
                                        device, "dedup_sink")
    rows, szs, good = pool
    sink = SinkTile(record=True)
    topo.tile(sink, ins=[("dedup_sink", True)])
    try:
        topo.build()
        md, ms = topo.metrics("dedup"), topo.metrics("sink")

        def done() -> bool:
            return (_front_done(topo, total)
                    and ms.counter("in_frags") >= md.counter("out_frags"))

        _t0, dt, counters = _run(topo, synth, total, idle_sleep_s, max_lanes,
                                 done, INGRESS_TILES, "ingress")
        lat = _percentiles(ms, "e2e_us_dedup_sink", "e2e")
        hv = _percentiles(topo.metrics("verify"), "svc_us_synth_verify", "verify_hop")
        lat.update({k: v for k, v in hv.items() if k.endswith("p99_us")})
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


#: the leader topology's deployment settings (firedancer_tpu/app/config.py:
#: pack_depth, pack_mb_inflight, pack_microblock_ns, pack_txn_limit,
#: pack_slot_ns; the microblock MTU)
PACK_DEPTH, PACK_MB_INFLIGHT, PACK_MICROBLOCK_NS = 4096, 1, 2_000_000
PACK_TXN_LIMIT, PACK_SLOT_NS, MB_MTU = 31, 400_000_000, 65_535


def leader(
    pool=None,
    *,
    total: int | None = None,
    repeat: int = 1,
    max_lanes: int = 4096,
    n_banks: int = 2,
    pack_device_select: bool = True,
    idle_sleep_s: float = 50e-6,
    device=None,
) -> dict:
    """Build synth -> verify -> dedup -> pack -> bank x n_banks -> sink x
    n_banks in the thread runtime (firedancer_tpu/app/config.py's wiring,
    with a recording SinkTile on each bank{i}_poh ring in the place of the
    PoH tile), stream `total` frags as `ingress` does, and run until every
    txn that reached pack has been executed, completed at pack and its
    microblock taken by its sink; -> a report (see below).

    The front is `ingress`'s (same pool default, VerifyTile, DedupTile,
    rings that hold the run).  Pack is PackTile(n_banks, depth 4096,
    mb_inflight 1, 2 ms microblock cadence, txn_limit 31, cu_limit
    1,500,000, 400 ms slot; scan_limit 1024 over 1024 account bits) with
    its select on `device` when pack_device_select (None: the CUDA card,
    through the pack_select kernel).  The banks are fee-only BankTiles.
    Bank rings: depth 1 << max(64, 4 * mb_inflight).bit_length(), the
    microblock MTU 65,535.  device=None raises "no CUDA device" on a host
    without one; "cpu" runs the plain versions (tests).

    The report: `counters` (every tile's counters), `pool`, `microblocks`
    (per sink, in arrival order: (bank, handle, [txn payloads])),
    `pack_engine` (the drained engine's state: inflight and pending txns,
    occupied lock-table entries, non-zero lock counts and bitset
    refcounts), `seconds` (from every tile in RUN to the last completion),
    `front_seconds` (to the moment verify and dedup were done),
    `txns_per_s` (total / seconds), `executed_per_s`, the e2e p50/p99 at
    the sinks (from pack's publish of the microblock, which stamps its
    origin as the JAX tile does) and the verify hop's p99 (µs)."""
    import time

    from .disco.topo import Topology
    from .tiles.bank import BankTile
    from .tiles.pack import PackTile, mb_decode
    from .tiles.sink import SinkTile

    # the card first: the pack tile resolves its select device at once
    pack = PackTile(n_banks, depth=PACK_DEPTH, mb_inflight=PACK_MB_INFLIGHT,
                    microblock_ns=PACK_MICROBLOCK_NS, txn_limit=PACK_TXN_LIMIT,
                    slot_ns=PACK_SLOT_NS, use_device_select=pack_device_select,
                    device=device)
    topo = Topology()
    synth, verify, pool, total = _front(topo, pool, total, repeat, max_lanes,
                                        device, "dedup_pack")
    bank_ring = 1 << max(64, 4 * PACK_MB_INFLIGHT).bit_length()
    for i in range(n_banks):
        topo.link(f"pack_bank{i}", depth=bank_ring, mtu=MB_MTU)
        topo.link(f"bank{i}_pack", depth=bank_ring)  # completions: metadata
        topo.link(f"bank{i}_poh", depth=bank_ring, mtu=MB_MTU)
    topo.tile(pack, ins=[("dedup_pack", True)]
              + [(f"bank{i}_pack", True) for i in range(n_banks)],
              outs=[f"pack_bank{i}" for i in range(n_banks)])
    sinks = [SinkTile(record=True, name=f"sink{i}") for i in range(n_banks)]
    for i in range(n_banks):
        topo.tile(BankTile(i), ins=[(f"pack_bank{i}", True)],
                  outs=[f"bank{i}_pack", f"bank{i}_poh"])
        topo.tile(sinks[i], ins=[(f"bank{i}_poh", True)])
    tiles = ("synth", "verify", "dedup", "pack",
             *(f"bank{i}" for i in range(n_banks)),
             *(f"sink{i}" for i in range(n_banks)))
    try:
        topo.build()
        md, mp = topo.metrics("dedup"), topo.metrics("pack")
        mbanks = [topo.metrics(f"bank{i}") for i in range(n_banks)]
        msinks = [topo.metrics(f"sink{i}") for i in range(n_banks)]

        front_done_at = []

        def done() -> bool:
            if not _front_done(topo, total):
                return False
            if not front_done_at:
                front_done_at.append(time.perf_counter())
            taken = mp.counter("inserted_txns") + mp.counter("insert_rejected")
            mbs = mp.counter("microblocks")
            return (
                taken >= md.counter("out_frags")
                and mp.counter("microblock_txns") >= mp.counter("inserted_txns")
                and mp.counter("completions") >= mbs
                and sum(m.counter("executed_microblocks")
                        + m.counter("malformed_microblocks")
                        for m in mbanks) >= mbs
                and sum(m.counter("sunk_frags") for m in msinks)
                >= sum(m.counter("executed_microblocks") for m in mbanks)
            )

        t0, dt, counters = _run(topo, synth, total, idle_sleep_s, max_lanes,
                                done, tiles, "leader")
        lat = {}
        for i, m in enumerate(msinks):
            lat.update(_percentiles(m, f"e2e_us_bank{i}_poh", f"e2e_sink{i}"))
        hv = _percentiles(topo.metrics("verify"), "svc_us_synth_verify", "verify_hop")
        lat.update({k: v for k, v in hv.items() if k.endswith("p99_us")})
    finally:
        topo.close()
    eng = pack.engine
    microblocks = []
    for s in sinks:
        got = []
        for rows, szs in zip(s.payloads, s.sizes):
            for row, sz in zip(rows, szs):
                handle, bank, txns = mb_decode(row[:sz])
                got.append((bank, handle, [bytes(t) for t in txns]))
        microblocks.append(got)
    executed = sum(counters[f"bank{i}"]["executed_txns"] for i in range(n_banks))
    return {
        "counters": counters,
        "pool": {"rows": pool[0], "szs": pool[1], "good": pool[2],
                 "tags": synth.tags},
        "microblocks": microblocks,
        "pack_engine": {
            "inflight": eng.inflight_cnt, "pending": eng.pending_cnt,
            "outstanding": eng.outstanding_cnt,
            "lock_keys": int((eng.lw_keys != 0).sum() + (eng.lr_keys != 0).sum()),
            "lock_counts": int((eng.lw_vals != 0).sum() + (eng.lr_vals != 0).sum()),
            "bit_refs": int((eng.bit_ref_rw != 0).sum() + (eng.bit_ref_w != 0).sum()),
        },
        "total": total, "seconds": dt, "txns_per_s": total / dt,
        "front_seconds": front_done_at[0] - t0,
        "executed_per_s": executed / dt, **lat,
    }


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", tuple(out.shape), str(out.dtype), out.device)
