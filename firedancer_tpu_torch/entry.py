"""Integration points of the port, the counterparts of __graft_entry__.py:

entry()             -> (fn, example_args): the single-card forward step of
                       the flagship path (Ed25519 batch verify, message form)
                       on the CUDA card (device="cpu": the plain versions).
dryrun_multichip(n) -> the step over a dp x mp mesh of n ranks and the
                       verify pool (parallel/dryrun.py): NCCL ranks on n
                       cards, or with device="cpu" gloo ranks on the CPU.
ingress(...)        -> the ingress tile pipeline over real rings: synth ->
                       verify (on the card) -> dedup -> sink, run to
                       completion; the tiles' counters, the sink's
                       survivors and the latencies.  front="wire" puts net
                       -> quic (legacy UDP and QUIC over real loopback
                       sockets) in the synth's place.  stem="native" runs
                       dedup (and net) on the native stem.
                       runtime="process" runs each tile in its own process,
                       profile=True adds each tile's run-loop profile.
leader(...)         -> the leader pipeline: synth -> verify -> dedup ->
                       pack (its select on the card) -> bank x n -> poh ->
                       shred <-> sign -> store, with a recording sink
                       beside the PoH tile on each bank's ring, run until
                       every slot that holds a mixin is stored; the tiles'
                       counters, the microblocks the sinks received, the
                       drained pack engine, the stored blocks and shreds
                       and the rates.  front="wire" as in ingress.
                       stem="native" runs net, dedup, pack, poh and shred
                       on the native stem.

    python -c "from firedancer_tpu_torch import entry; entry.dryrun_multichip(8, device='cpu')"
    python -c "from firedancer_tpu_torch import entry; print(entry.ingress(front='wire', device='cpu', max_lanes=32, idle_sleep_s=5e-3)['wire'])"
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

#: the wire front's datagram rings' depth past the run's transactions (the
#: QUIC handshakes, acks and the server's responses)
WIRE_SLACK = 4096


def _depth(n: int) -> int:
    """The smallest power of two >= n (at least 2): a ring that holds n."""
    return 1 << max(n - 1, 1).bit_length()


def raw_txns(pool) -> list[bytes]:
    """The pool's transactions as they go on the wire (each row's bytes up
    to its trailer)."""
    from .tiles import wire

    rows, szs, _good = pool
    tr = wire.parse_trailers(rows, szs.astype(np.int64))
    return [rows[i, : tr["txn_sz"][i]].tobytes() for i in range(len(rows))]


class _Front:
    """A declared front: `tiles` (its tile names, producer first), `in_link`
    (verify's in-link), `tags` (the pool's dedup tags), `total` (txns it
    feeds verify), `begin()` (called once every tile is in RUN) and
    `tick()` (called at every poll); a wire front also its `traffic`, its
    QUIC tile and, once begun, the bound `addrs`."""

    def __init__(self, tiles, in_link, tags, total, begin, tick):
        self.tiles, self.in_link, self.tags, self.total = tiles, in_link, tags, total
        self.begin, self.tick = begin, tick
        self.traffic = self.quic = self.addrs = None


def _front(topo, pool, total, repeat, max_lanes, device, out_link, *,
           front="synth", traffic=None, identity_secret=None, release=None):
    """Declare the front -> verify -> dedup -> `out_link` on `topo`; -> (a
    _Front, the VerifyTile, pool).  The verify tile is built first, so no
    pool is signed for a run that cannot start.

    front="synth": synth -> verify (every ring holds the run; the synth
    gets `total` frags through its release word once begun, or
    release()'s budget read again at every poll).
    front="wire": net -> quic(via_net) -> verify, with quic's responses on
    quic_net back to net (firedancer_tpu/app/config.py:307-319), bound to
    127.0.0.1 ephemeral ports; `traffic` (a tiles/bench.WireTraffic) sends
    the transactions once every tile is in RUN, and its poll is fed the
    QUIC tile's rx_txns_udp."""
    from .tiles import wire
    from .tiles.dedup import DedupTile
    from .tiles.synth import SynthTile, make_txn_pool
    from .tiles.verify import VerifyTile

    if front not in ("synth", "wire"):
        raise ValueError(f"front {front!r}: synth | wire")
    verify = VerifyTile(msg_width=1232, max_lanes=max_lanes, pad_full=True,
                        pre_dedup=False, device=device)
    if pool is None:
        pool = make_txn_pool(24, corrupt_frac=0.3, seed=17)
    rows, szs, _good = pool
    if front == "synth":
        total = 2 * len(rows) if total is None else total
        depth = _depth(total)
        # the synth publishes nothing until every tile is in RUN (begin
        # writes its release word), so the boot (the verify tile's
        # warm-up) is not timed; the word reaches a synth child too
        synth = SynthTile(rows, szs, total=0, repeat=repeat)
        topo.link("synth_verify", depth=depth, mtu=wire.LINK_MTU)
        topo.tile(synth, outs=["synth_verify"])

        def set_release(n: int) -> None:
            word = topo.wksp.view(f"shared_{synth.release_region}")
            word.view(np.uint64)[0] = n

        def begin():
            set_release(total if release is None else release())

        def tick():
            if release is not None:
                set_release(release())

        fr = _Front(("synth",), "synth_verify", synth.tags, total, begin, tick)
    else:
        from .tiles.bench import WireTraffic
        from .tiles.net import NET_MTU, NetTile
        from .tiles.quic import QuicIngressTile

        if release is not None:
            raise ValueError("paced runs take the synth front")
        if traffic is None:
            raws = raw_txns(pool)
            traffic = WireTraffic(raws * 2, raws, n_clients=2)
        if identity_secret is None:
            identity_secret = np.random.default_rng(IDENTITY_SEED).integers(
                0, 256, 32, np.uint8).tobytes()
        total = traffic.txns
        depth = _depth(total)
        net = NetTile(quic_addr=("127.0.0.1", 0), udp_addr=("127.0.0.1", 0))
        quic = QuicIngressTile(identity_secret, via_net=True)
        topo.link("net_quic", depth=_depth(total + WIRE_SLACK), mtu=NET_MTU)
        topo.link("quic_net", depth=WIRE_SLACK, mtu=NET_MTU)
        topo.link("quic_verify", depth=depth, mtu=wire.LINK_MTU)
        topo.tile(net, ins=[("quic_net", True)], outs=["net_quic"])
        topo.tile(quic, ins=[("net_quic", True)], outs=["quic_verify", "quic_net"])
        mq = []

        def begin():
            import socket

            mq.append(topo.metrics("quic"))
            rcvbuf = net.udp_sock.sock.getsockopt(socket.SOL_SOCKET,
                                                  socket.SO_RCVBUF)
            fr.addrs = {"quic": net.quic_addr, "udp": net.udp_addr}
            traffic.start(fr.addrs, rcvbuf)

        def tick():
            traffic.poll(mq[0].counter("rx_txns_udp"))

        # the pool's dedup tags, as the synth front computes them
        fr = _Front(("net", "quic"), "quic_verify", SynthTile(rows, szs).tags, total,
                    begin, tick)
        fr.traffic, fr.quic = traffic, quic
    for ln in ("verify_dedup", out_link):
        topo.link(ln, depth=depth, mtu=wire.LINK_MTU)
    topo.tile(verify, ins=[(fr.in_link, True)], outs=["verify_dedup"])
    topo.tile(DedupTile(depth=1 << 20), ins=[("verify_dedup", True)],
              outs=[out_link])
    return fr, verify, pool


#: seconds the wire front may go without progress before the run fails
WIRE_STALL_S = 60.0

#: the QUIC tile's counters a stalled wire run reports
_QUIC_DROPS = ("parse_fail_txns", "shed_backlog", "drop_txn_rate", "shed_unstaked",
               "drop_conn_cap", "drop_handshake_rate", "tx_eagain_drops")


def _wire_done(topo, fr, marks) -> bool:
    """The wire front's part of done(): the senders finished, net received
    every datagram they sent and quic took in every transaction.  Marks
    the moment the legacy transactions were all in; raises when neither
    the senders nor the front moved for WIRE_STALL_S (a datagram lost on
    the way, a transaction dropped)."""
    import time

    mn, mq = topo.metrics("net"), topo.metrics("quic")
    now = time.perf_counter()
    finished = fr.traffic.finished()
    sent = fr.traffic.dgrams_sent
    rx, udp, quic = (mn.counter("rx_dgrams"), mq.counter("rx_txns_udp"),
                     mq.counter("rx_txns_quic"))
    if udp >= len(fr.traffic.legacy):
        marks.setdefault("legacy_in", now)
    state = (finished, sent["legacy"], rx, udp, quic)
    if marks.get("state") != state:
        marks["state"], marks["moved"] = state, now
    elif now - marks["moved"] > WIRE_STALL_S:
        raise TimeoutError(
            f"wire front stalled {WIRE_STALL_S} s: sent {sent}, net rx_dgrams "
            f"{rx}, quic rx_txns_udp {udp} rx_txns_quic {quic} of {fr.total}, "
            f"{ {k: mq.counter(k) for k in _QUIC_DROPS} }")
    return (finished and rx >= sent["legacy"] + sent["quic"]
            and udp + quic + mq.counter("parse_fail_txns") >= fr.total)


def _wire_report(fr, counters, marks, t0) -> dict:
    """The report's `wire` block."""
    rep = fr.traffic.report()
    n_legacy = len(fr.traffic.legacy)
    cn, cq = counters["net"], counters["quic"]
    return {
        "addrs": fr.addrs,
        **rep,
        "net_rx_dgrams": cn["rx_dgrams"], "oversize_drops": cn["oversize_drops"],
        "rx_txns_udp": cq["rx_txns_udp"], "rx_txns_quic": cq["rx_txns_quic"],
        "conns_opened": cq["conns_opened"],
        # distinct connections the server holds (conns_opened counts every
        # connection id the server registers: a connection's own and the
        # spare ones it offers once established)
        "connections": len({id(c) for c in fr.quic.server.conns.values()}),
        "legacy_txns_per_s": (n_legacy / (marks["legacy_in"] - t0)
                              if "legacy_in" in marks else None),
    }


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


#: the base counters that show which loop handled a tile's work
STEM_COUNTERS = ("stem_engaged", "stem_frags", "py_frags", "py_credit")


def _stem_report(counters) -> dict:
    """Every tile's STEM_COUNTERS, from a run's counters."""
    return {n: {k: c[k] for k in STEM_COUNTERS} for n, c in counters.items()}


def _run(topo, fr, idle_sleep_s, max_lanes, done, tiles, what):
    """Start `topo`, begin the front once every tile is in RUN, wait for
    done() (ticking the front at every 1 ms poll), halt; -> (the begin's
    perf_counter, seconds from the begin to done, every tile's counters,
    the seconds start() took to bring every tile to RUN)."""
    import time

    t_boot = time.perf_counter()
    topo.start(batch_max=max_lanes, idle_sleep_s=idle_sleep_s)
    t0 = time.perf_counter()
    fr.begin()
    deadline = t0 + 600.0
    while not done():
        topo.poll_failure()
        if time.perf_counter() > deadline:
            raise TimeoutError(f"{what}: not done after 600 s")
        time.sleep(1e-3)
        fr.tick()
    dt = time.perf_counter() - t0
    topo.halt()
    topo.poll_failure()
    counters = {
        n: {c: topo.metrics(n).counter(c)
            for c in topo.metrics(n).schema.counters}
        for n in tiles
    }
    return t0, dt, counters, t0 - t_boot


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
    stem: str | None = None,
    front: str = "synth",
    traffic=None,
    identity_secret: bytes | None = None,
    runtime: str | None = None,
    profile: bool = False,
) -> dict:
    """Build synth -> verify -> dedup -> sink, stream
    `total` frags (default: two passes over the pool), each pool entry
    `repeat` times back to back, and run until every frag has left the
    pipeline; -> a report (see below).

    front="wire" puts net -> quic -> verify in the synth's place (see
    _front): the QUIC tile terminates TLS with `identity_secret` (None: 32
    bytes from IDENTITY_SEED), and `traffic` (a tiles/bench.WireTraffic;
    None: the pool's raw txns twice as legacy datagrams and once over two
    QUIC connections from a spawned child) gets the bound addresses and
    sends; total and repeat do not apply.  The run ends once the senders
    finished, net received every datagram and every frag left the
    pipeline.

    pool: (rows, szs, good) from tiles.synth.make_txn_pool, by default
    tests/test_pipeline.py's (24 txns, 30 % corrupted, seed 17).  The
    verify tile is VerifyTile(msg_width=1232, max_lanes, pad_full=True,
    pre_dedup=False) on one domain, the dedup tile DedupTile(depth=2^20).
    Every ring holds the whole run (depth: the smallest power of two >=
    total), so the synth never waits for credits and the verify tile
    forms full batches; batch_max is max_lanes, and idle_sleep_s goes to
    the run loop.  device=None runs verify on the CUDA card and raises "no
    CUDA device" on a host without one; "cpu" runs the plain versions
    (tests); "off" the strict host path.  stem: the run loop's inner loop
    for every tile, "python" (None) or "native" (disco/topo.Topology).
    runtime: "thread" (None) or "process", one OS process per tile (the
    synth front only: a wire front's sockets would be bound in the
    children, and this harness reads them from its own tile copies);
    the sink then logs its survivors in its shm sig log
    (tiles/sink.py shm_log), read back through the topology.  profile:
    enable_profile() on the topology.

    The report: `counters` (every tile's counters), `pool` (rows, szs,
    good, tags), the sink's `survivors` (tags) with their `payloads` and
    `sizes` (None under the process runtime: the shm log holds sigs only),
    `seconds` (from every tile in RUN until the last frag left),
    `boot_seconds` (start() bringing every tile to RUN), `txns_per_s`
    (total / seconds), the e2e p50/p99 at the sink and the verify hop's
    p99 (µs, from the run loop's link hists), the verify tile's
    `landed_stamps` (pool_seq, domain, lanes, dispatch and land stamps in
    µs; None under the process runtime, where they stay in the verify
    child, as `landed_stamps_note` says), `runtime`, under the process
    runtime `children` (each child's Topology.tile_device: its CUDA
    context and its kernels' launches), `stem`: the mode and
    every tile's stem_engaged, stem_frags, py_frags and py_credit, and
    with profile `profile`: disco/profile.aggregate of every tile's
    region (gil_wait_frac, sched_lag_p99_us, the per-tile rows), the
    render_rows table and `cores`, the CPUs this process may run on.  A
    wire run adds `wire`: the bound `addrs`, the datagrams sent (legacy,
    quic), the blaster's window, the
    granted SO_RCVBUF and the truesize it was divided by, each QUIC
    client's report and handshake ms, QUIC txns/s (client side: first txn
    sent to the last packet acked), net's rx_dgrams and oversize_drops,
    quic's rx_txns_udp, rx_txns_quic and conns_opened, and legacy txns/s
    (from the begin to quic holding every legacy txn)."""
    import os

    from .disco import profile as PF
    from .disco.topo import Topology
    from .tiles import wire
    from .tiles.sink import SIGLOG_ALLOC, SinkTile, read_siglog

    topo = Topology(stem=stem, runtime=runtime)
    proc = runtime == "process"
    if proc and front != "synth":
        raise ValueError(f"runtime='process' takes the synth front, not {front!r}")
    if profile:
        topo.enable_profile()
    fr, verify, pool = _front(topo, pool, total, repeat, max_lanes, device,
                              "dedup_sink", front=front, traffic=traffic,
                              identity_secret=identity_secret)
    total = fr.total
    rows, szs, good = pool
    sink = SinkTile(record=not proc, shm_log=total if proc else 0)
    topo.tile(sink, ins=[("dedup_sink", True)])
    marks: dict = {}
    prof = None
    try:
        topo.build()
        md, ms = topo.metrics("dedup"), topo.metrics("sink")

        def done() -> bool:
            if front == "wire" and not _wire_done(topo, fr, marks):
                return False
            return (_front_done(topo, total)
                    and ms.counter("in_frags") >= md.counter("out_frags"))

        t0, dt, counters, boot_s = _run(topo, fr, idle_sleep_s, max_lanes, done,
                                        fr.tiles + INGRESS_TILES[1:], "ingress")
        lat = _percentiles(ms, "e2e_us_dedup_sink", "e2e")
        hv = _percentiles(topo.metrics("verify"), f"svc_us_{fr.in_link}", "verify_hop")
        lat.update({k: v for k, v in hv.items() if k.endswith("p99_us")})
        if profile:
            pm = topo.profile_metrics()
            prof = {**PF.aggregate(pm), "rows": PF.render_rows(pm),
                    "cores": len(os.sched_getaffinity(0))}
        if proc:
            # the sink child has halted: its shm log is final; so are the
            # device words each child published as it exited
            survivors = read_siglog(topo.tile_alloc_view("sink", SIGLOG_ALLOC))
            children = {n: topo.tile_device(n) for n in topo.tiles}
    finally:
        topo.close()
        if front == "wire":
            fr.traffic.close()
    payloads = sizes = None
    if not proc:
        # the sink has halted: its records are final
        survivors = sink.all_sigs()
        payloads = (np.concatenate(sink.payloads) if sink.payloads
                    else np.zeros((0, wire.LINK_MTU), np.uint8))
        sizes = (np.concatenate(sink.sizes) if sink.sizes
                 else np.zeros(0, np.uint16))
    return {
        "counters": counters,
        "pool": {"rows": rows, "szs": szs, "good": good, "tags": fr.tags},
        "survivors": survivors, "payloads": payloads, "sizes": sizes,
        "total": total, "seconds": dt, "boot_seconds": boot_s,
        "txns_per_s": total / dt, **lat,
        "landed_stamps": None if proc else list(verify.landed_stamps),
        **({"landed_stamps_note": "the verify tile's stamps stay in its child "
            "process"} if proc else {}),
        "runtime": "process" if proc else "thread",
        **({"children": children} if proc else {}),
        **({"profile": prof} if profile else {}),
        "stem": {"mode": stem or "python", "tiles": _stem_report(counters)},
        **({"wire": _wire_report(fr, counters, marks, t0)} if front == "wire" else {}),
    }


#: the leader topology's deployment settings (firedancer_tpu/app/config.py:
#: pack_depth, pack_mb_inflight, pack_microblock_ns, pack_txn_limit,
#: pack_slot_ns; the microblock MTU)
PACK_DEPTH, PACK_MB_INFLIGHT, PACK_MICROBLOCK_NS = 4096, 1, 2_000_000
PACK_TXN_LIMIT, PACK_SLOT_NS, MB_MTU = 31, 400_000_000, 65_535


#: the block egress's settings (firedancer_tpu/app/config.py:377-408):
#: ticks per slot, the shred version, the rings' depths; the seed of the
#: leader's identity key
TICKS_PER_SLOT, SHRED_VERSION, IDENTITY_SEED = 64, 1, 0
POH_SHRED_DEPTH, SHRED_STORE_DEPTH, SIGN_DEPTH = 4096, 4096, 256


def leader(
    pool=None,
    *,
    total: int | None = None,
    repeat: int = 1,
    max_lanes: int = 4096,
    n_banks: int = 2,
    pack_device_select: bool = True,
    idle_sleep_s: float = 50e-6,
    paced: bool = False,
    slot_ms: float = 400.0,
    blockstore_path: str | None = None,
    device=None,
    stem: str | None = None,
    front: str = "synth",
    traffic=None,
    identity_secret: bytes | None = None,
) -> dict:
    """Build synth -> verify -> dedup -> pack -> bank x n_banks -> poh ->
    shred <-> sign -> store in the thread runtime
    (firedancer_tpu/app/config.py's wiring), with a recording SinkTile as a
    second reliable consumer of each bank{i}_poh ring; stream `total`
    frags as `ingress` does (or, when paced, at most PACK_DEPTH - n_banks x
    PACK_MB_INFLIGHT x PACK_TXN_LIMIT of them in flight: published and not
    yet executed at a bank or dropped before one, so that pack's buffer
    never fills and rejects nothing), and run until every txn that reached pack has
    been executed, completed at pack and its microblock taken by its sink
    and mixed by the PoH tile, every slot up to the one holding the last
    mixin has passed its boundary, and the store has completed each of
    those slots; -> a report (see below).

    The front is `ingress`'s (same pool default, VerifyTile, DedupTile,
    rings that hold the run; front="wire", traffic and identity_secret as
    there, and then paced is refused and the report carries `wire`).  Pack
    is PackTile(n_banks, depth 4096, mb_inflight 1, 2 ms microblock
    cadence, txn_limit 31, cu_limit
    1,500,000, 400 ms slot; scan_limit 1024 over 1024 account bits) with
    its select on `device` when pack_device_select (None: the CUDA card,
    through the pack_select kernel).  The banks are fee-only BankTiles.
    Bank rings: depth 1 << max(64, 4 * mb_inflight).bit_length(), the
    microblock MTU 65,535.  The egress: PohTile(ticks_per_slot=64,
    slot_ms) on every bank{i}_poh ring -> poh_shred (depth 4096, MTU 104)
    -> ShredTile(shred_version=1, its shredder on `device`) <-> SignTile
    ([ROLE_SHRED], an identity key made from IDENTITY_SEED) over
    shred_sign (256, MTU 32) and sign_shred (256, MTU 64) -> shred_store
    (4096, MTU 1228) -> StoreTile (Reed-Solomon recovery on `device`) in
    blockstore_path, or in a temporary directory that is removed after the
    run.  slot_ms paces the PoH clock (JAX's 400 ms slots; the CPU tests
    shorten it).  device=None raises "no CUDA device" on a host without
    one; "cpu" runs the plain versions (tests).  stem: the run loop's
    inner loop for every tile, "python" (None) or "native"; under "native"
    net, dedup, pack (with pack_device_select in its insert-only shape), poh
    and shred run on the native stem and the other tiles keep the Python
    loop.
    Counters land once a burst on the stem, so done() reads them up to one
    burst late; it never reads them early.

    The report: `counters` (every tile's counters), `pool`, `microblocks`
    (per sink, in arrival order: (bank, handle, [txn payloads])),
    `microblock_payloads` (every sink's raw microblocks), `pack_engine`
    (the drained engine's state: inflight and pending txns, occupied
    lock-table entries, non-zero lock counts and bitset refcounts),
    `paced` (as given), `seconds` (from every tile in RUN until every
    microblock was executed and taken by its sink), `front_seconds` (to the
    moment verify and dedup were done), `egress_seconds` (to the moment
    every mixed slot was stored), `txns_per_s` (total / seconds), `executed_per_s`, the e2e
    p50/p99 at the sinks (from pack's publish of the microblock, which
    stamps its origin as the JAX tile does) and the verify hop's p99 (µs),
    `identity` (the signing key's public key), `slots_mixed` (slots 0 ..
    the one holding the last mixin), `shred_tile` (its pending FEC sets,
    queued sign requests and queued shreds after the halt) and
    `blockstore` (`path`: blockstore_path or None, and every stored slot's
    `blocks` and `shreds` read back), and `stem` (as in `ingress`)."""
    import shutil
    import tempfile
    import time

    from .ballet import shred as SH
    from .disco.topo import Topology
    from .ops.ed25519 import hostpath
    from .tiles.bank import BankTile
    from .tiles.pack import PackTile, mb_decode
    from .tiles.poh import ENTRY_SZ, PohTile
    from .tiles.shred import ShredTile
    from .tiles.sign import ROLE_SHRED, SignTile
    from .tiles.sink import SinkTile
    from .tiles.store import StoreTile
    from .utils import devices

    dev = devices.resolve(device)
    # the card first: the pack tile resolves its select device at once
    pack = PackTile(n_banks, depth=PACK_DEPTH, mb_inflight=PACK_MB_INFLIGHT,
                    microblock_ns=PACK_MICROBLOCK_NS, txn_limit=PACK_TXN_LIMIT,
                    slot_ns=PACK_SLOT_NS, use_device_select=pack_device_select,
                    device=dev)
    identity = np.random.default_rng(IDENTITY_SEED).integers(
        0, 256, 32, np.uint8).tobytes()
    path = blockstore_path or tempfile.mkdtemp(prefix="fdt_blockstore_")
    topo = Topology(stem=stem)
    window = PACK_DEPTH - n_banks * PACK_MB_INFLIGHT * PACK_TXN_LIMIT

    def release() -> int:
        gone = (mv.counter("verify_fail_txns") + mv.counter("dedup_drop_txns")
                + md.counter("dup_txns") + mp.counter("insert_rejected")
                + sum(m.counter("executed_txns") for m in mbanks))
        return min(total, gone + window)

    fr = None
    try:
        fr, verify, pool = _front(topo, pool, total, repeat, max_lanes, dev,
                                  "dedup_pack", front=front, traffic=traffic,
                                  identity_secret=identity_secret,
                                  release=release if paced else None)
        total = fr.total
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
        poh = PohTile(ticks_per_slot=TICKS_PER_SLOT, slot_ms=slot_ms)
        shred = ShredTile(shred_version=SHRED_VERSION, device=dev)
        store = StoreTile(path, device=dev)
        topo.link("poh_shred", depth=POH_SHRED_DEPTH, mtu=ENTRY_SZ)
        topo.link("shred_store", depth=SHRED_STORE_DEPTH, mtu=SH.MAX_SZ)
        topo.link("shred_sign", depth=SIGN_DEPTH, mtu=32)
        topo.link("sign_shred", depth=SIGN_DEPTH, mtu=64)
        topo.tile(poh, ins=[(f"bank{i}_poh", True) for i in range(n_banks)],
                  outs=["poh_shred"])
        topo.tile(shred, ins=[("poh_shred", True), ("sign_shred", True)],
                  outs=["shred_store", "shred_sign"])
        topo.tile(SignTile(identity, roles=[ROLE_SHRED]), ins=[("shred_sign", True)],
                  outs=["sign_shred"])
        topo.tile(store, ins=[("shred_store", True)])
        tiles = (*fr.tiles, "verify", "dedup", "pack",
                 *(f"bank{i}" for i in range(n_banks)),
                 *(f"sink{i}" for i in range(n_banks)),
                 "poh", "shred", "sign", "store")
        topo.build()
        md, mp = topo.metrics("dedup"), topo.metrics("pack")
        mpoh, mstore = topo.metrics("poh"), topo.metrics("store")
        mbanks = [topo.metrics(f"bank{i}") for i in range(n_banks)]
        msinks = [topo.metrics(f"sink{i}") for i in range(n_banks)]

        marks = {}
        mv = topo.metrics("verify")

        def done() -> bool:
            if front == "wire" and not _wire_done(topo, fr, marks):
                return False
            if not _front_done(topo, total):
                return False
            marks.setdefault("front", time.perf_counter())
            taken = mp.counter("inserted_txns") + mp.counter("insert_rejected")
            mbs = mp.counter("microblocks")
            executed = sum(m.counter("executed_microblocks") for m in mbanks)
            if not (
                taken >= md.counter("out_frags")
                and mp.counter("microblock_txns") >= mp.counter("inserted_txns")
                and mp.counter("completions") >= mbs
                and executed + sum(m.counter("malformed_microblocks")
                                   for m in mbanks) >= mbs
                and sum(m.counter("sunk_frags") for m in msinks) >= executed
            ):
                return False
            marks.setdefault("executed", time.perf_counter())
            if mpoh.counter("mixins") < executed:
                return False
            # read after the mixin count: the slot that holds the last mixin
            # or a later one
            last = marks.setdefault("slot", poh.slot)
            return (poh.slot > last
                    and mstore.counter("completed_slots") >= last + 1)

        t0, dt, counters, _boot_s = _run(topo, fr, idle_sleep_s, max_lanes, done,
                                         tiles, "leader")
        lat = {}
        for i, m in enumerate(msinks):
            lat.update(_percentiles(m, f"e2e_us_bank{i}_poh", f"e2e_sink{i}"))
        hv = _percentiles(topo.metrics("verify"), f"svc_us_{fr.in_link}", "verify_hop")
        lat.update({k: v for k, v in hv.items() if k.endswith("p99_us")})
        # the store has halted: its files are final
        bs = store.store
        stored = bs.slots()
        blockstore = {"path": blockstore_path,
                      "blocks": {s: bs.block(s) for s in stored},
                      "shreds": {s: bs.shreds(s) for s in stored}}
    finally:
        topo.close()
        if front == "wire" and fr is not None:
            fr.traffic.close()
        if blockstore_path is None:
            shutil.rmtree(path, ignore_errors=True)
    eng = pack.engine
    microblocks, payloads = [], []
    for s in sinks:
        got = []
        for rows, szs in zip(s.payloads, s.sizes):
            for row, sz in zip(rows, szs):
                payloads.append(row[:sz].tobytes())
                handle, bank, txns = mb_decode(row[:sz])
                got.append((bank, handle, [bytes(t) for t in txns]))
        microblocks.append(got)
    executed = sum(counters[f"bank{i}"]["executed_txns"] for i in range(n_banks))
    seconds = marks["executed"] - t0
    return {
        "counters": counters,
        "pool": {"rows": pool[0], "szs": pool[1], "good": pool[2],
                 "tags": fr.tags},
        "microblocks": microblocks,
        "microblock_payloads": payloads,
        "pack_engine": {
            "inflight": eng.inflight_cnt, "pending": eng.pending_cnt,
            "outstanding": eng.outstanding_cnt,
            "lock_keys": int((eng.lw_keys != 0).sum() + (eng.lr_keys != 0).sum()),
            "lock_counts": int((eng.lw_vals != 0).sum() + (eng.lr_vals != 0).sum()),
            "bit_refs": int((eng.bit_ref_rw != 0).sum() + (eng.bit_ref_w != 0).sum()),
        },
        "total": total, "paced": paced, "seconds": seconds,
        "txns_per_s": total / seconds,
        "front_seconds": marks["front"] - t0, "egress_seconds": dt,
        "executed_per_s": executed / seconds, **lat,
        "identity": hostpath.public_from_secret(identity),
        "slots_mixed": marks["slot"] + 1,
        "shred_tile": {"pending": shred.pending_cnt, "signq": shred.signq_len,
                       "outq": shred.outq_len},
        "blockstore": blockstore,
        "stem": {"mode": stem or "python", "tiles": _stem_report(counters)},
        **({"wire": _wire_report(fr, counters, marks, t0)} if front == "wire" else {}),
    }


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", tuple(out.shape), str(out.dtype), out.device)
