"""The port's ring library (firedancer_tpu_torch/tango/, built from its own
copies of fdt_tango.c, fdt_sha512.c and fdt_trace.c) against the JAX
package's, on the same seeded streams in one process: the two libraries load
side by side, each with its own constant tables.  Everything compared is
bytes, bools or counts, so every comparison is exact."""

import hashlib

import numpy as np
import pytest

from firedancer_tpu.ballet import txn as TJ
from firedancer_tpu.disco import metrics as MJ
from firedancer_tpu.disco import trace as TRJ
from firedancer_tpu.tango import rings as RJ
from firedancer_tpu.tango import tempo as TEJ
from firedancer_tpu.tiles import wire as WJ
from firedancer_tpu.waltz import pcap as PJ
from firedancer_tpu_torch.ballet import txn as T
from firedancer_tpu_torch.disco import metrics as M
from firedancer_tpu_torch.disco import trace as TR
from firedancer_tpu_torch.tango import rings as R
from firedancer_tpu_torch.tango import tempo as TE
from firedancer_tpu_torch.tiles import wire as W
from firedancer_tpu_torch.tiles.synth import make_txn_pool
from firedancer_tpu_torch.utils import cbuild
from firedancer_tpu_torch.waltz import pcap as P


def _wksp(mod, size=1 << 22):
    return mod.Workspace(size)  # anonymous (numpy-backed) only


def test_port_library_is_its_own_build():
    """Built from the port's sources into the port's _build/, and loaded as a
    second library beside the JAX package's."""
    R.trace_now()  # the first use builds and loads the library
    so = cbuild.library_path("fdt_tango", R._NATIVE_SOURCES)
    assert so.exists() and so.is_relative_to(cbuild.BUILD)
    assert [p.name for p in R._NATIVE_SOURCES] == [
        "fdt_tango.c", "fdt_sha512.c", "fdt_trace.c", "fdt_pack.c"]
    assert R._Library._cdll._name == str(so) != RJ._lib._name
    # named workspaces live under the port's own /dev/shm prefix, which the
    # JAX package's fdt_wksp_* globs never match
    assert R.SHM_PREFIX == "/dev/shm/fdt_torch_wksp_"
    assert not R.SHM_PREFIX.startswith("/dev/shm/fdt_wksp_")


@pytest.mark.parametrize("seed,n,depth", [(1, 40, 64), (2, 300, 128), (3, 1000, 256)])
def test_mcache_dcache_round_trip_matches_jax(seed, n, depth):
    """publish_batch of payload rows -> drain -> gather, in chunks of a
    quarter ring (so the producer laps the ring), on both libraries."""
    rng = np.random.default_rng(seed)
    sigs = rng.integers(0, 2**63, n, dtype=np.uint64)
    szs = rng.integers(1, 300, n).astype(np.uint16)
    rows = rng.integers(0, 256, (n, 300), dtype=np.uint8)
    tsorigs = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    outs = []
    for mod in (R, RJ):
        ws = _wksp(mod)
        mc = mod.MCache.create(ws, "mc", depth)
        dc = mod.DCache.create(ws, "dc", 300, depth)
        seq, cons = 0, 0
        got_frags, got_rows, got_chunks = [], [], []
        step = depth // 4
        for lo in range(0, n, step):
            sl = slice(lo, lo + step)
            chunks = dc.write_batch(rows[sl], szs[sl])
            got_chunks.append(chunks)
            seq = mc.publish_batch(seq, sigs[sl], chunks, szs[sl],
                                   tspub=7, tsorigs=tsorigs[sl])
            frags, cons, ovr = mc.drain(cons, depth)
            assert ovr == 0
            got_frags.append(frags)
            got_rows.append(dc.read_batch(frags["chunk"], frags["sz"], 300))
        frags = np.concatenate(got_frags)
        outs.append((frags, np.concatenate(got_rows), np.concatenate(got_chunks),
                     seq, cons))
    (fp, rp, cp, sp, kp), (fj, rj, cj, sj, kj) = outs
    assert sp == sj == kp == kj == n
    assert fp.tobytes() == fj.tobytes()
    np.testing.assert_array_equal(cp, cj)
    np.testing.assert_array_equal(rp, rj)
    np.testing.assert_array_equal(fp["sig"], sigs)
    for i in range(n):
        assert (rp[i, : szs[i]] == rows[i, : szs[i]]).all()
        assert not rp[i, szs[i]:].any()


def test_mcache_overrun_and_poll_match_jax():
    """A consumer lapped by the producer: the same overrun count and resync
    point; poll on an empty line reports -1 on both."""
    sigs = np.arange(1, 301, dtype=np.uint64)
    res = []
    for mod in (R, RJ):
        mc = mod.MCache.create(_wksp(mod), "mc", 64)
        mc.publish_batch(0, sigs, tspub=1)
        frags, seq, ovr = mc.drain(0, 1000)
        rc, _f, now = mc.poll(seq)
        res.append((frags.tobytes(), seq, ovr, rc, mc.seq_query()))
    assert res[0] == res[1]
    assert res[0][1] == 300 and res[0][2] > 0 and res[0][3] == -1


@pytest.mark.parametrize("depth,alphabet,n", [(16, 40, 500), (64, 100, 2000), (1024, 3000, 6000)])
def test_tcache_dedup_matches_jax(depth, alphabet, n):
    """A stream with repeats inside the window and evictions past it."""
    rng = np.random.default_rng(depth)
    tags = rng.integers(1, alphabet + 1, n).astype(np.uint64)
    masks = []
    for mod in (R, RJ):
        tc = mod.TCache.create(_wksp(mod), "tc", depth)
        masks.append(np.concatenate([tc.dedup(tags[i : i + 97])
                                     for i in range(0, n, 97)]))
        masks.append(np.array([tc.query(int(t)) for t in range(1, alphabet + 1)]))
    np.testing.assert_array_equal(masks[0], masks[2])
    np.testing.assert_array_equal(masks[1], masks[3])
    assert masks[0].any() and not masks[0].all()


def test_tcache_region_filled_by_jax_answers_the_same_in_the_port():
    """State carried across: the JAX package fills a tag cache; its bytes,
    copied into the port's TCache (joined, not re-initialized), answer the
    same dedup queries as the JAX cache does."""
    depth = 256
    rng = np.random.default_rng(11)
    fill = rng.integers(1, 2000, 3000).astype(np.uint64)
    queries = rng.integers(1, 2000, 1500).astype(np.uint64)
    tj = RJ.TCache.create(_wksp(RJ), "tc", depth)
    tj.dedup(fill)
    map_cnt = R.TCache.map_cnt_for(depth)
    mem = np.zeros(R.TCache.footprint(depth, map_cnt), np.uint8)
    assert len(mem) == len(tj.mem)
    mem[:] = tj.mem
    tp = R.TCache(mem, depth, map_cnt, join=True)
    np.testing.assert_array_equal(tp.dedup(queries), tj.dedup(queries))
    np.testing.assert_array_equal(tp.mem, tj.mem)


def _multi_sig_txn(rng, n_sig: int) -> bytes:
    """A txn with n_sig signatures (random bytes) and n_sig signer keys."""
    addrs = [rng.bytes(32) for _ in range(n_sig + 2)]
    body = T.build([rng.bytes(64) for _ in range(n_sig)], addrs, rng.bytes(32),
                   [(len(addrs) - 1, [0, 1], rng.bytes(int(rng.integers(1, 40))))],
                   readonly_unsigned_cnt=1)
    return W.append_trailer(body, T.parse(body))


def _expand_stream(seed: int):
    """Rows of a signed pool, multi-signature txns and one payload too short
    for a trailer (a poisoned lane)."""
    rng = np.random.default_rng(seed)
    rows, szs, _ = make_txn_pool(6, corrupt_frac=0.3, seed=seed)
    extra = [_multi_sig_txn(rng, k) for k in (2, 3, 1)] + [b"\x01" * 10]
    ext_rows = np.zeros((len(extra), W.LINK_MTU), np.uint8)
    for i, b in enumerate(extra):
        ext_rows[i, : len(b)] = np.frombuffer(b, np.uint8)
    return (np.concatenate([rows, ext_rows]),
            np.concatenate([szs, np.array([len(b) for b in extra], np.uint16)]))


@pytest.mark.parametrize("seed", [3, 4])
def test_expand_native_matches_jax_and_hashlib(seed):
    """wire.expand_native (gather + trailer parse + lane expansion + tags +
    SHA512(R || A || M) digests in one native call) against the JAX
    package's on the same dcache stream; digests against hashlib, which
    fails if the port's library were left without its SHA-512 constants."""
    rows, szs = _expand_stream(seed)
    outs = []
    for mod, wmod in ((R, W), (RJ, WJ)):
        ws = _wksp(mod)
        mc = mod.MCache.create(ws, "mc", 64)
        dc = mod.DCache.create(ws, "dc", wmod.LINK_MTU, 64)
        mc.publish_batch(0, np.arange(len(rows), dtype=np.uint64),
                         dc.write_batch(rows, szs), szs, tspub=1)
        frags, _, _ = mc.drain(0, 64)
        outs.append(wmod.expand_native(dc, frags, 256, with_digests=True))
    p, j = outs
    assert sorted(p) == sorted(j)
    for k in p:
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    assert list(p["sig_cnt"][-4:]) == [2, 3, 1, 1]
    lanes = len(p["sigs"])
    assert lanes == int(p["sig_cnt"].sum())
    for lane in range(lanes):
        t = p["txn_idx"][lane]
        m = p["msgs"][lane, : p["lens"][lane]].tobytes()
        want = hashlib.sha512(p["sigs"][lane, :32].tobytes()
                              + p["pubs"][lane].tobytes() + m).digest()
        if szs[t] < W.TRAILER_SZ:  # the poisoned lane: zeros
            assert not p["digests"][lane].any() and p["tags"][t] == 0
        else:
            assert p["digests"][lane].tobytes() == want
    # tags: the first 8 bytes of the first signature, little-endian
    tr = W.parse_trailers(rows[:-1], szs[:-1].astype(np.int64))
    for t in range(len(rows) - 1):
        off = tr["sig_off"][t]
        assert p["tags"][t] == int.from_bytes(rows[t, off : off + 8].tobytes(), "little")


def test_wire_parsers_match_jax():
    rows, szs = _expand_stream(5)
    rows, szs = rows[:-1], szs[:-1].astype(np.int64)
    tp, tj = W.parse_trailers(rows, szs), WJ.parse_trailers(rows, szs)
    assert sorted(tp) == sorted(tj)
    for k in tp:
        np.testing.assert_array_equal(tp[k], tj[k])
    for i in range(len(rows)):
        body = rows[i, : tp["txn_sz"][i]].tobytes()
        dp, dj = T.parse(body), TJ.parse(body)
        assert repr(dp) == repr(dj) and dp.message(body) == dj.message(body)


@pytest.mark.parametrize("a,b", [(5, 3), (3, 5), (0, 2**64 - 1), (2**64 - 1, 0),
                                 (2**63, 1), (1, 2**63 + 2)])
def test_seq_and_credit_helpers_match_jax(a, b):
    for fn in ("seq_diff", "seq_lt", "seq_le", "seq_min", "seq_max"):
        assert getattr(R, fn)(a, b) == getattr(RJ, fn)(a, b), fn
    assert R.cr_avail(a, b, 1024) == RJ.cr_avail(a, b, 1024)
    assert R.trace_ts_diff(a, b) == RJ.trace_ts_diff(a, b)


def test_rejoin_helpers_match_jax():
    res = []
    for mod in (R, RJ):
        ws = _wksp(mod)
        mc = mod.MCache.create(ws, "mc", 64)
        fs = mod.FSeq.create(ws, "fs")
        mc.publish_batch(0, np.arange(100, dtype=np.uint64), tspub=1)
        fs.update(70)
        res.append((mod.consumer_rejoin(mc, fs, replay=10),
                    mod.consumer_rejoin(mc, fs, reliable=False),
                    mod.producer_rejoin(mc)))
    assert res[0] == res[1]


def test_cnc_and_fseq_match_jax():
    res = []
    for mod in (R, RJ):
        ws = _wksp(mod)
        cnc = mod.CNC.create(ws, "cnc")
        fs = mod.FSeq.create(ws, "fs", seq0=9)
        s0 = cnc.signal_query()
        cnc.signal(mod.CNC_HALT)
        cnc.heartbeat(1234)
        fs.diag_add(0, 5)
        res.append((s0, cnc.signal_query(), cnc.heartbeat_query(), fs.query(), fs.diag(0)))
    assert res[0] == res[1] == (R.CNC_BOOT, R.CNC_HALT, 1234, 9, 5)


def test_metrics_hists_and_native_sample_match_jax():
    """Metrics words, hist percentiles, and the port library's native hist
    sample word-identical to Metrics.hist_sample."""
    schema = M.MetricsSchema(counters=("a",), hists=("h", "w"), wide_hists=("w",))
    schema_j = MJ.MetricsSchema(counters=("a",), hists=("h", "w"), wide_hists=("w",))
    vals = np.random.default_rng(3).integers(-5, 1 << 26, 500)
    mp = M.Metrics(np.zeros(M.Metrics.footprint(schema), np.uint8), schema)
    mj = MJ.Metrics(np.zeros(MJ.Metrics.footprint(schema_j), np.uint8), schema_j)
    mn = M.Metrics(np.zeros(M.Metrics.footprint(schema), np.uint8), schema)
    for m in (mp, mj):
        m.inc("a", 3)
        m.hist_sample_many("h", vals[:250])
        for v in vals[250:]:
            m.hist_sample("w", int(v))
    addr, nb = mn.hist_ref("w")
    for v in vals[250:]:
        R.trace_hist_sample(addr, nb, int(v))
    np.testing.assert_array_equal(mp.words, mj.words)
    assert mn.hist("w") == mp.hist("w")
    for q in (0, 50, 99, 100):
        assert M.hist_percentile(mp.hist("h"), q) == MJ.hist_percentile(mj.hist("h"), q)
        assert M.hist_percentile(mp.hist("w"), q) == MJ.hist_percentile(mj.hist("w"), q)


def test_span_ring_and_native_span_match_jax():
    """Tracer events (ingest, publish, point) byte-identical to the JAX
    package's, and the port library's native span writer to Tracer.point."""
    frags = np.zeros(5, dtype=R.FRAG_DTYPE)
    frags["seq"] = np.arange(5)
    frags["sig"] = np.arange(10, 15)
    frags["tsorig"] = 3
    frags["tspub"] = 4
    rings = []
    for mod in (TR, TRJ):
        ring = mod.SpanRing(np.zeros(mod.SpanRing.footprint(64), np.uint8), 64, 1)
        tr = mod.Tracer(ring, 1)
        tr.ingest(2, frags, 99)
        tr.publish(3, 7, frags["sig"], 100, None)
        tr.point(mod.LAND, ts=5, seq=1, aux16=2, aux64=3)
        rings.append(ring)
    np.testing.assert_array_equal(rings[0].words, rings[1].words)
    a = TR.SpanRing(np.zeros(TR.SpanRing.footprint(8), np.uint8), 8, 1)
    b = TR.SpanRing(np.zeros(TR.SpanRing.footprint(8), np.uint8), 8, 1)
    TR.Tracer(a, 1).point(TR.DISPATCH, ts=77, seq=5, sig=6, aux16=1, aux64=9, link=2)
    R.trace_span(b.words, TR.DISPATCH, link=2, aux16=1, ts=77, seq=5, sig=6, aux64=9)
    np.testing.assert_array_equal(a.words, b.words)
    assert TR.decode(a.read()[0])[0]["aux64"] == 9


def test_tempo_matches_jax():
    for cr in (1, 64, 4096, 1 << 20, 1 << 26):
        assert TE.lazy_default(cr) == TEJ.lazy_default(cr)
    for lazy in (2, 1000, 123457):
        for rng_u32 in (0, 7, 2**32 - 1):
            assert TE.async_reload(lazy, rng_u32) == TEJ.async_reload(lazy, rng_u32)


def test_pcap_round_trips_across_packages(tmp_path):
    rows, szs, _ = make_txn_pool(5, seed=8)
    payloads = [rows[i, : szs[i] - W.TRAILER_SZ].tobytes() for i in range(5)]
    for writer, reader, name in ((P, PJ, "a"), (PJ, P, "b")):
        path = str(tmp_path / f"{name}.pcap")
        w = writer.PcapWriter(path)
        for i, p in enumerate(payloads):
            w.write(p, ts_us=1000 * i)
        w.close()
        assert reader.read_udp_payloads(path) == [(1000 * i, p) for i, p in enumerate(payloads)]
