"""The port's native stem (firedancer_tpu_torch/tango/native/fdt_stem.c with
its dedup, pack, PoH and shred handlers, fdt_pack_sched, fdt_sha256,
fdt_poh.c and fdt_shred.c, driven through tango/rings.py's Stem) against
the JAX package's stem and the port's Python loop, on raw rings.

Each case feeds one seeded frag sequence, made with numpy, through three
loops: the JAX tile on the JAX package's native stem, the port's tile on
the port's stem, and the port's tile on the port's Python loop (on_frags
and after_credit called as run_loop calls them).  The stem loops follow
run_loop's contract: a burst that hands back (STEM_PYTHON) falls through
to the Python drain and after_credit, a spec with an after-credit hook
skips the Python after_credit otherwise, and a closed `ready` gate keeps
the Python loop.  What each loop publishes (sig, size, ctl, payload, in
order) and the tile's state afterwards must be byte-identical across the
three.  Each package's ring library is loaded in one process, as
tests/test_torch_rings.py does.  No wall clock (PoH unpaced, pack's
cadence 0 and its slot at 10^15 ns or 1 ns), no processes, no named
workspaces."""

import hashlib
from types import SimpleNamespace

import numpy as np
import pytest

from firedancer_tpu.disco import metrics as METJ
from firedancer_tpu.disco import mux as MJ
from firedancer_tpu.disco import trace as TRJ
from firedancer_tpu.tango import rings as RJ
from firedancer_tpu.tiles import dedup as DEDJ
from firedancer_tpu.tiles import pack as PACKJ
from firedancer_tpu.tiles import poh as POHJ
from firedancer_tpu.tiles import shred as SHREDJ
from firedancer_tpu_torch.ballet import shred as SH
from firedancer_tpu_torch.disco import metrics as METT
from firedancer_tpu_torch.disco import mux as MT
from firedancer_tpu_torch.disco import trace as TRT
from firedancer_tpu_torch.tango import rings as RT
from firedancer_tpu_torch.tiles import dedup as DEDT
from firedancer_tpu_torch.tiles import pack as PACKT
from firedancer_tpu_torch.tiles import poh as POHT
from firedancer_tpu_torch.tiles import shred as SHREDT
from firedancer_tpu_torch.tiles import wire

import torch_stem_rig as RIG
from torch_stem_rig import TSPUB, Rig

SIDES = {
    "jax": SimpleNamespace(R=RJ, M=MJ, MET=METJ, TR=TRJ, dedup=DEDJ, pack=PACKJ,
                           poh=POHJ, shred=SHREDJ),
    "torch": SimpleNamespace(R=RT, M=MT, MET=METT, TR=TRT, dedup=DEDT, pack=PACKT,
                             poh=POHT, shred=SHREDT),
}
#: (package, loop) of the three loops every case runs
LOOPS = (("jax", "stem"), ("torch", "stem"), ("torch", "python"))
ENTRY_SZ = POHT.ENTRY_SZ


def _same(results):
    """Every loop's result equals the first's, value by value (numpy arrays
    byte for byte)."""
    ref = results[LOOPS[0]]
    for key, res in results.items():
        assert res.keys() == ref.keys()
        for k in ref:
            a, b = ref[k], res[k]
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), (key, k)
            else:
                assert a == b, (key, k, a, b)


# ---------------------------------------------------------------------------
# dedup


def _dedup_rig(side, loop):
    return Rig(SIDES[side], loop, SIDES[side].dedup.DedupTile(depth=1 << 10),
               [(512, 512)], [(512, 512)])


def _dedup_batch(rng, n, n_tags):
    """n frags: tags drawn from n_tags values (in-batch and cross-batch
    duplicates) with a few zero tags (pass-through survivors), payloads of
    seeded bytes and sizes, origin stamps."""
    sigs = rng.integers(1, n_tags + 1, n).astype(np.uint64) * 1009
    sigs[rng.choice(n, 3, replace=False)] = 0
    szs = rng.integers(40, 400, n).astype(np.uint16)
    rows = rng.integers(0, 256, (n, 400), np.uint8)
    return sigs, rows, szs, rng.integers(0, 1 << 32, n).astype(np.uint32)


def test_dedup_matches_across_loops():
    """Two batches with duplicates inside and across them and zero tags:
    the survivors' stream (sig, size, ctl, carried tsorig, payload), the dup
    count, the tag cache's bytes and the journal words match."""
    results = {}
    for side, loop in LOOPS:
        rig = _dedup_rig(side, loop)
        rng = np.random.default_rng(31)
        stream = []
        for n in (96, 64):
            sigs, rows, szs, tso = _dedup_batch(rng, n, 48)
            rig.feed(0, sigs, rows, szs, tso)
            rig.step()
            stream += rig.drain(0, with_tsorig=True)
        tile = rig.tile
        results[(side, loop)] = {
            "stream": stream, "dup_txns": rig.counter("dup_txns"),
            "tcache": tile._tc.mem.copy(), "journal": tile._jnl.copy(),
        }
        if loop == "stem":
            assert rig.bursts == 2 and rig.handbacks == 0
    _same(results)
    ref = results[LOOPS[0]]
    assert 0 < len(ref["stream"]) < 160 and ref["dup_txns"] > 0
    assert int(ref["journal"][0]) == 0  # the phase word is clear


def test_dedup_amnesty_gate_keeps_the_python_loop():
    """A pending replay amnesty closes the handler's `ready` gate: the
    Python path consumes the grant (the amnestied duplicate goes through
    once), then the stem engages again.  All three loops publish the same
    stream."""
    results = {}
    for side, loop in LOOPS:
        rig = _dedup_rig(side, loop)
        row = np.arange(64, dtype=np.uint8)[None, :]
        sz = np.array([64], np.uint16)
        rig.feed(0, [77], row, sz)
        rig.step()
        rig.tile._amnesty = {77}
        if loop == "stem":
            assert not rig.spec.ready()
        rig.feed(0, [77, 78], np.repeat(row, 2, 0), np.repeat(sz, 2))
        rig.step()
        assert rig.tile._amnesty == set()
        rig.feed(0, [77, 79], np.repeat(row, 2, 0), np.repeat(sz, 2))
        rig.step()
        results[(side, loop)] = {"stream": rig.drain(0, with_tsorig=True),
                                 "dup_txns": rig.counter("dup_txns")}
        if loop == "stem":
            assert (rig.bursts, rig.gated) == (2, 1)
    _same(results)
    assert [s for s, *_ in results[LOOPS[0]]["stream"]] == [77, 77, 78, 79]


# ---------------------------------------------------------------------------
# pack: insert, completions and the native scheduler (fdt_pack_sched)


def _pack_tile(side, n_banks, depth, slot_ns, select, mb_inflight=2):
    kw = {"depth": depth, "mb_inflight": mb_inflight, "microblock_ns": 0,
          "slot_ns": slot_ns}
    if select:
        kw["use_device_select"] = True
        if side == "torch":
            kw["device"] = "cpu"
    return SIDES[side].pack.PackTile(n_banks, **kw)


def _run_pack(side, loop, pool_n=300, depth=512, n_banks=2, slot_ns=10**15,
              select=False):
    """rig.run_pack on the side's PackTile; the handler's shape checked:
    the native scheduler without the select, insert-only with it."""
    res, r = RIG.run_pack(SIDES[side], loop,
                          _pack_tile(side, n_banks, depth, slot_ns, select), pool_n)
    if loop == "stem":
        assert bool(r.spec.ac_handler) == (not select)
        assert r.spec.native_ins == ((0,) if select else None)
    return res, r


@pytest.mark.parametrize("pool_n, depth", [(300, 512), (300, 128)],
                         ids=["fits", "pool_full"])
def test_pack_matches_across_loops(pool_n, depth):
    """Insert, the native scheduler and the completion rings: the microblock
    stream (bank, sig, size, encoded bytes) and every engine array (pool,
    exact lock tables, writer-cost map, scheduler words, registry) match.
    With the pool smaller than the corpus, the insert path hands the
    eviction back to Python before it mutates anything."""
    results, rigs = {}, {}
    for side, loop in LOOPS:
        results[(side, loop)], rigs[(side, loop)] = _run_pack(side, loop, pool_n, depth)
    _same(results)
    ref = results[LOOPS[0]]
    assert ref["microblocks"] > 0 and ref["completions"] == ref["microblocks"]
    assert ref["microblock_txns"] == ref["inserted_txns"]
    for key in LOOPS[:2]:
        rig = rigs[key]
        assert rig.ctrs["microblocks"] == ref["microblocks"]  # all native
        if depth < pool_n:
            assert ref["insert_rejected"] > 0 and rig.handbacks > 0
            # the eviction decided on the Python path
            assert rig.ctx.metrics.counter("insert_rejected") > 0
        else:
            assert rig.ctx.metrics.counter("inserted_txns") == 0


def test_pack_end_of_block_hands_back():
    """Past the block deadline the hook keeps draining completions while
    microblocks are outstanding and hands back with none, so the Python
    end_block resets the budgets: block counts and budget words match."""
    results, rigs = {}, {}
    for side, loop in LOOPS:
        results[(side, loop)], rigs[(side, loop)] = _run_pack(
            side, loop, pool_n=96, depth=128, slot_ns=1)
    _same(results)
    assert results[LOOPS[0]]["blocks"] >= 1
    for key in LOOPS[:2]:
        assert rigs[key].handbacks >= results[LOOPS[0]]["blocks"]


def test_pack_stale_completion_is_a_metered_drop():
    """A completion whose (bank, handle) is not outstanding is counted in
    stale_completions, on every loop, and releases nothing."""
    for side, loop in LOOPS:
        rig = Rig(SIDES[side], loop, _pack_tile(side, 1, 64, 10**15, False),
                  [(64, wire.LINK_MTU), (64, 0)], [(64, 65_535)])
        rig.feed(1, [(0 << 32) | 7, (5 << 32) | 9])
        rig.step()
        assert rig.counter("stale_completions") == 2, (side, loop)
        assert rig.tile.engine.outstanding_cnt == 0 and int(rig.tile.bank_busy[0]) == 0
        if loop == "stem":
            assert rig.handbacks == 0


def test_pack_insert_only_with_device_select():
    """With use_device_select (the port's select on device="cpu") the
    handler keeps the insert-only shape: completions hand back, and the
    Python after_credit schedules through the select every iteration.  The
    microblocks and engine arrays match the JAX package's stem (its own
    select) and the port's Python loop."""
    results, rigs = {}, {}
    for side, loop in LOOPS:
        results[(side, loop)], rigs[(side, loop)] = _run_pack(
            side, loop, pool_n=64, depth=128, select=True)
    _same(results)
    ref = results[LOOPS[0]]
    assert ref["microblocks"] > 0 and ref["microblock_txns"] == ref["inserted_txns"] == 64
    for key in LOOPS[:2]:
        rig = rigs[key]
        assert rig.ctrs["inserted_txns"] == 64 and rig.handbacks > 0
        assert rig.ctx.metrics.counter("inserted_txns") == 0


# ---------------------------------------------------------------------------
# poh: fdt_poh_mixins (frag handler) and fdt_poh_tick (after-credit hook)


def test_poh_matches_across_loops():
    """Microblocks mixed in between unpaced tick batches that cross slot
    boundaries: the entry stream (sig, size, bytes) and the chain state,
    hashcnt, slot and tick words match; the entries chain prev to state."""
    results = {}
    for side, loop in LOOPS:
        tile = SIDES[side].poh.PohTile(tick_batch=8, ticks_per_slot=16, slot_ms=0)
        rig = Rig(SIDES[side], loop, tile, [(1024, 1024), (1024, 1024)], [(1024, ENTRY_SZ)],
                  cap=64)
        rng = np.random.default_rng(57)
        stream = []
        for r in range(6):
            for i in (0, 1):
                n = int(rng.integers(1, 6))
                szs = rng.integers(40, 1000, n).astype(np.uint16)
                rig.feed(i, np.arange(1, n + 1), rng.integers(0, 256, (n, 1000), np.uint8),
                         szs)
            rig.step()
            stream += rig.drain(0)
        names = ("hashcnt", "mixins", "entries", "slots", "leader_slots")
        results[(side, loop)] = {
            "stream": stream, "state": bytes(tile.state), "words": tile._w[:16].copy(),
            **{k: rig.counter(k) for k in names}}
        if loop == "stem":
            assert rig.handbacks == 0
    _same(results)
    ref = results[LOOPS[0]]
    sigs = {s for s, *_ in ref["stream"]}
    assert 1 in sigs and 8 in sigs and any(s & POHT.SLOT_BOUNDARY_TAG for s in sigs)
    assert ref["slots"] == 3
    for a, b in zip(ref["stream"], ref["stream"][1:]):
        assert b[-1][0:32] == a[-1][72:104]


def test_poh_in_burst_trace_matches_jax():
    """The stem's in-burst trace (fdt_trace.h's block on cfg word 240),
    armed alike on both packages' stems with an injected clock: the span
    ring's words (ingest and publish spans, mixins and tick entries) and
    the hist words it fills are byte-identical, so the port's fdt_trace.h
    copy lays out what fdt_stem.c writes as the JAX package's does."""
    results = {}
    for side in ("jax", "torch"):
        S = SIDES[side]
        tile = S.poh.PohTile(tick_batch=8, ticks_per_slot=16, slot_ms=0)
        rig = Rig(S, "stem", tile, [(256, 512), (256, 512)], [(256, ENTRY_SZ)], cap=64)
        ring = S.TR.SpanRing(np.zeros(S.TR.SpanRing.footprint(1024), np.uint8), 1024, 1)
        m = rig.ctx.metrics
        hists = [m.hist_ref(h) for h in ("loop_ns", "hk_ns", "frag_ns")]
        rig.stem.arm_trace(ring_addr=ring.words.ctypes.data, sample=1,
                           in_rows=[(3, *hists), (4, None, None, None)], out_links=[9],
                           batch_hist=m.hist_ref("batch_sz"),
                           clock=np.array([1000, 7], np.uint64), keepalive=(ring.words,))
        rng = np.random.default_rng(71)
        for _ in range(4):
            for i in (0, 1):
                n = int(rng.integers(1, 5))
                rig.feed(i, np.arange(1, n + 1), rng.integers(0, 256, (n, 512), np.uint8),
                         rng.integers(40, 512, n).astype(np.uint16),
                         rng.integers(0, 1 << 20, n).astype(np.uint32))
            rig.step()
            rig.drain(0)
        results[side] = (ring.words.copy(), m.words.copy())
    assert int(results["jax"][0][0]) > 8  # spans were written
    for a, b in zip(results["jax"], results["torch"]):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# shred: fdt_shred_entries / fdt_shred_sign / fdt_shred_drain (manual credits)


def _shred_rig(side, loop, depth=1 << 10):
    kw = {"device": "cpu"} if side == "torch" else {}
    tile = SIDES[side].shred.ShredTile(shred_version=7, **kw)
    rig = Rig(SIDES[side], loop, tile, [(depth, ENTRY_SZ), (256, 64)],
              [(depth, SH.MAX_SZ), (256, 32)])
    if loop == "stem":
        assert rig.spec.manual and rig.spec.ac_handler
    return rig


def test_shred_matches_across_loops():
    """Entries append natively, each slot boundary hands back to the Python
    shredder, sign requests drain from the shared queue, the responses
    patch and queue natively, and the drain publishes: both out streams
    and the tile's counters and queue words match."""
    results = {}
    for side, loop in LOOPS:
        rig = _shred_rig(side, loop)
        rng = np.random.default_rng(3)
        stream, reqs = [], []
        for slot in range(1, 4):
            n = 6 + slot
            rig.feed(0, [7] * n, rng.integers(0, 256, (n, ENTRY_SZ), np.uint8),
                     np.full(n, ENTRY_SZ, np.uint16))
            rig.step()
            rig.feed(0, [POHT.SLOT_BOUNDARY_TAG | slot], np.zeros((1, ENTRY_SZ), np.uint8),
                     np.array([ENTRY_SZ], np.uint16))
            rig.step()
            got = rig.drain(1)
            reqs += got
            for tag, _sz, _ctl, root in got:
                sig = hashlib.sha256(root).digest() + hashlib.sha256(root + b"x").digest()
                rig.feed(1, [tag], np.frombuffer(sig, np.uint8)[None, :],
                         np.array([64], np.uint16))
            rig.step()
            rig.step()
            stream += rig.drain(0)
        names = ("batches", "fec_sets", "data_shreds", "parity_shreds",
                 "sign_requests", "sign_responses")
        results[(side, loop)] = {
            "stream": stream, "reqs": reqs, "words": rig.tile._w[:10].copy(),
            **{k: rig.counter(k) for k in names}}
        if loop == "stem":
            assert rig.handbacks == 3  # once a slot boundary
            assert rig.ctrs["sign_responses"] == 3
    _same(results)
    ref = results[LOOPS[0]]
    assert ref["sign_requests"] == 3 and len(ref["stream"]) > 0
    for _tag, _sz, _ctl, raw in ref["stream"]:
        assert raw[0:64] != b"\0" * 64 and SH.parse(raw) is not None


def test_shred_drain_is_credit_gated_per_round():
    """A stalled shred consumer: the drain publishes at most the ring's
    depth (one live cr_avail read a round), then delivers the rest in
    order, each once, as the consumer frees credits."""
    results = {}
    for side, loop in LOOPS:
        rig = _shred_rig(side, loop, depth=64)
        for i in range(200):
            rig.tile._outq_push(1000 + i, bytes([i & 0xFF]) * 100)
        rig.step()
        ol = rig.ctx.outs[0]
        assert RT.seq_diff(ol.mcache.seq_query(), rig.cons[0].query()) <= 64
        got = []
        for _ in range(10):
            got += rig.drain(0, max_frags=64)
            rig.step()
        results[(side, loop)] = {"stream": got}
    _same(results)
    assert [s for s, *_ in results[LOOPS[0]]["stream"]] == list(range(1000, 1200))


# ---------------------------------------------------------------------------
# fdt_sha256 against hashlib


def test_sha256_matches_hashlib():
    """fdt_sha256 on seeded sizes across both padding regimes and multi-
    block messages, fdt_sha256_mix (prev || mix) and fdt_sha256_append (n
    iterations) against hashlib."""
    lib = RT._lib
    rng = np.random.default_rng(12)
    for sz in [*range(0, 132), 192, 1000, 4096, 5000]:
        buf = rng.integers(0, 256, max(sz, 1), np.uint8)
        out = np.zeros(32, np.uint8)
        lib.fdt_sha256(buf.ctypes.data, sz, out.ctypes.data)
        assert out.tobytes() == hashlib.sha256(buf[:sz].tobytes()).digest(), sz
    for _ in range(16):
        prev, mix = rng.integers(0, 256, (2, 32), np.uint8)
        prev, mix = np.ascontiguousarray(prev), np.ascontiguousarray(mix)
        out = np.zeros(32, np.uint8)
        lib.fdt_sha256_mix(prev.ctypes.data, mix.ctypes.data, out.ctypes.data)
        assert out.tobytes() == hashlib.sha256(prev.tobytes() + mix.tobytes()).digest()
    st = rng.integers(0, 256, 32, np.uint8)
    for n in (0, 1, 7, 64, 500):
        ref = st.tobytes()
        for _ in range(n):
            ref = hashlib.sha256(ref).digest()
        got = st.copy()
        lib.fdt_sha256_append(got.ctypes.data, n)
        assert got.tobytes() == ref, n


# ---------------------------------------------------------------------------
# the cfg layout and the ids


def test_cfg_layout_and_ids_pinned_to_jax():
    """The cfg block's size and word indices, the out-block layout, the
    trace block's, the statuses, the flags and the handler and hook ids are
    the JAX package's."""
    assert int(RT._lib.fdt_stem_cfg_words()) == int(RJ._lib.fdt_stem_cfg_words()) == 256
    names = [n for n in vars(RT) if n.startswith(("STEM_", "_STEM_", "_SC_", "_SI", "_SO",
                                                   "_TR_", "PACK_SCHED_WORDS"))]
    names = [n for n in names if n not in ("STEM_HANDLERS", "STEM_HOOKS")]
    assert len(names) > 60
    for n in names:
        assert getattr(RT, n) == getattr(RJ, n), n
    assert RT.STEM_HANDLERS == (RT.STEM_H_DEDUP, RT.STEM_H_BANK, RT.STEM_H_PACK,
                                RT.STEM_H_POH, RT.STEM_H_SHRED, RT.STEM_H_NET)
    assert RT.STEM_HOOKS == (RT.STEM_AC_PACK, RT.STEM_AC_POH, RT.STEM_AC_SHRED,
                             RT.STEM_AC_NET)


@pytest.mark.parametrize("word, value", [
    ("handler", RT.STEM_H_BANK), ("handler", 8), ("handler", 9),
    ("hook", 6), ("hook", 7)])
def test_bank_and_net_ids_are_refused(word, value):
    """The port carries the bank and net handlers and the net hook: a
    StemSpec naming the bank id is accepted, and one naming an id no stem
    dispatches raises, and fdt_stem_run rejects a cfg block that names one
    (Stem.run raises) before it drains anything."""
    args = np.zeros(8, np.uint64)
    if (word, value) == ("handler", RT.STEM_H_BANK):
        spec = RT.StemSpec(value, args)
        assert spec.handler == RT.STEM_H_BANK and value in RT.STEM_HANDLERS
        return
    with pytest.raises(ValueError, match="port's stem"):
        if word == "handler":
            RT.StemSpec(value, args)
        else:
            RT.StemSpec(RT.STEM_H_POH, args, ac_handler=value, ac_args=args)
    rig = _dedup_rig("torch", "stem")
    rig.feed(0, [5], np.zeros((1, 64), np.uint8), np.array([64], np.uint16))
    rig.stem._w[RT._SC_HANDLER if word == "handler" else RT._SC_AC] = value
    with pytest.raises(RuntimeError, match="rejected"):
        rig.stem.run(64, TSPUB)
    assert rig.ins[0].seq == 0 and rig.stem.consumed(0) == 0
