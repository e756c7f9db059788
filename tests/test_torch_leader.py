"""The port's leader pipeline (firedancer_tpu_torch/tiles/pack.py, bank.py,
entry.leader) against the JAX package's.

The topology synth -> dedup -> pack -> bank x 2 -> sink x 2 (as
tests/test_leader_pipeline.py, with a recording sink in the place of the
PoH tile) runs in both packages on one seeded pool, with the pack select on
the host and on the device path (the port's plain version, device="cpu",
against JAX's select_noconflict).  Which bank gets which microblock depends
on thread timing, so what is compared is what does not: the executed txn
set, the fees, completions == microblocks, the drained engines and
conflict-free microblocks.  Then entry.leader(device="cpu") with the verify
tile on a 24-txn pool.  The run loops sleep a few ms when idle (see
tests/test_torch_tiles.py)."""

import time

import numpy as np
import pytest

from firedancer_tpu.disco import Topology as TopologyJ
from firedancer_tpu.tiles.bank import BankTile as BankJ
from firedancer_tpu.tiles.dedup import DedupTile as DedupJ
from firedancer_tpu.tiles.pack import PackTile as PackJ
from firedancer_tpu.tiles.pack import mb_decode as mb_decode_j
from firedancer_tpu.tiles.sink import SinkTile as SinkJ
from firedancer_tpu.tiles.synth import SynthTile as SynthJ
from firedancer_tpu_torch import entry
from firedancer_tpu_torch.ballet import txn as T
from firedancer_tpu_torch.disco.topo import Topology
from firedancer_tpu_torch.ops import pack_select as PS
from firedancer_tpu_torch.tiles import wire
from firedancer_tpu_torch.tiles.bank import BankTile
from firedancer_tpu_torch.tiles.dedup import DedupTile
from firedancer_tpu_torch.tiles.pack import PackTile, mb_decode
from firedancer_tpu_torch.tiles.sink import SinkTile
from firedancer_tpu_torch.tiles.synth import SynthTile, make_txn_pool

IDLE_S = 2e-3
N_BANKS = 2
MB_MTU = 65_535


def _run_topology(jax_side: bool, pool, select: bool) -> dict:
    """synth -> dedup -> pack -> bank x N_BANKS -> sink x N_BANKS in one
    package; -> counters, the sinks' microblocks, the drained engine."""
    Topo, Synth, Dedup, Pack, Bank, Sink, dec = (
        (TopologyJ, SynthJ, DedupJ, PackJ, BankJ, SinkJ, mb_decode_j) if jax_side
        else (Topology, SynthTile, DedupTile, PackTile, BankTile, SinkTile, mb_decode))
    rows, szs, _ = pool
    kw = {"use_device_select": select, "microblock_ns": 1_000_000}
    if not jax_side and select:
        kw["device"] = "cpu"
    pack = Pack(N_BANKS, **kw)
    sinks = [Sink(record=True, name=f"sink{i}") for i in range(N_BANKS)]
    topo = Topo()
    topo.link("synth_dedup", depth=256, mtu=wire.LINK_MTU)
    topo.link("dedup_pack", depth=256, mtu=wire.LINK_MTU)
    for i in range(N_BANKS):
        topo.link(f"pack_bank{i}", depth=128, mtu=MB_MTU)
        topo.link(f"bank{i}_pack", depth=128)
        topo.link(f"bank{i}_poh", depth=128, mtu=MB_MTU)
    topo.tile(Synth(rows, szs, total=len(rows)), outs=["synth_dedup"])
    topo.tile(Dedup(depth=1 << 12), ins=[("synth_dedup", True)], outs=["dedup_pack"])
    topo.tile(pack, ins=[("dedup_pack", True)]
              + [(f"bank{i}_pack", True) for i in range(N_BANKS)],
              outs=[f"pack_bank{i}" for i in range(N_BANKS)])
    for i in range(N_BANKS):
        topo.tile(Bank(i), ins=[(f"pack_bank{i}", True)],
                  outs=[f"bank{i}_pack", f"bank{i}_poh"])
        topo.tile(sinks[i], ins=[(f"bank{i}_poh", True)])
    topo.build()
    names = ["pack", *(f"bank{i}" for i in range(N_BANKS)),
             *(f"sink{i}" for i in range(N_BANKS))]
    try:
        topo.start(batch_max=64, idle_sleep_s=IDLE_S)
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            topo.poll_failure()
            mp = topo.metrics("pack")
            executed = sum(topo.metrics(f"bank{i}").counter("executed_txns")
                           for i in range(N_BANKS))
            sunk = sum(topo.metrics(f"sink{i}").counter("sunk_frags")
                       for i in range(N_BANKS))
            if (executed >= len(rows) and mp.counter("completions")
                    >= mp.counter("microblocks") == sunk):
                break
            time.sleep(0.01)
        topo.halt()
        counters = {n: {c: topo.metrics(n).counter(c)
                        for c in topo.metrics(n).schema.counters} for n in names}
    finally:
        topo.close()
    mbs = [dec(row[:sz]) for s in sinks for rs, ss in zip(s.payloads, s.sizes)
           for row, sz in zip(rs, ss)]
    eng = pack.engine
    return {
        "counters": counters,
        "microblocks": [(bank, handle, [bytes(t) for t in txns])
                        for handle, bank, txns in mbs],
        "engine": (eng.inflight_cnt, eng.pending_cnt, eng.outstanding_cnt,
                   int((eng.lw_keys != 0).sum() + (eng.lr_keys != 0).sum()),
                   int((eng.lw_vals != 0).sum() + (eng.lr_vals != 0).sum()),
                   int((eng.bit_ref_rw != 0).sum() + (eng.bit_ref_w != 0).sum())),
    }


def assert_conflict_free(microblocks) -> None:
    """No microblock holds two txns that write one account, or one that
    writes and one that reads it."""
    for _bank, _handle, txns in microblocks:
        writes, reads = [], []
        for t in txns:
            d = T.parse(t)
            writes += [bytes(d.acct_addr(t, j)) for j in d.writable_idxs()]
            reads += [bytes(d.acct_addr(t, j)) for j in d.readonly_idxs()]
        assert len(set(writes)) == len(writes)
        assert not set(writes) & set(reads)


def _executed(r) -> list:
    return sorted(t for _b, _h, txns in r["microblocks"] for t in txns)


@pytest.mark.parametrize("select", [False, True], ids=["host_select", "device_select"])
def test_leader_topology_matches_jax(select):
    pool = make_txn_pool(48, seed=29)
    got = _run_topology(False, pool, select)
    want = _run_topology(True, pool, select)
    rows, szs, _ = pool
    payloads = sorted(rows[i, : szs[i] - wire.TRAILER_SZ].tobytes() for i in range(len(rows)))
    assert _executed(got) == _executed(want) == payloads
    for r in (got, want):
        c = r["counters"]
        assert c["pack"]["inserted_txns"] == len(rows)
        assert c["pack"]["insert_rejected"] == 0
        assert c["pack"]["completions"] == c["pack"]["microblocks"] == len(r["microblocks"])
        assert sum(c[f"bank{i}"]["executed_txns"] for i in range(N_BANKS)) == len(rows)
        assert sum(c[f"bank{i}"]["fees_lamports"] for i in range(N_BANKS)) == 5000 * len(rows)
        assert r["engine"] == (0, 0, 0, 0, 0, 0)
        assert_conflict_free(r["microblocks"])
        for bank, _h, _t in r["microblocks"]:
            assert 0 <= bank < N_BANKS


def test_leader_entry_on_cpu():
    """entry.leader with the verify tile (the plain versions on the CPU,
    one 32-lane batch) and the port's select: every good txn executed
    once, exact counts."""
    pool = make_txn_pool(24, corrupt_frac=0.3, seed=17)
    rows, szs, good = pool
    n_good, total = int(good.sum()), 32
    sent = good[np.arange(total) % len(rows)]
    before = PS.LAUNCHES
    r = entry.leader(pool, total=total, max_lanes=32, idle_sleep_s=5e-3, device="cpu")
    assert PS.LAUNCHES == before  # the plain version never counts
    c = r["counters"]
    assert c["verify"]["out_frags"] == int(sent.sum())
    assert c["verify"]["verify_fail_txns"] == total - int(sent.sum())
    assert c["dedup"]["dup_txns"] == int(sent.sum()) - n_good
    assert c["pack"]["inserted_txns"] == n_good and c["pack"]["insert_rejected"] == 0
    assert c["pack"]["completions"] == c["pack"]["microblocks"] > 0
    assert sum(c[f"bank{i}"]["executed_txns"] for i in range(2)) == n_good
    assert sum(c[f"bank{i}"]["fees_lamports"] for i in range(2)) == 5000 * n_good
    assert sum(c[f"sink{i}"]["sunk_frags"] for i in range(2)) == c["pack"]["microblocks"]
    assert r["pack_engine"] == {"inflight": 0, "pending": 0, "outstanding": 0,
                                "lock_keys": 0, "lock_counts": 0, "bit_refs": 0}
    mbs = [m for per_sink in r["microblocks"] for m in per_sink]
    got = sorted(t for _b, _h, txns in mbs for t in txns)
    want = sorted(rows[i, : szs[i] - wire.TRAILER_SZ].tobytes() for i in np.flatnonzero(good))
    assert got == want
    assert_conflict_free(mbs)
    for i, per_sink in enumerate(r["microblocks"]):
        assert all(bank == i for bank, _h, _t in per_sink)
    assert r["txns_per_s"] > 0 and r["executed_per_s"] > 0


def test_leader_refuses_funk_and_elastic():
    with pytest.raises(NotImplementedError, match="funk"):
        BankTile(0, funk=object())
    topo = Topology()
    with pytest.raises(NotImplementedError, match="elastic"):
        topo.declare_shards("bank", ["bank0", "bank1"], producer="pack")
