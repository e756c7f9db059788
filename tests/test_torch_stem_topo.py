"""The native stem in the port's thread runtime: entry.ingress and
entry.leader with stem="native" on the CPU, held to chip_smoke.py's exact
checks (check_tiles, check_leader, check_egress), with the stem engaged on
every tile that has a native handler; and the stem modes the topology and
the run loop refuse.

The verify tile runs its plain versions on one or two 32-lane batches
(chip_smoke.B set to 32, its calls of verify_core counted); the run loops
sleep 5 ms when idle (see tests/test_torch_tiles.py); PoH slots are 2 s,
as in tests/test_torch_egress.py: the shredder's Merkle layers run plain
torch on the CPU, ~0.7 s a FEC set, so shorter slots outrun the shred
tile."""

import numpy as np
import pytest

import chip_smoke as CS
from firedancer_tpu_torch import entry
from firedancer_tpu_torch.disco import mux
from firedancer_tpu_torch.disco.topo import Topology
from firedancer_tpu_torch.ops.ed25519 import verify as V
from firedancer_tpu_torch.tango import rings as R
from firedancer_tpu_torch.tiles.sink import SinkTile
from firedancer_tpu_torch.tiles.synth import make_txn_pool

LANES, IDLE_S, SLOT_MS = 32, 5e-3, 2000
#: the tiles with a native handler on the leader's path
NATIVE_TILES = ("dedup", "pack", "poh", "shred")


@pytest.fixture
def counted(monkeypatch):
    """chip_smoke's batch size at the test's lanes, and a count of the
    verify tile's verify_core calls (the plain version counts no launch)."""
    monkeypatch.setattr(CS, "B", LANES)
    calls = [0]
    core = V.verify_core

    def counting(*a, **kw):
        calls[0] += 1
        return core(*a, **kw)

    monkeypatch.setattr(V, "verify_core", counting)
    return calls


def _engaged(r, tiles):
    st = r["stem"]["tiles"]
    assert r["stem"]["mode"] == "native"
    for n, c in st.items():
        assert c["stem_engaged"] == (n in tiles), (n, c)
    for n in tiles:
        assert st[n]["stem_frags"] > 0, (n, st[n])
    return st


def test_ingress_native_on_cpu(counted):
    """entry.ingress(stem="native"): dedup on the stem, every counter, the
    sink's survivors and payloads exact (check_tiles)."""
    pool = make_txn_pool(16, corrupt_frac=0.25, seed=5)
    r = entry.ingress(pool, total=64, max_lanes=LANES, idle_sleep_s=IDLE_S,
                      device="cpu", stem="native")
    CS.check_tiles(r, counted[0], 64)
    st = _engaged(r, ("dedup",))
    assert st["dedup"]["stem_frags"] == r["counters"]["dedup"]["in_frags"]
    assert st["dedup"]["py_frags"] == 0


@pytest.mark.parametrize("select", [True, False], ids=["select_on", "select_off"])
def test_leader_native_on_cpu(counted, select):
    """entry.leader(stem="native"): dedup, pack (insert-only with the select
    on, the native scheduler with it off), poh and shred on the stem; every
    count, microblock and stored slot exact (check_leader, check_egress)."""
    pool = make_txn_pool(16, corrupt_frac=0.25, seed=5)
    r = entry.leader(pool, total=32, max_lanes=LANES, idle_sleep_s=IDLE_S,
                     slot_ms=SLOT_MS, pack_device_select=select, device="cpu",
                     stem="native")
    CS.check_leader(r, counted[0], 32)
    eg = CS.check_egress(r, "cpu")
    c = r["counters"]
    assert eg["mixins"] == c["poh"]["mixins"] == c["pack"]["microblocks"]
    st = _engaged(r, NATIVE_TILES)
    # poh never hands back; shred hands back once a slot boundary
    assert st["poh"]["py_frags"] == 0 and st["poh"]["py_credit"] == 0
    assert st["shred"]["py_frags"] > 0
    if select:
        # the Python after_credit schedules through the select
        assert st["pack"]["py_credit"] >= c["pack"]["microblocks"]
    else:
        # the native scheduler: the Python after_credit ran only on the
        # end-of-block handbacks
        assert st["pack"]["py_credit"] <= c["pack"]["blocks"]


class _UnknownIdTile(SinkTile):
    """A tile whose native handler names an id no stem dispatches."""

    def native_handler(self, ctx):
        return R.StemSpec(9, np.zeros(8, np.uint64))


def test_refused_stem_modes_and_handlers():
    """An unknown stem mode raises at Topology(), at start() and in the run
    loop; a native handler naming an id no stem dispatches fails the tile's
    boot under stem="native", and the Python loop never asks for it.  The
    bank handler id is one the port's stem dispatches."""
    assert R.STEM_H_BANK in R.STEM_HANDLERS
    with pytest.raises(ValueError, match="stem mode"):
        Topology(stem="bogus")
    with pytest.raises(ValueError, match="stem mode"):
        mux.run_loop(mux.Tile(), None, stem="bogus")
    topo = Topology(stem="native")
    topo.link("l", depth=64, mtu=64)
    topo.tile(SinkTile(name="src"), outs=["l"])
    topo.tile(_UnknownIdTile(name="bad"), ins=[("l", True)])
    try:
        with pytest.raises(ValueError, match="stem mode"):
            topo.start(stem="bogus")
    finally:
        topo.close()
    for stem, raises in (("native", True), ("python", False)):
        topo = Topology(stem=stem)
        topo.link("l", depth=64, mtu=64)
        topo.tile(SinkTile(name="src"), outs=["l"])
        topo.tile(_UnknownIdTile(name="bad"), ins=[("l", True)])
        try:
            if raises:
                with pytest.raises(ValueError, match="dedup, bank, pack, poh, shred and net"):
                    topo.start(idle_sleep_s=IDLE_S)
            else:
                topo.start(idle_sleep_s=IDLE_S)
                assert topo.metrics("bad").counter("stem_engaged") == 0
                topo.halt()
        finally:
            topo.close()
