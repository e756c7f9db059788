"""entry.leader(front="wire") on the CPU: net -> quic -> verify -> dedup ->
pack -> bank x 2 -> poh -> shred <-> sign -> store over real loopback
sockets, on the native stem, held to chip_smoke.py's exact checks
(check_leader with the wire front's partial batches, check_wire's front
counters, check_egress on every stored slot) with chip_smoke.B at 32 and
the verify tile's verify_core calls counted.  PoH slots are 2 s, as in
tests/test_torch_stem_topo.py; the run loops sleep 5 ms when idle."""

import pytest

import chip_smoke as CS
from firedancer_tpu_torch import entry
from firedancer_tpu_torch.ops.ed25519 import hostpath
from firedancer_tpu_torch.ops.ed25519 import verify as V
from firedancer_tpu_torch.tiles import bench as TB
from firedancer_tpu_torch.tiles.synth import make_txn_pool

LANES, IDLE_S, SLOT_MS = 32, 5e-3, 2000
IDENTITY = bytes(range(40, 72))


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


def test_entry_leader_wire_on_cpu(counted):
    """entry.leader(front="wire", stem="native"): net, dedup, pack, poh and
    shred on the stem, every count exact (check_leader with the wire
    front's partial batches, check_wire's front counters) and every stored
    slot checked (check_egress)."""
    pool = make_txn_pool(16, corrupt_frac=0.25, seed=5)
    raws = entry.raw_txns(pool)
    traffic = TB.WireTraffic(raws * 2, raws, n_clients=2, seed=5)
    r = entry.leader(pool, max_lanes=LANES, idle_sleep_s=IDLE_S, slot_ms=SLOT_MS,
                     device="cpu", stem="native", front="wire", traffic=traffic,
                     identity_secret=IDENTITY)
    CS.check_leader(r, counted[0], len(raws) * 3)
    CS.check_wire(r, counted[0], len(raws) * 2, hostpath.public_from_secret(IDENTITY))
    CS.check_stem(r, CS.STEM_TILES["wire_leader"])
    CS.check_egress(r, "cpu")
