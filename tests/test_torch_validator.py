"""The validator as an operator boots it, on the CPU:
app.config.build_validator_topology(cfg, identity, blockstore, funk,
device="cpu") from a TOML text (verify at 32 lanes x 512 bytes, the native
stem), 64 distinct transfers over 16 payers, each payer funded in a fresh
Funk, 56 sent as legacy datagrams and 8 over 2 QUIC connections, run by
chip_smoke.validator_run and held to chip_smoke.py's exact checks:
check_validator (every transfer executed once, none failed, the fees, the
store after the halt equal to the dict ledger, RPC, the /metrics scrape, a
Monitor attached by name), check_stem and check_egress (every slot that
holds a mixin stored, signed and recoverable); the store's balances also
equal the JAX package's Executor applying the same transactions.  PoH
slots are 2 s, as in tests/test_torch_stem_topo.py; the run loops sleep
5 ms when idle.  And `fdtctl run --full` in a subprocess: on a host
without a card it exits non-zero with "no CUDA device" and leaves no
workspace file."""

import glob
import os
import subprocess
import sys

import pytest
import torch

import chip_smoke as CS
from firedancer_tpu.flamenco import accounts as AJ
from firedancer_tpu.flamenco import runtime as RJ
from firedancer_tpu.funk import funk as FJ
from firedancer_tpu_torch import entry
from firedancer_tpu_torch.flamenco import accounts as AT
from firedancer_tpu_torch.ops.ed25519 import hostpath
from firedancer_tpu_torch.ops.ed25519 import verify as V
from firedancer_tpu_torch.tango import rings as R
from firedancer_tpu_torch.tiles import bench as TB
from firedancer_tpu_torch.tiles import poh as POH

TXNS, PAYERS, QUIC_TXNS, QUIC_CLIENTS = 64, 16, 8, 2
EXTRA = '[topo]\nstem = "native"\n[tiles.verify]\nmax_lanes = 32\nmsg_width = 512\n'
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def counted(monkeypatch):
    """2 s PoH slots, and a count of the verify tile's verify_core calls (the
    plain version counts no launch)."""
    monkeypatch.setitem(POH.PohTile.__init__.__kwdefaults__, "slot_ms", 2000.0)
    calls = [0]
    core = V.verify_core

    def counting(*a, **kw):
        calls[0] += 1
        return core(*a, **kw)

    monkeypatch.setattr(V, "verify_core", counting)
    return calls


def test_validator_on_cpu(counted):
    rows, _payers = TB.make_transfer_pool(TXNS, n_signers=PAYERS, seed=6, device="cpu")
    raws = entry.raw_txns(TB.wire_pool(rows))
    funding, want = CS.transfer_ledger(raws)
    identity = CS.wire_identity()
    ports = dict(zip(("quic", "udp", "metric", "rpc"), CS.free_ports(4)))
    text = CS.validator_toml("fdt_test_validator", ports, EXTRA)
    r = CS.validator_run(text, raws, funding, identity, device="cpu", idle_sleep_s=5e-3,
                         rpc_sample=sorted(want)[:8], want=want, quic_txns=QUIC_TXNS,
                         quic_clients=QUIC_CLIENTS)
    # 64 transfers over 16 payers fill few microblocks: bank 1 may stay idle
    CS.check_validator(r, want, TXNS - QUIC_TXNS, hostpath.public_from_secret(identity),
                       native=True, launches=counted[0], all_banks_busy=False)
    CS.check_stem(r, CS.STEM_TILES["validator"], handback=("bank0", "bank1"))
    egress = CS.check_egress(r, "cpu")
    assert egress["slots_stored"] >= 1 and r["counters"]["store"]["completed_slots"] >= 1
    assert not glob.glob(f"{R.SHM_PREFIX}fdt_test_validator*")
    # the JAX package's executor, the same transactions in corpus order
    jf = FJ.Funk()
    for k, lam in funding.items():
        AJ.AccountMgr(jf).store(k, AJ.Account(lam))
    ex = RJ.Executor(jf)
    assert all(ex.execute_txn(t).ok for t in raws)
    jax_bal = {k: AJ.AccountMgr(jf).lamports(k) for k in want}
    port_bal = {k: AT.Account.decode(r["funk"][k]).lamports for k in want}
    assert port_bal == jax_bal == want


def test_fdtctl_run_full_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: fdtctl runs the validator here")
    cfg = tmp_path / "v.toml"
    cfg.write_text('name = "fdt_test_cli"\n')
    key = tmp_path / "k"
    key.write_bytes(bytes(range(32)))
    res = subprocess.run(
        [sys.executable, "-m", "firedancer_tpu_torch.app.fdtctl", "run", "--full",
         "--config", str(cfg), "--keyfile", str(key), "--iterations", "2",
         "--blockstore", str(tmp_path / "store")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert not glob.glob(f"{R.SHM_PREFIX}fdt_test_cli*")
