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
5 ms when idle.  The same corpus under `[topo] runtime = "process"` (one
OS process per tile, the Python loop, profiled): the bank counters and
the banks' shared account table exact, and ROADMAP C-8 held (the bank
children execute against pickled copies of the funk, in the JAX package
too, so the parent's funk and RPC getBalance keep the funding).  And
`fdtctl run --full` in a subprocess: on a host without a card it exits
non-zero with "no CUDA device" and leaves no workspace file."""

import glob
import os
import pickle
import subprocess
import sys

import pytest
import torch

import chip_smoke as CS
from firedancer_tpu.flamenco import accounts as AJ
from firedancer_tpu.flamenco import runtime as RJ
from firedancer_tpu.funk import funk as FJ
from firedancer_tpu.tiles.bank import BankTile as BankJ
from firedancer_tpu_torch import entry
from firedancer_tpu_torch.flamenco import accounts as AT
from firedancer_tpu_torch.funk import funk as FT
from firedancer_tpu_torch.ops.ed25519 import hostpath
from firedancer_tpu_torch.ops.ed25519 import verify as V
from firedancer_tpu_torch.tango import rings as R
from firedancer_tpu_torch.tiles import bench as TB
from firedancer_tpu_torch.tiles import poh as POH
from firedancer_tpu_torch.tiles.bank import BankTile as BankT

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
    name = f"fdt_test_validator_{os.getpid()}"
    text = CS.validator_toml(name, ports, EXTRA)
    r = CS.validator_run(text, raws, funding, identity, device="cpu", idle_sleep_s=5e-3,
                         rpc_sample=sorted(want)[:8], want=want, quic_txns=QUIC_TXNS,
                         quic_clients=QUIC_CLIENTS)
    # 64 transfers over 16 payers fill few microblocks: bank 1 may stay idle
    CS.check_validator(r, want, TXNS - QUIC_TXNS, hostpath.public_from_secret(identity),
                       native=True, launches=counted[0], all_banks_busy=False)
    CS.check_stem(r, CS.STEM_TILES["validator"], handback=("bank0", "bank1"))
    egress = CS.check_egress(r, "cpu")
    assert egress["slots_stored"] >= 1 and r["counters"]["store"]["completed_slots"] >= 1
    assert not glob.glob(f"{R.SHM_PREFIX}{name}*")
    # the JAX package's executor, the same transactions in corpus order
    jf = FJ.Funk()
    for k, lam in funding.items():
        AJ.AccountMgr(jf).store(k, AJ.Account(lam))
    ex = RJ.Executor(jf)
    assert all(ex.execute_txn(t).ok for t in raws)
    jax_bal = {k: AJ.AccountMgr(jf).lamports(k) for k in want}
    port_bal = {k: AT.Account.decode(r["funk"][k]).lamports for k in want}
    assert port_bal == jax_bal == want


EXTRA_PROCESS = ('[topo]\nruntime = "process"\n'
                 '[tiles.verify]\nmax_lanes = 32\nmsg_width = 512\n')


@pytest.fixture
def slow_slots(monkeypatch):
    """2 s PoH slots, as `counted` sets them (a PohTile built in this
    process carries them into its child)."""
    monkeypatch.setitem(POH.PohTile.__init__.__kwdefaults__, "slot_ms", 2000.0)


def test_validator_process_runtime_on_cpu(slow_slots):
    rows, _payers = TB.make_transfer_pool(TXNS, n_signers=PAYERS, seed=6, device="cpu")
    raws = entry.raw_txns(TB.wire_pool(rows))
    funding, want = CS.transfer_ledger(raws)
    identity = CS.wire_identity()
    ports = dict(zip(("quic", "udp", "metric", "rpc"), CS.free_ports(4)))
    # the pid keeps concurrent runs out of each other's leftover check
    name = f"fdt_test_validator_p{os.getpid()}"
    text = CS.validator_toml(name, ports, EXTRA_PROCESS)
    sample = sorted(want)[:8]
    r = CS.validator_run(text, raws, funding, identity, device="cpu", idle_sleep_s=5e-3,
                         rpc_sample=sample, want=want, quic_txns=QUIC_TXNS,
                         quic_clients=QUIC_CLIENTS, profile=True)
    assert r["runtime"] == "process" and r["verify_pid"] is not None
    CS.check_validator(r, want, TXNS - QUIC_TXNS, hostpath.public_from_secret(identity),
                       native=False, launches=None, all_banks_busy=False)
    CS.check_egress(r, "cpu")
    # the verify tile ran in its child: the shm metrics count its batches
    assert r["verify_pid"] != os.getpid()
    assert r["counters"]["verify0"]["device_batches"] >= 1
    assert r["counters"]["verify0"]["in_frags"] == TXNS
    # every bank-ring microblock's digest came back from the sink children
    assert len(r["microblock_sha256"]) == r["counters"]["poh"]["mixins"]
    # the plain versions on the CPU: no child made a CUDA context or
    # launched a kernel
    assert r["children"].keys() == r["counters"].keys() - {"metric", "rpc"}
    assert not any(d["cuda"] or any(d["launches"].values())
                   for d in r["children"].values())
    assert r["profile"]["tiles"].keys() == r["counters"].keys()
    assert all(row["samples"] > 0 for row in r["monitor_profile"].values())
    assert not glob.glob(f"{R.SHM_PREFIX}{name}*")
    # ROADMAP C-8: the parent's funk (getBalance's source) still holds the
    # funding, and no destination, after every transfer executed
    assert all(r["rpc"]["getBalance"][k] == funding.get(k, 0) for k in sample)
    for k, lam in want.items():
        rec = r["funk"].get(k)
        assert (AT.Account.decode(rec).lamports if rec else 0) == funding.get(k, 0) != lam


def test_bank_tile_pickles_a_funk_copy_in_both_packages():
    """ROADMAP C-8's cause: a process-runtime child gets its tile by
    pickle, so a bank child's funk is a COPY of the parent's — in the JAX
    package (tiles/bank.py:250-265) and in the port alike; a write to it
    never reaches the parent's."""
    key = bytes(range(32))
    jf, pf = FJ.Funk(), FT.Funk()
    AJ.AccountMgr(jf).store(key, AJ.Account(7))
    AT.AccountMgr(pf).store(key, AT.Account(7))
    for bank, funk, acc in ((BankJ(0, funk=jf), jf, AJ), (BankT(0, funk=pf), pf, AT)):
        child = pickle.loads(pickle.dumps(bank))
        assert child.funk is not funk
        acc.AccountMgr(child.funk).store(key, acc.Account(9))
        assert acc.AccountMgr(child.funk).lamports(key) == 9
        assert acc.AccountMgr(funk).lamports(key) == 7


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
