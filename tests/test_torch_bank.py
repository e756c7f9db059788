"""The port's native bank executor and funk-backed bank tile against the
JAX package's, exactly (bytes and integers).

1. The fdt_bank library (firedancer_tpu_torch/tango/native/fdt_bank.c,
   built into the port's ring library, driven through flamenco/runtime.py's
   BankTable and Executor) against the JAX package's library, both loaded
   in this process.  The JAX package's test_bank_native.py cases that need
   no process (the differential fuzz with the zero-check feature on and
   off, the warm table, the table-full fallback, the commit's lamports
   cache, the journal rollback, the mid-microblock resume and the replayed
   microblock that must not re-execute) run as written under a mirror:
   every BankTable operation and every execute_fast_transfers_native /
   execute_txn_with_table call also runs on the port, on a copy of the
   JAX table's memory, journal, store and executor state taken just before
   the call; the result, the table's bytes, the journal's bytes, the store
   and the executor's state after it must be equal.
2. The funk-backed BankTile on raw rings (tests/torch_stem_rig.py), three
   ways: the JAX tile on the JAX package's stem, the port's tile on the
   port's stem (the bank handler, fdt_bank_pipeline) and the port's tile on
   its Python loop, over seeded microblocks of warm and cold transfers,
   transfers to an account with data, a non-transfer, a malformed
   microblock and a replayed one: what each publishes, the counters and
   the store after the halt's commit must be equal across the three."""

import importlib
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from firedancer_tpu.ballet import pack as PJ
from firedancer_tpu.disco import metrics as METJ
from firedancer_tpu.disco import mux as MJ
from firedancer_tpu.flamenco import accounts as AJ
from firedancer_tpu.flamenco import runtime as RUJ
from firedancer_tpu.funk import funk as FJ
from firedancer_tpu.tango import rings as RJ
from firedancer_tpu.tiles import bank as BANKJ
from firedancer_tpu_torch.ballet import pack as PT
from firedancer_tpu_torch.ballet import txn as T
from firedancer_tpu_torch.disco import metrics as METT
from firedancer_tpu_torch.disco import mux as MT
from firedancer_tpu_torch.flamenco import accounts as AT
from firedancer_tpu_torch.flamenco import runtime as RUT
from firedancer_tpu_torch.funk import funk as FT
from firedancer_tpu_torch.tango import rings as RT
from firedancer_tpu_torch.tiles import bank as BANKT

TESTS = Path(__file__).resolve().parent
if str(TESTS) not in sys.path:
    sys.path.insert(0, str(TESTS))

from test_torch_runtime import executor_state, funk_state, port_executor, port_funk  # noqa: E402
from torch_stem_rig import Rig  # noqa: E402

#: test_bank_native.py's cases that run in one process
NATIVE_CASES = ("test_fuzz_native_matches_golden", "test_sequential_dependency_and_warm_table_reuse",
                "test_table_full_falls_back_without_divergence",
                "test_commit_keeps_lam_cache_discipline", "test_journal_rollback_restores_slots",
                "test_mid_microblock_resume_applies_exactly_once",
                "test_replayed_completed_microblock_never_reexecutes")


def _native_cases():
    mod = importlib.import_module("test_bank_native")
    out = []
    for name in NATIVE_CASES:
        fn = getattr(mod, name)
        params = {}
        for m in getattr(fn, "pytestmark", []):
            if m.name == "parametrize":
                params[m.args[0]] = list(m.args[1])
        if not params:
            out.append((name, {}))
        else:
            (a, av), (b, bv) = params.items()
            out += [(name, {a: x, b: y}) for x in av for y in bv]
    return out


def port_table(jt) -> RUT.BankTable:
    """A port BankTable over copies of a JAX table's memory and journal."""
    return RUT.BankTable(jt.mem.copy(), jt.slot_cnt, journal=jt.journal.copy())


def table_state(t) -> dict:
    return {"mem": t.mem.tobytes(), "journal": t.journal.tobytes()}


def _outcome(fn, *a, **kw):
    try:
        return ("ok", fn(*a, **kw))
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return (type(e).__name__, str(e))


def _scan_fields(s) -> dict:
    return {k: (v.tobytes() if isinstance(v, np.ndarray) else v) for k, v in vars(s).items()}


@pytest.fixture
def bank_mirror(monkeypatch):
    """-> the calls mirrored, by name."""
    calls, depth = [], [0]
    init = RUJ.BankTable.__init__

    def table_init(self, mem, slot_cnt, journal=None):
        fresh = not mem.any()
        pmem = mem.copy()
        init(self, mem, slot_cnt, journal=journal)
        twin = RUT.BankTable(pmem, slot_cnt,
                             journal=None if journal is None else self.journal.copy())
        assert twin.rejoined == self.rejoined and fresh != self.rejoined
        assert twin.mem.tobytes() == self.mem.tobytes()
        calls.append("__init__")

    monkeypatch.setattr(RUJ.BankTable, "__init__", table_init)

    def mirror_table_op(name):
        orig = getattr(RUJ.BankTable, name)

        def op(self, *a, **kw):
            if depth[0]:
                return orig(self, *a, **kw)
            twin = port_table(self)
            pa = list(a)
            pf = None
            if name in ("commit", "recover", "resolve"):
                pf = port_funk(a[0])
                pa[0] = pf
            depth[0] += 1
            try:
                want = _outcome(orig, self, *a, **kw)
            finally:
                depth[0] -= 1
            got = _outcome(getattr(twin, name), *pa, **kw)
            assert got == want, name
            assert table_state(twin) == table_state(self), name
            if pf is not None:
                assert funk_state(pf) == funk_state(a[0]), name
            calls.append(name)
            if want[0] != "ok":
                return orig(self, *a, **kw)  # raises as it did
            return want[1]

        monkeypatch.setattr(RUJ.BankTable, name, op)

    for name in ("get", "put", "resolve", "begin", "mark_done", "mark_complete",
                 "already_complete", "commit", "recover"):
        mirror_table_op(name)

    def mirror_exec(name):
        orig = getattr(RUJ.Executor, name)

        def run(self, table, *a, **kw):
            if depth[0]:
                return orig(self, table, *a, **kw)
            twin = port_table(table)
            pex = port_executor(self, port_funk(self.funk))
            pa = list(a)
            if name == "execute_fast_transfers_native":
                rows, szs, idx, scan = a[:4]
                pscan = PT.txn_scan(rows, szs)
                assert _scan_fields(pscan) == _scan_fields(scan)
                pa[3] = pscan
            depth[0] += 1
            try:
                want = orig(self, table, *a, **kw)
            finally:
                depth[0] -= 1
            got = getattr(pex, name)(twin, *pa, **kw)
            assert (got.__dict__ if hasattr(got, "__dict__") else got) == (
                want.__dict__ if hasattr(want, "__dict__") else want), name
            assert table_state(twin) == table_state(table), name
            assert funk_state(pex.funk) == funk_state(self.funk), name
            assert executor_state(pex) == executor_state(self), name
            calls.append(name)
            return want

        monkeypatch.setattr(RUJ.Executor, name, run)

    mirror_exec("execute_fast_transfers_native")
    mirror_exec("execute_txn_with_table")
    return calls


@pytest.mark.parametrize("case,kw", _native_cases(),
                         ids=[f"{c}-{kw}" for c, kw in _native_cases()])
def test_fdt_bank_matches_jax(case, kw, bank_mirror):
    getattr(importlib.import_module("test_bank_native"), case)(**kw)
    assert {"execute_fast_transfers_native", "recover", "put"} & set(bank_mirror), bank_mirror


def test_bank_library_entry_points_match_jax():
    """fdt_bank_tab_footprint, and fdt_bank_pipeline's two early returns (a
    microblock below the journal's completed mark: 3, republish; one with
    more txns than the scratch holds: 2, the Python path) through both
    libraries."""
    for slots in (0, 3, 4, 1 << 10, 1 << 14):
        assert int(RT._lib.fdt_bank_tab_footprint(slots)) == int(
            RJ._lib.fdt_bank_tab_footprint(slots))
    mb = np.frombuffer(mb_encode(1, 0, [b"x"] * 5), np.uint8).copy()
    for tag, mark, max_n, want in ((7, 9, 64, 3), (9, 9, 4, 2), (9, 0, 4, 2)):
        got = []
        for lib in (RT._lib, RJ._lib):
            jnl = np.zeros(32, np.uint64)
            jnl[31] = mark
            args = np.zeros(24, np.uint64)
            args[3], args[20] = max_n, jnl.ctypes.data
            stats = np.zeros(8, np.uint64)
            rc = lib.fdt_bank_pipeline(mb.ctypes.data, len(mb), args.ctypes.data, tag,
                                       stats.ctypes.data)
            got.append((rc, stats.tolist()))
        assert got[0] == got[1] and got[0][0] == want, got


# ---------------------------------------------------------------------------
# 2. the funk-backed bank tile, three ways

SIDES = {
    "jax": SimpleNamespace(R=RJ, M=MJ, MET=METJ, bank=BANKJ, Funk=FJ.Funk, A=AJ),
    "torch": SimpleNamespace(R=RT, M=MT, MET=METT, bank=BANKT, Funk=FT.Funk, A=AT),
}
LOOPS = (("jax", "stem"), ("torch", "stem"), ("torch", "python"))
MB_MTU = 65_535


def _xfer(payer, dest, amount, bh=bytes(32)):
    data = (2).to_bytes(4, "little") + int(amount).to_bytes(8, "little")
    return T.build([bytes(64)], [payer, dest, bytes(32)], bh, [(2, [0, 1], data)],
                   readonly_unsigned_cnt=1)


def _create(payer, new, lamports, owner):
    data = ((0).to_bytes(4, "little") + int(lamports).to_bytes(8, "little")
            + (16).to_bytes(8, "little") + owner)
    return T.build([bytes(64)] * 2, [payer, new, bytes(32)], bytes(32),
                   [(2, [0, 1], data)], readonly_unsigned_cnt=1)


def mb_encode(handle: int, bank: int, txns) -> bytes:
    out = handle.to_bytes(4, "little") + bank.to_bytes(2, "little") + len(txns).to_bytes(
        2, "little")
    for t in txns:
        out += len(t).to_bytes(2, "little") + t
    return out


def bank_corpus(seed: int, n_mb: int = 14):
    """(funding: key -> (lamports, owner, data), microblocks) for bank 0:
    transfers among warm payers (the stem executes them), to fresh
    destinations (the stem hands them back), to an account with data,
    account creations (not fast), a malformed microblock and a microblock
    delivered twice."""
    rng = np.random.default_rng(seed)

    def key():
        return rng.integers(0, 256, 32, np.uint8).tobytes()

    payers = [key() for _ in range(10)]
    data_acct, owner = key(), key()
    funding = {p: (int(rng.integers(2_000_000, 9_000_000)), bytes(32), b"") for p in payers}
    funding[data_acct] = (777, owner, b"state")
    mbs = []
    for h in range(n_mb):
        kind = int(rng.integers(0, 6)) if h > 1 else h
        n = int(rng.integers(1, 9))
        pick = rng.permutation(len(payers))
        if kind == 0:  # cold destinations
            txns = [_xfer(payers[pick[i]], key(), int(rng.integers(1, 50_000)))
                    for i in range(n)]
        elif kind in (1, 2):  # among payers (warm once touched)
            txns = [_xfer(payers[pick[i]], payers[pick[-1 - i]], int(rng.integers(0, 90_000)))
                    for i in range(min(n, 5))]
        elif kind == 3:
            txns = [_xfer(payers[pick[0]], data_acct, 1_234), _xfer(payers[pick[1]], payers[pick[2]], 5)]
        elif kind == 4:
            txns = [_create(payers[pick[0]], key(), 10_000_000, owner),
                    _xfer(payers[pick[1]], payers[pick[0]], 9)]
        else:
            txns = [_xfer(payers[pick[0]], payers[pick[0]], 3)]
        mbs.append(mb_encode(h, 0, txns))
    bad = bytearray(mb_encode(n_mb, 0, [_xfer(payers[0], payers[1], 7)]))
    bad[6:8] = (3).to_bytes(2, "little")
    mbs.insert(n_mb // 2, bytes(bad))
    return funding, mbs


def _run_bank(side, loop, funding, mbs, replay):
    S = SIDES[side]
    funk = S.Funk()
    mgr = S.A.AccountMgr(funk)
    for k, (lam, owner, data) in funding.items():
        mgr.store(k, S.A.Account(lam, owner, False, 0, data))
    tile = S.bank.BankTile(0, funk=funk, table_slots=256)
    rig = Rig(S, loop, tile, [(256, MB_MTU)], [(256, 0), (256, MB_MTU)])
    out = {"completions": [], "poh": []}
    for i, mb in enumerate(mbs):
        row = np.zeros((1, len(mb)), np.uint8)
        row[0] = np.frombuffer(mb, np.uint8)
        rig.feed(0, [i], row, np.array([len(mb)], np.uint16))
        if replay and i == replay:
            # a replayed frag of an earlier microblock: its seq is below the
            # completed mark, so it republishes without executing
            rig.ins[0].seq -= 1
        for _ in range(4):
            rig.step()
        out["completions"] += rig.drain(0)
        out["poh"] += rig.drain(1)
    tile.on_halt(rig.ctx)
    names = ("executed_microblocks", "executed_txns", "failed_txns", "fast_txns",
             "fees_lamports", "malformed_microblocks", "native_txns")
    out["counters"] = {n: rig.counter(n) for n in names}
    out["funk"] = dict(funk.root)
    out["loop"] = (rig.bursts, rig.handbacks, rig.ctrs.get("executed_microblocks", 0))
    return out


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_funk_bank_tile_matches_across_loops(seed):
    funding, mbs = bank_corpus(seed)
    res = {(s, lp): _run_bank(s, lp, funding, mbs, replay=0) for s, lp in LOOPS}
    ref = res[LOOPS[0]]
    for key, r in res.items():
        for k in ("completions", "poh", "counters", "funk"):
            assert r[k] == ref[k], (key, k)
    c = ref["counters"]
    assert c["malformed_microblocks"] == 1 and c["executed_microblocks"] == len(mbs) - 1
    assert c["executed_txns"] > c["fast_txns"] > 0
    # both stems executed warm microblocks in the bank handler and handed
    # the others back, the same ones
    assert res[("jax", "stem")]["loop"] == res[("torch", "stem")]["loop"]
    bursts, handbacks, native_mbs = res[("torch", "stem")]["loop"]
    assert bursts > 0 and handbacks > 0 and native_mbs > 0


def test_funk_bank_tile_replay_matches_across_loops():
    """A frag delivered again after its microblock completed republishes on
    both outs but never re-executes, on every loop."""
    funding, mbs = bank_corpus(9, n_mb=6)
    res = {(s, lp): _run_bank(s, lp, funding, mbs, replay=2) for s, lp in LOOPS}
    ref = res[LOOPS[0]]
    for key, r in res.items():
        for k in ("completions", "poh", "counters", "funk"):
            assert r[k] == ref[k], (key, k)
    assert len(ref["completions"]) == len(mbs) + 1
