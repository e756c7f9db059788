"""The port's pack hop pieces (firedancer_tpu_torch/ballet/compute_budget.py,
base58.py, pack.py, tango/native/fdt_pack.c, tiles/pack.py's codec and
csrc/pack_select.cu's host build) against the JAX package's, on seeded
inputs.  Everything compared is bytes, integers or bools: exact.

The engines are driven op by op through the same insert / schedule /
complete / expire / replace / end_block sequences, with no device select
and with the port's select (device="cpu", the plain version) against JAX's
select_noconflict, and every engine array is compared after every op."""

import ctypes
import functools

import numpy as np
import pytest
import torch

from firedancer_tpu.ballet import compute_budget as CBJ
from firedancer_tpu.ballet import pack as PJ
from firedancer_tpu.ballet import txn as TJ
from firedancer_tpu.ops import pack_select as PSJ
from firedancer_tpu.tiles import pack as TPJ
from firedancer_tpu_torch.ballet import base58
from firedancer_tpu_torch.ballet import compute_budget as CB
from firedancer_tpu_torch.ballet import pack as P
from firedancer_tpu_torch.ballet import txn as T
from firedancer_tpu_torch.ops import pack_select as PS
from firedancer_tpu_torch.tiles import pack as TP
from firedancer_tpu_torch.tiles import wire
from firedancer_tpu_torch.tiles.synth import make_txn_pool
from test_pack import _acct, _mk_txn
from test_torch_verify_core import assert_no_sanitizer_report, host_library
from torch_pack_cases import (EDGE_CASES, WINDOW, edge_case, seg_rows, step_bound,
                              windowed_greedy)


def _vote_txn(payer: bytes, vote_acct: bytes, data: bytes = b"\x02" * 24) -> bytes:
    """A simple vote: one instruction to the Vote program."""
    addrs = [payer, vote_acct, P.VOTE_PROGRAM_ID]
    return TJ.build([bytes(64)], addrs, bytes(32), [(2, [1, 0], data)],
                    readonly_unsigned_cnt=1)


def _hot_payer_txns(n: int, n_payers: int, seed: int) -> list[bytes]:
    """System transfers over a few hot payers, as bench.py's
    _bench_pack_sched builds them (random signatures)."""
    rng = np.random.default_rng(seed)
    payers = [bytes(rng.integers(0, 256, 32, np.uint8)) for _ in range(n_payers)]
    out = []
    for i in range(n):
        p, d = payers[i % n_payers], payers[(i * 7 + 3) % n_payers]
        data = (2).to_bytes(4, "little") + int(1 + rng.integers(1, 999)).to_bytes(8, "little")
        sig = bytes(rng.integers(0, 256, 64, np.uint8))
        out.append(TJ.build([sig], [p, d, bytes(32)], bytes(32), [(2, [0, 1], data)],
                            readonly_unsigned_cnt=1))
    return out


def _rows(payloads: list[bytes], width: int = wire.LINK_MTU):
    rows = np.zeros((len(payloads), width), np.uint8)
    szs = np.zeros(len(payloads), np.uint32)
    for i, p in enumerate(payloads):
        rows[i, : len(p)] = np.frombuffer(p, np.uint8)
        szs[i] = len(p)
    return rows, szs


# ---------------------------------------------------------------------------
# base58 and the compute budget


def test_base58_decode_matches_jax():
    from firedancer_tpu.ballet import base58 as B58J

    for s in ("Vote111111111111111111111111111111111111111",
              "ComputeBudget111111111111111111111111111111", "11111111111111111111111111111111",
              "3yZe7d", "", "0OIl", "1112"):
        assert base58.decode(s) == B58J.decode(s)
        assert base58.decode_32(s) == B58J.decode_32(s)


def _dup_budget_txn() -> bytes:
    ins = (1, [], b"\x02" + (1000).to_bytes(4, "little"))
    return TJ.build([bytes(64)], [_acct(1), CBJ.COMPUTE_BUDGET_PROGRAM_ID], bytes(32),
                    [ins, ins], readonly_unsigned_cnt=1)


ESTIMATE_CASES = {
    "defaults": lambda: _mk_txn(_acct(1), [_acct(2)], [_acct(3)]),
    "cu_limit_and_price": lambda: _mk_txn(_acct(1), [], [], cu_limit=50_000,
                                          cu_price=2_000_000),
    "duplicate_budget_instr": _dup_budget_txn,
    "price_only": lambda: _mk_txn(_acct(4), [_acct(5), _acct(6)], [], cu_price=7),
    "vote": lambda: _vote_txn(_acct(7), _acct(8)),
    "saturating_price": lambda: _mk_txn(_acct(1), [], [], cu_limit=1_400_000,
                                        cu_price=(1 << 64) - 1),
}


@pytest.mark.parametrize("case", sorted(ESTIMATE_CASES))
def test_estimate_matches_jax(case):
    tx = ESTIMATE_CASES[case]()
    got = CB.estimate(tx, T.parse(tx))
    want = CBJ.estimate(tx, TJ.parse(tx))
    assert (got.rewards, got.cost, got.cu_limit, got.ok) == (
        want.rewards, want.cost, want.cu_limit, want.ok)
    assert got.ok == (case != "duplicate_budget_instr")


BUDGET_CASES = {
    "deprecated_request_units": [b"\x00" + (7000).to_bytes(4, "little")
                                 + (123).to_bytes(4, "little"),
                                 b"\x02" + (1).to_bytes(4, "little")],
    "heap_then_heap": [b"\x01" + (32 * 1024).to_bytes(4, "little"),
                       b"\x01" + (64 * 1024).to_bytes(4, "little")],
    "heap_not_granular": [b"\x01" + (1000).to_bytes(4, "little")],
    "limit_price": [b"\x02" + (300_000).to_bytes(4, "little"),
                    b"\x03" + (5_000).to_bytes(8, "little")],
    "limit_above_max": [b"\x02" + (1_400_001).to_bytes(4, "little")],
    "bad_kind_and_short": [b"\x09\x00\x00\x00\x00", b"\x02\x00"],
}


@pytest.mark.parametrize("case", sorted(BUDGET_CASES))
def test_budget_state_matches_jax(case):
    st, sj = CB.BudgetState(), CBJ.BudgetState()
    for data in BUDGET_CASES[case]:
        assert st.parse_instr(data) == sj.parse_instr(data)
        assert vars(st) == vars(sj)
    for total in (1, 3):
        assert st.finalize(total) == sj.finalize(total)


def test_builtin_costs_match_jax():
    assert CB.BUILTIN_COSTS == CBJ.BUILTIN_COSTS
    assert CB.COMPUTE_BUDGET_PROGRAM_ID == CBJ.COMPUTE_BUDGET_PROGRAM_ID
    assert P.VOTE_PROGRAM_ID == PJ.VOTE_PROGRAM_ID


# ---------------------------------------------------------------------------
# the native scan (fdt_txn_scan) through both packages' libraries


def _scan_inputs(kind: str):
    if kind == "pool":
        rows, szs, _good = make_txn_pool(32, corrupt_frac=0.2, seed=3)
        # the pack tile's input: payload sizes without the wire trailer
        return rows, (szs.astype(np.int64) - wire.TRAILER_SZ).astype(np.uint32)
    if kind == "hot_payers":
        return _rows(_hot_payer_txns(48, 8, seed=29))
    if kind == "budget_and_votes":
        txs = [ESTIMATE_CASES[c]() for c in sorted(ESTIMATE_CASES)]
        txs += [_vote_txn(_acct(20 + i), _acct(40 + i)) for i in range(3)]
        return _rows(txs)
    rng = np.random.default_rng(11)  # garbage, truncated and oversized rows
    txs = [bytes(rng.integers(0, 256, int(n), np.uint8)) for n in (0, 1, 100, 700)]
    good = _mk_txn(_acct(1), [_acct(2)], [])
    txs += [good[:-3], good + b"\x00", good]
    return _rows(txs)


SCAN_FIELDS = ("ok", "is_vote", "fast", "cost", "rewards", "cu_limit", "tags",
               "lamports", "payer_off", "src_off", "dst_off", "fee", "bs_rw",
               "bs_w", "whash", "w_cnt", "rhash", "r_cnt", "tszs")


@pytest.mark.parametrize("kind", ["pool", "hot_payers", "budget_and_votes", "garbage"])
def test_txn_scan_matches_jax(kind):
    rows, szs = _scan_inputs(kind)
    width = rows.shape[1] + wire.TRAILER_SZ
    tr, trj = (np.zeros((len(rows), width), np.uint8) for _ in range(2))
    got = P.txn_scan(rows, szs, nbits=1024, with_bitsets=True, with_trailer=True, trows=tr)
    want = PJ.txn_scan(rows, szs, nbits=1024, with_bitsets=True, with_trailer=True,
                       trows=trj)
    assert got.n_ok == want.n_ok
    for f in SCAN_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    np.testing.assert_array_equal(tr, trj)
    if kind != "garbage":
        assert got.n_ok > 0
    plain = P.txn_scan(rows, szs)
    np.testing.assert_array_equal(plain.cost, got.cost)


@pytest.mark.parametrize("tx", ["defaults", "vote", "duplicate_budget_instr"])
def test_is_simple_vote_matches_jax(tx):
    b = ESTIMATE_CASES[tx]()
    assert P.is_simple_vote(b, T.parse(b)) == PJ.is_simple_vote(b, TJ.parse(b))


# ---------------------------------------------------------------------------
# the engine, op by op


ENGINE_ARRAYS = (
    "rows", "szs", "rewards", "cost", "expires_at", "state", "sig_tag", "is_vote",
    "bs_rw", "bs_w", "whash", "w_cnt", "rhash", "r_cnt", "in_use_rw", "in_use_w",
    "bit_ref_rw", "bit_ref_w", "lw_keys", "lw_vals", "lr_keys", "lr_vals",
    "wc_keys", "wc_vals", "_sched_words", "mb_used", "mb_bank", "mb_handle",
    "mb_head", "mb_cnt", "mb_cost", "mb_next",
)


def assert_same_engine(got, want):
    for name in ENGINE_ARRAYS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert got.pending_cnt == want.pending_cnt
    assert got.inflight_cnt == want.inflight_cnt
    assert got.lock_table_load() == want.lock_table_load()


def _payer_mix(n: int, seed: int) -> list[bytes]:
    """Txns over a small account set (write conflicts, shared readers) and
    seeded prices."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        w = [_acct(100 + int(a)) for a in rng.choice(6, int(rng.integers(0, 3)), replace=False)]
        r = [_acct(200 + int(a)) for a in rng.choice(4, int(rng.integers(0, 2)), replace=False)]
        out.append(_mk_txn(_acct(10 + i % 9), w, r, cu_price=int(rng.integers(1, 10**6)),
                           cu_limit=int(rng.integers(1_000, 400_000)),
                           data=bytes([i % 251]) * 16))
    return out


def _pool_payloads(n: int, seed: int) -> list[bytes]:
    rows, szs, good = make_txn_pool(n, corrupt_frac=0.0, seed=seed)
    return [rows[i, : szs[i] - wire.TRAILER_SZ].tobytes() for i in range(n)]


# Each scenario: (engine kwargs, ops).  Ops: ("insert", payload, kw),
# ("batch", payloads, expires_at), ("schedule", bank, kw), ("complete", k)
# (the k-th scheduled microblock), ("drain", bank_count, kw) (complete what
# is outstanding, then schedule each bank, until nothing schedules),
# ("end_block",).
SCENARIOS = {
    "conflicts": ({}, [
        *[("insert", _mk_txn(_acct(10 + i), [_acct(80)] if i % 3 == 0 else [_acct(100 + i)],
                             [_acct(200)], cu_price=(i + 1) * 100_000), {"sig_tag": i + 1})
          for i in range(12)],
        ("schedule", 0, {"cu_limit": 10_000_000}),
        ("schedule", 1, {"cu_limit": 10_000_000}),
        ("complete", 0),
        ("schedule", 0, {"cu_limit": 10_000_000, "txn_limit": 2}),
        ("drain", 2, {}),
        ("end_block",),
    ]),
    "votes": ({}, [
        ("batch", [_vote_txn(_acct(30 + i), _acct(60 + i % 3)) for i in range(8)]
         + _payer_mix(8, seed=4), 0),
        ("schedule", 0, {"vote_fraction": 0.25, "txn_limit": 8}),
        ("schedule", 1, {"vote_fraction": 0.5}),
        ("drain", 2, {"txn_limit": 5}),
        ("end_block",),
    ]),
    "expire": ({}, [
        ("insert", _mk_txn(_acct(1), [_acct(2)], []), {"expires_at": 100}),
        ("insert", _mk_txn(_acct(3), [_acct(4)], []), {"expires_at": 300}),
        ("insert", _mk_txn(_acct(5), [_acct(6)], []), {}),
        ("batch", _payer_mix(6, seed=5), 150),
        ("schedule", 0, {"now": 200}),
        ("complete", 0),
        ("drain", 1, {"now": 400}),
    ]),
    "replace": ({"depth": 8}, [
        *[("insert", _mk_txn(_acct(10 + i), [_acct(100 + i)], [], cu_price=10), {})
          for i in range(8)],
        ("insert", _mk_txn(_acct(30), [_acct(31)], [], cu_price=1), {}),
        ("batch", [_mk_txn(_acct(40 + i), [_acct(120 + i)], [], cu_price=10**6 + i)
                   for i in range(5)], 0),
        ("insert", _mk_txn(_acct(50), [_acct(51)], [], cu_price=10**7), {}),
        ("insert", b"\x01\x02\x03", {}),
        ("drain", 2, {"txn_limit": 3}),
    ]),
    "budgets": ({"block_cost_limit": 1_500_000, "writer_cost_cap": 700_000}, [
        ("batch", _payer_mix(24, seed=6), 0),
        ("schedule", 0, {"cu_limit": 600_000, "byte_limit": 600}),
        ("schedule", 1, {"cu_limit": 900_000}),
        ("complete", 0), ("complete", 1),
        ("schedule", 0, {}),
        ("drain", 2, {}),
        ("end_block",),
        ("drain", 2, {"cu_limit": 0}),
        ("drain", 2, {}),
    ]),
    "pool": ({"depth": 256}, [
        ("batch", _pool_payloads(96, seed=5), 0),
        ("drain", 2, {}),
    ]),
    "hot_payers": ({"depth": 128}, [
        ("batch", [t for t in _hot_payer_txns(64, 16, seed=29)], 0),
        ("drain", 2, {"txn_limit": 31}),
        ("end_block",),
    ]),
}


def _run_scenario(pk, ops, select, scan_limit):
    """Apply `ops` to engine `pk`; yields after every op a record of what
    it returned."""
    mbs, outstanding = [], []

    def schedule(bank, kw):
        kw = {"scan_limit": scan_limit, "device_select": select, **kw}
        mb = pk.schedule_microblock(bank, **kw)
        if mb is None:
            return None
        mbs.append((bank, mb))
        outstanding.append((bank, mb))
        return ("mb", bank, mb.handle, mb.txn_idx.tolist(), mb.total_cost)

    def complete(m):
        outstanding.remove(m)
        pk.microblock_complete(m[0], m[1].handle)
        return ("complete", m[0], m[1].handle)

    for op in ops:
        if op[0] == "insert":
            yield pk.insert(op[1], **op[2])
        elif op[0] == "batch":
            rows, szs = _rows(op[1])
            yield pk.insert_batch(rows, szs, expires_at=op[2])
        elif op[0] == "schedule":
            yield schedule(op[1], op[2])
        elif op[0] == "complete":
            yield complete(mbs[op[1]])
        elif op[0] == "drain":
            rounds = []
            for _ in range(200):
                out = [complete(m) for m in list(outstanding)]
                out += [schedule(b, op[2]) for b in range(op[1])]
                rounds.append(out)
                if not any(o and o[0] == "mb" for o in out):
                    break
            yield rounds
        else:
            pk.end_block()
            yield "end_block"


@pytest.mark.parametrize("select", ["host", "device"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_matches_jax(scenario, select):
    kw, ops = SCENARIOS[scenario]
    kw = {"max_banks": 4, **kw}
    depth = kw.pop("depth", 64)
    got_eng, want_eng = P.Pack(depth, **kw), PJ.Pack(depth, **kw)
    sel_p = sel_j = None
    if select == "device":
        sel_p = functools.partial(PS.select_noconflict, device="cpu")
        sel_j = PSJ.select_noconflict
    # the port's plain select loops over every candidate row: a short scan
    # keeps the CPU run short (the pool scenario runs the deployment's 1024)
    scan_limit = 1024 if scenario == "pool" else 64
    scheduled = 0
    for got, want in zip(_run_scenario(got_eng, ops, sel_p, scan_limit),
                         _run_scenario(want_eng, ops, sel_j, scan_limit)):
        assert got == want
        assert_same_engine(got_eng, want_eng)
        scheduled += str(got).count("'mb'")
    assert scheduled > 0
    assert got_eng.outstanding_cnt == want_eng.outstanding_cnt


# ---------------------------------------------------------------------------
# the microblock codec across packages


@pytest.mark.parametrize("n,seed", [(1, 31), (5, 32), (31, 33)])
def test_mb_codec_across_packages(n, seed):
    rows, szs, _ = make_txn_pool(n, seed=seed)
    idx = np.random.default_rng(seed).permutation(n)
    buf = TP.mb_encode(7 + n, 3, rows, szs, idx=idx)
    np.testing.assert_array_equal(buf, TPJ.mb_encode(7 + n, 3, rows, szs, idx=idx))
    for dec in (TP.mb_decode, TPJ.mb_decode):
        handle, bank, txns = dec(buf)
        assert (handle, bank, len(txns)) == (7 + n, 3, n)
        for k, t in zip(idx, txns):
            np.testing.assert_array_equal(t, rows[k, : szs[k]])


def test_bank_decode_rejects_malformed():
    from firedancer_tpu_torch.tiles.bank import BankTile

    rows, szs, _ = make_txn_pool(3, seed=34)
    buf = TP.mb_encode(1, 0, rows, szs)
    bank = BankTile(0)
    trows, tszs = bank._decode(buf)
    assert len(trows) == 3 and (tszs == szs).all()
    assert bank._decode(buf[:-1]) is None and bank._decode(buf[:5]) is None
    from firedancer_tpu_torch.funk import Funk

    funk_bank = BankTile(1, funk=Funk())
    assert funk_bank.funk is not None and funk_bank._decode(buf[:5]) is None


# ---------------------------------------------------------------------------
# the kernel's host build against select_plain and a Python greedy


def greedy(rw, wr, in_rw, in_w, costs, cu_limit, txn_limit):
    """The scan in Python ints over (K, W2) words."""
    sel_rw, sel_w = [int(x) for x in in_rw], [int(x) for x in in_w]
    cu, taken, want = 0, 0, []
    for i in range(len(costs)):
        hit = any((int(wr[i][j]) & sel_rw[j]) | (int(rw[i][j]) & sel_w[j])
                  for j in range(len(sel_rw)))
        ok = not hit and cu + int(costs[i]) <= cu_limit and taken < txn_limit
        if ok:
            sel_rw = [s | int(x) for s, x in zip(sel_rw, rw[i])]
            sel_w = [s | int(x) for s, x in zip(sel_w, wr[i])]
            cu += int(costs[i])
            taken += 1
        want.append(ok)
    return np.array(want, bool)


def _scan_case(K, W2, case, seed):
    """(K, W2) int32 words, in-use words, int64 costs, cu_limit, txn_limit."""
    rng = np.random.default_rng(seed)
    rw = np.zeros((K, W2), np.uint32)
    wr = np.zeros((K, W2), np.uint32)
    for i in range(K):
        for b in rng.integers(0, W2 * 32, 4):
            rw[i, b >> 5] |= np.uint32(1) << np.uint32(b & 31)
        for b in rng.integers(0, W2 * 32, 2):
            wr[i, b >> 5] |= np.uint32(1) << np.uint32(b & 31)
    rw |= wr
    in_rw = np.zeros(W2, np.uint32)
    in_w = np.zeros(W2, np.uint32)
    costs = rng.integers(1_000, 200_000, K).astype(np.int64)
    cu_limit, txn_limit = 1_500_000, 31
    if case == "pad_rows":
        costs[rng.random(K) < 0.3] = PS.PAD_COST
        costs[-1] = PS.PAD_COST
    elif case == "in_use":
        for b in rng.integers(0, W2 * 32, 3):
            in_rw[b >> 5] |= np.uint32(1) << np.uint32(b & 31)
        in_w[rng.integers(0, W2)] |= np.uint32(1) << np.uint32(rng.integers(0, 32))
        in_rw |= in_w
    elif case == "cu_limit_0":
        cu_limit = 0
        costs[::5] = 0
    elif case == "cu_limit_exact":
        cu_limit = int(costs[0] + costs[min(1, K - 1)])
        wr[:] = 0
        rw[:] = 0  # no conflicts: the budget alone decides
    return (rw.view(np.int32), wr.view(np.int32), in_rw.view(np.int32),
            in_w.view(np.int32), costs, cu_limit, txn_limit)


@pytest.fixture(scope="module")
def host_select_lib(tmp_path_factory):
    return host_library(tmp_path_factory, "pack_select")


@pytest.fixture(scope="module")
def host_select(host_select_lib):
    fn = host_select_lib.fdt_pack_select_host
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_int64] * 2
    fn.restype = None

    def run(rw, wr, in_rw, in_w, costs, cu_limit, txn_limit):
        """-> (take mask, the chain's step count)."""
        K, W2 = rw.shape
        arrs = [np.ascontiguousarray(a) for a in (rw, wr, in_rw, in_w, costs)]
        take = np.full(K, 7, np.uint8)
        stats = np.full(4, -1, np.int64)
        fn(*(a.ctypes.data for a in arrs), take.ctypes.data, stats.ctypes.data, K, W2,
           cu_limit, txn_limit)
        assert set(np.unique(take)) <= {0, 1} and stats[1:].tolist() == [0, 0, 0]
        return take.astype(bool), int(stats[0])

    return run


@pytest.mark.parametrize("case", ["random", "pad_rows", "in_use", "cu_limit_0",
                                  "cu_limit_exact"])
@pytest.mark.parametrize("W2", [2, 32, 64])
@pytest.mark.parametrize("K", [1, 33, 1024])
def test_kernel_host_build_matches_plain(host_select, capfd, K, W2, case):
    args = _scan_case(K, W2, case, seed=K * 100 + W2)
    got, steps = host_select(*args)
    assert_no_sanitizer_report(capfd)
    np.testing.assert_array_equal(got, greedy(*args))
    assert steps == windowed_greedy(*args)[1] <= step_bound(*args, got)
    plain = PS.select_plain(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args[:5]),
                            args[5], args[6]).numpy()
    np.testing.assert_array_equal(got, plain)
    if case == "pad_rows":
        assert not got[args[4] == PS.PAD_COST].any()
    if case == "cu_limit_0":
        assert (args[4][got] == 0).all()


def test_select_impl_on_cpu_runs_plain_and_never_counts():
    args = _scan_case(40, 4, "random", seed=9)
    before = PS.LAUNCHES
    take = PS.select_impl(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args[:5]),
                          args[5], args[6])
    assert PS.LAUNCHES == before and take.dtype == torch.bool
    np.testing.assert_array_equal(take.numpy(), greedy(*args))
    assert PS.select_plain(*(torch.zeros((0, 4), dtype=torch.int32),) * 2,
                           *(torch.zeros(4, dtype=torch.int32),) * 2,
                           torch.zeros(0, dtype=torch.int64), 10, 2).shape == (0,)


def test_select_noconflict_matches_jax_at_deployment_shape():
    """K = 1024 candidates of 1024 account bits (16 u64 words), the shape
    the engine pads to: the port's select on the CPU against JAX's."""
    rng = np.random.default_rng(7)
    K, W = 1024, 16
    rw = np.zeros((K, W), np.uint64)
    wr = np.zeros((K, W), np.uint64)
    for i in range(K):
        for b in rng.integers(0, W * 64, 6):
            rw[i, b >> 6] |= np.uint64(1) << np.uint64(b & 63)
        for b in rng.integers(0, W * 64, 2):
            wr[i, b >> 6] |= np.uint64(1) << np.uint64(b & 63)
    rw |= wr
    in_rw = np.zeros(W, np.uint64)
    in_rw[3] = np.uint64(0xF0F0)
    costs = rng.integers(1_000, 200_000, K).astype(np.int64)
    costs[700:] = PS.PAD_COST
    args = (rw, wr, in_rw, np.zeros(W, np.uint64), costs, 1_500_000, 31)
    got = PS.select_noconflict(*args, device="cpu")
    np.testing.assert_array_equal(got, PSJ.select_noconflict(*args))
    assert got.sum() > 1 and not got[700:].any()


# ---------------------------------------------------------------------------
# the kernel's two phases: live rows, then a chain of takes over them


@pytest.mark.parametrize("K,W2,case", [
    (K, W2, case)
    for K, W2 in [(1, 1), (31, 2), (97, 32), (100, 33), (1000, 2), (1024, 32), (70, 300)]
    for case in EDGE_CASES
    # a take at live row m needs more than m rows
    if not (case.startswith("take_at_") and K <= int(case[len("take_at_"):]))])
def test_kernel_host_build_chain_edges(host_select, capfd, K, W2, case):
    """The host build against the Python greedy, select_plain, JAX's
    select_noconflict (even W2: u64 rows) and the two-phase model, whose
    step count it must equal, within ceil(live / 32) + takes."""
    args = edge_case(case, K, W2, seed=K * 1000 + W2)
    got, steps = host_select(*args)
    assert_no_sanitizer_report(capfd)
    want = greedy(*args)
    np.testing.assert_array_equal(got, want)
    model, model_steps = windowed_greedy(*args)
    np.testing.assert_array_equal(model, want)
    assert steps == model_steps <= step_bound(*args, got)
    plain = PS.select_plain(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args[:5]),
                            args[5], args[6]).numpy()
    np.testing.assert_array_equal(plain, want)
    if W2 % 2 == 0:
        u64 = [np.ascontiguousarray(a).view(np.uint64) for a in args[:4]]
        np.testing.assert_array_equal(PSJ.select_noconflict(*u64, *args[4:]), want)
    if case.startswith("take_at_"):
        m = int(case[len("take_at_"):])
        assert list(np.flatnonzero(got)) == [0, m] and steps == 2 + (m > WINDOW)
    if case == "budget_exact":
        assert int(args[4][got].sum()) == args[5] and got[: min(5, K)].all()
    if case == "zero_cost_cu_limit_0":
        assert (args[4][got] == 0).all() and got.any() == (args[4] == 0).any()
    if case == "all_dead":
        assert not got.any() and steps == 0
    if case == "txn_limit_1":
        assert got.sum() <= 1


@pytest.mark.parametrize("W2,K,case", [
    (W2, k, case) for W2 in (4, 64, 300)
    for k, case in [(seg_rows(W2) + 77, "random"), (2 * seg_rows(W2), "txn_limit_31"),
                    (seg_rows(W2) + 1, "budget_exact")]])
def test_kernel_host_build_segments(host_select, capfd, W2, K, case):
    """K over one segment: the chain carries its state into the next
    segment's phase 1 (the Python greedy and the model; select_plain too
    where the loop is short enough on the CPU)."""
    args = edge_case(case, K, W2, seed=K)
    got, steps = host_select(*args)
    assert_no_sanitizer_report(capfd)
    np.testing.assert_array_equal(got, greedy(*args))
    assert steps == windowed_greedy(*args)[1] <= step_bound(*args, got)
    if K <= 2048:
        plain = PS.select_plain(
            *(torch.from_numpy(np.ascontiguousarray(a)) for a in args[:5]),
            args[5], args[6]).numpy()
        np.testing.assert_array_equal(got, plain)


def test_seg_rows_matches_the_kernel(host_select_lib):
    """ops/pack_select.py's seg_rows (the step bound's segments) is the
    kernel's ps_seg_rows at every width it takes."""
    fn = host_select_lib.fdt_pack_select_seg_rows
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    assert all(fn(W2) == PS.seg_rows(W2) for W2 in range(1, PS.MAX_W2 + 1))


@pytest.mark.parametrize("K", [0, 1, 77, 1024])
def test_selector_staging_layout_gives_plain_mask(K):
    """The selector on the CPU: the u64 inputs written into its staging
    block (`views`; a call on the card hands the same offsets to
    fdt_pack_select_call, which copies into and launches on them) read
    back, as the kernel reads them, as select_plain's int32 words, and
    give select_plain's (and JAX's) mask; one selector serves calls of any
    K up to its size."""
    W = 16
    sel = PS.Selector(1024, W, device="cpu")
    for k in sorted({K, max(K - 5, 0)}):
        rng = np.random.default_rng(k)
        rw = rng.integers(0, 2**63, (k, W), dtype=np.uint64) & np.uint64(0x0101010101010101)
        wr = rw & np.uint64(0x0001000100010001)
        in_rw = np.zeros(W, np.uint64)
        in_rw[3] = np.uint64(0x0100)
        in_w = np.zeros(W, np.uint64)
        costs = rng.integers(1_000, 200_000, k).astype(np.int64)
        got = sel(rw, wr, in_rw, in_w, costs, 1_500_000, 31)
        block = sel._host[: sel._offsets(k)[-1]]
        want_block = np.concatenate([PS.split_u32(a).ravel().view(np.uint8)
                                     for a in (rw, wr, in_rw, in_w)] + [costs.view(np.uint8)])
        np.testing.assert_array_equal(block, want_block)
        words = [torch.from_numpy(PS.split_u32(a)) for a in (rw, wr, in_rw, in_w)]
        want = PS.select_plain(*words, torch.from_numpy(costs), 1_500_000, 31).numpy()
        np.testing.assert_array_equal(got, want)
        if k:
            np.testing.assert_array_equal(
                got, PSJ.select_noconflict(rw, wr, in_rw, in_w, costs, 1_500_000, 31))
    assert sel.stats is None  # the plain version counts no steps


def test_selector_rejects_bad_inputs():
    sel = PS.Selector(8, 2, device="cpu")
    z = np.zeros((8, 2), np.uint64)
    with pytest.raises(ValueError, match="holds 8"):
        sel(np.zeros((9, 2), np.uint64), np.zeros((9, 2), np.uint64), z[0], z[0],
            np.zeros(9, np.int64), 10, 2)
    with pytest.raises(ValueError, match="cand_w must have shape"):
        sel(z, z[:1], z[0], z[0], np.zeros(8, np.int64), 10, 2)
    with pytest.raises(ValueError, match="in_use_rw must have shape"):
        sel(z, z, z[0, :1], z[0], np.zeros(8, np.int64), 10, 2)
    with pytest.raises(ValueError, match="u64 words a row"):
        PS.Selector(8, PS.MAX_W2, device="cpu")
    with pytest.raises(ValueError, match="counts no steps"):
        t = torch.zeros((1, 2), dtype=torch.int32)
        PS.select_impl(t, t, t[0], t[0], torch.zeros(1, dtype=torch.int64), 10, 2,
                       stats=torch.zeros(4, dtype=torch.int64))


def test_pack_tile_owns_a_selector():
    """A PackTile with the device select holds one Selector sized for its
    scan and binds select_noconflict to it (so a hook on the module-level
    function sees every call)."""
    tile = TP.PackTile(2, use_device_select=True, device="cpu")
    sel = tile._selector
    assert isinstance(sel, PS.Selector) and sel.device == torch.device("cpu")
    assert (sel.k_max, sel.w) == (tile.scan_limit, tile.engine.W)
    assert tile._dev_select.func is PS.select_noconflict
    assert tile._dev_select.keywords == {"selector": sel}
    assert TP.PackTile(2)._selector is None
