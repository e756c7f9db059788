"""The port's waltz/admission.py against the JAX package's, on seeded op
scripts that drive each class and its JAX twin in lockstep (every return
value and the state after each op equal: exact), and the unit cases of
tests/test_hostile_ingress.py (the token bucket's tick domain, the
connection caps and their reasons, the emergency level, the txn bucket's
high-stake exemption, the idle and slow-loris sweep, the shedder's
hysteresis and commanded floor, the stake table) on the port."""

import dataclasses
import inspect
import types

import numpy as np
import pytest

from firedancer_tpu.waltz import admission as AJ
from firedancer_tpu_torch.waltz import admission as A

S = A.TICKS_PER_S


def test_constants_match_jax():
    for name in ("TICKS_PER_S", "REASONS", "CLASS_UNSTAKED", "CLASS_LOW", "CLASS_HI",
                 "CLASS_NAMES", "SHED_FOOTPRINT", "SHED_W_COMMANDED", "SHED_W_BURN",
                 "SHED_W_LEVEL", "SHED_W_TRANSITIONS"):
        assert getattr(A, name) == getattr(AJ, name), name
    assert ([f.name for f in dataclasses.fields(A.AdmissionConfig)]
            == [f.name for f in dataclasses.fields(AJ.AdmissionConfig)])
    assert A.AdmissionConfig().to_dict() == AJ.AdmissionConfig().to_dict()
    src = inspect.getsource(A)
    assert "import time" not in src and "time.monotonic" not in src


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_token_bucket_script(seed):
    rng = np.random.default_rng(seed)
    rate, burst = int(rng.integers(0, 50)), int(rng.integers(1, 20))
    a, b = A.TokenBucket(rate, burst), AJ.TokenBucket(rate, burst)
    now = 0
    for _ in range(500):
        now += int(rng.integers(0, S // 20))
        n = int(rng.integers(1, 30))
        assert a.take(now, n) == b.take(now, n)
        assert ([getattr(a, k) for k in type(a).__slots__]
                == [getattr(b, k) for k in type(b).__slots__])


def _addr(rng):
    return (f"10.0.{int(rng.integers(0, 4))}.{int(rng.integers(1, 4))}",
            int(rng.integers(1000, 1010)))


def _server_view(conns):
    """A stand-in QuicServer view for sweep(): by_addr of conns with their
    established flag and last_rx_tick."""
    return types.SimpleNamespace(by_addr={
        addr: types.SimpleNamespace(scid=key, established=est, last_rx_tick=t)
        for key, (addr, est, t) in conns.items()})


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_conn_admission_script(seed):
    rng = np.random.default_rng(seed)
    cfg = dict(max_conns=6, max_conns_per_source=2, handshake_rate=int(rng.integers(1, 8)),
               handshake_burst=3, txn_rate=20, txn_burst=5, idle_timeout_s=0.5,
               handshake_timeout_s=0.2)
    stakes = {b"10.0.0.1:1001": 50_000, b"whale": 2_000_000, b"minnow": 10}
    a = A.ConnAdmission(A.AdmissionConfig(**cfg), A.StakeTable(dict(stakes)))
    b = AJ.ConnAdmission(AJ.AdmissionConfig(**cfg), AJ.StakeTable(dict(stakes)))
    conns: dict = {}
    now = 0
    for i in range(600):
        now += int(rng.integers(0, S // 50))
        op = int(rng.integers(0, 7))
        if op == 0:
            addr = _addr(rng)
            assert a.admit_handshake(addr, now) == b.admit_handshake(addr, now)
        elif op == 1:
            addr = _addr(rng)
            got = a.admit_conn(addr, now)
            assert got == b.admit_conn(addr, now)
            if got is None:
                key = i.to_bytes(4, "little")
                a.conn_opened(key, addr, now)
                b.conn_opened(key, addr, now)
                conns[key] = (addr, False, now)
        elif op == 2 and conns:
            key = list(conns)[int(rng.integers(0, len(conns)))]
            a.conn_released(key)
            b.conn_released(key)
            del conns[key]
        elif op == 3:
            key = bytes([int(rng.integers(0, 4))])
            ident = [b"whale", b"minnow", b"nobody", b"10.0.0.1:1001"][int(rng.integers(0, 4))]
            n = int(rng.integers(1, 12))
            assert a.admit_txns(key, ident, now, n) == b.admit_txns(key, ident, now, n)
        elif op == 4 and conns:
            key = list(conns)[int(rng.integers(0, len(conns)))]
            addr, _est, _t = conns[key]
            conns[key] = (addr, bool(rng.integers(0, 2)), now)
        elif op == 5:
            assert a.sweep(_server_view(conns), now) == b.sweep(_server_view(conns), now)
        else:
            lvl = int(rng.integers(0, 4))
            a.level = b.level = lvl
        assert a.per_source == b.per_source
        assert len(a.conns) == len(b.conns)


@pytest.mark.parametrize("seed", [7, 8])
def test_load_shedder_script(seed):
    rng = np.random.default_rng(seed)
    cfg = dict(shed_hi=0.75, shed_lo=0.25, shed_cooldown_s=0.3, shed_dwell_s=0.05)
    a, b = A.LoadShedder(A.AdmissionConfig(**cfg)), AJ.LoadShedder(AJ.AdmissionConfig(**cfg))
    now = 0
    for _ in range(800):
        now += int(rng.integers(0, S // 40))
        frac = float(rng.random())
        cmd = int(rng.integers(0, 4)) if rng.random() < 0.1 else 0
        assert a.update(now, frac, cmd) == b.update(now, frac, cmd)
        assert (a.level, a.transitions) == (b.level, b.transitions)
    for cls_ in range(3):
        for lvl in range(4):
            assert A.LoadShedder.admits(cls_, lvl) == AJ.LoadShedder.admits(cls_, lvl)


def test_stake_table_and_config_match_jax():
    doc = {"0x0a0b": 500, "1.2.3.4:5": 70_000, "whale": 3}
    t, tj = A.StakeTable.from_config(doc, low_stake=1000), AJ.StakeTable.from_config(doc, low_stake=1000)
    assert t.stakes == tj.stakes and t.total() == tj.total()
    for ident in (b"\x0a\x0b", b"1.2.3.4:5", b"whale", b"unknown", None):
        assert (t.weight(ident), t.cls_of(ident)) == (tj.weight(ident), tj.cls_of(ident))
    for n, seed in ((12, 5), (16, 6), (1, 0)):
        s, sj = A.StakeTable.synthetic(n, seed=seed), AJ.StakeTable.synthetic(n, seed=seed)
        assert list(s.stakes.items()) == list(sj.stakes.items())
    assert A.StakeTable.synthetic(12, seed=5).stakes != A.StakeTable.synthetic(12, seed=6).stakes
    cfg = A.AdmissionConfig(max_conns=100, backlog_cap=4000)
    cfgj = AJ.AdmissionConfig(max_conns=100, backlog_cap=4000)
    for n_active, base in ((1, 4), (4, 4), (8, 4), (3, 2)):
        assert cfg.autosized(n_active, base).to_dict() == cfgj.autosized(n_active, base).to_dict()
    assert A.AdmissionConfig.from_dict(cfg.to_dict()) == cfg
    for addr in (("1.2.3.4", 5), "unix"):
        assert A.addr_identity(addr) == AJ.addr_identity(addr)
        assert A.source_key(addr) == AJ.source_key(addr)


# ---------------------------------------------------------------------------
# tests/test_hostile_ingress.py's unit cases, on the port


def test_token_bucket_tick_domain():
    b = A.TokenBucket(rate_per_s=10, burst=4)
    assert b.take(now=0, n=6) == 4
    assert b.take(now=0, n=1) == 0
    assert b.take(now=S // 10, n=2) == 1
    assert b.take(now=100 * S, n=100) == 4
    assert A.TokenBucket(0, 1).take(now=0, n=999) == 999


def test_conn_caps_emergency_and_txn_exemption():
    a = A.ConnAdmission(A.AdmissionConfig(max_conns=4, max_conns_per_source=2,
                                          handshake_rate=2, handshake_burst=2,
                                          txn_rate=5, txn_burst=3))
    assert a.admit_handshake(("1.1.1.1", 1), now=0) is None
    assert a.admit_handshake(("1.1.1.2", 1), now=0) is None
    assert a.admit_handshake(("1.1.1.3", 1), now=0) == "drop_handshake_rate"
    for i in range(2):
        assert a.admit_conn(("9.9.9.9", 1000 + i), S) is None
        a.conn_opened(bytes([i]), ("9.9.9.9", 1000 + i), S)
    assert a.admit_conn(("9.9.9.9", 3000), S) == "drop_source_cap"
    for i in range(2):
        a.conn_opened(bytes([16 + i]), (f"8.8.8.{i}", 1), S)
    assert a.admit_conn(("7.7.7.7", 1), S) == "drop_conn_cap"
    a.conn_released(bytes([0]))
    a.conn_released(bytes([16]))
    assert a.admit_conn(("9.9.9.9", 3000), S) is None
    e = A.ConnAdmission(A.AdmissionConfig(), A.StakeTable({b"1.2.3.4:5": 10_000}))
    e.level = 3
    assert e.admit_handshake(("6.6.6.6", 1), now=0) == "drop_emergency"
    assert e.admit_handshake(("1.2.3.4", 5), now=0) is None
    t = A.ConnAdmission(A.AdmissionConfig(txn_rate=5, txn_burst=3),
                        A.StakeTable({b"whale": 1_000_000}, low_stake=1000))
    assert t.admit_txns(b"k1", b"nobody", now=0, n=5) == 3
    assert t.admit_txns(b"k2", b"whale", now=0, n=500) == 500


def test_idle_and_slow_loris_sweep():
    a = A.ConnAdmission(A.AdmissionConfig(idle_timeout_s=1.0, handshake_timeout_s=0.5))
    est = types.SimpleNamespace(scid=b"A", established=True, last_rx_tick=1)
    loris = types.SimpleNamespace(scid=b"B", established=False, last_rx_tick=0)
    server = types.SimpleNamespace(by_addr={("1.1.1.1", 1): est, ("2.2.2.2", 2): loris})
    a.conn_opened(b"A", ("1.1.1.1", 1), now=1)
    a.conn_opened(b"B", ("2.2.2.2", 2), now=1)
    assert a.sweep(server, now=int(0.2 * S)) == ([], [])
    loris.last_rx_tick = int(0.6 * S)
    assert a.sweep(server, now=int(0.7 * S)) == ([], [("2.2.2.2", 2)])
    idle, _hs = a.sweep(server, now=int(1.5 * S))
    assert ("1.1.1.1", 1) in idle


def test_load_shedder_hysteresis_and_commanded_floor():
    sh = A.LoadShedder(A.AdmissionConfig(shed_hi=0.75, shed_lo=0.25,
                                         shed_cooldown_s=1.0, shed_dwell_s=0.1))
    D = int(0.1 * S)
    assert [sh.update(t, 0.9) for t in (0, 1, D, 2 * D, 3 * D)] == [1, 1, 2, 3, 3]
    assert sh.update(3 * D, 0.5) == 3
    assert sh.update(1 * S, 0.1) == 3
    assert sh.update(int(1.5 * S), 0.1) == 3
    assert sh.update(int(2.1 * S), 0.1) == 2
    assert sh.update(int(2.2 * S), 0.1, commanded=3) == 3
    assert sh.update(int(2.3 * S), 0.1, commanded=0) == 3
    assert not A.LoadShedder.admits(A.CLASS_UNSTAKED, 1)
    assert A.LoadShedder.admits(A.CLASS_HI, 3)
