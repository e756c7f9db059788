"""The port's account store and runtime (firedancer_tpu_torch/funk/funk.py,
flamenco/accounts.py, features.py, sysvar.py, runtime.py and the program
set it loads: ballet/sbpf.py, secp256k1.py, flamenco/vm.py) against the JAX
package's, exactly (bytes and integers).

Every test function of the JAX package's funk and runtime test files runs
as written, its own assertions on the JAX modules holding, under a mirror
that runs the port beside it:

  funk      every Funk the JAX test makes gets a port twin; each operation
            (txn_prepare / cancel / publish / is_frozen, rec_write / remove
            / write_many / read / read_batch, checkpoint) runs on both, its
            result compared, and after each one the two stores' root
            records, open transactions (parent, records, children) and
            lamports caches must be equal; checkpoint files byte for byte.
  executor  every call of a JAX Executor's begin_slot, execute_txn and
            execute_fast_transfers also runs on a port Executor built from a
            copy of the JAX executor's state and store just before the call;
            the result (every TxnResult field, or the tuple), the whole
            store after the call and the executor's state must be equal.

The cases are the JAX package's seeded transactions: fees and the system
program, fast transfers, native programs (config, ed25519), durable nonces
and secp256k1, feature gates, loader v4, BPF and CPI."""

import dataclasses
import importlib
import inspect
import sys
from pathlib import Path

import numpy as np
import pytest

from firedancer_tpu.flamenco import runtime as RJ
from firedancer_tpu.funk import funk as FJ
from firedancer_tpu_torch.ballet import base58 as B58T
from firedancer_tpu_torch.flamenco import features as FET
from firedancer_tpu_torch.flamenco import runtime as RT
from firedancer_tpu_torch.flamenco import sysvar as SVT
from firedancer_tpu_torch.funk import funk as FT

TESTS = Path(__file__).resolve().parent
if str(TESTS) not in sys.path:
    sys.path.insert(0, str(TESTS))

FUNK_MODULES = ("test_funk",)
RUNTIME_MODULES = ("test_runtime", "test_bank_fast", "test_native_programs",
                   "test_nonce_secp", "test_features", "test_loader_v4", "test_cpi",
                   "test_sbpf_vm")


def _cases(modules):
    out = []
    for name in modules:
        mod = importlib.import_module(name)
        for fn, obj in vars(mod).items():
            if fn.startswith("test_") and callable(obj) and not hasattr(obj, "pytestmark"):
                out.append((name, fn))
    return out


def _call(module: str, fn: str, tmp_path):
    f = getattr(importlib.import_module(module), fn)
    kw = {}
    for p in inspect.signature(f).parameters:
        assert p == "tmp_path", f"{module}.{fn} takes {p}"
        kw[p] = tmp_path
    f(**kw)


# ---------------------------------------------------------------------------
# the store


def funk_state(f) -> dict:
    """Everything a Funk holds, as plain values."""
    return {
        "root": dict(f.root),
        "txns": {x: (t.parent, dict(t.recs), sorted(t.children)) for x, t in f.txns.items()},
        "lam_cache": dict(f.lam_cache),
    }


def port_funk(jf) -> FT.Funk:
    """A port Funk holding a copy of a JAX Funk's state."""
    pf = FT.Funk()
    pf.root = dict(jf.root)
    pf.txns = {x: FT._Txn(t.xid, t.parent, dict(t.recs), set(t.children))
               for x, t in jf.txns.items()}
    pf.lam_cache = dict(jf.lam_cache)
    return pf


_FUNK_OPS = ("txn_prepare", "txn_is_frozen", "txn_cancel", "txn_publish", "rec_write",
             "rec_remove", "rec_write_many", "rec_read", "rec_read_batch")


def _same_value(a, b):
    if isinstance(a, tuple) and a and isinstance(a[0], np.ndarray):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    else:
        assert a == b


@pytest.fixture
def funk_mirror(monkeypatch):
    """Every JAX Funk of the test gets a port twin; -> the ops mirrored."""
    twins, ops = {}, []
    depth = [0]  # operations called by an operation are the outer one's
    init = FJ.Funk.__init__

    def make(self):
        init(self)
        twins[id(self)] = FT.Funk()

    monkeypatch.setattr(FJ.Funk, "__init__", make)
    for name in _FUNK_OPS:
        orig = getattr(FJ.Funk, name)

        def op(self, *a, _orig=orig, _name=name, **kw):
            if _name == "rec_write_many":
                a = (a[0], list(a[1]))  # a generator is read once
            if depth[0]:
                return _orig(self, *a, **kw)
            twin = twins[id(self)]
            depth[0] += 1
            try:
                want = _orig(self, *a, **kw)
            except AssertionError:
                with pytest.raises(AssertionError):
                    getattr(twin, _name)(*a, **kw)
                ops.append(_name)
                raise
            finally:
                depth[0] -= 1
            got = getattr(twin, _name)(*a, **kw)
            _same_value(want, got)
            assert funk_state(twin) == funk_state(self), _name
            ops.append(_name)
            return want

        monkeypatch.setattr(FJ.Funk, name, op)
    ckpt = FJ.Funk.checkpoint

    def checkpoint(self, path):
        ckpt(self, path)
        twins[id(self)].checkpoint(str(path) + ".port")
        assert Path(str(path) + ".port").read_bytes() == Path(path).read_bytes()
        restored = FT.Funk.restore(str(path) + ".port")
        assert restored.root == self.root
        ops.append("checkpoint")

    monkeypatch.setattr(FJ.Funk, "checkpoint", checkpoint)
    restore = FJ.Funk.restore.__func__

    def restore_mirrored(cls, path):
        jf = restore(cls, path)
        twins[id(jf)] = FT.Funk.restore(path)
        assert funk_state(twins[id(jf)]) == funk_state(jf)
        return jf

    monkeypatch.setattr(FJ.Funk, "restore", classmethod(restore_mirrored))
    return ops


@pytest.mark.parametrize("module,fn", _cases(FUNK_MODULES))
def test_funk_matches_jax(module, fn, funk_mirror, tmp_path):
    _call(module, fn, tmp_path)
    assert funk_mirror, "the case ran no funk operation"


# ---------------------------------------------------------------------------
# the executor

_EX_STATE = ("xid", "slot", "recent_blockhash", "lamports_per_signature",
             "last_touched", "last_fallbacks")


def port_executor(jex, pf) -> RT.Executor:
    """A port Executor over `pf` in the JAX executor's state."""
    pex = RT.Executor(pf, jex.xid)
    for a in _EX_STATE:
        setattr(pex, a, list(getattr(jex, a)) if a == "last_touched" else getattr(jex, a))
    pex.features = FET.Features(dict(jex.features.slots))
    pex._slot_hashes = (None if jex._slot_hashes is None
                        else SVT.SlotHashes.decode(jex._slot_hashes.encode()))
    return pex


def executor_state(ex) -> dict:
    return {**{a: getattr(ex, a) for a in _EX_STATE},
            "features": dict(ex.features.slots),
            "slot_hashes": None if ex._slot_hashes is None else ex._slot_hashes.encode()}


def result_value(r):
    """A TxnResult as a dict of its fields; anything else as it is."""
    return dataclasses.asdict(r) if dataclasses.is_dataclass(r) else r


@pytest.fixture
def executor_mirror(monkeypatch):
    """Every entry-point call of a JAX Executor also runs on a port
    Executor made from a copy of its state; -> the calls mirrored."""
    calls = []
    for name in ("begin_slot", "execute_txn", "execute_fast_transfers"):
        orig = getattr(RJ.Executor, name)

        def entry(self, *a, _orig=orig, _name=name, **kw):
            pex = port_executor(self, port_funk(self.funk))
            if _name == "execute_txn":
                a, kw = a[:1], {}  # the port parses the payload itself
            want = _orig(self, *a, **kw)
            got = getattr(pex, _name)(*a, **kw)
            assert result_value(got) == result_value(want), _name
            assert funk_state(pex.funk) == funk_state(self.funk), _name
            assert executor_state(pex) == executor_state(self), _name
            calls.append(_name)
            return want

        monkeypatch.setattr(RJ.Executor, name, entry)
    return calls


@pytest.mark.parametrize("module,fn", _cases(RUNTIME_MODULES))
def test_executor_matches_jax(module, fn, executor_mirror, tmp_path):
    _call(module, fn, tmp_path)


def test_every_runtime_module_reaches_the_executor(monkeypatch):
    """Each mirrored module's cases reach at least one executor call (so
    the mirror is not vacuous), and the mirror compares something."""
    counts = {}
    for module in RUNTIME_MODULES:
        calls = []
        orig = RJ.Executor.execute_txn

        def counting(self, *a, **kw):
            calls.append(1)
            return orig(self, *a, **kw)

        monkeypatch.setattr(RJ.Executor, "execute_txn", counting)
        for mod, fn in _cases([module]):
            if inspect.signature(getattr(importlib.import_module(mod), fn)).parameters:
                continue
            getattr(importlib.import_module(mod), fn)()
        monkeypatch.setattr(RJ.Executor, "execute_txn", orig)
        counts[module] = len(calls)
    assert all(counts.values()), counts


# ---------------------------------------------------------------------------
# host functions of the runtime and its programs, on seeded inputs


def test_pda_and_rent_match_jax():
    rng = np.random.default_rng(11)
    for _ in range(64):
        prog = rng.integers(0, 256, 32, np.uint8).tobytes()
        seeds = [rng.integers(0, 256, int(rng.integers(0, 33)), np.uint8).tobytes()
                 for _ in range(int(rng.integers(0, 4)))]
        assert RT.find_program_address(seeds, prog) == RJ.find_program_address(seeds, prog)
        want = _outcome(RJ.create_program_address, seeds + [b"\x07"], prog)
        assert _outcome(RT.create_program_address, seeds + [b"\x07"], prog) == want
    for space in (0, 1, 128, 10_000, 10 * 1024 * 1024):
        assert RT.rent_exempt_minimum(space) == RJ.rent_exempt_minimum(space)


def _outcome(fn, *a):
    try:
        return ("ok", fn(*a))
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return (type(e).__name__, str(e))


def test_secp256k1_murmur3_base58_match_jax():
    from firedancer_tpu.ballet import base58 as B58J
    from firedancer_tpu.ballet import murmur3 as MJ
    from firedancer_tpu.ballet import secp256k1 as KJ
    from firedancer_tpu_torch.ballet import murmur3 as MT
    from firedancer_tpu_torch.ballet import secp256k1 as KT

    rng = np.random.default_rng(12)
    for n in range(0, 70, 3):
        data = rng.integers(0, 256, n, np.uint8).tobytes()
        seed = int(rng.integers(0, 2**32))
        assert MT.murmur3_32(data, seed) == MJ.murmur3_32(data, seed)
        key = data[:32].rjust(32, b"\0")
        assert B58T.encode_32(key) == B58J.encode_32(key)
        assert B58T.decode_32(B58J.encode_32(key)) == key
    for _ in range(6):
        secret = int.from_bytes(rng.integers(0, 256, 32, np.uint8).tobytes(), "big") % KJ.N
        k = int.from_bytes(rng.integers(0, 256, 32, np.uint8).tobytes(), "big") % KJ.N
        digest = rng.integers(0, 256, 32, np.uint8).tobytes()
        sig, rec = KJ.sign(digest, secret, k)
        assert KT.sign(digest, secret, k) == (sig, rec)
        assert KT.pubkey_of(secret) == KJ.pubkey_of(secret)
        for s, r in ((sig, rec), (sig, rec ^ 1), (bytes(64), 0)):
            assert KT.recover(digest, s, r) == KJ.recover(digest, s, r)
        pub = KJ.pubkey_of(secret)
        assert KT.eth_address(pub) == KJ.eth_address(pub)


def test_sysvars_and_features_match_jax():
    from firedancer_tpu.flamenco import features as FEJ
    from firedancer_tpu.flamenco import sysvar as SVJ
    from firedancer_tpu.flamenco.accounts import AccountMgr as AMJ
    from firedancer_tpu_torch.flamenco.accounts import AccountMgr as AMT

    assert FET.FEATURE_IDS == FEJ.FEATURE_IDS
    for slot in (0, 1, 431_999, 432_000, 10**7):
        jf, pf = FJ.Funk(), FT.Funk()
        SVJ.install(AMJ(jf), slot, unix_timestamp=slot * 3)
        SVT.install(AMT(pf), slot, unix_timestamp=slot * 3)
        assert pf.root == jf.root
