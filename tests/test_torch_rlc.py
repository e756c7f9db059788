"""Batch (RLC) verification in the port (`verify_batch_digest_rlc` and its
parts) against the JAX package, golden and the port's per-signature path,
on the CPU: an honest batch accepts through the batch equation, a corrupt
lane falls back to the strict path, prologue rejects do not poison the
batch, a mixed batch equals the per-signature verdicts, and the order-2
torsion cancellation pair is rejected by the subgroup gate.

Results are bools: every comparison is exact.  The comparisons through
Pallas interpret mode are marked slow, as in tests/test_msm_rlc.py."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import torsion2_pair
from firedancer_tpu.ops.ed25519 import verify as VJ
from firedancer_tpu_torch.ops.ed25519 import golden
from firedancer_tpu_torch.ops.ed25519 import point as PT
from firedancer_tpu_torch.ops.ed25519 import verify as V

L = golden.L
N = 12


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _make_batch(seed, n=N, n_keys=4):
    rng = np.random.default_rng(seed)
    secrets = [rng.bytes(32) for _ in range(n_keys)]
    sigs = np.zeros((n, 64), np.uint8)
    pubs = np.zeros((n, 32), np.uint8)
    digs = np.zeros((n, 64), np.uint8)
    for i in range(n):
        sec = secrets[i % n_keys]
        pub = golden.public_from_secret(sec)
        m = rng.bytes(48)
        s = golden.sign(sec, m)
        sigs[i] = np.frombuffer(s, np.uint8)
        pubs[i] = np.frombuffer(pub, np.uint8)
        digs[i] = np.frombuffer(hashlib.sha512(s[:32] + pub + m).digest(), np.uint8)
    return digs, sigs, pubs


ZB = np.ones((N, 16), np.uint8)  # odd z, deterministic


def _impl(digs, sigs, pubs, zb=ZB):
    ok, batch_ok = V._verify_digest_rlc_impl(*_t(digs, sigs, pubs, zb))
    return ok.tolist(), bool(batch_ok)


@pytest.fixture
def spy(monkeypatch):
    """Records what each verify_batch_digest_rlc call's batch equation said
    ((lane_ok, batch_ok) per call) and counts subgroup-gate runs and
    strict-path fallbacks."""
    seen = {"impl": [], "gates": 0, "fallbacks": 0}
    impl, strict, gate = V._verify_digest_rlc_impl, V._verify_from_digest, V._torsion_free_pair

    def spy_impl(*args, **kw):
        ok, batch_ok = impl(*args, **kw)
        seen["impl"].append((ok.tolist(), bool(batch_ok)))
        return ok, batch_ok

    def spy_strict(*args):
        seen["fallbacks"] += 1
        return strict(*args)

    def spy_gate(*args):
        seen["gates"] += 1
        return gate(*args)

    monkeypatch.setattr(V, "_verify_digest_rlc_impl", spy_impl)
    monkeypatch.setattr(V, "_verify_from_digest", spy_strict)
    monkeypatch.setattr(V, "_torsion_free_pair", spy_gate)
    return seen


def _rlc(digs, sigs, pubs, zb=ZB):
    return V.verify_batch_digest_rlc(digs, sigs, pubs, zb, device="cpu").tolist()


def test_z_limbs_and_l_digits_match_jax():
    rng = np.random.default_rng(5)
    zb = rng.integers(0, 256, (N, 16), np.uint8)
    np.testing.assert_array_equal(
        V._z_limbs(torch.from_numpy(zb)).numpy(), np.asarray(VJ._z_limbs(jnp.asarray(zb))))
    np.testing.assert_array_equal(V._L_DIGITS, VJ._L_DIGITS)
    d = V._L_DIGITS[:, 0].astype(object)
    assert sum(int(d[i]) << (4 * i) for i in range(64)) == L


def test_honest_batch_accepts_by_the_batch_equation(spy):
    digs, sigs, pubs = _make_batch(10)
    # the batch equation itself accepts (no fallback): a gate that flagged
    # subgroup points would demote every batch and the verdicts alone could
    # not show it
    assert _rlc(digs, sigs, pubs) == [True] * N
    # zbytes=None draws z from os.urandom
    assert V.verify_batch_digest_rlc(digs, sigs, pubs, device="cpu").all()
    assert spy == {"impl": [([True] * N, True)] * 2, "gates": 2, "fallbacks": 0}


def test_corrupt_lane_falls_back_to_per_sig(spy):
    digs, sigs, pubs = _make_batch(11)
    sigs[5, 40] ^= 1  # s stays canonical: the lane passes the prologue
    assert _rlc(digs, sigs, pubs) == [i != 5 for i in range(N)]
    # the equation fails: no gate, straight to the strict path
    assert spy == {"impl": [([True] * N, False)], "gates": 0, "fallbacks": 1}


def test_prologue_rejects_do_not_poison_batch(spy):
    digs, sigs, pubs = _make_batch(12)
    # lane 2: non-canonical s (s + L), lane 9: small-order pubkey; both are
    # left out by the prologue, and the rest must still batch-accept
    s_int = int.from_bytes(bytes(sigs[2, 32:]), "little") + L
    sigs[2, 32:] = np.frombuffer(s_int.to_bytes(32, "little"), np.uint8)
    pubs[9] = np.frombuffer(golden.small_order_blocklist()[3], np.uint8)
    want = [i not in (2, 9) for i in range(N)]
    assert _rlc(digs, sigs, pubs) == want
    assert spy == {"impl": [(want, True)], "gates": 1, "fallbacks": 0}


def test_rlc_matches_per_sig_on_mixed_random_batch(spy):
    digs, sigs, pubs = _make_batch(13, n=8)
    sigs[0, 0] ^= 1  # R corrupt
    sigs[3, 40] ^= 1  # s corrupt
    digs[6, 1] ^= 1  # digest (message) corrupt
    got = _rlc(digs, sigs, pubs, ZB[:8])
    assert spy["fallbacks"] == 1 and spy["gates"] == 0 and not spy["impl"][0][1]
    want = V.verify_batch_digest(digs, sigs, pubs, device="cpu").tolist()
    assert got == want == [i not in (0, 3, 6) for i in range(8)]


# ---------------------------------------------------------------------------
# cofactor gap: order-2 torsion residual cancellation
# ---------------------------------------------------------------------------

def _torsion2_pair():
    """The order-2 torsion-cancellation pair of chip_smoke.torsion2_pair as
    (digests, sigs, pubs) arrays and the messages: two signatures with
    mixed-order R' = R + T2 whose cofactorless residuals are both T2, so
    their z-weighted sum cancels for every odd z pair."""
    msgs, sigs, pubs = torsion2_pair(golden)
    digs = [hashlib.sha512(s[:32] + p + m).digest() for m, s, p in zip(msgs, sigs, pubs)]
    to8 = lambda bs: np.stack([np.frombuffer(b, np.uint8) for b in bs])  # noqa: E731
    return to8(digs), to8(sigs), to8(pubs), msgs


def _gate_points():
    """Encodings: an honest subgroup point, the mixed-order R' of the
    torsion pair, and bytes that fail to decompress."""
    _, sigs, pubs, _ = _torsion2_pair()
    bad = next(bytes([i]) * 32 for i in range(2, 256)
               if golden.point_decompress(bytes([i]) * 32) is None)
    return np.stack([pubs[0], sigs[1, :32], np.frombuffer(bad, np.uint8)])


def test_torsion_gate_matches_golden():
    encs = _gate_points()
    got = V._torsion_free(*PT.decompress_bytes(torch.from_numpy(encs))).tolist()
    want = []
    for e in encs:
        p = golden.point_decompress(e.tobytes())
        want.append(p is not None and golden.scalar_mul(L, p) == golden.IDENT)
    assert got == want == [True, False, False]
    y, sign = PT.decompress_bytes(torch.from_numpy(encs[:2]))
    assert V._torsion_free_pair(y[:, :1], sign[:, :1], y[:, 1:], sign[:, 1:]).tolist() == [False]


def test_rlc_rejects_order2_torsion_cancellation(spy):
    digs, sigs, pubs, msgs = _torsion2_pair()
    for i in range(2):
        assert golden.verify(msgs[i], bytes(sigs[i]), bytes(pubs[i])) != golden.ERR_OK
    # the prologue passes both lanes and the equation holds (the residuals
    # cancel); the subgroup gate fails the batch and the strict path rejects
    # both
    assert _rlc(digs, sigs, pubs, ZB[:2]) == [False, False]
    assert spy == {"impl": [([True, True], False)], "gates": 1, "fallbacks": 1}


# ---------------------------------------------------------------------------
# against the JAX package through Pallas interpret mode (slow)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_torsion_gate_matches_jax():
    encs = _gate_points()[:2]
    pts, ok = [], []
    for e in encs:
        p, o = VJ.PT.decompress(jnp.asarray(np.tile(e, (1, 1))))
        pts.append(p)
        ok.append(bool(np.asarray(o)[0]))
    assert ok == [True, True]
    jx = np.asarray(VJ._torsion_free_pair(pts[0], pts[1]))
    y, sign = PT.decompress_bytes(torch.from_numpy(encs))
    port = V._torsion_free_pair(y[:, :1], sign[:, :1], y[:, 1:], sign[:, 1:])
    np.testing.assert_array_equal(port.numpy(), jx)


@pytest.mark.slow
@pytest.mark.parametrize("case", ["honest", "torsion"])
def test_rlc_impl_matches_pallas_interpret(case):
    if case == "honest":
        digs, sigs, pubs = _make_batch(10)
        zb = ZB
    else:
        digs, sigs, pubs, _ = _torsion2_pair()
        zb = ZB[:2]
    port = _impl(digs, sigs, pubs, zb)
    lane_ok, batch_ok = VJ._verify_digest_rlc_impl(
        *(jnp.asarray(a) for a in (digs, sigs, pubs, zb)), interpret=True)
    assert port == (np.asarray(lane_ok).tolist(), bool(np.asarray(batch_ok)))
    assert port[1] == (case == "honest")
