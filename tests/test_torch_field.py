"""The port's GF(2^255-19) limb arithmetic against the JAX package and
Python ints.  Inputs come from numpy seeds and go to both packages; results
are integers, so every comparison is exact (limb for limb where the two
modules compute the same carried form)."""

import numpy as np
import pytest
import torch

from firedancer_tpu.ops.ed25519 import field as FJ
from firedancer_tpu_torch.ops.ed25519 import field as FT

P = FT.P
B = 13  # not a multiple of any tile width


def _rand_ints(rng, n, hi=P):
    return [int.from_bytes(rng.bytes(40), "little") % hi for _ in range(n)]


def _limbs(vals):
    return np.stack([FT.int_to_limbs(v) for v in vals], axis=1)


def _carried(rng, n):
    """Carried-form limbs: canonical limbs of random values."""
    return _limbs(_rand_ints(rng, n))


def _same(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_constants_match_jax():
    assert (FT.P, FT.D, FT.SQRT_M1) == (FJ.P, FJ.D, FJ.SQRT_M1)
    assert (FT.RADIX, FT.NLIMB, FT.FOLD, FT.LOOSE_MAX) == (
        FJ.RADIX, FJ.NLIMB, FJ.FOLD, FJ.LOOSE_MAX)
    for name in ("ONE", "D", "D2", "SQRT_M1", "P32", "P"):
        np.testing.assert_array_equal(FT._CONSTS[name], FJ._CONST_TABLE[name])


def test_int_limbs_roundtrip():
    rng = np.random.default_rng(1)
    vals = _rand_ints(rng, B, 1 << 260)
    l = _limbs(vals)
    assert FT.limbs_to_int(torch.from_numpy(l)) == vals
    assert FT.limbs_to_int(l) == FJ.limbs_to_int(l)


@pytest.mark.parametrize("seed", [2, 3])
def test_mul_sqr_match_jax_and_ints(seed):
    rng = np.random.default_rng(seed)
    a, b = _carried(rng, B), _carried(rng, B)
    # lazy two-term differences, as the point formulas feed mul_rr
    a = a - _carried(rng, B)
    got = FT.mul_rr(torch.from_numpy(a), torch.from_numpy(b))
    _same(got, FJ.mul_rr(a, b))
    want = [x * y % P for x, y in zip(FT.limbs_to_int(a), FT.limbs_to_int(b))]
    assert [v % P for v in FT.limbs_to_int(got)] == want
    _same(FT.sqr_rr(torch.from_numpy(b)), FJ.sqr_rr(b))


def test_carry1_loose_max_contract():
    """carry1 accepts |limb| <= LOOSE_MAX and leaves |limb| <= 8209."""
    rng = np.random.default_rng(4)
    lm = FT.LOOSE_MAX
    x = rng.integers(-lm, lm + 1, (FT.NLIMB, B)).astype(np.int32)
    x[:, 0], x[:, 1], x[:, 2] = lm, -lm, 0
    x[::2, 3], x[1::2, 3] = lm, -lm
    got = FT.carry1(torch.from_numpy(x))
    _same(got, FJ.carry1(x))
    assert int(got.abs().max()) <= 8209
    assert [v % P for v in FT.limbs_to_int(got)] == [
        v % P for v in FT.limbs_to_int(x)]


def test_mul_loose_inputs_give_carried_outputs():
    """mul normalizes lazy chains with |limb| <= 2^17; carried outputs lie
    in [-1218, 8801] (field.py's contract)."""
    rng = np.random.default_rng(5)
    lm = FT.LOOSE_MAX
    a = rng.integers(-lm, lm + 1, (FT.NLIMB, B)).astype(np.int32)
    b = rng.integers(-lm, lm + 1, (FT.NLIMB, B)).astype(np.int32)
    a[:, 0], b[:, 0] = lm, lm
    a[:, 1], b[:, 1] = -lm, lm
    got = FT.mul(torch.from_numpy(a), torch.from_numpy(b))
    _same(got, FJ.mul(a, b))
    assert int(got.min()) >= -1218 and int(got.max()) <= 8801
    want = [x * y % P for x, y in zip(FT.limbs_to_int(a), FT.limbs_to_int(b))]
    assert [v % P for v in FT.limbs_to_int(got)] == want


def test_canonical_eq_is_zero_parity():
    rng = np.random.default_rng(6)
    vals = [0, 1, P - 1, P, P + 1, 2 * P, (1 << 255) - 1, (1 << 255) + 5]
    vals += _rand_ints(rng, B - len(vals), 1 << 259)
    x = _limbs(vals)
    loose = x - _carried(rng, B) + _carried(rng, B)  # same class, lazy form
    c = FT.canonical(torch.from_numpy(loose))
    _same(c, FJ.canonical(loose))
    assert FT.limbs_to_int(c) == [
        v % P for v in FT.limbs_to_int(loose)]
    assert (c >= 0).all() and (c <= FT.MASK).all()
    xt, lt = torch.from_numpy(x), torch.from_numpy(loose)
    _same(FT.eq(xt, lt), FJ.eq(x, loose))
    _same(FT.is_zero(lt), FJ.is_zero(loose))
    _same(FT.parity(lt), FJ.parity(loose))
    assert FT.is_zero(lt).tolist() == [v % P == 0 for v in FT.limbs_to_int(loose)]


def test_pow_p58_and_invert():
    rng = np.random.default_rng(7)
    vals = _rand_ints(rng, 4)
    z = torch.from_numpy(_limbs(vals))
    got = FT.limbs_to_int(FT.pow_p58(z))
    assert [g % P for g in got] == [pow(v, (P - 5) // 8, P) for v in vals]
    inv = FT.limbs_to_int(FT.invert(z))
    assert [g * v % P for g, v in zip(inv, vals)] == [1] * 4
    _same(FT.pow_p58(z), FJ.pow_p58(z.numpy()))


def test_from_bytes_to_bytes():
    rng = np.random.default_rng(8)
    b = rng.integers(0, 256, (B, 32), np.uint8)
    b[0] = 0xFF  # all ones: non-canonical, bit 255 set
    l = FT.from_bytes(torch.from_numpy(b))
    _same(l, FJ.from_bytes(b))
    assert FT.limbs_to_int(l) == [int.from_bytes(r.tobytes(), "little") for r in b]
    out = FT.to_bytes(l)
    _same(out, FJ.to_bytes(np.asarray(l.numpy())))
    assert [int.from_bytes(r.tobytes(), "little") for r in out.numpy()] == [
        int.from_bytes(r.tobytes(), "little") % P for r in b]
