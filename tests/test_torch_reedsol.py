"""The port's Reed-Solomon coding against the JAX package: its GF(2^8)
copy against the original, `encode` against the JAX `_apply_bitmatrix` and
`_encode_host`, and `recover` against the data and the JAX `recover`.
Bytes are compared exactly."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ballet import gf256 as GJ
from firedancer_tpu.ops import reedsol as RJ
from firedancer_tpu_torch.ballet import gf256 as GT
from firedancer_tpu_torch.ops import reedsol as RT


def test_gf256_tables_and_scalars_match_original():
    assert GT.POLY == GJ.POLY
    np.testing.assert_array_equal(GT.EXP, GJ.EXP)
    np.testing.assert_array_equal(GT.LOG, GJ.LOG)
    for a, b in itertools.product(range(0, 256, 7), range(1, 256, 11)):
        assert GT.mul(a, b) == GJ.mul(a, b)
        assert GT.div(a, b) == GJ.div(a, b)
    assert [GT.inv(a) for a in range(1, 256)] == [GJ.inv(a) for a in range(1, 256)]


@pytest.mark.parametrize("d,total", [(1, 2), (4, 7), (32, 64)])
def test_gf256_matrices_match_original(d, total):
    np.testing.assert_array_equal(GT.vandermonde(total, d), GJ.vandermonde(total, d))
    np.testing.assert_array_equal(GT.code_matrix(d, total), GJ.code_matrix(d, total))
    pm = GT.parity_matrix(d, total - d)
    np.testing.assert_array_equal(pm, GJ.parity_matrix(d, total - d))
    np.testing.assert_array_equal(GT.expand_bits(pm), GJ.expand_bits(pm))
    sq = GT.code_matrix(d, total)[total - d:]
    np.testing.assert_array_equal(GT.mat_inv(sq), GJ.mat_inv(sq))
    np.testing.assert_array_equal(GT.mat_mul(sq, GT.mat_inv(sq)), np.eye(d, dtype=np.uint8))
    assert [GT.mul_bitmatrix(c).tolist() for c in (0, 1, 2, 0x8E, 255)] == \
        [GJ.mul_bitmatrix(c).tolist() for c in (0, 1, 2, 0x8E, 255)]


def test_gf256_singular_raises():
    with pytest.raises(ValueError, match="singular"):
        GT.mat_inv(np.zeros((2, 2), np.uint8))


@pytest.mark.parametrize("d,p", [(1, 1), (32, 32), (67, 67)])
def test_encode_matches_jax(d, p):
    rng = np.random.default_rng(d * 100 + p)
    data = rng.integers(0, 256, (d, 96), np.uint8)
    got = RT.encode(data, p, device="cpu").numpy()
    want = np.asarray(RJ._apply_bitmatrix(jnp.asarray(RJ._parity_bits_matrix(d, p)),
                                          jnp.asarray(data)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, RJ._encode_host(data, p))
    np.testing.assert_array_equal(RT._encode_host(data, p), got)


def test_encode_all_ones_reaches_column_sum_536():
    """All-ones data at D = 67: a column of the product sums up to 8·67 =
    536 ones, beyond what bfloat16 holds exactly; MATMUL_DTYPE keeps every
    parity bit."""
    data = np.full((67, 40), 0xFF, np.uint8)
    bits = RT._unpack_bits(torch.from_numpy(data)).to(torch.int64)
    bmat = torch.from_numpy(RT._parity_bits_matrix(67, 67)).to(torch.int64)
    assert int((bmat @ bits).max()) > 256
    np.testing.assert_array_equal(RT.encode(data, 67, device="cpu").numpy(),
                                  RJ._encode_host(data, 67))


def _fec_set(seed, d, p, n=64):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (d, n), np.uint8)
    return data, np.concatenate([data, RJ._encode_host(data, p)])


@pytest.mark.parametrize("pattern", ["data_lost", "parity_only", "random"])
def test_recover(pattern):
    d, p = 32, 32
    data, shreds = _fec_set(7, d, p)
    present = np.ones(d + p, bool)
    if pattern == "data_lost":
        present[[0, 5, 31]] = False
    elif pattern == "parity_only":
        present[:d] = False
    else:
        present[np.random.default_rng(8).choice(d + p, p, replace=False)] = False
    garbage = shreds.copy()
    garbage[~present] = 0xA5
    got = RT.recover(garbage, present, d, device="cpu").numpy()
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(got, RJ.recover(garbage, present, d))


def test_recover_partial_returns_none():
    _, shreds = _fec_set(9, 8, 4, n=16)
    present = np.zeros(12, bool)
    present[:7] = True
    assert RT.recover(shreds, present, 8, device="cpu") is None
    assert RJ.recover(shreds, present, 8) is None
