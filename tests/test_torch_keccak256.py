"""The port's batched Keccak-256 against its host digest, the JAX
keccak256 and the JAX digest_host, across the 136-byte rate boundaries.
Digests are compared exactly."""

import numpy as np
import pytest

from firedancer_tpu.ops import keccak256 as KJ
from firedancer_tpu_torch.ops import keccak256 as KT

LENGTHS = [0, 1, 134, 135, 136, 137, 271, 272, 273, 300]
EMPTY = "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"


def _batch(seed, lengths, width):
    rng = np.random.default_rng(seed)
    lens = np.array(lengths, np.int32)
    msgs = rng.integers(0, 256, (len(lens), width), np.uint8)
    msgs[np.arange(width)[None, :] >= lens[:, None]] = 0
    return msgs, lens


def test_empty_input_vector():
    assert KT.digest_host(b"").hex() == EMPTY
    got = KT.keccak256(np.zeros((1, 0), np.uint8), np.zeros(1, np.int32), device="cpu")
    assert got.numpy()[0].tobytes().hex() == EMPTY


def test_keccak256_matches_host_and_jax():
    msgs, lens = _batch(5, LENGTHS, 300)
    got = KT.keccak256(msgs, lens, device="cpu").numpy()
    for i, n in enumerate(lens):
        assert got[i].tobytes() == KT.digest_host(msgs[i, :n].tobytes()), n
    np.testing.assert_array_equal(got, np.asarray(KJ.keccak256(msgs, lens)))


@pytest.mark.parametrize("n", [0, 1, 135, 136, 137, 272, 1000, 1232])
def test_digest_host_matches_jax(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert KT.digest_host(data) == KJ.digest_host(data)


def test_keccak256_single_block_width():
    """Width below the rate: one absorbed block per lane."""
    msgs, lens = _batch(6, [0, 7, 64], 64)
    got = KT.keccak256(msgs, lens, device="cpu").numpy()
    assert [g.tobytes() for g in got] == \
        [KT.digest_host(msgs[i, :n].tobytes()) for i, n in enumerate(lens)]
