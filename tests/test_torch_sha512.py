"""The port's batched SHA-512 against hashlib and the JAX package across the
block-boundary lengths and Solana's 1232-byte maximum packet."""

import hashlib

import numpy as np
import pytest
import torch

from firedancer_tpu.ops import sha512 as SHJ
from firedancer_tpu_torch.ops import sha512 as SHT

LENGTHS = [0, 111, 112, 127, 128, 1232]


@pytest.mark.parametrize("width", [128, 1232])
def test_sha512_matches_hashlib(width):
    rng = np.random.default_rng(width)
    lens = np.array([min(n, width) for n in LENGTHS] + [width // 2, 1], np.int64)
    msgs = rng.integers(0, 256, (len(lens), width), np.uint8)
    got = SHT.sha512(torch.from_numpy(msgs), torch.from_numpy(lens)).numpy()
    for i, n in enumerate(lens):
        assert got[i].tobytes() == hashlib.sha512(msgs[i, :n].tobytes()).digest()


def test_sha512_matches_jax():
    rng = np.random.default_rng(21)
    lens = np.array(LENGTHS + [1000, 17], np.int32)
    msgs = rng.integers(0, 256, (len(lens), 1232), np.uint8)
    got = SHT.sha512(torch.from_numpy(msgs), torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(got, np.asarray(SHJ.sha512(msgs, lens)))
